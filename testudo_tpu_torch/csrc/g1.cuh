// BLS12-377 G1 group law for the Hopper kernels, and the per-lane bodies of
// the packed EC kernels.
//
// Replaces the fused EC kernel bodies of testudo_tpu/tpu/pallas_curve.py
// (:391-584, ops "add2", "step", "scan2b", "bucket", "bucket_mixed", and the
// ladder of :733-749), which trace tpu/curve.py's staged RCB16 formulas over
// lazily reduced limb rows.  The formulas here are the same three
// (Renes-Costello-Batina 2016, a = 0: Algorithm 7 complete add, Algorithm 8
// complete mixed add, Algorithm 9 complete double) on strictly reduced
// values, so every coordinate written is canonical and equals, limb for
// limb, what the JAX package writes.
//
// A point is three Fq elements in a thread's registers.  In device memory a
// batch is `(72, L)` int32: coordinate-major 16-bit limb rows, batch along L.
//
// Each `lane_*` function is the whole work of one thread of one kernel; the
// `__global__` functions in the .cu files only compute the lane index.  The
// same functions compile as plain C++ for csrc/host_check.cpp.
#pragma once
#include "fp.cuh"

typedef FqParams Fq;
#define FQN 12
#define G1_ROWS 72  // 3 coordinates x 24 limb rows

struct G1 {
  u32 x[FQN], y[FQN], z[FQN];
};

FP_FN void g1_set_identity(G1& r) {
  fp_zero<Fq>(r.x);
  fp_copy<Fq>(r.y, FQ_ONE);
  fp_zero<Fq>(r.z);
}

FP_FN void g1_load(G1& r, const int* base, long L, long lane) {
  fp_load<Fq>(r.x, base, L, lane, 0);
  fp_load<Fq>(r.y, base, L, lane, 24);
  fp_load<Fq>(r.z, base, L, lane, 48);
}

FP_FN void g1_store(int* base, long L, long lane, const G1& a) {
  fp_store<Fq>(base, L, lane, 0, a.x);
  fp_store<Fq>(base, L, lane, 24, a.y);
  fp_store<Fq>(base, L, lane, 48, a.z);
}

FP_FN void g1_select(G1& r, bool c, const G1& a, const G1& b) {
  fp_select<Fq>(r.x, c, a.x, b.x);
  fp_select<Fq>(r.y, c, a.y, b.y);
  fp_select<Fq>(r.z, c, a.z, b.z);
}

// Shared tail of Algorithms 7 and 8: from t0 = X1X2, t1 = Y1Y2, t2 (Z1Z2 or
// Z1), t3, t4 and Y3 as staged in tpu/curve.py:199-213.
FP_FN void g1_add_tail(G1& r, u32* t0, u32* t1, const u32* t2, const u32* t3,
                       const u32* t4, const u32* y3) {
  u32 x3[FQN], t2b[FQN], y3b[FQN], z3[FQN], a[FQN], b[FQN];
  fp_add<Fq>(x3, t0, t0);
  fp_add<Fq>(t0, x3, t0);  // 3 X1X2
  fp_mul3<Fq>(t2b, t2);
  fp_mul3<Fq>(y3b, y3);
  fp_add<Fq>(z3, t1, t2b);
  fp_sub<Fq>(t1, t1, t2b);
  fp_mul<Fq>(a, t4, y3b);  // a1
  fp_mul<Fq>(b, t3, t1);   // a2
  fp_sub<Fq>(r.x, b, a);
  fp_mul<Fq>(a, y3b, t0);  // a3
  fp_mul<Fq>(b, t1, z3);   // a4
  fp_add<Fq>(r.y, b, a);
  fp_mul<Fq>(a, t0, t3);   // a5
  fp_mul<Fq>(b, z3, t4);   // a6
  fp_add<Fq>(r.z, b, a);
}

// r = p + q, complete (RCB16 Algorithm 7).  r may alias p or q.
FP_FN void g1_add(G1& r, const G1& p, const G1& q) {
  u32 t0[FQN], t1[FQN], t2[FQN], t3[FQN], t4[FQN], y3[FQN], u[FQN], v[FQN];
  fp_mul<Fq>(t0, p.x, q.x);
  fp_mul<Fq>(t1, p.y, q.y);
  fp_mul<Fq>(t2, p.z, q.z);
  fp_add<Fq>(u, p.x, p.y);
  fp_add<Fq>(v, q.x, q.y);
  fp_mul<Fq>(t3, u, v);  // m3
  fp_add<Fq>(u, p.y, p.z);
  fp_add<Fq>(v, q.y, q.z);
  fp_mul<Fq>(t4, u, v);  // m4
  fp_add<Fq>(u, p.x, p.z);
  fp_add<Fq>(v, q.x, q.z);
  fp_mul<Fq>(y3, u, v);  // m5
  fp_add<Fq>(u, t0, t1);
  fp_sub<Fq>(t3, t3, u);
  fp_add<Fq>(u, t1, t2);
  fp_sub<Fq>(t4, t4, u);
  fp_add<Fq>(u, t0, t2);
  fp_sub<Fq>(y3, y3, u);
  g1_add_tail(r, t0, t1, t2, t3, t4, y3);
}

// r = p + (x2, y2), complete mixed add (RCB16 Algorithm 8): the second
// point is affine and must not be the identity.  r may alias p.
FP_FN void g1_add_mixed(G1& r, const G1& p, const u32* x2, const u32* y2) {
  u32 t0[FQN], t1[FQN], t3[FQN], t4[FQN], y3[FQN], u[FQN], v[FQN];
  fp_mul<Fq>(t0, p.x, x2);
  fp_mul<Fq>(t1, p.y, y2);
  fp_add<Fq>(u, p.x, p.y);
  fp_add<Fq>(v, x2, y2);
  fp_mul<Fq>(t3, u, v);  // m3
  fp_mul<Fq>(t4, y2, p.z);  // m4
  fp_mul<Fq>(y3, x2, p.z);  // m5
  fp_add<Fq>(u, t0, t1);
  fp_sub<Fq>(t3, t3, u);
  fp_add<Fq>(t4, t4, p.y);
  fp_add<Fq>(y3, y3, p.x);
  // the tail reads its t2 (here Z1) before it writes r, so r may alias p
  g1_add_tail(r, t0, t1, p.z, t3, t4, y3);
}

// r = 2p, complete (RCB16 Algorithm 9).  r may alias p.
FP_FN void g1_double(G1& r, const G1& p) {
  u32 t0[FQN], t1[FQN], t2[FQN], txy[FQN], z3[FQN], t2b[FQN], y3[FQN], u[FQN];
  fp_mul<Fq>(t0, p.y, p.y);
  fp_mul<Fq>(t1, p.y, p.z);
  fp_mul<Fq>(t2, p.z, p.z);
  fp_mul<Fq>(txy, p.x, p.y);
  fp_add<Fq>(z3, t0, t0);
  fp_add<Fq>(z3, z3, z3);
  fp_add<Fq>(z3, z3, z3);  // 8 Y^2
  fp_mul3<Fq>(t2b, t2);
  fp_add<Fq>(y3, t0, t2b);
  fp_mul3<Fq>(u, t2b);     // t2t = 3 t2b
  fp_sub<Fq>(t0, t0, u);
  fp_mul<Fq>(u, t2b, z3);  // b1
  fp_mul<Fq>(r.z, t1, z3);  // b2
  fp_mul<Fq>(y3, t0, y3);  // b3
  fp_add<Fq>(r.y, u, y3);
  fp_mul<Fq>(u, t0, txy);  // b4
  fp_add<Fq>(r.x, u, u);
}

// ---------------------------------------------------------------------------
// Per-lane kernel bodies
// ---------------------------------------------------------------------------

// Montgomery product of lane `lane` of two (2N, m) limb arrays.
template <class F>
FP_FN void lane_mont_mul(const int* a, const int* b, int* out, long m, long lane) {
  u32 x[F::N], y[F::N];
  fp_load<F>(x, a, m, lane, 0);
  fp_load<F>(y, b, m, lane, 0);
  fp_mul_inline<F>(x, x, y);  // one product per thread: nothing to share
  fp_store<F>(out, m, lane, 0, x);
}

// out = a + b
FP_FN void lane_add2(const int* a, const int* b, int* out, long L, long lane) {
  G1 p, q;
  g1_load(p, a, L, lane);
  g1_load(q, b, L, lane);
  g1_add(p, p, q);
  g1_store(out, L, lane, p);
}

// out_acc = mask ? acc + base : acc;  out_base = 2 base.  The add always
// runs and the mask selects, as in the plain version: a warp pays for the
// add as soon as one of its lanes is masked in.
FP_FN void lane_step(const int* acc, const int* base, const int* mask,
                     int* out_acc, int* out_base, long L, long lane) {
  G1 a, b, s;
  g1_load(a, acc, L, lane);
  g1_load(b, base, L, lane);
  g1_add(s, a, b);
  g1_select(s, mask[lane] != 0, s, a);
  g1_store(out_acc, L, lane, s);
  g1_double(b, b);
  g1_store(out_base, L, lane, b);
}

// out_run = run + bl;  out_tot = tot + run (the old run)
FP_FN void lane_scan2b(const int* run, const int* tot, const int* bl,
                       int* out_run, int* out_tot, long L, long lane) {
  G1 r, o, s;
  g1_load(r, run, L, lane);
  g1_load(o, bl, L, lane);
  g1_add(s, r, o);
  g1_store(out_run, L, lane, s);
  g1_load(o, tot, L, lane);
  g1_add(s, o, r);
  g1_store(out_tot, L, lane, s);
}

// Is `bit` set in any lane of this warp?  The answer is the same for every
// thread of the warp, so a branch on it never splits the warp.  (On the CPU
// build a "warp" is the one lane.)
FP_FN bool any_lane(bool bit) {
#ifdef __CUDACC__
  return __any_sync(__activemask(), bit) != 0;
#else
  return bit;
#endif
}

// out = [s] P: LSB-first double-and-add over all 16 * nl scalar bits, acc
// and base in registers for the whole ladder.  scal is (nl, L) canonical
// 16-bit limbs.  A step adds then selects, as the plain version does; the
// add is skipped when no lane of the warp has the bit set, which changes no
// lane's result (the Horner combine's scalars 2^(c w) have one bit each).
FP_FN void lane_ladder(const int* pts, const int* scal, int* out, int nl, long L,
                       long lane) {
  G1 acc, base, s;
  g1_set_identity(acc);
  g1_load(base, pts, L, lane);
  FP_NO_UNROLL
  for (int k = 0; k < nl; k++) {
    u32 limb = (u32)scal[(long)k * L + lane];
    FP_NO_UNROLL
    for (int bit = 0; bit < 16; bit++) {
      bool set = ((limb >> bit) & 1u) != 0;
      if (any_lane(set)) {
        g1_add(s, acc, base);
        g1_select(acc, set, s, acc);
      }
      g1_double(base, base);
    }
  }
  g1_store(out, L, lane, acc);
}

// out[lane] = sum over t < count[lane] of table[src(start[lane] + t)], added
// in order onto the identity.  table is point-major, `(rows, 72)` int32;
// src(i) = idx[i] when idx != nullptr (the sorted-index table of the bucket
// phase), else i itself (consecutive rows: the segment reduce).  MIXED reads
// only X and Y of each row and runs the mixed add: the rows must be affine
// lifts (Z = R mod p) and never the identity.  A lane with count 0 returns
// the identity.
template <bool MIXED>
FP_FN void lane_bucket(const int* table, const int* idx, const int* start,
                       const int* count, int* out, long L, long lane) {
  G1 acc;
  g1_set_identity(acc);
  long pos = start[lane];
  int n = count[lane];
  FP_NO_UNROLL
  for (int t = 0; t < n; t++) {
    long src = idx ? (long)idx[pos + t] : pos + t;
    const int* row = table + src * G1_ROWS;
    if (MIXED) {
      u32 x2[FQN], y2[FQN];
      fp_load_row<Fq>(x2, row);
      fp_load_row<Fq>(y2, row + 24);
      g1_add_mixed(acc, acc, x2, y2);
    } else {
      G1 q;
      fp_load_row<Fq>(q.x, row);
      fp_load_row<Fq>(q.y, row + 24);
      fp_load_row<Fq>(q.z, row + 48);
      g1_add(acc, acc, q);
    }
  }
  g1_store(out, L, lane, acc);
}
