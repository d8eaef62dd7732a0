// BLS12-377 group law for the Hopper kernels, once for both groups, and the
// per-lane bodies of the packed EC kernels.
//
// Replaces the fused EC kernel bodies of testudo_tpu/tpu/pallas_curve.py
// (:391-584, ops "add_mask", "add2", "step", "scan2", "scan2b", "bucket",
// "bucket_mixed", and the ladder of :733-749), which trace tpu/curve.py's
// staged RCB16 formulas over lazily reduced limb rows, for `ncomp = 1` (G1
// over Fq) and `ncomp = 2` (G2 over Fq2).  The formulas here are the same
// three (Renes-Costello-Batina 2016, a = 0: Algorithm 7 complete add,
// Algorithm 8 complete mixed add, Algorithm 9 complete double) on strictly
// reduced values, so every coordinate written is canonical and equals, limb
// for limb, what the JAX package writes.
//
// The formulas are templates over a coordinate-field policy C (`FqCoord`:
// one Fq element, b3 = 3; `Fq2Coord`: an Fq2 element, b3 = 3/u), as
// tpu/curve.py writes them once over an ops namespace.  A point is three
// coordinates in a thread's registers (and, for G2, local memory: two
// points and the temporaries of an add exceed 255 registers).  In device
// memory a batch is `(C::ROWS, L)` int32: coordinate-major, component-major
// within a coordinate, 24 rows of 16-bit limbs per component, batch along
// L: 72 rows for G1, 144 for G2.
//
// Each `lane_*` function is the whole work of one thread of one kernel; the
// `__global__` functions in the .cu files only compute the lane index.  The
// same functions compile as plain C++ for csrc/host_check.cpp.
#pragma once
#include "fp2.cuh"

// ---------------------------------------------------------------------------
// Coordinate-field policies
// ---------------------------------------------------------------------------

struct FqCoord {
  struct E {
    u32 v[FQN];
  };
  static constexpr int COMP_ROWS = 2 * FQN;  // limb rows of one coordinate
  static constexpr int ROWS = 3 * COMP_ROWS;
  FP_MEMBER static void zero(E& r) { fp_zero<Fq>(r.v); }
  FP_MEMBER static void one(E& r) { fp_copy<Fq>(r.v, FQ_ONE); }
  FP_MEMBER static void select(E& r, bool c, const E& a, const E& b) {
    fp_select<Fq>(r.v, c, a.v, b.v);
  }
  FP_MEMBER static void add(E& r, const E& a, const E& b) { fp_add<Fq>(r.v, a.v, b.v); }
  FP_MEMBER static void sub(E& r, const E& a, const E& b) { fp_sub<Fq>(r.v, a.v, b.v); }
  FP_MEMBER static void mul(E& r, const E& a, const E& b) { fp_mul<Fq>(r.v, a.v, b.v); }
  FP_MEMBER static void mul3(E& r, const E& a) { fp_mul3<Fq>(r.v, a.v); }
  FP_MEMBER static void mul_b3(E& r, const E& a) { fp_mul3<Fq>(r.v, a.v); }  // b3 = 3
  FP_MEMBER static void load(E& r, const int* base, long L, long lane, int row0) {
    fp_load<Fq>(r.v, base, L, lane, row0);
  }
  FP_MEMBER static void store(int* base, long L, long lane, int row0, const E& a) {
    fp_store<Fq>(base, L, lane, row0, a.v);
  }
  FP_MEMBER static void load_row(E& r, const int* row) { fp_load_row<Fq>(r.v, row); }
};

struct Fq2Coord {
  typedef Fq2 E;
  static constexpr int COMP_ROWS = 4 * FQN;
  static constexpr int ROWS = 3 * COMP_ROWS;
  FP_MEMBER static void zero(E& r) { fp2_zero(r); }
  FP_MEMBER static void one(E& r) { fp2_one(r); }
  FP_MEMBER static void select(E& r, bool c, const E& a, const E& b) {
    fp2_select(r, c, a, b);
  }
  FP_MEMBER static void add(E& r, const E& a, const E& b) { fp2_add(r, a, b); }
  FP_MEMBER static void sub(E& r, const E& a, const E& b) { fp2_sub(r, a, b); }
  FP_MEMBER static void mul(E& r, const E& a, const E& b) { fp2_mul(r, a, b); }
  FP_MEMBER static void mul3(E& r, const E& a) { fp2_mul3(r, a); }
  FP_MEMBER static void mul_b3(E& r, const E& a) { fp2_mul_b3(r, a); }
  FP_MEMBER static void load(E& r, const int* base, long L, long lane, int row0) {
    fp2_load(r, base, L, lane, row0);
  }
  FP_MEMBER static void store(int* base, long L, long lane, int row0, const E& a) {
    fp2_store(base, L, lane, row0, a);
  }
  FP_MEMBER static void load_row(E& r, const int* row) { fp2_load_row(r, row); }
};

// ---------------------------------------------------------------------------
// Points and the three formulas
// ---------------------------------------------------------------------------

template <class C>
struct Pt {
  typename C::E x, y, z;
};

template <class C>
FP_FN void ec_set_identity(Pt<C>& r) {
  C::zero(r.x);
  C::one(r.y);
  C::zero(r.z);
}

template <class C>
FP_FN void ec_load(Pt<C>& r, const int* base, long L, long lane) {
  C::load(r.x, base, L, lane, 0);
  C::load(r.y, base, L, lane, C::COMP_ROWS);
  C::load(r.z, base, L, lane, 2 * C::COMP_ROWS);
}

template <class C>
FP_FN void ec_store(int* base, long L, long lane, const Pt<C>& a) {
  C::store(base, L, lane, 0, a.x);
  C::store(base, L, lane, C::COMP_ROWS, a.y);
  C::store(base, L, lane, 2 * C::COMP_ROWS, a.z);
}

template <class C>
FP_FN void ec_select(Pt<C>& r, bool c, const Pt<C>& a, const Pt<C>& b) {
  C::select(r.x, c, a.x, b.x);
  C::select(r.y, c, a.y, b.y);
  C::select(r.z, c, a.z, b.z);
}

// Shared tail of Algorithms 7 and 8: from t0 = X1X2, t1 = Y1Y2, t2 (Z1Z2 or
// Z1), t3, t4 and Y3 as staged in tpu/curve.py:199-213.
template <class C>
FP_FN void ec_add_tail(Pt<C>& r, typename C::E& t0, typename C::E& t1,
                       const typename C::E& t2, const typename C::E& t3,
                       const typename C::E& t4, const typename C::E& y3) {
  typename C::E x3, t2b, y3b, z3, a, b;
  C::add(x3, t0, t0);
  C::add(t0, x3, t0);  // 3 X1X2
  C::mul_b3(t2b, t2);
  C::mul_b3(y3b, y3);
  C::add(z3, t1, t2b);
  C::sub(t1, t1, t2b);
  C::mul(a, t4, y3b);  // a1
  C::mul(b, t3, t1);   // a2
  C::sub(r.x, b, a);
  C::mul(a, y3b, t0);  // a3
  C::mul(b, t1, z3);   // a4
  C::add(r.y, b, a);
  C::mul(a, t0, t3);   // a5
  C::mul(b, z3, t4);   // a6
  C::add(r.z, b, a);
}

// r = p + q, complete (RCB16 Algorithm 7).  r may alias p or q.
template <class C>
FP_FN void ec_add(Pt<C>& r, const Pt<C>& p, const Pt<C>& q) {
  typename C::E t0, t1, t2, t3, t4, y3, u, v;
  C::mul(t0, p.x, q.x);
  C::mul(t1, p.y, q.y);
  C::mul(t2, p.z, q.z);
  C::add(u, p.x, p.y);
  C::add(v, q.x, q.y);
  C::mul(t3, u, v);  // m3
  C::add(u, p.y, p.z);
  C::add(v, q.y, q.z);
  C::mul(t4, u, v);  // m4
  C::add(u, p.x, p.z);
  C::add(v, q.x, q.z);
  C::mul(y3, u, v);  // m5
  C::add(u, t0, t1);
  C::sub(t3, t3, u);
  C::add(u, t1, t2);
  C::sub(t4, t4, u);
  C::add(u, t0, t2);
  C::sub(y3, y3, u);
  ec_add_tail<C>(r, t0, t1, t2, t3, t4, y3);
}

// r = p + (x2, y2), complete mixed add (RCB16 Algorithm 8): the second
// point is affine and must not be the identity.  r may alias p.
template <class C>
FP_FN void ec_add_mixed(Pt<C>& r, const Pt<C>& p, const typename C::E& x2,
                        const typename C::E& y2) {
  typename C::E t0, t1, t3, t4, y3, u, v;
  C::mul(t0, p.x, x2);
  C::mul(t1, p.y, y2);
  C::add(u, p.x, p.y);
  C::add(v, x2, y2);
  C::mul(t3, u, v);      // m3
  C::mul(t4, y2, p.z);  // m4
  C::mul(y3, x2, p.z);  // m5
  C::add(u, t0, t1);
  C::sub(t3, t3, u);
  C::add(t4, t4, p.y);
  C::add(y3, y3, p.x);
  // the tail reads its t2 (here Z1) before it writes r, so r may alias p
  ec_add_tail<C>(r, t0, t1, p.z, t3, t4, y3);
}

// r = 2p, complete (RCB16 Algorithm 9).  r may alias p.
template <class C>
FP_FN void ec_double(Pt<C>& r, const Pt<C>& p) {
  typename C::E t0, t1, t2, txy, z3, t2b, y3, u;
  C::mul(t0, p.y, p.y);
  C::mul(t1, p.y, p.z);
  C::mul(t2, p.z, p.z);
  C::mul(txy, p.x, p.y);
  C::add(z3, t0, t0);
  C::add(z3, z3, z3);
  C::add(z3, z3, z3);  // 8 Y^2
  C::mul_b3(t2b, t2);
  C::add(y3, t0, t2b);
  C::mul3(u, t2b);  // t2t = 3 t2b
  C::sub(t0, t0, u);
  C::mul(u, t2b, z3);   // b1
  C::mul(r.z, t1, z3);  // b2
  C::mul(y3, t0, y3);   // b3
  C::add(r.y, u, y3);
  C::mul(u, t0, txy);  // b4
  C::add(r.x, u, u);
}

// ---------------------------------------------------------------------------
// Per-lane kernel bodies
// ---------------------------------------------------------------------------

// out = a + b
template <class C>
FP_FN void lane_add2(const int* a, const int* b, int* out, long L, long lane) {
  Pt<C> p, q;
  ec_load<C>(p, a, L, lane);
  ec_load<C>(q, b, L, lane);
  ec_add<C>(p, p, q);
  ec_store<C>(out, L, lane, p);
}

// out = mask ? acc + pts : acc.  `pts` is a batch of L points, or ONE point
// (a single column, `shared`) that every lane adds: the fixed-base ladder's
// table column.  The add always runs and the mask selects.
template <class C>
FP_FN void lane_add_mask(const int* acc, const int* pts, const int* mask, int* out,
                         long L, bool shared, long lane) {
  Pt<C> a, b, s;
  ec_load<C>(a, acc, L, lane);
  ec_load<C>(b, pts, shared ? 1 : L, shared ? 0 : lane);
  ec_add<C>(s, a, b);
  ec_select<C>(s, mask[lane] != 0, s, a);
  ec_store<C>(out, L, lane, s);
}

// out_acc = mask ? acc + base : acc;  out_base = 2 base.  The add always
// runs and the mask selects, as in the plain version: a warp pays for the
// add as soon as one of its lanes is masked in.
template <class C>
FP_FN void lane_step(const int* acc, const int* base, const int* mask,
                     int* out_acc, int* out_base, long L, long lane) {
  Pt<C> a, b, s;
  ec_load<C>(a, acc, L, lane);
  ec_load<C>(b, base, L, lane);
  ec_add<C>(s, a, b);
  ec_select<C>(s, mask[lane] != 0, s, a);
  ec_store<C>(out_acc, L, lane, s);
  ec_double<C>(b, b);
  ec_store<C>(out_base, L, lane, b);
}

// out_run = run + bl;  out_tot = tot + out_run (the new run: two dependent adds)
template <class C>
FP_FN void lane_scan2(const int* run, const int* tot, const int* bl,
                      int* out_run, int* out_tot, long L, long lane) {
  Pt<C> r, o;
  ec_load<C>(r, run, L, lane);
  ec_load<C>(o, bl, L, lane);
  ec_add<C>(r, r, o);
  ec_store<C>(out_run, L, lane, r);
  ec_load<C>(o, tot, L, lane);
  ec_add<C>(o, o, r);
  ec_store<C>(out_tot, L, lane, o);
}

// out_run = run + bl;  out_tot = tot + run (the old run)
template <class C>
FP_FN void lane_scan2b(const int* run, const int* tot, const int* bl,
                       int* out_run, int* out_tot, long L, long lane) {
  Pt<C> r, o, s;
  ec_load<C>(r, run, L, lane);
  ec_load<C>(o, bl, L, lane);
  ec_add<C>(s, r, o);
  ec_store<C>(out_run, L, lane, s);
  ec_load<C>(o, tot, L, lane);
  ec_add<C>(s, o, r);
  ec_store<C>(out_tot, L, lane, s);
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
// and base held by the thread for the whole ladder.  scal is (nl, L)
// canonical 16-bit limbs.  A step adds then selects, as the plain version
// does; the add is skipped when no lane of the warp has the bit set, which
// changes no lane's result (the Horner combine's scalars 2^(c w) have one
// bit each).
template <class C>
FP_FN void lane_ladder(const int* pts, const int* scal, int* out, int nl, long L,
                       long lane) {
  Pt<C> acc, base, s;
  ec_set_identity<C>(acc);
  ec_load<C>(base, pts, L, lane);
  FP_NO_UNROLL
  for (int k = 0; k < nl; k++) {
    u32 limb = (u32)scal[(long)k * L + lane];
    FP_NO_UNROLL
    for (int bit = 0; bit < 16; bit++) {
      bool set = ((limb >> bit) & 1u) != 0;
      if (any_lane(set)) {
        ec_add<C>(s, acc, base);
        ec_select<C>(acc, set, s, acc);
      }
      ec_double<C>(base, base);
    }
  }
  ec_store<C>(out, L, lane, acc);
}

// out[lane] = sum over t < count[lane] of table[src(start[lane] + t)], added
// in order onto the identity.  table is point-major, `(rows, C::ROWS)` int32;
// src(i) = idx[i] when idx != nullptr (the sorted-index table of the bucket
// phase), else i itself (consecutive rows: the segment reduce).  MIXED reads
// only X and Y of each row and runs the mixed add: the rows must be affine
// lifts (Z = R mod p) and never the identity.  A lane with count 0 returns
// the identity.
template <class C, bool MIXED>
FP_FN void lane_bucket(const int* table, const int* idx, const int* start,
                       const int* count, int* out, long L, long lane) {
  Pt<C> acc;
  ec_set_identity<C>(acc);
  long pos = start[lane];
  int n = count[lane];
  FP_NO_UNROLL
  for (int t = 0; t < n; t++) {
    long src = idx ? (long)idx[pos + t] : pos + t;
    const int* row = table + src * C::ROWS;
    if (MIXED) {
      typename C::E x2, y2;
      C::load_row(x2, row);
      C::load_row(y2, row + C::COMP_ROWS);
      ec_add_mixed<C>(acc, acc, x2, y2);
    } else {
      Pt<C> q;
      C::load_row(q.x, row);
      C::load_row(q.y, row + C::COMP_ROWS);
      C::load_row(q.z, row + 2 * C::COMP_ROWS);
      ec_add<C>(acc, acc, q);
    }
  }
  ec_store<C>(out, L, lane, acc);
}
