// The bodies of the fused sumcheck's kernels: a round (sumcheck_round.cu)
// and its tail (sumcheck_tail.cu), over Fr tables in device memory.
//
// A round's tables are one stack `(T, n, 16)` int32 (an Fr element's 16-bit
// limbs contiguous, Montgomery form).  Three kinds (testudo_tpu/core/
// sumcheck.py:62-114, `_round_evals_*`):
//   SC_QUAD       sum A B               tables A, B;         points 0, 2
//   SC_CUBIC_TAU  sum tau (A B - C)     tables tau, A, B, C; points 0, 2, 3
//   SC_CUBIC      sum A_i B_i C_i       for the instances i of the batched
//                 product layout: k_par instances sharing one C, then
//                 k_seq with their own, stacked as A_par (k_par), B_par
//                 (k_par), C, A_seq (k_seq), B_seq (k_seq), C_seq (k_seq);
//                 `prove_cubic` is k_par = 1, k_seq = 0.
// A round may first fold every table by the previous round's challenge r
// (dense.bound_top: Z'[i] = Z[i] + r (Z[i + n/2] - Z[i])): then the thread of
// pair p reads rows p, p + n/4, p + n/2, p + 3n/4 of a table, writes the two
// folded rows p and p + n/4 of the half-size table, and those two are the
// (lo, hi) of its pair in the round's evaluation.  Sources and destinations
// are separate stacks, so the instances of the batched layout read their
// shared C while instance 0 writes its fold.  A fold of 2-row tables (the
// last challenge) writes the final row and evaluates nothing.  Every sum is
// exact (canonical modular additions); a block writes one partial sum per
// instance and point.
//
// The tail, one warp: sums the partials, combines the instances by the
// random-linear coefficients, forms the round polynomial's coefficients
// (UniPoly.from_evals), absorbs them into the Poseidon sponge (Fr or Fq:
// an Fr value re-read as an Fq integer), squeezes the challenge (on an Fq
// sponge the low 252 bits of the canonical value), and evaluates the next
// claim by Horner.  The sponge's mode and index come in as arguments: the
// caller replays the mode machine (core/sumcheck.py `_simulate_schedule`).
//
// The file also compiles as plain C++: csrc/host_check.cpp runs the pair
// body over a plain loop of "threads" and blocks and the tail's machine on
// one thread (`HostSponge`).
#pragma once
#include "poseidon.cuh"

#define SC_TPB 128       // threads of a round block
#define SC_MAX_BLOCKS 528  // most blocks of a round (4 a multiprocessor of an H100)
#define SC_QUAD 0
#define SC_CUBIC_TAU 1
#define SC_CUBIC 2
#define FRN 8      // 32-bit words of an Fr element
#define FR_ROW 16  // int32 limbs of an Fr row in device memory

typedef FrParams Fr;

template <int KIND>
struct ScKind {
  static constexpr int NT = KIND == SC_QUAD ? 2 : KIND == SC_CUBIC_TAU ? 4 : 3;  // tables
  static constexpr int NPTS = KIND == SC_QUAD ? 2 : 3;  // evaluation points
};

// Pairs a round block's threads take: n / 2 without a fold, n / 4 with one;
// the last fold (n = 2) is one "pair", row 0.
FP_FN long sc_pairs(long n, bool fold) { return fold ? (n == 2 ? 1 : n / 4) : n / 2; }

// The stack indexes of instance `inst`'s tables, and which of them its
// blocks write the fold of (a shared C: instance 0).
template <int KIND>
FP_FN void sc_tables(int* tab, bool* own, int inst, int kp, int ks) {
  if (KIND != SC_CUBIC) {
    for (int j = 0; j < ScKind<KIND>::NT; j++) {
      tab[j] = j;
      own[j] = true;
    }
  } else if (inst < kp) {
    tab[0] = inst, tab[1] = kp + inst, tab[2] = 2 * kp;
    own[0] = own[1] = true, own[2] = inst == 0;
  } else {
    const int j = inst - kp, base = 2 * kp + 1;
    tab[0] = base + j, tab[1] = base + ks + j, tab[2] = base + 2 * ks + j;
    own[0] = own[1] = own[2] = true;
  }
}

// (lo, hi) of table t at pair p.  With `fold`, the source tables have n
// rows: lo and hi are the folded rows p and p + h of the n/2-row result
// (h = n/4), stored to dst when `store`; without, rows p and p + n/2.
FP_FN void sc_line(u32* lo, u32* hi, const int* src, int* dst, const u32* r, long n, long p, int t,
                   bool fold, bool store) {
  const int* tab = src + (long)t * n * FR_ROW;
  if (!fold) {
    fp_load_row<Fr>(lo, tab + p * FR_ROW);
    fp_load_row<Fr>(hi, tab + (p + n / 2) * FR_ROW);
    return;
  }
  const long s = n / 2, h = s / 2;
  u32 a[FRN], b[FRN];
  fp_load_row<Fr>(a, tab + p * FR_ROW);
  fp_load_row<Fr>(b, tab + (p + s) * FR_ROW);
  fp_sub<Fr>(b, b, a);
  fp_mul_inline<Fr>(b, b, r);
  fp_add<Fr>(lo, a, b);
  fp_load_row<Fr>(a, tab + (p + h) * FR_ROW);
  fp_load_row<Fr>(b, tab + (p + h + s) * FR_ROW);
  fp_sub<Fr>(b, b, a);
  fp_mul_inline<Fr>(b, b, r);
  fp_add<Fr>(hi, a, b);
  if (store) {
    int* d = dst + (long)t * s * FR_ROW;
    fp_store_row<Fr>(d + p * FR_ROW, lo);
    fp_store_row<Fr>(d + (p + h) * FR_ROW, hi);
  }
}

// The kind's combination of one instance's table values x at a point.
template <int KIND>
FP_FN void sc_comb(u32* out, u32 (*x)[FRN]) {
  u32 t[FRN];
  if (KIND == SC_QUAD) {
    fp_mul_inline<Fr>(out, x[0], x[1]);
  } else if (KIND == SC_CUBIC_TAU) {
    fp_mul_inline<Fr>(t, x[1], x[2]);
    fp_sub<Fr>(t, t, x[3]);
    fp_mul_inline<Fr>(out, x[0], t);
  } else {
    fp_mul_inline<Fr>(t, x[0], x[1]);
    fp_mul_inline<Fr>(out, t, x[2]);
  }
}

// One pair of one instance: the fold (with `fold`), then, with `eval`, the
// combination at X = 0 (lo), 2 (2 hi - lo) and 3 (3 hi - 2 lo) added into acc.
template <int KIND>
FP_FN void sc_pair(u32 (*acc)[FRN], const int* src, int* dst, const u32* r, long n, long p,
                   int inst, int kp, int ks, bool fold, bool eval) {
  constexpr int NT = ScKind<KIND>::NT;
  int tab[NT];
  bool own[NT];
  sc_tables<KIND>(tab, own, inst, kp, ks);
  u32 lo[NT][FRN], hi[NT][FRN], v[FRN];
  FP_UNROLL
  for (int j = 0; j < NT; j++) sc_line(lo[j], hi[j], src, dst, r, n, p, tab[j], fold, own[j]);
  if (KIND == SC_CUBIC && fold && kp == 0 && inst == 0) {  // a shared C that no instance reads
    u32 w[FRN];
    sc_line(v, w, src, dst, r, n, p, 0, true, true);
  }
  if (!eval) return;
  sc_comb<KIND>(v, lo);
  fp_add<Fr>(acc[0], acc[0], v);
  FP_UNROLL
  for (int j = 0; j < NT; j++) {
    fp_sub<Fr>(hi[j], hi[j], lo[j]);  // the line's slope
    fp_add<Fr>(lo[j], lo[j], hi[j]);
    fp_add<Fr>(lo[j], lo[j], hi[j]);  // X = 2
  }
  sc_comb<KIND>(v, lo);
  fp_add<Fr>(acc[1], acc[1], v);
  if (ScKind<KIND>::NPTS == 3) {
    FP_UNROLL
    for (int j = 0; j < NT; j++) fp_add<Fr>(lo[j], lo[j], hi[j]);  // X = 3
    sc_comb<KIND>(v, lo);
    fp_add<Fr>(acc[2], acc[2], v);
  }
}

// The round polynomial's coefficients from e0 = ev[0], e1 = e - e0, e2 =
// ev[1] (and e3 = ev[2]): c, b, a of a quadratic, d, c, b, a of a cubic
// (UniPoly.from_evals; the same field elements in any order of operations).
template <int NPTS>
FP_FN void sc_coeffs(u32 (*c)[FRN], const u32 (*ev)[FRN], const u32* e) {
  u32 e1[FRN], t[FRN], u[FRN];
  fp_sub<Fr>(e1, e, ev[0]);
  if (NPTS == 2) {  // c = e0, a = (e2 - 2 e1 + e0) / 2, b = e1 - e0 - a
    fp_copy<Fr>(c[0], ev[0]);
    fp_sub<Fr>(t, ev[1], e1);
    fp_add<Fr>(t, t, ev[0]);
    fp_sub<Fr>(t, t, e1);
    fp_mul_inline<Fr>(c[2], t, FR_TWO_INV);
    fp_sub<Fr>(t, e1, ev[0]);
    fp_sub<Fr>(c[1], t, c[2]);
    return;
  }
  const u32 *e0 = ev[0], *e2 = ev[1], *e3 = ev[2];
  u32 e1x3[FRN], e2x3[FRN];
  fp_add<Fr>(e1x3, e1, e1);
  fp_add<Fr>(e1x3, e1x3, e1);
  fp_add<Fr>(e2x3, e2, e2);
  fp_add<Fr>(e2x3, e2x3, e2);
  fp_copy<Fr>(c[0], e0);  // d
  // a = (3 e1 + e3 - 3 e2 - e0) / 6
  fp_add<Fr>(t, e1x3, e3);
  fp_add<Fr>(u, e2x3, e0);
  fp_sub<Fr>(t, t, u);
  fp_mul_inline<Fr>(c[3], t, FR_SIX_INV);
  // b = (2 e0 + 4 e2 - 5 e1 - e3) / 2
  fp_add<Fr>(t, e0, e0);
  fp_add<Fr>(t, t, e2x3);
  fp_add<Fr>(t, t, e2);
  fp_add<Fr>(u, e1x3, e1);
  fp_add<Fr>(u, u, e1);
  fp_add<Fr>(u, u, e3);
  fp_sub<Fr>(t, t, u);
  fp_mul_inline<Fr>(c[2], t, FR_TWO_INV);
  // c = e1 - d - a - b
  fp_sub<Fr>(t, e1, e0);
  fp_sub<Fr>(t, t, c[3]);
  fp_sub<Fr>(c[1], t, c[2]);
}

// acc = c[0] + r (c[1] + r (... c[NC-1])): the next round's claim.
template <int NC>
FP_FN void sc_horner(u32* acc, const u32 (*c)[FRN], const u32* r) {
  fp_copy<Fr>(acc, c[NC - 1]);
  FP_UNROLL
  for (int j = NC - 2; j >= 0; j--) {
    fp_mul_inline<Fr>(acc, acc, r);
    fp_add<Fr>(acc, acc, c[j]);
  }
}

// An Fr value as an element of the sponge's field S: itself, or (Fq) the
// same canonical integer in Montgomery Fq (the cross-field absorb rule).
template <class S>
FP_FN void sc_to_sponge(u32* w, const u32* v) {
  if constexpr (S::N == FRN) {
    fp_copy<Fr>(w, v);
  } else {
    u32 one[FRN] = {1}, canon[FRN], ext[S::N] = {0};
    fp_mul_inline<Fr>(canon, v, one);
    FP_UNROLL
    for (int i = 0; i < FRN; i++) ext[i] = canon[i];
    fp_mul_inline<S>(w, ext, FQ_R2);
  }
}

// A squeezed element of S as the Fr challenge: itself, or (Fq) the low 252
// bits of its canonical value, in Montgomery Fr.
template <class S>
FP_FN void sc_from_sponge(u32* r, const u32* v) {
  if constexpr (S::N == FRN) {
    fp_copy<Fr>(r, v);
  } else {
    u32 one[S::N] = {1}, canon[S::N];
    fp_mul_inline<S>(canon, v, one);
    canon[FRN - 1] &= 0x0fffffffu;  // bits 224-251 of the 252 kept
    fp_mul_inline<Fr>(r, canon, FR_R2);
  }
}

// The sponge of one thread (the host build): the three elements in an array.
template <class S>
struct HostSponge {
  u32 s[POS_T][S::N];
  FP_MEMBER void permute() { pos_permute_host<S>(s); }
  FP_MEMBER void add(int j, const u32* w) { fp_add<S>(s[j], s[j], w); }
  FP_MEMBER void get(int j, u32* out) const { fp_copy<S>(out, s[j]); }
};

// The transcript of one round: append_scalar of each of the NC
// coefficients, then challenge_scalar, from the sponge's (mode, index)
// (poseidon/sponge.py: an absorb after a squeeze, or at a full rate,
// permutes first; so does a squeeze after an absorb).
template <class S, int NC, class Sponge>
FP_FN void sc_transcript(Sponge& sp, const u32 (*c)[FRN], int mode, int index, u32* r) {
  u32 w[S::N];
  FP_NO_UNROLL
  for (int j = 0; j < NC; j++) {
    if (mode == 1 || index == POS_RATE) {
      sp.permute();
      index = 0;
    }
    mode = 0;
    sc_to_sponge<S>(w, c[j]);
    sp.add(POS_CAPACITY + index, w);
    index++;
  }
  if (mode == 0 || index == POS_RATE) {
    sp.permute();
    index = 0;
  }
  sp.get(POS_CAPACITY + index, w);
  sc_from_sponge<S>(r, w);
}

// The tail after the sums: coefficients c, challenge r and next claim e
// (in place) from the combined evaluations ev.
template <class S, int NPTS, class Sponge>
FP_FN void sc_tail_round(Sponge& sp, u32 (*c)[FRN], u32* r, u32* e, const u32 (*ev)[FRN], int mode,
                         int index) {
  sc_coeffs<NPTS>(c, ev, e);
  sc_transcript<S, NPTS + 1>(sp, c, mode, index, r);
  sc_horner<NPTS + 1>(e, c, r);
}

#ifdef __CUDACC__
// Butterfly sum over the 32 lanes of a warp: every lane ends with the total.
template <class F>
__device__ __forceinline__ void warp_sum(u32* x) {
  FP_UNROLL
  for (int off = 16; off > 0; off >>= 1) {
    u32 o[F::N];
    FP_UNROLL
    for (int w = 0; w < F::N; w++) o[w] = __shfl_xor_sync(0xffffffffu, x[w], off);
    fp_add<F>(x, x, o);
  }
}

// The sponge of one warp: lane l holds element l % 3 (pos_permute_warp).
template <class S>
struct WarpSponge {
  u32 x[S::N];
  u32* sh;
  int lane;
  __device__ __forceinline__ void permute() { pos_permute_warp<S>(x, sh, lane); }
  __device__ __forceinline__ void add(int j, const u32* w) {
    u32 t[S::N];
    fp_add<S>(t, x, w);
    fp_select<S>(x, lane % POS_T == j, t, x);
  }
  __device__ __forceinline__ void get(int j, u32* out) const {
    FP_UNROLL
    for (int w = 0; w < S::N; w++) out[w] = __shfl_sync(0xffffffffu, x[w], j);
  }
};
#endif
