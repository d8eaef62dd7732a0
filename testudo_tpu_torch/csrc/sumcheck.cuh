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
// (dense.bound_top: Z'[i] = Z[i] + r (Z[i + n/2] - Z[i])): a pair p then
// reads rows p, p + n/4, p + n/2, p + 3n/4 of a table, gives the two folded
// rows p and p + n/4 of the half-size table, and those two are the (lo, hi)
// of its pair in the round's evaluation.  Sources and destinations are
// separate stacks, so the instances of the batched layout read their shared
// C while instance 0 writes its fold.  A fold of 2-row tables (the last
// challenge) writes the final row and evaluates nothing.  Every sum is exact
// (canonical modular additions); a block writes one partial sum per instance
// and point.
//
// Two forms of a round (sumcheck_round.cu picks one by shape):
//   - tiled (every round with a fold, and small ones without): a block
//     works a tile of pairs at a time (ScTile, small or large tiles); a
//     thread a (table, pair) reads its rows straight from device memory and
//     folds both halves (two independent products), the folded rows go
//     through shared memory (in mont_rm.cuh's swizzled slots) to a thread a
//     (pair, point) that forms the combination, so that a thread's chain is
//     one fold product and one or two combination products (`sc_load`,
//     `sc_comb_item`, a barrier after each);
//   - straight (rounds without a fold from SC_STRAIGHT_MIN_PAIRS pairs): a
//     thread a pair reads its rows and adds the combination at every point
//     (`sc_pair_straight`), with no barrier between warps.
//
// The tail, one warp: sums the partials, combines the instances by the
// random-linear coefficients, forms the round polynomial's coefficients
// (UniPoly.from_evals), absorbs them into the Poseidon sponge (Fr or Fq:
// an Fr value re-read as an Fq integer), squeezes the challenge (on an Fq
// sponge the low 252 bits of the canonical value), and evaluates the next
// claim by Horner.  The sponge's mode and index come in as arguments: the
// caller replays the mode machine (core/sumcheck.py `_simulate_schedule`).
//
// The file also compiles as plain C++: csrc/host_check.cpp runs each form
// of the round over a plain loop of "threads", block after block, and the
// tail's machine on one thread (`HostSponge`).
#pragma once
#include "mont_rm.cuh"
#include "poseidon.cuh"

#define SC_QUAD 0
#define SC_CUBIC_TAU 1
#define SC_CUBIC 2
#define FRN 8      // 32-bit words of an Fr element
#define FR_ROW 16  // int32 limbs of an Fr row in device memory
// Pairs of a tile (P), a block having NT P threads: small tiles (64 pairs
// for quad, 32 for the others) for rounds that need at most SC_SMALL_GRID
// of them (a block's chain is shorter), large tiles (SC_P pairs, 64 for
// quad) above.  A tiled round's grid is at most SC_SMALL_GRID blocks or one
// block for SC_PAIRS_A_BLOCK pairs, whichever is more: the tail sums the
// partials 32 a lane step, so it gets no more steps than from one thread a
// pair at 128 threads a block.
#define SC_P 128
#define SC_SMALL_GRID 32
#define SC_PAIRS_A_BLOCK 128
// Rounds without a fold and with this many pairs or more take the straight
// form (tools/exp_sumcheck_round.py times every form at every shape).
#define SC_STRAIGHT_MIN_PAIRS (1L << 15)
#define SC_TILED_LARGE 0  // the forms of a round (sc_form)
#define SC_TILED_SMALL 1
#define SC_STRAIGHT 2

// Helpers the launcher calls on the host as well.
#ifdef __CUDACC__
#define SC_HD __host__ __device__ __forceinline__
#else
#define SC_HD static inline
#endif

typedef FrParams Fr;

template <int KIND>
struct ScKind {
  static constexpr int NT = KIND == SC_QUAD ? 2 : KIND == SC_CUBIC_TAU ? 4 : 3;  // tables
  static constexpr int NPTS = KIND == SC_QUAD ? 2 : 3;  // evaluation points
  static constexpr int P_LARGE = KIND == SC_QUAD ? 64 : SC_P;
  static constexpr int P_SMALL = KIND == SC_QUAD ? 64 : 32;
};

// A tile: with a fold, P pairs (their rows p0 + i, + n/4, + n/2, + 3n/4 of
// each table); without, 2P pairs (rows p0 + i and + n/2).  Shared memory
// holds a region of 4P rows a table (REGION 16-byte chunks), and the lo and
// hi rows of the tile's pair i are its rows i and PT + i (PT the tile's
// pairs).  A thread a (table, i < P).
template <int KIND, int P>
struct ScTile {
  static constexpr int NT = ScKind<KIND>::NT;
  static constexpr int NPTS = ScKind<KIND>::NPTS;
  static constexpr int TPB = NT * P;
  static constexpr int REGION = 16 * P;
  static constexpr int SMEM = NT * REGION * 16;  // bytes of a block's regions
  static_assert(P % 32 == 0, "a warp's threads share one table and one point");
};

// Pairs of a round block's threads take: n / 2 without a fold, n / 4 with
// one; the last fold (n = 2) is one "pair", row 0.
SC_HD long sc_pairs(long n, bool fold) { return fold ? (n == 2 ? 1 : n / 4) : n / 2; }

// Pairs of a tile.
SC_HD int sc_tile_pairs(int P, bool fold) { return fold ? P : 2 * P; }

// Tiles of P pairs a round needs.
SC_HD long sc_tiles(int P, long n, bool fold) {
  return (sc_pairs(n, fold) + sc_tile_pairs(P, fold) - 1) / sc_tile_pairs(P, fold);
}

// Threads of a straight block: a block covers at least 128 pairs, and the
// card keeps no more than 4 an SM resident (quad's body is small).
template <int KIND>
SC_HD constexpr int sc_straight_tpb() {
  return KIND == SC_QUAD ? 256 : 128;
}

// The form a round takes (the SC_TILED_* and SC_STRAIGHT above).
template <int KIND>
SC_HD int sc_form(long n, bool fold) {
  if (!fold && sc_pairs(n, fold) >= SC_STRAIGHT_MIN_PAIRS) return SC_STRAIGHT;
  return sc_tiles(ScKind<KIND>::P_SMALL, n, fold) <= SC_SMALL_GRID ? SC_TILED_SMALL
                                                                   : SC_TILED_LARGE;
}

// Combination threads a point (a multiple of 32): the tile's pairs, or as
// many as the block has for each point; a thread then takes PT / TC pairs
// (one or two).
template <int KIND, int TPB>
FP_FN int sc_comb_threads(int PT) {
  constexpr int most = TPB / ScKind<KIND>::NPTS / 32 * 32;
  return PT < most ? PT : most;
}

// Instances of a layout.
template <int KIND>
SC_HD int sc_instances(int kp, int ks) { return KIND == SC_CUBIC ? kp + ks : 1; }

// Block rows (grid y) of a round: one an instance, and with a fold of the
// batched layout without par instances one more, which folds the shared C
// that no instance reads.
template <int KIND>
SC_HD int sc_rows(int kp, int ks, bool fold) {
  return sc_instances<KIND>(kp, ks) + (KIND == SC_CUBIC && kp == 0 && fold ? 1 : 0);
}

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

// What the blocks of row y read, fold and sum: its first nt tables (stack
// indexes tab, folds stored where own) and, with eval, the sums.
struct ScRow {
  int tab[4];
  bool own[4];
  int nt;
  bool eval;
};

template <int KIND>
FP_FN ScRow sc_row(int y, int kp, int ks, long n, bool fold) {
  ScRow row = {{0, 0, 0, 0}, {false, false, false, false}, 1, false};
  if (y < sc_instances<KIND>(kp, ks)) {
    sc_tables<KIND>(row.tab, row.own, y, kp, ks);
    row.nt = ScKind<KIND>::NT;
    row.eval = !(fold && n == 2);
  } else {  // the unread shared C (sc_rows): table 0, folded only
    row.own[0] = true;
  }
  return row;
}

// Row w of a table region as 8 words, and back.
FP_FN void sc_get(u32* x, const Limb4* t, int w) {
  FP_UNROLL
  for (int k = 0; k < 4; k++) {
    const Limb4 v = t[rm_slot<Fr>(w, k)];
    x[2 * k] = (u32)v.a | ((u32)v.b << 16);
    x[2 * k + 1] = (u32)v.c | ((u32)v.d << 16);
  }
}

FP_FN void sc_put(Limb4* t, int w, const u32* x) {
  FP_UNROLL
  for (int k = 0; k < 4; k++) {
    Limb4 v;
    v.a = (int)(x[2 * k] & 0xffffu);
    v.b = (int)(x[2 * k] >> 16);
    v.c = (int)(x[2 * k + 1] & 0xffffu);
    v.d = (int)(x[2 * k + 1] >> 16);
    t[rm_slot<Fr>(w, k)] = v;
  }
}

// Phase 1: thread (table j, i) reads its rows straight, with a fold the
// four rows of pair p = p0 + i, folds both halves (Z[p] + r (Z[p + n/2] -
// Z[p]), two independent products), stores the folded rows p and p + n/4
// to the destination (when the row owns the table; for n = 2 both are row
// 0, stored once) and puts them at rows i and P + i; without, the lo and hi
// rows of pairs p0 + i and p0 + P + i at rows i, P + i and 2P + i, 3P + i.
// A pair past the tables' end reads the last pair's rows and stores
// nothing.  A warp's threads share j: a block row with one table leaves
// the other warps idle.
template <int KIND, int P>
FP_FN void sc_load(Limb4* st, int* dst, const int* src, const u32* r, long n, long p0, long pairs,
                   bool fold, const ScRow& row, int tid) {
  const int j = tid / P, i = tid % P;
  if (j >= row.nt) return;
  const int* tab = src + (long)row.tab[j] * n * FR_ROW;
  Limb4* t = st + j * ScTile<KIND, P>::REGION;
  const long s = n / 2;
  if (fold) {
    const long h = s / 2, p = p0 + i < pairs ? p0 + i : pairs - 1;
    u32 a0[FRN], b0[FRN], a1[FRN], b1[FRN];
    fp_load_row<Fr>(a0, tab + p * FR_ROW);
    fp_load_row<Fr>(b0, tab + (p + s) * FR_ROW);
    fp_load_row<Fr>(a1, tab + (p + h) * FR_ROW);
    fp_load_row<Fr>(b1, tab + (p + h + s) * FR_ROW);
    fp_sub<Fr>(b0, b0, a0);
    fp_sub<Fr>(b1, b1, a1);
    fp_mul_inline<Fr>(b0, b0, r);
    fp_mul_inline<Fr>(b1, b1, r);
    fp_add<Fr>(a0, a0, b0);
    fp_add<Fr>(a1, a1, b1);
    sc_put(t, i, a0);
    sc_put(t, P + i, a1);
    if (row.own[j] && p0 + i < pairs) {
      int* d = dst + (long)row.tab[j] * s * FR_ROW;
      fp_store_row<Fr>(d + p * FR_ROW, a0);
      if (h > 0) fp_store_row<Fr>(d + (p + h) * FR_ROW, a1);
    }
    return;
  }
  FP_UNROLL
  for (int m = 0; m < 2; m++) {
    const long q = p0 + i + m * P, p = q < pairs ? q : pairs - 1;
    u32 a[FRN], b[FRN];
    fp_load_row<Fr>(a, tab + p * FR_ROW);
    fp_load_row<Fr>(b, tab + (p + s) * FR_ROW);
    sc_put(t, i + m * P, a);
    sc_put(t, 2 * P + i + m * P, b);
  }
}

// The value at X = 0, 2 or 3 (pt = 0, 1, 2) of the line through lo and hi.
FP_FN void sc_line_at(u32* x, const u32* lo, const u32* hi, int pt) {
  u32 d[FRN];
  fp_copy<Fr>(x, lo);
  if (pt == 0) return;
  fp_sub<Fr>(d, hi, lo);  // the line's slope
  fp_add<Fr>(x, x, d);
  fp_add<Fr>(x, x, d);
  if (pt == 2) fp_add<Fr>(x, x, d);
}

// The same for rows lo and hi of a table region.
FP_FN void sc_point(u32* x, const Limb4* t, int lo, int hi, int pt) {
  u32 a[FRN], b[FRN];
  sc_get(a, t, lo);
  if (pt != 0) sc_get(b, t, hi);
  sc_line_at(x, a, b, pt);
}

// The kind's combination of one instance's values x at a point: A B,
// tau (A B - C) or A B C.
template <int KIND>
FP_FN void sc_comb_of(u32* v, u32 (*x)[FRN]) {
  u32 t[FRN];
  if (KIND == SC_QUAD) {
    fp_mul_inline<Fr>(v, x[0], x[1]);
  } else if (KIND == SC_CUBIC_TAU) {
    fp_mul_inline<Fr>(t, x[1], x[2]);
    fp_sub<Fr>(t, t, x[3]);
    fp_mul_inline<Fr>(v, x[0], t);
  } else {
    fp_mul_inline<Fr>(t, x[0], x[1]);
    fp_mul_inline<Fr>(v, t, x[2]);
  }
}

// Phase 2 (with eval): thread `tid` forms the combination at point tid /
// TC of the tile's pairs tid % TC (and + TC when the tile has twice TC
// pairs) and adds them into acc, for pairs of the tables (a select: pairs
// past the end add nothing).  Threads from NPTS TC on form nothing; TC is a
// multiple of 32, so a warp's threads share a point and take the same side
// of every branch.
template <int KIND, int P, int TPB>
FP_FN void sc_comb_item(u32* acc, const Limb4* st, long p0, long pairs, bool fold, int tid) {
  constexpr int NT = ScKind<KIND>::NT, REGION = 16 * P;
  const int PT = sc_tile_pairs(P, fold), TC = sc_comb_threads<KIND, TPB>(PT);
  const int pt = tid / TC;
  if (pt >= ScKind<KIND>::NPTS) return;
  FP_UNROLL
  for (int m = 0; m < 2; m++) {
    const int i = tid % TC + m * TC;
    if (i >= PT) break;
    u32 x[NT][FRN], v[FRN];
    FP_UNROLL
    for (int j = 0; j < NT; j++) sc_point(x[j], st + j * REGION, i, PT + i, pt);
    sc_comb_of<KIND>(v, x);
    fp_add<Fr>(v, acc, v);
    fp_select<Fr>(acc, p0 + i < pairs, v, acc);
  }
}

// The straight form: pair p of the row's instance, its tables' lo and hi
// rows read straight, the combination at every point added into acc.
template <int KIND>
FP_FN void sc_pair_straight(u32 (*acc)[FRN], const int* src, long n, long p, const ScRow& row) {
  constexpr int NT = ScKind<KIND>::NT;
  u32 lo[NT][FRN], hi[NT][FRN], x[NT][FRN], v[FRN];
  FP_UNROLL
  for (int j = 0; j < NT; j++) {
    fp_load_row<Fr>(lo[j], src + ((long)row.tab[j] * n + p) * FR_ROW);
    fp_load_row<Fr>(hi[j], src + ((long)row.tab[j] * n + p + n / 2) * FR_ROW);
  }
  FP_UNROLL
  for (int pt = 0; pt < ScKind<KIND>::NPTS; pt++) {
    FP_UNROLL
    for (int j = 0; j < NT; j++) sc_line_at(x[j], lo[j], hi[j], pt);
    sc_comb_of<KIND>(v, x);
    fp_add<Fr>(acc[pt], acc[pt], v);
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
