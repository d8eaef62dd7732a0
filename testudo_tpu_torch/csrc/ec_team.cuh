// Group operations of ec.cuh worked by a TEAM of threads per lane: the
// schedule of a short program of them, as a table, and the work of one rank.
// Four kernels run such tables: the LSB-first ladder of ec.cuh's
// `lane_ladder` (ladder_team.cu: one program, the ladder step), the
// weighted bucket sum of the MSM (wsum_team.cu: three programs, the scan
// step, the same ladder step and one complete add), and two on one complete
// add of a pair of points (`team_pair_add`): the chain of the commit's
// table (chain_team.cu) and the pairwise folds of every path (fold_team.cu);
// and the fixed-base multiplication (fixed_base_team.cu) on the same add
// with its sums selected by a scalar bit (`team_masked_add`).
//
// One ladder step (acc = bit ? acc + base : acc; base = 2 base) runs the
// complete add and the complete double of ec.cuh, whose products mostly do
// not depend on each other: the add's t0, t1, t2, m3, m4, m5 and the
// double's t0, t1, t2, txy are ten independent products, then a1..a6 and
// b1..b4 ten more.  One thread runs them one after the other (20 Fq
// products, 63 for G2, where every Fq2 product is three Fq products by
// Karatsuba); a team runs each round's products side by side.  A scan step
// of the weighted sum is two independent complete adds (24 products, 76 for
// G2) in the same two (three) rounds.
//
// Each program is written once, below (`team_step`, `team_scan`,
// `team_add_opd`, `team_pair_add`, `team_masked_add`), over the same
// formulas as ec_add / ec_double / fp2_mul /
// fp2_mul_b3 and in the same order, but on slot numbers instead of values:
// it records a program of Fq operations, each a product or a sum /
// difference of two slots.  `team_schedule` puts every operation in the
// first STAGE after its operands are ready (a stage holds products only or
// sums only), gives each value a slot of the lane's shared memory once the
// slot's last value has been read, and writes the table: per stage, its
// operations, one 32-bit word each (operand slots a and b, result slot,
// subtract, select).  Rank r of a team runs operation r of every stage (T at
// a time when a stage holds more than T) and the team syncs after each;
// ranks without one multiply zeros into a dummy slot, so every thread runs
// the same code and reaches every sync.  A stage never writes a slot that
// another operation of it reads, so the ranks of a stage may run in any
// order: csrc/host_check.cpp runs them one after another on the CPU, from
// these tables and these functions.
//
// The values are the same canonical Fq elements the one-thread kernels
// compute (every operation reduces strictly), so the results are equal limb
// for limb; only which thread computes which product changes.
#pragma once
#include "ec.cuh"

#define TEAM_MAX_OPS 400
#define TEAM_MAX_STAGES 48
#define TEAM_SLOT_BITS 10
#define TEAM_SLOT_MASK ((1u << TEAM_SLOT_BITS) - 1u)

// The schedule of one program, as the kernels receive it.
// op word: a | b << 10 | out << 20 | subtract << 30 | select << 31
// stage word: first op | count << 16 | products << 31
struct TeamTable {
  int nops, nstages, nslots, nfixed;
  u32 op[TEAM_MAX_OPS];
  u32 stage[TEAM_MAX_STAGES];
};

// Fixed slots of a lane that holds `npts` points of a group with nc Fq
// components per coordinate: point k's X, Y, Z at 3 nc k (component-major,
// as the packed rows), then zero, the constant k of G2's b3 (fp2.cuh), and
// the dummy that idle ranks write.  Temporaries follow.  The constants sit
// at the end, so they are found from the number of fixed slots `nf`.
#define TEAM_NFIXED(nc, npts) (3 * (nc) * (npts) + 3)
#define TEAM_ZERO_SLOT(nf) ((nf)-3)
#define TEAM_KB3_SLOT(nf) ((nf)-2)
#define TEAM_DUMMY_SLOT(nf) ((nf)-1)
// zero times zero into the dummy slot
#define TEAM_DUMMY_OP(nf)                                                  \
  ((u32)TEAM_ZERO_SLOT(nf) | ((u32)TEAM_ZERO_SLOT(nf) << TEAM_SLOT_BITS) | \
   ((u32)TEAM_DUMMY_SLOT(nf) << (2 * TEAM_SLOT_BITS)))

// The points of a ladder lane: acc, then base.
#define LADDER_NPTS 2
// The points of a weighted-sum lane: the accumulator of the weight ladder,
// the run (the ladder's base), the bucket being scanned, a copy of the run
// before the ladder, and the second operand of the closing adds (the scan's
// tot until then).
enum { WS_ACC = 0, WS_RUN = 1, WS_BKT = 2, WS_RUN0 = 3, WS_OPD = 4, WS_NPTS = 5 };
// The points of a chain, fold or fixed-base lane: the sum, then the point
// added to it.
#define PAIR_NPTS 2
// Buckets a group of the weighted sum at window bits c, and its lanes for W
// windows (one a group).
#define WSUM_H(c) ((c) < 5 ? 1 << (c) : 32)
#define WSUM_LANES(W, c) ((long)(W) * ((1L << (c)) / WSUM_H(c)))

// Threads per lane, a divisor of 32 (a team never spans warps).  Ladder: 16
// for G1 (two lanes a warp, 10 products a round), 32 for G2 (one lane a
// warp, 30 Fq products a round); each beat the half size on an H100
// (PERF.md section 6).  Weighted sum: chosen at 2,560 lanes with
// tools/exp_wsum.py (PERF.md section 6).
#define TEAM_T(nc) ((nc) == 1 ? 16 : 32)
#define WSUM_T(nc) ((nc) == 1 ? 16 : 32)
// Chain and fold: threads a lane and lanes (teams) a block, chosen at the
// paths' shapes with tools/exp_fold.py on an H100 (PERF.md section 6).  A
// G1 add's stages hold at most 6 operations, a G2 add's 18.  A fold launch
// of S segments gives a block FOLD_CARD_TEAMS / S teams, within
// FOLD_TEAMS_MIN .. FOLD_TEAMS(nc): many where few segments leave the card
// room, few for many segments (the commit's 1,024, where the idle teams of a
// level's late rounds cost issue slots), and never more than the widest
// segment has pairs, nor than fit the shared memory (fold_team.cu).
#define CHAIN_T(nc) ((nc) == 1 ? 8 : 16)
#define CHAIN_TEAMS(nc) ((nc) == 1 ? 4 : 2)
#define FOLD_T(nc) ((nc) == 1 ? 8 : 16)
#define FOLD_TEAMS(nc) ((nc) == 1 ? 32 : 16)
#define FOLD_TEAMS_MIN 4
#define FOLD_CARD_TEAMS 4096
static_assert(32 % TEAM_T(1) == 0 && 32 % TEAM_T(2) == 0, "a team must not span warps");
static_assert(32 % WSUM_T(1) == 0 && 32 % WSUM_T(2) == 0, "a team must not span warps");
static_assert(32 % CHAIN_T(1) == 0 && 32 % CHAIN_T(2) == 0, "a team must not span warps");
static_assert(32 % FOLD_T(1) == 0 && 32 % FOLD_T(2) == 0, "a team must not span warps");
// Fixed base: threads a lane and lanes a block, chosen at the setup's 2,047
// lanes (nv = 20) with tools/exp_fixed_base.py on an H100 (PERF.md section
// 6).  There T = 8 (G1) and 16 (G2) beat 32 by 44% and 1%; at 63 and 255
// lanes T = 32 wins (fewer lanes a warp skip more steps), by 0.6 / 1.0 ms.
#define FIXED_T(nc) ((nc) == 1 ? 8 : 16)
#define FIXED_TEAMS(nc) 4
static_assert(32 % FIXED_T(1) == 0 && 32 % FIXED_T(2) == 0, "a team must not span warps");

// A team syncs after every stage: the warp's sync on the card.  On the CPU
// (csrc/host_check.cpp) one thread runs the ranks one after another.
// The fold's teams sync as a block between the levels of its tree, after
// their stores to device memory (the next level's loads are other teams').
#ifdef __CUDACC__
#define TEAM_SYNC() __syncwarp()
#define TEAM_BLOCK_SYNC() \
  do {                    \
    __threadfence_block(); \
    __syncthreads();      \
  } while (0)
#define TEAM_ONE_THREAD 0
#else
#define TEAM_SYNC()
#define TEAM_BLOCK_SYNC()
#define TEAM_ONE_THREAD 1
#endif

// Is `b` true for any thread of the warp?  The same answer for all 32, so a
// branch on it keeps every team of the warp on the same stages and syncs;
// every thread of the warp must call it (the kernels clamp lanes past the
// end, never return early).  On the CPU a lane runs as in a warp where
// another lane needs every step (as `any_lane`): the select keeps acc.
FP_FN bool team_any(bool b) {
#ifdef __CUDACC__
  return __any_sync(0xffffffffu, b) != 0;
#else
  (void)b;
  return true;
#endif
}

// ---------------------------------------------------------------------------
// The work of one rank (device and host)
// ---------------------------------------------------------------------------

// A lane's slots in shared memory, word-major: word j of slot s at
// region[j * ns + s], so the ranks' loads of one word hit different banks.
FP_FN void team_slot_load(u32* r, const u32* region, int ns, int s) {
  FP_UNROLL
  for (int j = 0; j < FQN; j++) r[j] = region[j * ns + s];
}

FP_FN void team_slot_store(u32* region, int ns, int s, const u32* a) {
  FP_UNROLL
  for (int j = 0; j < FQN; j++) region[j * ns + s] = a[j];
}

// r = a + b, or a - b when `sub` (as a + (p - b), with p - b in [1, p] and
// p for b = 0: a + p - b < 2p takes one conditional subtraction).  The
// same code runs either way: only a select depends on `sub`.
FP_FN void team_add_or_sub(u32* r, const u32* a, const u32* b, bool sub) {
  u32 nb[FQN];
  u64 borrow = 0;
  FP_UNROLL
  for (int i = 0; i < FQN; i++) {
    u64 s = (u64)FQ_P[i] - b[i] - borrow;
    nb[i] = sub ? (u32)s : b[i];
    borrow = s >> 63;
  }
  fp_add<Fq>(r, a, nb);
}

// One operation of a stage: a product when `mul` (the same for every rank
// of the stage), else a sum or difference; a `select` operation keeps the
// slot's old value unless the step's scalar bit is set.
FP_FN void team_op(u32* region, int ns, u32 op, bool mul, bool bit) {
  const int a = (int)(op & TEAM_SLOT_MASK);
  const int b = (int)((op >> TEAM_SLOT_BITS) & TEAM_SLOT_MASK);
  const int o = (int)((op >> (2 * TEAM_SLOT_BITS)) & TEAM_SLOT_MASK);
  u32 x[FQN], y[FQN];
  team_slot_load(x, region, ns, a);
  team_slot_load(y, region, ns, b);
  if (mul) {
    fp_mul_inline<Fq>(x, x, y);  // one product per thread and stage: inlined
  } else {
    u32 old[FQN];
    team_slot_load(old, region, ns, o);
    team_add_or_sub(x, x, y, ((op >> 30) & 1u) != 0);
    fp_select<Fq>(x, ((op >> 31) != 0) && !bit, old, x);
  }
  team_slot_store(region, ns, o, x);
}

// Operation i of the stage whose word is `stage`, or the dummy where the
// stage has no operation i (its last sub-round, or a rank it leaves idle).
FP_FN u32 team_pick(const u32* ops, u32 stage, int i, u32 dummy) {
  const int count = (int)((stage >> 16) & 0x7fffu);
  return i < count ? ops[(stage & 0xffffu) + i] : dummy;
}

// A table as a kernel holds it: its operations and stages (in shared
// memory on the card).
struct TeamCode {
  const u32* ops;
  const u32* stages;
  int nstages;
};

// One run of a table on a lane: rank r runs operation r, r + T, ... of every
// stage, the team syncing after each sub-round of T; `bit` drives the
// selects.  On the CPU one thread runs the T ranks of a sub-round in turn.
template <int T>
FP_FN void team_run(u32* region, int ns, const TeamCode& code, u32 dummy, int rank, bool bit) {
  FP_NO_UNROLL
  for (int s = 0; s < code.nstages; s++) {
    const u32 st = code.stages[s];
    const bool mul = (st >> 31) != 0;
    const int count = (int)((st >> 16) & 0x7fffu);
    FP_NO_UNROLL
    for (int i = 0; i < count; i += T) {
      if (TEAM_ONE_THREAD) {
        for (int r = 0; r < T; r++) team_op(region, ns, team_pick(code.ops, st, i + r, dummy), mul, bit);
      } else {
        team_op(region, ns, team_pick(code.ops, st, i + rank, dummy), mul, bit);
      }
      TEAM_SYNC();
    }
  }
}

// A team member's share of the work on whole points: slots first, first +
// step, ... of the point's 3 nc.  The kernels pass (rank, T); the CPU, with
// one thread for the team, (0, 1).

// The constants of a lane with nf fixed slots: zero, k, dummy.
FP_FN void team_consts(u32* region, int ns, int nf, int first, int step) {
  for (int c = first; c < 3; c += step) {
    u32 v[FQN];
    if (c == 1)
      fp_copy<Fq>(v, FQ_B3K);
    else
      fp_zero<Fq>(v);
    team_slot_store(region, ns, TEAM_ZERO_SLOT(nf) + c, v);
  }
}

// point pt = the identity (0, 1, 0), 1 in the first component of Y
template <int NC>
FP_FN void team_identity(u32* region, int ns, int pt, int first, int step) {
  for (int c = first; c < 3 * NC; c += step) {
    u32 v[FQN];
    if (c == NC)
      fp_copy<Fq>(v, FQ_ONE);
    else
      fp_zero<Fq>(v);
    team_slot_store(region, ns, 3 * NC * pt + c, v);
  }
}

// point dst = point src
template <int NC>
FP_FN void team_copy(u32* region, int ns, int dst, int src, int first, int step) {
  for (int c = first; c < 3 * NC; c += step) {
    u32 v[FQN];
    team_slot_load(v, region, ns, 3 * NC * src + c);
    team_slot_store(region, ns, 3 * NC * dst + c, v);
  }
}

// Point pt = point p of a batch whose int k of point p lies at ptr[p sp +
// k sr] (a packed (rows, L) batch: sp = 1, sr = L; a point-major table: sp
// = rows, sr = 1), and back.  A member moves words first, first + step, ...
// of the point's 3 nc 12 words (word j of component c: ints 24 c + 2 j and
// + 1), so on a point-major row a team's stores are side by side.
template <int NC>
FP_FN void team_load(u32* region, int ns, int pt, const int* ptr, long sp, long sr, long p,
                     int first, int step) {
  for (int w = first; w < 3 * NC * FQN; w += step) {
    const int c = w / FQN, j = w % FQN;
    const int* q = ptr + p * sp + (long)(2 * FQN * c + 2 * j) * sr;
    region[j * ns + 3 * NC * pt + c] = (u32)q[0] | ((u32)q[sr] << 16);
  }
}

template <int NC>
FP_FN void team_store(int* ptr, long sp, long sr, long p, const u32* region, int ns, int pt,
                      int first, int step) {
  for (int w = first; w < 3 * NC * FQN; w += step) {
    const int c = w / FQN, j = w % FQN;
    const u32 v = region[j * ns + 3 * NC * pt + c];
    int* q = ptr + p * sp + (long)(2 * FQN * c + 2 * j) * sr;
    q[0] = (int)(v & 0xffffu);
    q[sr] = (int)(v >> 16);
  }
}

// ---------------------------------------------------------------------------
// The work of one lane (device and host)
// ---------------------------------------------------------------------------

// out[lane] = [s] P of ec.cuh's `lane_ladder`, by the ladder table `step`:
// the lane's points and temporaries in `region` (ns slots), the team's
// member `rank` of T.  Lanes past L run on with clamped loads and store
// nothing.
template <class C, int T>
FP_FN void lane_ladder_team(u32* region, int ns, const TeamCode& step, const int* pts,
                            const int* scal, int* out, int nl, long L, long lane, int rank) {
  constexpr int NC = C::COMP_ROWS / (2 * FQN);
  constexpr int NF = TEAM_NFIXED(NC, LADDER_NPTS);
  const int first = TEAM_ONE_THREAD ? 0 : rank, stride = TEAM_ONE_THREAD ? 1 : T;
  const long src = lane < L ? lane : L - 1;
  team_identity<NC>(region, ns, 0, first, stride);
  team_load<NC>(region, ns, 1, pts, 1, L, src, first, stride);
  team_consts(region, ns, NF, first, stride);
  TEAM_SYNC();
  FP_NO_UNROLL
  for (int k = 0; k < nl; k++) {
    const u32 limb = (u32)scal[(long)k * L + src];
    FP_NO_UNROLL
    for (int bit = 0; bit < 16; bit++)
      team_run<T>(region, ns, step, TEAM_DUMMY_OP(NF), rank, ((limb >> bit) & 1u) != 0);
  }
  if (lane < L) team_store<NC>(out, 1, L, lane, region, ns, 0, first, stride);
}

// The per-group weighted sum of msm.py's `_weighted_sum_packed` for lane
// (w, g), g < groups = 2^c / h, h = min(2^c, 32), by the tables `code`
// (scan step, ladder step, add): over the buckets B = (C::ROWS, W 2^c)
//   run = tot = O; for l = h-1 .. 0: (run, tot) = (run + B_l, tot + run)
//   acc = O; for bit < maxbits: acc = bit of (g h) ? acc + run : acc; run = 2 run
//   out = acc + tot (+ the scan's run when plus_one)
// with B_l = B[:, w 2^c + g h + l] and maxbits = max(1, bit length of
// (groups - 1) h): the adds of scan2b, step and add2 in their order and
// with their operands.  out is (C::ROWS, W groups).
template <class C, int T>
FP_FN void lane_wsum_team(u32* region, int ns, const TeamCode* code, const int* buckets,
                          int* out, int W, int c, bool plus_one, long lane, int rank) {
  constexpr int NC = C::COMP_ROWS / (2 * FQN);
  constexpr u32 DUMMY = TEAM_DUMMY_OP(TEAM_NFIXED(NC, WS_NPTS));
  const int first = TEAM_ONE_THREAD ? 0 : rank, stride = TEAM_ONE_THREAD ? 1 : T;
  const int h = WSUM_H(c);
  const long groups = (1L << c) / h;
  const long L = WSUM_LANES(W, c);
  const long src = lane < L ? lane : L - 1;
  const long g = src % groups;
  const long col0 = ((src / groups) << c) + g * h;
  const long weight = g * h;
  int maxbits = 1;
  while (((groups - 1) * h) >> maxbits) maxbits++;
  team_consts(region, ns, TEAM_NFIXED(NC, WS_NPTS), first, stride);
  team_identity<NC>(region, ns, WS_ACC, first, stride);
  team_identity<NC>(region, ns, WS_RUN, first, stride);
  team_identity<NC>(region, ns, WS_OPD, first, stride);
  FP_NO_UNROLL
  for (int l = h - 1; l >= 0; l--) {
    team_load<NC>(region, ns, WS_BKT, buckets, 1, (long)W << c, col0 + l, first, stride);
    TEAM_SYNC();
    team_run<T>(region, ns, code[0], DUMMY, rank, false);
  }
  team_copy<NC>(region, ns, WS_RUN0, WS_RUN, first, stride);
  TEAM_SYNC();
  FP_NO_UNROLL
  for (int bit = 0; bit < maxbits; bit++)
    team_run<T>(region, ns, code[1], DUMMY, rank, ((weight >> bit) & 1) != 0);
  team_run<T>(region, ns, code[2], DUMMY, rank, false);
  if (plus_one) {  // the same for the whole grid
    team_copy<NC>(region, ns, WS_OPD, WS_RUN0, first, stride);
    TEAM_SYNC();
    team_run<T>(region, ns, code[2], DUMMY, rank, false);
  }
  if (lane < L) team_store<NC>(out, 1, L, lane, region, ns, WS_ACC, first, stride);
}

// Lane j of the commit's table (msm.py's `_multi_msm_table`), by the table
// `add` of `team_pair_add`: from the point-major bases (N, C::ROWS), row
// j B + d of the point-major table out (N B, C::ROWS) is d G_j as the chain
//   cur = O; for d = 1 .. B-1: cur = cur + G_j
// leaves it (row j B the identity): the adds of `add2` in their order and
// with their operands.  Lanes past N run on with clamped loads and store
// nothing.
template <class C, int T>
FP_FN void lane_chain_team(u32* region, int ns, const TeamCode& add, const int* base, int* out,
                           long N, int B, long lane, int rank) {
  constexpr int NC = C::COMP_ROWS / (2 * FQN);
  constexpr u32 DUMMY = TEAM_DUMMY_OP(TEAM_NFIXED(NC, PAIR_NPTS));
  const int first = TEAM_ONE_THREAD ? 0 : rank, stride = TEAM_ONE_THREAD ? 1 : T;
  const long src = lane < N ? lane : N - 1;
  team_consts(region, ns, TEAM_NFIXED(NC, PAIR_NPTS), first, stride);
  team_identity<NC>(region, ns, 0, first, stride);
  team_load<NC>(region, ns, 1, base, C::ROWS, 1, src, first, stride);
  TEAM_SYNC();
  if (lane < N) team_store<NC>(out, C::ROWS, 1, lane * B, region, ns, 0, first, stride);
  // the stores read the sum's slots, which only the last stages of the
  // next add write, after a sync
  FP_NO_UNROLL
  for (int d = 1; d < B; d++) {
    team_run<T>(region, ns, add, DUMMY, rank, false);
    if (lane < N) team_store<NC>(out, C::ROWS, 1, lane * B + d, region, ns, 0, first, stride);
  }
}

// Segment s of the pairwise fold (`PackedGroup.fold`): the n points of
// columns off .. off + n - 1 of a packed (C::ROWS, L) batch are reduced as
// `tree_reduce` does, level by level: while m > 1 points are left, point i
// = point i + point i + half for i < half = m / 2, and an odd level carries
// its last point to slot half.  The sum goes to column s of the packed
// (C::ROWS, S) out.  The block's P teams (team t of them, `add` the table
// of `team_pair_add`) take a level's pairs P at a time; the levels live in
// two halves of the segment's scratch (2 half_max points, point-major) and
// the block syncs between levels.  A team without a pair in its round
// clamps its loads, runs the stages and skips the store: every thread
// reaches every sync.  On the CPU one thread runs P = 1 team.
template <class C, int T>
FP_FN void block_fold_team(u32* region, int ns, const TeamCode& add, const int* a, long L,
                           long off, int n, int* scratch, int half_max, int* out, long S, long s,
                           int team, int P, int rank) {
  constexpr int NC = C::COMP_ROWS / (2 * FQN);
  constexpr u32 DUMMY = TEAM_DUMMY_OP(TEAM_NFIXED(NC, PAIR_NPTS));
  const int first = TEAM_ONE_THREAD ? 0 : rank, stride = TEAM_ONE_THREAD ? 1 : T;
  const int bfirst = TEAM_ONE_THREAD ? 0 : team * T + rank, bstride = TEAM_ONE_THREAD ? 1 : P * T;
  team_consts(region, ns, TEAM_NFIXED(NC, PAIR_NPTS), first, stride);
  const int* src = a + off;
  long sp = 1, sr = L;
  int m = n, buf = 0;
  if (m == 1) {  // a segment of one point is its own sum
    for (int k = bfirst; k < C::ROWS; k += bstride) out[k * S + s] = src[k * sr];
    return;
  }
  FP_NO_UNROLL
  while (m > 1) {
    const int half = m >> 1;
    int* dst;
    long dp, dr;
    if (m == 2) {  // the last level writes the sum
      dst = out + s;
      dp = 1;
      dr = S;
    } else {
      dst = scratch + ((long)s * 2 + buf) * half_max * C::ROWS;
      dp = C::ROWS;
      dr = 1;
    }
    FP_NO_UNROLL
    for (int base = 0; base < half; base += P) {
      const int i = base + team;
      const int ii = i < half ? i : half - 1;
      team_load<NC>(region, ns, 0, src, sp, sr, ii, first, stride);
      team_load<NC>(region, ns, 1, src, sp, sr, ii + half, first, stride);
      TEAM_SYNC();
      team_run<T>(region, ns, add, DUMMY, rank, false);
      if (i < half) team_store<NC>(dst, dp, dr, i, region, ns, 0, first, stride);
      TEAM_SYNC();
    }
    if (m & 1)
      for (int k = bfirst; k < C::ROWS; k += bstride)
        dst[half * dp + k * dr] = src[(long)(m - 1) * sp + k * sr];
    TEAM_BLOCK_SYNC();
    src = dst;
    sp = dp;
    sr = dr;
    buf ^= 1;
    m = half + (m & 1);
  }
}

// Lane i of the fixed-base multiplication (`PackedGroup.fixed_base`), by the
// table `add` of `team_masked_add`: with T_k column k of the packed (C::ROWS,
// 16 nl) table of doublings and s_i row i of the (N, nl) canonical 16-bit
// limbs,
//   acc = O; for k < 16 nl: acc = bit k of s_i ? acc + T_k : acc
// the adds and selects of `add_mask` in their order, so the limbs are its.
// Every lane reads T_k, a broadcast through L1 (a copy of the whole table
// staged in each block's shared memory was never faster at the setup's
// widths: PERF.md section 6).  A step is skipped when no lane of the warp
// has its bit set (`team_any`): a false select keeps acc, so the skip
// changes no limb.  Lanes past N run on with clamped loads and store
// nothing.
template <class C, int T>
FP_FN void lane_fixed_base_team(u32* region, int ns, const TeamCode& add, const int* table,
                                const int* scal, int* out, long N, int nl, long lane, int rank) {
  constexpr int NC = C::COMP_ROWS / (2 * FQN);
  constexpr u32 DUMMY = TEAM_DUMMY_OP(TEAM_NFIXED(NC, PAIR_NPTS));
  const int first = TEAM_ONE_THREAD ? 0 : rank, stride = TEAM_ONE_THREAD ? 1 : T;
  const long src = lane < N ? lane : N - 1;
  const int nb = 16 * nl;
  team_consts(region, ns, TEAM_NFIXED(NC, PAIR_NPTS), first, stride);
  team_identity<NC>(region, ns, 0, first, stride);
  TEAM_SYNC();
  FP_NO_UNROLL
  for (int l = 0; l < nl; l++) {
    const u32 limb = (u32)scal[src * nl + l];
    FP_NO_UNROLL
    for (int b = 0; b < 16; b++) {
      const bool bit = ((limb >> b) & 1u) != 0;
      if (!team_any(bit)) continue;
      team_load<NC>(region, ns, 1, table, 1, nb, 16 * l + b, first, stride);
      TEAM_SYNC();
      team_run<T>(region, ns, add, DUMMY, rank, bit);
    }
  }
  if (lane < N) team_store<NC>(out, 1, N, lane, region, ns, 0, first, stride);
}

// ---------------------------------------------------------------------------
// The programs and their schedule (host code: a launcher builds its tables
// once per group)
// ---------------------------------------------------------------------------

// Values are numbered: 0 .. nfixed-1 are the fixed slots as the program
// finds them, nfixed + i the result of operation i.
struct TeamProg {
  int nfixed, n;
  int mul[TEAM_MAX_OPS], a[TEAM_MAX_OPS], b[TEAM_MAX_OPS], sub[TEAM_MAX_OPS];
  int out_fixed[TEAM_MAX_OPS], sel[TEAM_MAX_OPS];
  bool written[TEAM_MAX_OPS];  // per fixed slot: the program has stored to it
  bool bad;

  void init(int nf) {
    nfixed = nf;
    n = 0;
    bad = false;
    for (int i = 0; i < TEAM_MAX_OPS; i++) written[i] = false;
  }
  // a fixed slot is read only as the program found it, a selected value never
  bool readable(int v) const { return v < nfixed ? !written[v] : !sel[v - nfixed]; }
  int op(int is_mul, int x, int y, int is_sub) {
    if (n >= TEAM_MAX_OPS || !readable(x) || !readable(y)) {
      bad = true;
      return 0;
    }
    mul[n] = is_mul;
    a[n] = x;
    b[n] = y;
    sub[n] = is_sub;
    out_fixed[n] = -1;
    sel[n] = 0;
    return nfixed + n++;
  }
  int lin(int x, int y, int is_sub) { return op(0, x, y, is_sub); }
  int prod(int x, int y) { return op(1, x, y, 0); }
  // The operation that made v writes fixed slot f instead (with `select`:
  // only when the step's bit is set).  Nothing may read v afterwards; every
  // reader of f's old value runs in an earlier stage (team_dependencies).
  void store(int f, int v, bool select) {
    int i = v - nfixed;
    if (i < 0 || out_fixed[i] >= 0 || written[f] || (select && mul[i])) {
      bad = true;
      return;
    }
    out_fixed[i] = f;
    sel[i] = select;
    written[f] = true;
  }
};

// Coordinate policies of the recorder, as FqCoord / Fq2Coord are of ec.cuh.
struct TeamFq {
  typedef int E;
  static constexpr int NC = 1;
  static E at(int slot) { return slot; }
  static E add(TeamProg& p, E x, E y) { return p.lin(x, y, 0); }
  static E sub(TeamProg& p, E x, E y) { return p.lin(x, y, 1); }
  static E mul(TeamProg& p, E x, E y) { return p.prod(x, y); }
  static E mul3(TeamProg& p, E x) { return add(p, add(p, x, x), x); }  // fp_mul3
  static E mul_b3(TeamProg& p, E x) { return mul3(p, x); }
  static void store(TeamProg& p, int slot, E v, bool select) { p.store(slot, v, select); }
};

struct TeamFq2 {
  struct E {
    int c0, c1;
  };
  static constexpr int NC = 2;
  static E at(int slot) { return {slot, slot + 1}; }
  static E add(TeamProg& p, E x, E y) { return {p.lin(x.c0, y.c0, 0), p.lin(x.c1, y.c1, 0)}; }
  static E sub(TeamProg& p, E x, E y) { return {p.lin(x.c0, y.c0, 1), p.lin(x.c1, y.c1, 1)}; }
  static E mul(TeamProg& p, E x, E y) {  // fp2_mul
    int sa = p.lin(x.c0, x.c1, 0), sb = p.lin(y.c0, y.c1, 0);
    int t0 = p.prod(x.c0, y.c0), t1 = p.prod(x.c1, y.c1), s = p.prod(sa, sb);
    s = p.lin(s, t0, 1);
    int c1 = p.lin(s, t1, 1);
    s = p.lin(t1, t1, 0);
    s = p.lin(s, s, 0);
    s = p.lin(s, t1, 0);  // 5 t1
    return {p.lin(t0, s, 1), c1};
  }
  static E mul3(TeamProg& p, E x) { return {TeamFq::mul3(p, x.c0), TeamFq::mul3(p, x.c1)}; }
  static E mul_b3(TeamProg& p, E x) {  // fp2_mul_b3: (3 a1, k a0)
    int t = TeamFq::mul3(p, x.c1);
    return {t, p.prod(x.c0, TEAM_KB3_SLOT(p.nfixed))};
  }
  static void store(TeamProg& p, int slot, E v, bool select) {
    p.store(slot, v.c0, select);
    p.store(slot + 1, v.c1, select);
  }
};

// A point of the recorder: its three coordinates' values.
template <class TC>
struct TeamPt {
  typename TC::E x, y, z;
};

// point pt of the fixed slots, as the program finds it
template <class TC>
static TeamPt<TC> team_pt(int pt) {
  const int s = 3 * TC::NC * pt;
  return {TC::at(s), TC::at(s + TC::NC), TC::at(s + 2 * TC::NC)};
}

template <class TC>
static void team_put(TeamProg& p, int pt, const TeamPt<TC>& v, bool select) {
  const int s = 3 * TC::NC * pt;
  TC::store(p, s, v.x, select);
  TC::store(p, s + TC::NC, v.y, select);
  TC::store(p, s + 2 * TC::NC, v.z, select);
}

// P + Q, ec_add's formulas and order
template <class TC>
static TeamPt<TC> team_rec_add(TeamProg& p, const TeamPt<TC>& P, const TeamPt<TC>& Q) {
  typedef typename TC::E E;
  const E px = P.x, py = P.y, pz = P.z, qx = Q.x, qy = Q.y, qz = Q.z;
  E t0 = TC::mul(p, px, qx), t1 = TC::mul(p, py, qy), t2 = TC::mul(p, pz, qz);
  E t3 = TC::mul(p, TC::add(p, px, py), TC::add(p, qx, qy));  // m3
  E t4 = TC::mul(p, TC::add(p, py, pz), TC::add(p, qy, qz));  // m4
  E y3 = TC::mul(p, TC::add(p, px, pz), TC::add(p, qx, qz));  // m5
  t3 = TC::sub(p, t3, TC::add(p, t0, t1));
  t4 = TC::sub(p, t4, TC::add(p, t1, t2));
  y3 = TC::sub(p, y3, TC::add(p, t0, t2));
  // ec_add_tail
  E x3 = TC::add(p, t0, t0);
  t0 = TC::add(p, x3, t0);  // 3 X1X2
  E t2b = TC::mul_b3(p, t2), y3b = TC::mul_b3(p, y3);
  E z3 = TC::add(p, t1, t2b);
  t1 = TC::sub(p, t1, t2b);
  E sx = TC::sub(p, TC::mul(p, t3, t1), TC::mul(p, t4, y3b));   // a2 - a1
  E sy = TC::add(p, TC::mul(p, t1, z3), TC::mul(p, y3b, t0));   // a4 + a3
  E sz = TC::add(p, TC::mul(p, z3, t4), TC::mul(p, t0, t3));    // a6 + a5
  return {sx, sy, sz};
}

// 2 Q, ec_double's formulas and order
template <class TC>
static TeamPt<TC> team_rec_double(TeamProg& p, const TeamPt<TC>& Q) {
  typedef typename TC::E E;
  const E qx = Q.x, qy = Q.y, qz = Q.z;
  E d0 = TC::mul(p, qy, qy), d1 = TC::mul(p, qy, qz), d2 = TC::mul(p, qz, qz);
  E dxy = TC::mul(p, qx, qy);
  E dz3 = TC::add(p, d0, d0);
  dz3 = TC::add(p, dz3, dz3);
  dz3 = TC::add(p, dz3, dz3);  // 8 Y^2
  E d2b = TC::mul_b3(p, d2);
  E dy3 = TC::add(p, d0, d2b);
  d0 = TC::sub(p, d0, TC::mul3(p, d2b));
  E bz = TC::mul(p, d1, dz3);                                    // b2
  E by = TC::add(p, TC::mul(p, d2b, dz3), TC::mul(p, d0, dy3));  // b1 + b3
  E u = TC::mul(p, d0, dxy);                                     // b4
  E bx = TC::add(p, u, u);
  return {bx, by, bz};
}

// One ladder step on points acc and base: s = acc + base (ec_add), base =
// 2 base (ec_double), acc = bit ? s : acc, as lane_step / lane_ladder.
template <class TC>
static void team_step(TeamProg& p, int acc, int base) {
  const TeamPt<TC> A = team_pt<TC>(acc), B = team_pt<TC>(base);
  const TeamPt<TC> s = team_rec_add<TC>(p, A, B);
  const TeamPt<TC> d = team_rec_double<TC>(p, B);
  team_put<TC>(p, acc, s, true);
  team_put<TC>(p, base, d, false);
}

// One scan step of the weighted sum, as lane_scan2b: run' = run + bucket,
// tot' = tot + run (the old run); tot lives in WS_OPD.
template <class TC>
static void team_scan(TeamProg& p) {
  const TeamPt<TC> run = team_pt<TC>(WS_RUN), tot = team_pt<TC>(WS_OPD);
  const TeamPt<TC> r = team_rec_add<TC>(p, run, team_pt<TC>(WS_BKT));
  const TeamPt<TC> t = team_rec_add<TC>(p, tot, run);
  team_put<TC>(p, WS_RUN, r, false);
  team_put<TC>(p, WS_OPD, t, false);
}

// acc = acc + opd, as lane_add2
template <class TC>
static void team_add_opd(TeamProg& p) {
  team_put<TC>(p, WS_ACC, team_rec_add<TC>(p, team_pt<TC>(WS_ACC), team_pt<TC>(WS_OPD)), false);
}

// point 0 = point 0 + point 1, the pair add of the chain and the fold
template <class TC>
static void team_pair_add(TeamProg& p) {
  team_put<TC>(p, 0, team_rec_add<TC>(p, team_pt<TC>(0), team_pt<TC>(1)), false);
}

// point 0 = bit ? point 0 + point 1 : point 0, the masked add of the fixed
// base (`add_mask`): the sum's last sums select
template <class TC>
static void team_masked_add(TeamProg& p) {
  team_put<TC>(p, 0, team_rec_add<TC>(p, team_pt<TC>(0), team_pt<TC>(1)), true);
}

// dep[i][j]: operation i must run in a later stage than operation j: it
// reads j's value (then j < i), or it writes a fixed slot whose old value j
// reads (j may come before or after i in the program: a program stores its
// results to fixed slots at its end).
static bool team_dep[TEAM_MAX_OPS][TEAM_MAX_OPS];
static bool team_feeds_product[TEAM_MAX_OPS];

static void team_dependencies(const TeamProg& p) {
  const int nf = p.nfixed, n = p.n;
  for (int i = 0; i < n; i++) {
    const int f = p.out_fixed[i];
    for (int j = 0; j < n; j++)
      team_dep[i][j] = j != i && ((j < i && (p.a[i] == nf + j || p.b[i] == nf + j)) ||
                                  (f >= 0 && (p.a[j] == f || p.b[j] == f)));
  }
  for (int j = 0; j < n; j++) {
    team_feeds_product[j] = false;
    for (int i = 0; i < n; i++)
      if (p.mul[i] && team_dep[i][j]) team_feeds_product[j] = true;
  }
}

// Put every operation that is ready at stage s (all it depends on in earlier
// stages) and of kind k into stage s; k < 0 takes sums while a ready sum
// feeds a product, else products.  Returns the kind placed, -1 if none.
static int team_fill(const TeamProg& p, int* stage, int s, int k, int* count) {
  static bool ready[TEAM_MAX_OPS];
  bool any[2] = {false, false}, urgent_sum = false;
  for (int i = 0; i < p.n; i++) {
    ready[i] = stage[i] < 0;
    for (int j = 0; j < p.n && ready[i]; j++)
      if (team_dep[i][j] && (stage[j] < 0 || stage[j] == s)) ready[i] = false;
    if (ready[i]) {
      any[p.mul[i]] = true;
      if (!p.mul[i] && team_feeds_product[i]) urgent_sum = true;
    }
  }
  if (k < 0) k = urgent_sum || !any[1] ? 0 : 1;
  if (!any[k]) return -1;
  *count = 0;
  for (int i = 0; i < p.n; i++)
    if (ready[i] && p.mul[i] == k) {
      stage[i] = s;
      ++*count;
    }
  return k;
}

// What the rest of a schedule costs from stage s on, filled by the rule of
// team_fill: a stage of products weighs 10, of sums 1, per 32 operations.
static int team_cost(const TeamProg& p, const int* stage0, int s) {
  static int stage[TEAM_MAX_OPS];
  for (int i = 0; i < p.n; i++) stage[i] = stage0[i];
  int cost = 0, count = 0, k;
  for (; (k = team_fill(p, stage, s, -1, &count)) >= 0 || (k = team_fill(p, stage, s, 1, &count)) >= 0; s++)
    cost += (k ? 10 : 1) * ((count + 31) / 32);
  return cost;
}

// Stages, slots and the table of a program; 0, or -1 if it does
// not fit the table.  Each stage takes the kind (products or sums) whose
// choice leaves the cheaper rest of the schedule (team_cost), and every
// ready operation of that kind.
static int team_schedule(const TeamProg& p, TeamTable& t) {
  const int nf = p.nfixed, n = p.n;
  static int stage[TEAM_MAX_OPS], trial[TEAM_MAX_OPS], last_use[TEAM_MAX_OPS];
  static int slot[TEAM_MAX_OPS], kind[TEAM_MAX_STAGES];
  team_dependencies(p);
  for (int i = 0; i < n; i++) stage[i] = -1;
  int nst = 0;
  for (int placed = 0; placed < n; nst++) {
    if (nst == TEAM_MAX_STAGES) return -1;
    int best = -1, best_cost = 0, count = 0;
    for (int k = 0; k < 2; k++) {
      for (int i = 0; i < n; i++) trial[i] = stage[i];
      if (team_fill(p, trial, nst, k, &count) < 0) continue;
      const int cost = (k ? 10 : 1) * ((count + 31) / 32) + team_cost(p, trial, nst + 1);
      if (best < 0 || cost < best_cost) {
        best = k;
        best_cost = cost;
      }
    }
    if (best < 0) return -1;  // nothing ready: the dependencies form a cycle
    kind[nst] = team_fill(p, stage, nst, best, &count);
    placed += count;
  }
  for (int i = 0; i < n; i++) {
    last_use[i] = stage[i];
    for (int j = i + 1; j < n; j++)
      if ((p.a[j] == nf + i || p.b[j] == nf + i) && stage[j] > last_use[i]) last_use[i] = stage[j];
  }
  // slots: a temporary takes the lowest slot whose last value was last read
  // in an earlier stage
  static int busy_until[1 << TEAM_SLOT_BITS];
  for (int k = 0; k < (1 << TEAM_SLOT_BITS); k++) busy_until[k] = -1;
  int nslots = nf;
  for (int s = 0; s < nst; s++) {
    for (int i = 0; i < n; i++) {
      if (stage[i] != s) continue;
      if (p.out_fixed[i] >= 0) {
        slot[i] = p.out_fixed[i];
        continue;
      }
      int k = nf;
      while (k < (1 << TEAM_SLOT_BITS) && busy_until[k] >= s) k++;
      if (k >= (1 << TEAM_SLOT_BITS)) return -1;
      slot[i] = k;
      busy_until[k] = last_use[i];
      if (k + 1 > nslots) nslots = k + 1;
    }
  }
  // the table, stage by stage, operations in program order within a stage
  int m = 0;
  for (int s = 0; s < nst; s++) {
    const int first = m;
    for (int i = 0; i < n; i++) {
      if (stage[i] != s) continue;
      const int sa = p.a[i] < nf ? p.a[i] : slot[p.a[i] - nf];
      const int sb = p.b[i] < nf ? p.b[i] : slot[p.b[i] - nf];
      t.op[m++] = (u32)sa | ((u32)sb << TEAM_SLOT_BITS) | ((u32)slot[i] << (2 * TEAM_SLOT_BITS)) |
                  ((u32)p.sub[i] << 30) | ((u32)p.sel[i] << 31);
    }
    t.stage[s] = (u32)first | ((u32)(m - first) << 16) | ((u32)kind[s] << 31);
  }
  t.nops = n;
  t.nstages = nst;
  t.nslots = nslots;
  t.nfixed = nf;
  return 0;
}

// The programs a table can hold.
enum {
  TEAM_LADDER_STEP = 0,
  TEAM_WSUM_SCAN = 1,
  TEAM_WSUM_STEP = 2,
  TEAM_WSUM_ADD = 3,
  TEAM_PAIR_ADD = 4,
  TEAM_MASKED_ADD = 5
};

template <class TC>
static void team_record(TeamProg& p, int program) {
  if (program == TEAM_LADDER_STEP)
    team_step<TC>(p, 0, 1);
  else if (program == TEAM_WSUM_SCAN)
    team_scan<TC>(p);
  else if (program == TEAM_WSUM_STEP)
    team_step<TC>(p, WS_ACC, WS_RUN);
  else if (program == TEAM_WSUM_ADD)
    team_add_opd<TC>(p);
  else if (program == TEAM_PAIR_ADD)
    team_pair_add<TC>(p);
  else
    team_masked_add<TC>(p);
}

// The table of `program` for the group with nc components (1: G1, 2: G2);
// 0, or -1 if the program does not fit.
static int team_table(TeamTable& t, int nc, int program) {
  static TeamProg p;  // large: kept off the stack
  if ((nc != 1 && nc != 2) || program < TEAM_LADDER_STEP || program > TEAM_MASKED_ADD) return -1;
  const int npts = program == TEAM_LADDER_STEP ? LADDER_NPTS
                   : program >= TEAM_PAIR_ADD  ? PAIR_NPTS
                                               : WS_NPTS;
  p.init(TEAM_NFIXED(nc, npts));
  if (nc == 1)
    team_record<TeamFq>(p, program);
  else
    team_record<TeamFq2>(p, program);
  if (p.bad) return -1;
  return team_schedule(p, t);
}

// The table of `program` for group nc, built at its first use and kept for
// the process; null if it does not fit.
static const TeamTable* team_table_once(int nc, int program) {
  static TeamTable tables[TEAM_MASKED_ADD + 1][2];
  static int state[TEAM_MASKED_ADD + 1][2];  // 0: not built, 1: built, -1: failed
  if ((nc != 1 && nc != 2) || program < TEAM_LADDER_STEP || program > TEAM_MASKED_ADD) return nullptr;
  int& st = state[program][nc - 1];
  if (st == 0) st = team_table(tables[program][nc - 1], nc, program) == 0 ? 1 : -1;
  return st == 1 ? &tables[program][nc - 1] : nullptr;
}
