// CPU build of the kernels' per-lane bodies (fp.cuh, fp2.cuh, ec.cuh compile
// as plain C++): the same arithmetic the CUDA kernels run, looped over lanes,
// with the same C interface minus the stream.  tests/test_torch_csrc.py
// builds this with the host compiler and holds it against the plain PyTorch
// versions, so the field and group code is checked where there is no GPU.
#include <algorithm>
#include <vector>

#include "ec_team.cuh"
#include "mont_rm.cuh"
#include "sumcheck.cuh"

// Run the statement given (it names the policy C) for the group `ncomp` names.
#define FOR_GROUP(...)                          \
  do {                                          \
    if (ncomp == 1) {                           \
      typedef FqCoord C;                        \
      __VA_ARGS__;                              \
    } else if (ncomp == 2) {                    \
      typedef Fq2Coord C;                       \
      __VA_ARGS__;                              \
    } else {                                    \
      return -1;                                \
    }                                           \
    return 0;                                   \
  } while (0)

template <class F>
static void host_chain(const int* a, const int* b, int* out, int G, long L, int K, int wide,
                       int inline_body) {
  if (wide) {
    for (long t = 0; t < G * L; t++) {
      if (inline_body)
        lane_mont_chain<F, true>(a, b, out, L, t / L, t % L, K);
      else
        lane_mont_chain<F, false>(a, b, out, L, t / L, t % L, K);
    }
  } else {
    for (long lane = 0; lane < L; lane++) {
      if (inline_body)
        lane_mont_chain_seq<F, true, 6>(a, b, out, L, lane, K);
      else
        lane_mont_chain_seq<F, false, 6>(a, b, out, L, lane, K);
    }
  }
}

// k_mont_mul_rm (mont_mul_rm.cu) on the CPU: block after block, each with
// its two stages as a plain array, the threads of a phase as a loop and the
// barriers between phases as the ends of those loops; grid 0 runs
// k_mont_mul_rm_narrow's body.
template <class F, bool SHARED>
static int host_rm(const int* a, const int* b, int* out, long n, long grid) {
  constexpr int STAGE = RmStage<F, SHARED>::CHUNKS;
  const long ntiles = (n + RM_TPB - 1) / RM_TPB;
  if (n <= 0) return 0;
  if (grid == 0) {
    const long lanes = (n + RM_NARROW_TPB - 1) / RM_NARROW_TPB * RM_NARROW_TPB;
    for (long lane = 0; lane < lanes; lane++) rm_lane<F, SHARED>(a, b, out, n, lane);
    return 0;
  }
  if (grid < 0 || grid > ntiles) return -2;
  u32 y[F::N];
  if (SHARED) fp_load_row<F>(y, b);
  for (long block = 0; block < grid; block++) {
    std::vector<Limb4> smem(2 * STAGE, Limb4{0, 0, 0, 0});
    long tile = block;
    for (int tid = 0; tid < RM_TPB; tid++) rm_issue<F, SHARED>(smem.data(), a, b, n, tile, tid);
    for (int it = 0; tile < ntiles; tile += grid, it++) {
      Limb4* cur = smem.data() + (it & 1) * STAGE;
      const long next = tile + grid;
      if (next < ntiles)
        for (int tid = 0; tid < RM_TPB; tid++)
          rm_issue<F, SHARED>(smem.data() + ((it + 1) & 1) * STAGE, a, b, n, next, tid);
      for (int tid = 0; tid < RM_TPB; tid++) rm_row_mul<F, SHARED>(cur, y, tid);
      for (int tid = 0; tid < RM_TPB; tid++) rm_drain<F>(out, cur, n, tile, tid);
    }
  }
  return 0;
}

// The team kernels (ladder_team.cu, wsum_team.cu, chain_team.cu,
// fold_team.cu, fixed_base_team.cu) on the CPU: the same
// tables and the same lane and per-rank functions, each stage's operations
// run one rank after another (T at a time, as the kernels' sub-rounds),
// lane by lane.
template <class C>
static int host_team(const int* pts, const int* scal, int* out, int nl, long L) {
  constexpr int NC = C::COMP_ROWS / (2 * FQN);
  static TeamTable tab;
  if (team_table(tab, NC, TEAM_LADDER_STEP) != 0) return -2;
  std::vector<u32> region((std::size_t)tab.nslots * FQN);
  const TeamCode step = {tab.op, tab.stage, tab.nstages};
  for (long lane = 0; lane < L; lane++)
    lane_ladder_team<C, TEAM_T(NC)>(region.data(), tab.nslots, step, pts, scal, out, nl, L, lane, 0);
  return 0;
}

// The wide ladder of ladder_wide.cu: every position of the order by the
// kernel's team body, one after another.
template <class C>
static int host_ladder_wide_impl(const int* pts, const int* scal, const int* order, int* out,
                                 int nl, long L) {
  constexpr int NC = C::COMP_ROWS / (2 * FQN);
  const TeamTable* s = team_table_once(NC, TEAM_LADDER_STEP);
  const TeamTable* d = team_table_once(NC, TEAM_LADDER_DOUBLE);
  if (!s || !d) return -2;
  const int ns = s->nslots > d->nslots ? s->nslots : d->nslots;
  std::vector<u32> region((std::size_t)ns * FQN);
  const TeamCode step = {s->op, s->stage, s->nstages}, dbl = {d->op, d->stage, d->nstages};
  for (long i = 0; i < L; i++)
    lane_ladder_wide_team<C, WIDE_T(NC)>(region.data(), ns, step, dbl, pts, scal, order, out, nl,
                                         L, i, 0);
  return 0;
}

template <class C>
static int host_wsum(const int* buckets, int* out, int W, int c, bool plus_one) {
  constexpr int NC = C::COMP_ROWS / (2 * FQN);
  static TeamTable tab[3];
  TeamCode code[3];
  int ns = 0;
  for (int k = 0; k < 3; k++) {
    if (team_table(tab[k], NC, TEAM_WSUM_SCAN + k) != 0) return -2;
    code[k] = {tab[k].op, tab[k].stage, tab[k].nstages};
    if (tab[k].nslots > ns) ns = tab[k].nslots;
  }
  const long L = WSUM_LANES(W, c);
  std::vector<u32> region((std::size_t)ns * FQN);
  for (long lane = 0; lane < L; lane++)
    lane_wsum_team<C, WSUM_T(NC)>(region.data(), ns, code, buckets, out, W, c, plus_one, lane, 0);
  return 0;
}

template <class C>
static int host_chain_team_impl(const int* base, int* out, long N, int B) {
  constexpr int NC = C::COMP_ROWS / (2 * FQN);
  const TeamTable* tab = team_table_once(NC, TEAM_PAIR_ADD);
  if (!tab) return -2;
  std::vector<u32> region((std::size_t)tab->nslots * FQN);
  const TeamCode add = {tab->op, tab->stage, tab->nstages};
  for (long lane = 0; lane < N; lane++)
    lane_chain_team<C, CHAIN_T(NC)>(region.data(), tab->nslots, add, base, out, N, B, lane, 0);
  return 0;
}

// One block of one team a segment, the segments in turn: the team takes
// every pair of a level in order.
template <class C>
static int host_fold_team_impl(const int* a, long L, const int* seg, int S, int max_len,
                               int* scratch, int* out) {
  constexpr int NC = C::COMP_ROWS / (2 * FQN);
  const TeamTable* tab = team_table_once(NC, TEAM_PAIR_ADD);
  if (!tab) return -2;
  std::vector<u32> region((std::size_t)tab->nslots * FQN);
  const TeamCode add = {tab->op, tab->stage, tab->nstages};
  for (long s = 0; s < S; s++)
    block_fold_team<C, FOLD_T(NC)>(region.data(), tab->nslots, add, a, L,
                                   seg ? seg[s] : s * max_len, seg ? seg[S + s] : max_len,
                                   scratch, (max_len + 1) / 2, out, S, s, 0, 1, 0);
  return 0;
}

// The team kernel of fixed_base_team.cu: each lane in turn.
template <class C>
static int host_fixed_base_team_impl(const int* table, const int* scal, int* out, long N, int nl) {
  constexpr int NC = C::COMP_ROWS / (2 * FQN);
  const TeamTable* tab = team_table_once(NC, TEAM_MASKED_ADD);
  if (!tab) return -2;
  std::vector<u32> region((std::size_t)tab->nslots * FQN);
  const TeamCode add = {tab->op, tab->stage, tab->nstages};
  for (long lane = 0; lane < N; lane++)
    lane_fixed_base_team<C, FIXED_T(NC)>(region.data(), tab->nslots, add, table, scal, out, N,
                                         nl, lane, 0);
  return 0;
}

// k_sumcheck_round (sumcheck_round.cu) on the CPU: each block row's blocks
// in turn, each walking its tiles of P pairs as the kernel does, with its
// shared memory as a plain array, the threads of a phase as a loop and the
// barriers between phases as the ends of those loops.  A block's shared
// memory starts with poison limbs (on the card it starts with whatever it
// held), so that a stale row that reached a store or a sum would show.  A
// block's partial for point pt sums the accumulators of threads pt TC .. pt
// TC + TC - 1.
template <int KIND, int P>
static void host_round_tiled(const int* src, int* dst, const int* r_row, int* partials, long n,
                             int fold, int kp, int ks, int nblocks) {
  constexpr int NP = ScKind<KIND>::NPTS;
  typedef ScTile<KIND, P> G;
  const long pairs = sc_pairs(n, fold);
  const int PT = sc_tile_pairs(P, fold), TC = sc_comb_threads<KIND, G::TPB>(PT);
  u32 r[FRN] = {0};
  if (fold) fp_load_row<Fr>(r, r_row);
  std::vector<Limb4> smem(G::SMEM / 16);
  std::vector<u32> acc((std::size_t)G::TPB * FRN);
  for (int y = 0; y < sc_rows<KIND>(kp, ks, fold); y++) {
    const ScRow row = sc_row<KIND>(y, kp, ks, n, fold);
    for (int b = 0; b < nblocks; b++) {
      std::fill(smem.begin(), smem.end(), Limb4{0x7a5c, 0x13f1, 0x5e0d, 0x0b6a});
      std::fill(acc.begin(), acc.end(), 0u);
      for (long tile = b; tile * PT < pairs; tile += nblocks) {
        for (int tid = 0; tid < G::TPB; tid++)
          sc_load<KIND, P>(smem.data(), dst, src, r, n, tile * PT, pairs, fold, row, tid);
        if (row.eval)
          for (int tid = 0; tid < G::TPB; tid++)
            sc_comb_item<KIND, P, G::TPB>(&acc[(std::size_t)tid * FRN], smem.data(), tile * PT,
                                          pairs, fold, tid);
      }
      if (y >= sc_instances<KIND>(kp, ks)) continue;
      for (int pt = 0; pt < NP; pt++) {
        u32 sum[FRN] = {0};
        for (int tid = pt * TC; tid < (pt + 1) * TC; tid++)
          fp_add<Fr>(sum, sum, &acc[(std::size_t)tid * FRN]);
        fp_store_row<Fr>(partials + (((long)y * nblocks + b) * NP + pt) * FR_ROW, sum);
      }
    }
  }
}

// k_sumcheck_round_straight (no fold) on the CPU: each block's threads over
// their grid-stride pairs.
template <int KIND>
static void host_round_straight(const int* src, int* partials, long n, int kp, int ks,
                                int nblocks) {
  constexpr int NP = ScKind<KIND>::NPTS, T = sc_straight_tpb<KIND>();
  for (int y = 0; y < sc_instances<KIND>(kp, ks); y++) {
    const ScRow row = sc_row<KIND>(y, kp, ks, n, false);
    for (int b = 0; b < nblocks; b++) {
      u32 sums[NP][FRN] = {};
      for (int tid = 0; tid < T; tid++)
        for (long p = (long)b * T + tid; p < n / 2; p += (long)nblocks * T)
          sc_pair_straight<KIND>(sums, src, n, p, row);
      for (int pt = 0; pt < NP; pt++)
        fp_store_row<Fr>(partials + (((long)y * nblocks + b) * NP + pt) * FR_ROW, sums[pt]);
    }
  }
}

// The round of `kind` in form `form` (an SC_TILED_* or SC_STRAIGHT).
template <int KIND>
static void host_round(const int* src, int* dst, const int* r, int* partials, long n, int fold,
                       int kp, int ks, int nblocks, int form) {
  if (form == SC_STRAIGHT)
    host_round_straight<KIND>(src, partials, n, kp, ks, nblocks);
  else if (form == SC_TILED_SMALL)
    host_round_tiled<KIND, ScKind<KIND>::P_SMALL>(src, dst, r, partials, n, fold, kp, ks, nblocks);
  else
    host_round_tiled<KIND, ScKind<KIND>::P_LARGE>(src, dst, r, partials, n, fold, kp, ks, nblocks);
}

// k_sumcheck_tail (sumcheck_tail.cu) on one thread: the sums in order, the
// sponge's three elements in an array.
template <class S, int NPTS>
static void host_tail(const int* partials, const int* inst_coeffs, const int* e_in,
                      const int* state_in, int* coeffs_out, int* r_out, int* e_out, int* state_out,
                      int k, int nblocks, int mode, int index) {
  u32 ev[NPTS][FRN] = {}, cf[FRN], v[FRN];
  for (int i = 0; i < k; i++) {
    u32 s[NPTS][FRN] = {};
    for (int b = 0; b < nblocks; b++)
      for (int pt = 0; pt < NPTS; pt++) {
        fp_load_row<Fr>(v, partials + (((long)i * nblocks + b) * NPTS + pt) * FR_ROW);
        fp_add<Fr>(s[pt], s[pt], v);
      }
    fp_load_row<Fr>(cf, inst_coeffs + (long)i * FR_ROW);
    for (int pt = 0; pt < NPTS; pt++) {
      fp_mul_inline<Fr>(s[pt], s[pt], cf);
      fp_add<Fr>(ev[pt], ev[pt], s[pt]);
    }
  }
  HostSponge<S> sp;
  for (int j = 0; j < POS_T; j++) fp_load_row<S>(sp.s[j], state_in + j * 2 * S::N);
  u32 c[NPTS + 1][FRN], r[FRN], e[FRN];
  fp_load_row<Fr>(e, e_in);
  sc_tail_round<S, NPTS>(sp, c, r, e, ev, mode, index);
  for (int j = 0; j < POS_T; j++) fp_store_row<S>(state_out + j * 2 * S::N, sp.s[j]);
  for (int j = 0; j <= NPTS; j++) fp_store_row<Fr>(coeffs_out + j * FR_ROW, c[j]);
  fp_store_row<Fr>(r_out, r);
  fp_store_row<Fr>(e_out, e);
}

extern "C" {

int host_mont_mul(const int* a, const int* b, int* out, int field, long m) {
  if (field != FIELD_FQ && field != FIELD_FR && field != FIELD_FR381) return -1;
  for (long lane = 0; lane < m; lane++) {
    if (field == FIELD_FQ)
      lane_mont_mul<FqParams>(a, b, out, m, lane);
    else if (field == FIELD_FR)
      lane_mont_mul<FrParams>(a, b, out, m, lane);
    else
      lane_mont_mul<Fr381Params>(a, b, out, m, lane);
  }
  return 0;
}

// Row-major product of (n, nlimbs) arrays of the field `field` (a FieldId),
// b one element when shared_b: the tiled form on `grid` blocks (1 .. the
// tiles) that walk the tiles as k_mont_mul_rm does, or with grid 0 the
// narrow form's body on every lane of its blocks.
int host_mont_mul_rm(const int* a, const int* b, int* out, int field, long n, int shared_b,
                     long grid) {
  switch (field) {
    case FIELD_FQ761:  // the narrow form only, as the launcher
      if (grid != 0) return -2;
      return shared_b ? host_rm<Fq761Params, true>(a, b, out, n, 0)
                      : host_rm<Fq761Params, false>(a, b, out, n, 0);
    case FIELD_FQ:
      return shared_b ? host_rm<FqParams, true>(a, b, out, n, grid)
                      : host_rm<FqParams, false>(a, b, out, n, grid);
    case FIELD_FR:
      return shared_b ? host_rm<FrParams, true>(a, b, out, n, grid)
                      : host_rm<FrParams, false>(a, b, out, n, grid);
    case FIELD_FR381:
      return shared_b ? host_rm<Fr381Params, true>(a, b, out, n, grid)
                      : host_rm<Fr381Params, false>(a, b, out, n, grid);
    default:
      return -1;
  }
}

// Slot of chunk k of row r in a staged tile of the row-major kernel (the
// layout follows the row's width: Fq's 6 chunks, or 4 for either Fr).
int host_rm_slot(int field, int r, int k) {
  return field == FIELD_FQ ? rm_slot<FqParams>(r, k) : rm_slot<FrParams>(r, k);
}

// K chained products on (G, nlimbs, L); wide = 0 needs G = 6.  The plain
// chain on (nlimbs, L) is G = 1, wide = 1, the only form of BW6-761's Fq and
// BLS12-381's Fr.
int host_mont_chain_group(const int* a, const int* b, int* out, int field, int G, long L,
                          int K, int wide, int inline_body) {
  if (!wide && G != 6) return -1;
  const bool single = G == 1 && wide;
  if (field == FIELD_FQ761 && single)
    host_chain<Fq761Params>(a, b, out, G, L, K, wide, inline_body);
  else if (field == FIELD_FR381 && single)
    host_chain<Fr381Params>(a, b, out, G, L, K, wide, inline_body);
  else if (field == FIELD_FQ)
    host_chain<FqParams>(a, b, out, G, L, K, wide, inline_body);
  else if (field == FIELD_FR)
    host_chain<FrParams>(a, b, out, G, L, K, wide, inline_body);
  else
    return -1;
  return 0;
}

// Fq2 product and b3 multiple of lane `lane` of (48, m) arrays (c0 rows,
// then c1 rows); out_b3 = b3 * a.
int host_fp2_mul(const int* a, const int* b, int* out, int* out_b3, long m) {
  for (long lane = 0; lane < m; lane++) {
    Fq2 x, y, r;
    fp2_load(x, a, m, lane, 0);
    fp2_load(y, b, m, lane, 0);
    fp2_mul(r, x, y);
    fp2_store(out, m, lane, 0, r);
    fp2_mul_b3(x, x);
    fp2_store(out_b3, m, lane, 0, x);
  }
  return 0;
}

int host_add2(const int* a, const int* b, int* out, long L, int ncomp) {
  FOR_GROUP(for (long lane = 0; lane < L; lane++) lane_add2<C>(a, b, out, L, lane));
}

int host_add_mask(const int* acc, const int* pts, const int* mask, int* out, long L,
                  int shared, int ncomp) {
  FOR_GROUP(for (long lane = 0; lane < L; lane++)
                lane_add_mask<C>(acc, pts, mask, out, L, shared != 0, lane));
}

int host_step(const int* acc, const int* base, const int* mask, int* out_acc,
              int* out_base, long L, int ncomp) {
  FOR_GROUP(for (long lane = 0; lane < L; lane++)
                lane_step<C>(acc, base, mask, out_acc, out_base, L, lane));
}

int host_scan2(const int* run, const int* tot, const int* bl, int* out_run,
               int* out_tot, long L, int ncomp) {
  FOR_GROUP(for (long lane = 0; lane < L; lane++)
                lane_scan2<C>(run, tot, bl, out_run, out_tot, L, lane));
}

int host_scan2b(const int* run, const int* tot, const int* bl, int* out_run,
                int* out_tot, long L, int ncomp) {
  FOR_GROUP(for (long lane = 0; lane < L; lane++)
                lane_scan2b<C>(run, tot, bl, out_run, out_tot, L, lane));
}

int host_ladder(const int* pts, const int* scal, int* out, int nl, long L, int ncomp) {
  FOR_GROUP(for (long lane = 0; lane < L; lane++)
                lane_ladder<C>(pts, scal, out, nl, L, lane));
}

int host_ladder_team(const int* pts, const int* scal, int* out, int nl, long L, int ncomp) {
  if (ncomp == 1) return host_team<FqCoord>(pts, scal, out, nl, L);
  if (ncomp == 2) return host_team<Fq2Coord>(pts, scal, out, nl, L);
  return -1;
}

// The wide ladder: order null or a permutation of the L lanes;
// warp_of_one runs each lane as a warp of its own (its skips and its stop
// at its top bit its own), else as in a warp where another lane needs every
// step.
int host_ladder_wide(const int* pts, const int* scal, const int* order, int* out, int nl, long L,
                     int warp_of_one, int ncomp) {
  if (ncomp != 1 && ncomp != 2) return -1;
  host_warp_of_one = warp_of_one != 0;
  const int rc = ncomp == 1 ? host_ladder_wide_impl<FqCoord>(pts, scal, order, out, nl, L)
                            : host_ladder_wide_impl<Fq2Coord>(pts, scal, order, out, nl, L);
  host_warp_of_one = false;
  return rc;
}

// Per-group weighted sums of (rows, W 2^c) buckets into (rows, W groups),
// as wsum_team.cu.
int host_wsum_team(const int* buckets, int* out, int W, int c, int plus_one, int ncomp) {
  if (W <= 0 || c < 0 || c > 24) return -3;
  if (ncomp == 1) return host_wsum<FqCoord>(buckets, out, W, c, plus_one != 0);
  if (ncomp == 2) return host_wsum<Fq2Coord>(buckets, out, W, c, plus_one != 0);
  return -1;
}

// The commit's table of multiples, as chain_team.cu: point-major bases (N,
// rows) -> point-major (N B, rows).
int host_chain_team(const int* base, int* out, long N, int B, int ncomp) {
  if (B < 1 || B > (1 << 16)) return -3;
  if (ncomp == 1) return host_chain_team_impl<FqCoord>(base, out, N, B);
  if (ncomp == 2) return host_chain_team_impl<Fq2Coord>(base, out, N, B);
  return -1;
}

// The pairwise folds of S segments, as fold_team.cu (its arguments and
// return codes).
int host_fold_team(const int* a, long L, const int* seg, int S, int max_len, int* scratch,
                   int* out, int ncomp) {
  if (ncomp != 1 && ncomp != 2) return -1;
  if (S < 1 || max_len < 1) return -3;
  if (ncomp == 1) return host_fold_team_impl<FqCoord>(a, L, seg, S, max_len, scratch, out);
  return host_fold_team_impl<Fq2Coord>(a, L, seg, S, max_len, scratch, out);
}

// The fixed-base multiplication of fixed_base_team.cu: packed (rows, 16 nl)
// table of doublings, (N, nl) scalar limbs -> packed (rows, N); the team
// kernel's lanes or, `one`, the one-thread kernel's.
int host_fixed_base(const int* table, const int* scal, int* out, long N, int nl, int one,
                    int ncomp) {
  if (ncomp != 1 && ncomp != 2) return -1;
  if (nl < 1 || nl > 16) return -3;
  if (one) {
    FOR_GROUP(for (long lane = 0; lane < N; lane++)
                  lane_fixed_base<C>(table, scal, out, N, nl, lane));
  }
  if (ncomp == 1) return host_fixed_base_team_impl<FqCoord>(table, scal, out, N, nl);
  return host_fixed_base_team_impl<Fq2Coord>(table, scal, out, N, nl);
}

// The table of a team program (ec_team.cuh: 0 the ladder step, 1-3 the
// weighted sum's scan step, ladder step and add, 4 the pair add, 5 the
// masked add, 6 the ladder's doubling alone) for a group: dims =
// (nops, nstages, nslots, nfixed), ops and stages as the kernels receive
// them (room for TEAM_MAX_OPS and TEAM_MAX_STAGES words).
int host_team_program(int ncomp, int program, u32* ops, u32* stages, int* dims) {
  TeamTable tab;
  if (team_table(tab, ncomp, program) != 0) return -1;
  for (int i = 0; i < tab.nops; i++) ops[i] = tab.op[i];
  for (int s = 0; s < tab.nstages; s++) stages[s] = tab.stage[s];
  dims[0] = tab.nops;
  dims[1] = tab.nstages;
  dims[2] = tab.nslots;
  dims[3] = tab.nfixed;
  return 0;
}

// The team ladder's table for a group.
int host_team_table(int ncomp, u32* ops, u32* stages, int* dims) {
  return host_team_program(ncomp, TEAM_LADDER_STEP, ops, stages, dims);
}

// The bucket kernel's schedule run by one "warp" at a time: take the next 32
// entries of perm from the counter *next, run their lanes, until none are
// left.
int host_bucket(const int* table, const int* idx, const int* start, const int* count,
                const int* perm, int* next, int* out, long L, int mixed, int ncomp) {
  FOR_GROUP(for (long first = *next; first < L; first = *next) {
    *next += 32;
    for (long i = first; i < first + 32 && i < L; i++) {
      if (mixed)
        lane_bucket<C, true>(table, idx, start, count, out, L, perm[i]);
      else
        lane_bucket<C, false>(table, idx, start, count, out, L, perm[i]);
    }
  });
}

// Poseidon permutations of (nstates, 3, nlimbs) states of the field `field`
// (FIELD_FR or FIELD_FQ), as poseidon.cu.
int host_poseidon_permute(const int* in, int* out, int field, long nstates) {
  if (field != FIELD_FR && field != FIELD_FQ) return -1;
  const int nlimbs = field == FIELD_FR ? 16 : 24;
  for (long st = 0; st < nstates; st++) {
    const long off = st * POS_T * nlimbs;
    if (field == FIELD_FR) {
      u32 s[POS_T][8];
      for (int e = 0; e < POS_T; e++) fp_load_row<FrParams>(s[e], in + off + e * nlimbs);
      pos_permute_host<FrParams>(s);
      for (int e = 0; e < POS_T; e++) fp_store_row<FrParams>(out + off + e * nlimbs, s[e]);
    } else {
      u32 s[POS_T][12];
      for (int e = 0; e < POS_T; e++) fp_load_row<FqParams>(s[e], in + off + e * nlimbs);
      pos_permute_host<FqParams>(s);
      for (int e = 0; e < POS_T; e++) fp_store_row<FqParams>(out + off + e * nlimbs, s[e]);
    }
  }
  return 0;
}

// One round of the fused sumcheck, as sumcheck_round.cu (its arguments and
// return codes), in the form the launcher takes for the shape (form -1), or
// in form `form` (SC_TILED_LARGE, SC_TILED_SMALL, or SC_STRAIGHT without a
// fold) whatever the shape.
int host_sumcheck_round(const int* src, int* dst, const int* r, int* partials, int kind, long n,
                        int fold, int k_par, int k_seq, int nblocks, int form) {
  if (n < 2 || (n & (n - 1)) || nblocks < 1 || k_par < 0 || k_seq < 0 ||
      (kind == SC_CUBIC && k_par + k_seq < 1) || form < -1 || form > SC_STRAIGHT ||
      (form == SC_STRAIGHT && fold))
    return -3;
  if (kind == SC_QUAD)
    host_round<SC_QUAD>(src, dst, r, partials, n, fold, k_par, k_seq, nblocks,
                             form < 0 ? sc_form<SC_QUAD>(n, fold) : form);
  else if (kind == SC_CUBIC_TAU)
    host_round<SC_CUBIC_TAU>(src, dst, r, partials, n, fold, k_par, k_seq, nblocks,
                                  form < 0 ? sc_form<SC_CUBIC_TAU>(n, fold) : form);
  else if (kind == SC_CUBIC)
    host_round<SC_CUBIC>(src, dst, r, partials, n, fold, k_par, k_seq, nblocks,
                              form < 0 ? sc_form<SC_CUBIC>(n, fold) : form);
  else
    return -1;
  return 0;
}

// The tail of a round, as sumcheck_tail.cu (its arguments and return codes).
int host_sumcheck_tail(const int* partials, const int* inst_coeffs, const int* e_in,
                       const int* state_in, int* coeffs_out, int* r_out, int* e_out,
                       int* state_out, int npts, int k, int nblocks, int sponge_field, int mode,
                       int index) {
  if ((npts != 2 && npts != 3) || k < 1 || nblocks < 1 || (mode != 0 && mode != 1) ||
      index < 0 || index > POS_RATE)
    return -3;
#define TAIL(S, P)                                                                         \
  host_tail<S, P>(partials, inst_coeffs, e_in, state_in, coeffs_out, r_out, e_out, state_out, \
                  k, nblocks, mode, index)
  if (sponge_field == FIELD_FR) {
    if (npts == 2) TAIL(FrParams, 2); else TAIL(FrParams, 3);
  } else if (sponge_field == FIELD_FQ) {
    if (npts == 2) TAIL(FqParams, 2); else TAIL(FqParams, 3);
  } else {
    return -1;
  }
#undef TAIL
  return 0;
}
}
