// CPU build of the kernels' per-lane bodies (fp.cuh, fp2.cuh, ec.cuh compile
// as plain C++): the same arithmetic the CUDA kernels run, looped over lanes,
// with the same C interface minus the stream.  tests/test_torch_csrc.py
// builds this with the host compiler and holds it against the plain PyTorch
// versions, so the field and group code is checked where there is no GPU.
#include <vector>

#include "ec_team.cuh"

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

// The team kernels (ladder_team.cu, wsum_team.cu, chain_team.cu,
// fold_team.cu) on the CPU: the same
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

extern "C" {

int host_mont_mul(const int* a, const int* b, int* out, int nlimbs, long m) {
  for (long lane = 0; lane < m; lane++) {
    if (nlimbs == 24)
      lane_mont_mul<FqParams>(a, b, out, m, lane);
    else if (nlimbs == 16)
      lane_mont_mul<FrParams>(a, b, out, m, lane);
    else
      return -1;
  }
  return 0;
}

// Row-major product of (n, nlimbs) arrays; b is one element when shared_b.
int host_mont_mul_rm(const int* a, const int* b, int* out, int nlimbs, long n, int shared_b) {
  for (long lane = 0; lane < n; lane++) {
    if (nlimbs == 24)
      lane_mont_mul_rm<FqParams>(a, b, out, lane, shared_b != 0);
    else if (nlimbs == 16)
      lane_mont_mul_rm<FrParams>(a, b, out, lane, shared_b != 0);
    else
      return -1;
  }
  return 0;
}

// K chained products on (G, nlimbs, L); wide = 0 needs G = 6.  The plain
// chain on (nlimbs, L) is G = 1, wide = 1.
int host_mont_chain_group(const int* a, const int* b, int* out, int nlimbs, int G, long L,
                          int K, int wide, int inline_body) {
  if (!wide && G != 6) return -1;
  if (nlimbs == 24)
    host_chain<FqParams>(a, b, out, G, L, K, wide, inline_body);
  else if (nlimbs == 16)
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

// The table of a team program (ec_team.cuh: 0 the ladder step, 1-3 the
// weighted sum's scan step, ladder step and add, 4 the pair add) for a group: dims =
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
}
