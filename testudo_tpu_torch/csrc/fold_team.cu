// K11: the pairwise folds of every path, all segments of a batch in one
// launch, each pair worked by a TEAM of threads of one warp (FOLD_T: 8 for
// G1, 16 for G2) and each segment by one block of teams, for G1 (ncomp 1)
// and G2 (ncomp 2).
//
// Replaces testudo_tpu/tpu/pallas_curve.py:415 `_ec_call("add2")` as
// pallas_curve.py:717-730 `tree_reduce` drives it (and the same halvings
// in testudo_tpu/tpu/msm.py: the weighted sum's fold of the groups, the
// multi-MSM's Horner fold over the windows): log2 n dependent `add2`
// launches at ever smaller widths, with the host loop between them
// (device/msm.py carried that over: 12 launches a warm MSM, 5 a commit, 192
// an open).  Here one block reduces one segment level by level in one
// launch: `block_fold_team` (ec_team.cuh) says what it computes; the pairs,
// their order and the odd level's carry are those of `tree_reduce`, so its
// limbs are the launches'.
//
// Bound on this card: latency.  A segment is a tree of ceil(log2 n) levels
// of independent complete adds, and a level's few pairs would be a few
// threads of one thread a pair.  So each pair has a team (rank r runs
// operation r of every stage of the add's table, 2 rounds of products for
// G1 and 3 for G2) and a block holds up to FOLD_TEAMS teams, fewer where a
// launch has many segments, the segments are narrower or the shared memory
// is short (ec_team.cuh); the teams take a level's pairs a round at a time.  A level's sums go to the segment's
// scratch in device memory (two halves, point-major, alternating), read by
// other teams at the next level after a block sync.  A team without a pair
// in a round clamps its loads, runs the stages and skips its store, so
// every thread reaches every sync; no branch encloses a product except the
// stage's kind, the same for the whole warp.  A segment of any width takes
// one block; the paths' segments have at most 1,024 points.
#include "ec_team.cuh"
#include "launch.cuh"

#define TPB_FOLD_MAX 512

template <class C, int T>
__global__ void __launch_bounds__(TPB_FOLD_MAX)
k_fold_team(const int* a, long L, const int* seg, int S, int max_len, int* scratch, int* out,
            TeamTable tab) {
  extern __shared__ u32 smem[];
  u32* ops = smem;
  u32* stages = smem + tab.nops;
  for (int i = threadIdx.x; i < tab.nops; i += blockDim.x) ops[i] = tab.op[i];
  for (int i = threadIdx.x; i < tab.nstages; i += blockDim.x) stages[i] = tab.stage[i];
  __syncthreads();
  const int ns = tab.nslots;
  const int team = threadIdx.x / T;
  u32* region = smem + tab.nops + tab.nstages + team * ns * FQN;
  const long s = blockIdx.x;
  const long off = seg ? seg[s] : s * max_len;
  const int n = seg ? seg[S + s] : max_len;
  block_fold_team<C, T>(region, ns, TeamCode{ops, stages, tab.nstages}, a, L, off, n, scratch,
                        (max_len + 1) / 2, out, S, s, team, blockDim.x / T, threadIdx.x % T);
}

// Launch at team size T with at most `teams` teams a block (the production
// launcher below picks them as ec_team.cuh says; a measurement may pick
// others): no more than the widest segment's pairs, nor than fit the card's
// shared memory.  -2 if the table is missing, -3 for a block that cannot be.
template <class C, int T>
static int fold_launch(const int* a, long L, const int* seg, int S, int max_len, int* scratch,
                       int* out, int teams, cudaStream_t st) {
  static_assert(32 % T == 0, "a team must not span warps");
  constexpr int NC = C::COMP_ROWS / (2 * FQN);
  const TeamTable* tab = team_table_once(NC, TEAM_PAIR_ADD);
  if (!tab) return -2;
  const size_t table_bytes = sizeof(u32) * ((size_t)tab->nops + tab->nstages);
  const size_t team_bytes = sizeof(u32) * (size_t)tab->nslots * FQN;
  const size_t room = smem_block_max();
  const int half_max = (max_len + 1) / 2;
  if (teams > half_max) teams = half_max;
  if (teams > TPB_FOLD_MAX / T) teams = TPB_FOLD_MAX / T;
  if (room > table_bytes && (size_t)teams * team_bytes > room - table_bytes)
    teams = (int)((room - table_bytes) / team_bytes);
  if (teams < 1) return -3;
  const size_t smem = table_bytes + (size_t)teams * team_bytes;
  const int e = smem_opt_in(k_fold_team<C, T>, smem);
  if (e) return e;
  k_fold_team<C, T><<<S, teams * T, smem, st>>>(a, L, seg, S, max_len, scratch, out, *tab);
  return LAUNCH_STATUS();
}

// a (rows, L) packed, seg (2, S): the segments' first columns, then their
// lengths (each 1 .. max_len) -> out (rows, S); seg null: S segments of
// max_len points from column 0 on (segment s from column s max_len).
// scratch holds S * 2 * ceil(max_len / 2) points of rows ints (unused when
// max_len <= 2).  ncomp selects the group (1: G1, 2: G2); -1 for any other
// group, -2 if the table did not build, -3 for S or max_len out of range.
extern "C" int testudo_fold_team(const int* a, long L, const int* seg, int S, int max_len,
                                 int* scratch, int* out, int ncomp, void* stream) {
  if (ncomp != 1 && ncomp != 2) return -1;
  if (S < 1 || max_len < 1) return -3;
  cudaStream_t st = (cudaStream_t)stream;
  int teams = FOLD_CARD_TEAMS / S;
  if (teams > FOLD_TEAMS(ncomp)) teams = FOLD_TEAMS(ncomp);
  if (teams < FOLD_TEAMS_MIN) teams = FOLD_TEAMS_MIN;
  return ncomp == 1 ? fold_launch<FqCoord, FOLD_T(1)>(a, L, seg, S, max_len, scratch, out, teams, st)
                    : fold_launch<Fq2Coord, FOLD_T(2)>(a, L, seg, S, max_len, scratch, out, teams,
                                                       st);
}
