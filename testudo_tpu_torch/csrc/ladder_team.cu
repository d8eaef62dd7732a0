// K4b: the ladder [s_l] P_l of ladder.cu, with each lane worked by a TEAM of
// TEAM_T threads of one warp (16 for G1, 32 for G2), for G1 (ncomp 1) and G2
// (ncomp 2): the launches the main paths make at 1,024 lanes or fewer (the
// Horner combine of every MSM, the MIPP folds and cross MSMs, the PST opens).
//
// Replaces, with ladder_wide.cu and ladder.cu, testudo_tpu/tpu/pallas_curve.py:733
// `_ladder_chain` (one `step` launch per scalar bit on the TPU).
//
// Bound on this card at these widths: latency.  A lane is a chain of 256
// dependent steps and one thread per lane runs a step's 20 Fq products (63
// for G2) one after the other, through call frames in local memory, on a
// card where 20 lanes fill 20 threads.  Most of a step's products are
// independent (ec_team.cuh), so here rank r of the lane's team runs product
// r of each round: a step is 2 rounds of products for G1 and 3 for G2 (the
// middle one G2's b3 products), with a few stages of sums between them.
// The lane's points and temporaries live in shared memory; each rank holds
// only the two operands of its one inlined product.  The team syncs with
// __syncwarp after every stage; every thread of the warp runs the same
// stages (lanes past L clamp their loads and skip the store), so the whole
// warp reaches every sync.  No branch encloses a product except the
// stage's kind, which is the same for the whole warp.
//
// Above the width where the team kernel's extra threads stop paying (the
// sqrt-PST commit's 32,768-lane Horner), ladder_wide.cu's smaller teams,
// each lane stopping after its top bit, do the same work in fewer
// instructions, and ladder.cu's one thread per lane the widest launches in
// no order: the wrapper picks (device/packed_curve.py, TEAM_LADDER_MAX_LANES,
// WIDE_LADDER_MAX_UNORDERED).
#include "ec_team.cuh"
#include "launch.cuh"

#define TPB_TEAM 64

template <class C>
__global__ void __launch_bounds__(TPB_TEAM)
k_ladder_team(const int* pts, const int* scal, int* out, int nl, long L, TeamTable tab) {
  constexpr int NC = C::COMP_ROWS / (2 * FQN);
  constexpr int T = TEAM_T(NC);
  extern __shared__ u32 smem[];
  u32* ops = smem;
  u32* stages = smem + tab.nops;
  for (int i = threadIdx.x; i < tab.nops; i += TPB_TEAM) ops[i] = tab.op[i];
  for (int i = threadIdx.x; i < tab.nstages; i += TPB_TEAM) stages[i] = tab.stage[i];
  __syncthreads();
  const int ns = tab.nslots;
  const int team = threadIdx.x / T;
  u32* region = smem + tab.nops + tab.nstages + team * ns * FQN;
  const long lane = (long)blockIdx.x * (TPB_TEAM / T) + team;
  lane_ladder_team<C, T>(region, ns, TeamCode{ops, stages, tab.nstages}, pts, scal, out, nl, L,
                         lane, threadIdx.x % T);
}

template <class C>
static int launch_team(const int* pts, const int* scal, int* out, int nl, long L,
                       const TeamTable& tab, cudaStream_t st) {
  constexpr int lanes_per_block = TPB_TEAM / TEAM_T(C::COMP_ROWS / (2 * FQN));
  const size_t smem = sizeof(u32) * ((size_t)tab.nops + tab.nstages +
                                     (size_t)lanes_per_block * tab.nslots * FQN);
  const int e = smem_opt_in(k_ladder_team<C>, smem);
  if (e) return e;
  k_ladder_team<C><<<GRID_FOR(L, lanes_per_block), TPB_TEAM, smem, st>>>(pts, scal, out, nl, L,
                                                                        tab);
  return LAUNCH_STATUS();
}

// ncomp selects the group (1: G1, 2: G2); -1 for any other group, -2 if the
// table did not build.
extern "C" int testudo_ladder_team(const int* pts, const int* scal, int* out, int nl, long L,
                                   int ncomp, void* stream) {
  if (ncomp != 1 && ncomp != 2) return -1;
  if (L <= 0) return 0;
  const TeamTable* tab = team_table_once(ncomp, TEAM_LADDER_STEP);
  if (!tab) return -2;
  cudaStream_t st = (cudaStream_t)stream;
  return ncomp == 1 ? launch_team<FqCoord>(pts, scal, out, nl, L, *tab, st)
                    : launch_team<Fq2Coord>(pts, scal, out, nl, L, *tab, st);
}
