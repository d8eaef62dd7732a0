// K10: the commit's table of multiples, d G_j for d < B, in one launch, each
// lane worked by a TEAM of threads of one warp (CHAIN_T: 8 for G1, 16 for
// G2), for G1 (ncomp 1) and G2 (ncomp 2).
//
// Replaces testudo_tpu/tpu/pallas_curve.py:415 `_ec_call("add2")` as
// testudo_tpu/tpu/msm.py:1038-1045 `tab_build` drives it: a `lax.scan` of
// B - 1 dependent `add2` launches over the N bases (device/msm.py carried
// that over as 255 launches at c = 8, one a step, with the host loop
// between them and a stack and transpose of the steps at the end).  Here
// lane j runs its whole chain in one launch and writes each step straight to
// its row of the point-major (N B, rows) table: `lane_chain_team`
// (ec_team.cuh) says what it computes; the adds, their order and their
// operands are those of the launches it replaces, so its limbs are theirs.
// The TPU's chunking of the scan to 1,024-lane blocks was a workaround for
// a fault of that chip and is not carried over.
//
// Bound on this card: latency.  A lane is a chain of B - 1 dependent
// complete adds (255 at the commit's c = 8), and the 1,024 lanes of the
// commit would be 16 blocks of 64 single threads.  So each lane has a team:
// rank r runs operation r of every stage of the add's table, 2 rounds of
// products for G1 and 3 for G2.  The table is a kernel argument, which each
// block copies to shared memory beside its lanes' slots.  The team stores a
// row together, a few words a thread, so the stores of a row are side by
// side; the table (75 MB for G1 at N = 1,024, c = 8) is written once, far
// below the chain's time at the card's memory rate.  Every thread of a warp
// runs the same stages (lanes past N clamp their loads and skip the
// stores), so the whole warp reaches every sync, and no branch encloses a
// product except the stage's kind, the same for the whole warp.
#include "ec_team.cuh"
#include "launch.cuh"

#define TPB_CHAIN_MAX 512

template <class C, int T>
__global__ void __launch_bounds__(TPB_CHAIN_MAX)
k_chain_team(const int* base, int* out, long N, int B, TeamTable tab) {
  extern __shared__ u32 smem[];
  u32* ops = smem;
  u32* stages = smem + tab.nops;
  for (int i = threadIdx.x; i < tab.nops; i += blockDim.x) ops[i] = tab.op[i];
  for (int i = threadIdx.x; i < tab.nstages; i += blockDim.x) stages[i] = tab.stage[i];
  __syncthreads();
  const int ns = tab.nslots;
  const int team = threadIdx.x / T;
  u32* region = smem + tab.nops + tab.nstages + team * ns * FQN;
  const long lane = (long)blockIdx.x * (blockDim.x / T) + team;
  lane_chain_team<C, T>(region, ns, TeamCode{ops, stages, tab.nstages}, base, out, N, B, lane,
                        threadIdx.x % T);
}

// Launch at team size T with `teams` lanes a block (the production launcher
// below uses CHAIN_T and CHAIN_TEAMS; a measurement may pick others).  -2 if
// the table is missing, -3 for a block that cannot be.
template <class C, int T>
static int chain_launch(const int* base, int* out, long N, int B, int teams, cudaStream_t st) {
  static_assert(32 % T == 0, "a team must not span warps");
  constexpr int NC = C::COMP_ROWS / (2 * FQN);
  const TeamTable* tab = team_table_once(NC, TEAM_PAIR_ADD);
  if (!tab) return -2;
  if (teams < 1 || teams * T > TPB_CHAIN_MAX) return -3;
  const size_t smem =
      sizeof(u32) * ((size_t)tab->nops + tab->nstages + (size_t)teams * tab->nslots * FQN);
  const int e = smem_opt_in(k_chain_team<C, T>, smem);
  if (e) return e;
  k_chain_team<C, T><<<GRID_FOR(N, teams), teams * T, smem, st>>>(base, out, N, B, *tab);
  return LAUNCH_STATUS();
}

// Point-major bases (N, rows) -> point-major table (N B, rows), row j B + d
// = d G_j.  ncomp selects the group (1: G1, 2: G2); -1 for any other group,
// -2 if the table did not build, -3 for B out of range.
extern "C" int testudo_chain_team(const int* base, int* out, long N, int B, int ncomp,
                                  void* stream) {
  if (ncomp != 1 && ncomp != 2) return -1;
  if (B < 1 || B > (1 << 16)) return -3;
  if (N <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return ncomp == 1 ? chain_launch<FqCoord, CHAIN_T(1)>(base, out, N, B, CHAIN_TEAMS(1), st)
                    : chain_launch<Fq2Coord, CHAIN_T(2)>(base, out, N, B, CHAIN_TEAMS(2), st);
}
