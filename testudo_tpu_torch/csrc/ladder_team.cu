// K4b: the ladder [s_l] P_l of ladder.cu, with each lane worked by a TEAM of
// TEAM_T threads of one warp (16 for G1, 32 for G2), for G1 (ncomp 1) and G2
// (ncomp 2): the launches the main paths make at 1,024 lanes or fewer (the
// Horner combine of every MSM, the MIPP folds and cross MSMs, the PST opens).
//
// Replaces, with ladder.cu, testudo_tpu/tpu/pallas_curve.py:733
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
// sqrt-PST commit's 32,768-lane Horner), ladder.cu's one thread per lane
// does the same work in fewer instructions: the wrapper picks
// (device/packed_curve.py, TEAM_LADDER_MAX_LANES).
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
  const int ns = tab.nslots, nst = tab.nstages;
  const int rank = threadIdx.x % T;
  const int team = threadIdx.x / T;
  u32* region = smem + tab.nops + tab.nstages + team * ns * FQN;
  const long lane = (long)blockIdx.x * (TPB_TEAM / T) + team;
  const long src = lane < L ? lane : L - 1;  // past L: run on, store nothing
  team_init<C>(region, ns, pts, L, src, rank);
  __syncthreads();
  FP_NO_UNROLL
  for (int k = 0; k < nl; k++) {
    const u32 limb = (u32)scal[(long)k * L + src];
    FP_NO_UNROLL
    for (int bit = 0; bit < 16; bit++) {
      const bool set = ((limb >> bit) & 1u) != 0;
      FP_NO_UNROLL
      for (int s = 0; s < nst; s++) {
        const u32 st = stages[s];
        const bool mul = (st >> 31) != 0;
        const int count = (int)((st >> 16) & 0x7fffu);
        FP_NO_UNROLL
        for (int i = 0; i < count; i += T) {
          team_op(region, ns, team_pick(ops, st, i + rank, NC), mul, set);
          __syncwarp();
        }
      }
    }
  }
  if (lane < L) team_store<C>(out, region, ns, L, lane, rank);
}

// The step's table for this group, built on the first launch and kept; null
// if it does not fit.
static const TeamTable* team_table_for(int ncomp) {
  static TeamTable tables[2];
  static int state[2] = {0, 0};  // 0: not built, 1: built, -1: failed
  int g = ncomp - 1;
  if (state[g] == 0) state[g] = team_table(tables[g], ncomp) == 0 ? 1 : -1;
  return state[g] == 1 ? &tables[g] : nullptr;
}

template <class C>
static int launch_team(const int* pts, const int* scal, int* out, int nl, long L,
                       const TeamTable& tab, cudaStream_t st) {
  constexpr int lanes_per_block = TPB_TEAM / TEAM_T(C::COMP_ROWS / (2 * FQN));
  const size_t smem = sizeof(u32) * ((size_t)tab.nops + tab.nstages +
                                     (size_t)lanes_per_block * tab.nslots * FQN);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(k_ladder_team<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
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
  const TeamTable* tab = team_table_for(ncomp);
  if (!tab) return -2;
  cudaStream_t st = (cudaStream_t)stream;
  return ncomp == 1 ? launch_team<FqCoord>(pts, scal, out, nl, L, *tab, st)
                    : launch_team<Fq2Coord>(pts, scal, out, nl, L, *tab, st);
}
