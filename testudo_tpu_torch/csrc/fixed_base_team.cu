// K11: the fixed-base scalar multiplication [s_i] B of N scalars in one
// launch, from the packed table of the 256 doublings 2^k B, for G1 (ncomp
// 1) and G2 (ncomp 2): each lane worked by a TEAM of threads of one warp
// (FIXED_T, FIXED_TEAMS), or one thread per lane for wide launches
// (device/packed_curve.py picks by width: FIXED_TEAM_MAX_LANES).
//
// Replaces testudo_tpu/tpu/pallas_curve.py:403 `_ec_call("add_mask")` as
// testudo_tpu/tpu/curve.py:429-459 `fixed_base_mul_g1` (and :462-486, G2)
// drives it: a `fori_loop` of 256 dependent `add_mask` launches, bit k of
// every scalar selecting one complete add of table column k onto the
// accumulators (device/curve.py carried that over as 256 launches with a
// slice, shift, mask and copy of the scalars and a copy of the column
// between them).  Here a lane reads its own scalar bits and runs its whole
// chain in one launch: `lane_fixed_base_team` (ec_team.cuh) and
// `lane_fixed_base` (ec.cuh) say what they compute; the adds, their order
// and their operands are those of the launches they replace, so the limbs
// are theirs.
//
// Bound on this card: latency at the setup's widths (63 to 2,047 lanes: 1
// to 32 blocks of 64 single threads, each a chain of 256 dependent adds).
// So a lane has a team: rank r runs operation r of every stage of the
// masked add's table (`team_masked_add`: the pair add whose last sums select
// on the lane's bit), 2 rounds of products for G1 and 3 for G2.  The add
// runs on every step and the select keeps acc where the bit is clear: no
// branch encloses a product except a warp-uniform skip of a step no lane of
// the warp needs (`team_any`).  Every lane reads table column k at step k,
// a broadcast of 288 B (G1) or 576 B (G2) through L1.  Every thread of a
// warp runs the same stages (lanes past N clamp their loads and skip the
// store), so the whole warp reaches every sync.  At wide launches the team's extra threads stop paying and one
// thread per lane runs the same adds (`k_fixed_base_one`).
#include "ec_team.cuh"
#include "launch.cuh"

#define TPB_FIXED_MAX 512
#define TPB_FIXED_ONE_MAX 256  // a G2 add takes up to 255 registers a thread
#define TPB_FIXED_ONE 64

template <class C, int T>
__global__ void __launch_bounds__(TPB_FIXED_MAX)
k_fixed_base_team(const int* table, const int* scal, int* out, long N, int nl, TeamTable tab) {
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
  lane_fixed_base_team<C, T>(region, ns, TeamCode{ops, stages, tab.nstages}, table, scal, out, N,
                             nl, lane, threadIdx.x % T);
}

// Launch at team size T with `teams` lanes a block (the production launcher
// below uses FIXED_T and FIXED_TEAMS; a measurement may pick others).  -2 if
// the table is missing, -3 for a block that cannot be (its threads must fill
// whole warps: the skip asks all 32).
template <class C, int T>
static int fixed_base_launch(const int* table, const int* scal, int* out, long N, int nl,
                             int teams, cudaStream_t st) {
  static_assert(32 % T == 0, "a team must not span warps");
  constexpr int NC = C::COMP_ROWS / (2 * FQN);
  const TeamTable* tab = team_table_once(NC, TEAM_MASKED_ADD);
  if (!tab) return -2;
  if (teams < 1 || teams * T > TPB_FIXED_MAX || (teams * T) % 32) return -3;
  const size_t smem =
      sizeof(u32) * ((size_t)tab->nops + tab->nstages + (size_t)teams * tab->nslots * FQN);
  const int e = smem_opt_in(k_fixed_base_team<C, T>, smem);
  if (e) return e;
  k_fixed_base_team<C, T><<<GRID_FOR(N, teams), teams * T, smem, st>>>(table, scal, out, N, nl,
                                                                      *tab);
  return LAUNCH_STATUS();
}

template <class C>
__global__ void __launch_bounds__(TPB_FIXED_ONE_MAX)
k_fixed_base_one(const int* table, const int* scal, int* out, long N, int nl) {
  const long lane = LANE_INDEX(blockDim.x);
  if (lane < N) lane_fixed_base<C>(table, scal, out, N, nl, lane);
}

// One thread a lane on blocks of `tpb`.
template <class C>
static int fixed_base_one_launch(const int* table, const int* scal, int* out, long N, int nl,
                                 int tpb, cudaStream_t st) {
  if (tpb < 32 || tpb > TPB_FIXED_ONE_MAX || tpb % 32) return -3;
  k_fixed_base_one<C><<<GRID_FOR(N, tpb), tpb, 0, st>>>(table, scal, out, N, nl);
  return LAUNCH_STATUS();
}

// Packed (rows, 16 nl) table of doublings and (N, nl) canonical scalar limbs
// -> packed (rows, N) multiples.  ncomp selects the group (1: G1, 2: G2);
// -1 for any other group, -2 if the table did not build, -3 for nl out of
// range.
extern "C" int testudo_fixed_base_team(const int* table, const int* scal, int* out, long N,
                                       int nl, int ncomp, void* stream) {
  if (ncomp != 1 && ncomp != 2) return -1;
  if (nl < 1 || nl > 16) return -3;
  if (N <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return ncomp == 1
             ? fixed_base_launch<FqCoord, FIXED_T(1)>(table, scal, out, N, nl, FIXED_TEAMS(1), st)
             : fixed_base_launch<Fq2Coord, FIXED_T(2)>(table, scal, out, N, nl, FIXED_TEAMS(2), st);
}

// The same, one thread per lane.
extern "C" int testudo_fixed_base_one(const int* table, const int* scal, int* out, long N,
                                      int nl, int ncomp, void* stream) {
  if (ncomp != 1 && ncomp != 2) return -1;
  if (nl < 1 || nl > 16) return -3;
  if (N <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return ncomp == 1 ? fixed_base_one_launch<FqCoord>(table, scal, out, N, nl, TPB_FIXED_ONE, st)
                    : fixed_base_one_launch<Fq2Coord>(table, scal, out, N, nl, TPB_FIXED_ONE, st);
}
