// K9: the weighted bucket sum of every MSM in one launch, each lane worked
// by a TEAM of threads of one warp (WSUM_T: 16 for G1, 32 for G2), for G1
// (ncomp 1) and G2 (ncomp 2).
//
// Replaces testudo_tpu/tpu/pallas_curve.py:450 `_ec_call("scan2b")` and
// :424 `_ec_call("step")` as testudo_tpu/tpu/msm.py:673-720
// `_weighted_sum_packed` drives them: a `lax.scan` of h `scan2b` launches,
// then a chain of `step` launches and one or two `add2` launches, each over
// all W * groups lanes (device/msm.py carried that over one launch per
// step: 32 `scan2b`, 12 `step`, 2 `add2` at the signed c = 13 plan's 2,560
// lanes, with the host loop between them).  Here one lane (w, g) runs the
// whole chain in one launch: `lane_wsum_team` (ec_team.cuh) says what it
// computes; the adds, their order and their operands are those of the
// launches it replaces, so its limbs are theirs.
//
// Bound on this card at this width: latency.  A lane is a chain of about
// 46 dependent rounds of group operations (32 scan steps of two independent
// adds, 12 ladder steps, two adds), and 2,560 lanes of one thread would be
// 40 blocks of 64 on 132 SMs.  So each lane has a team: rank r runs
// operation r of every stage of the step's table (ec_team.cuh), two rounds
// of products a step for G1 and three for G2.  The three tables (scan step,
// ladder step, add) sit in constant memory, copied to the card once per
// group and device, and each block copies them to shared memory; the
// lane's run, tot, acc, run0, the loaded bucket and the temporaries live in
// shared memory.  The ladder's bit comes from the lane index (no mask
// tensor); every thread of a warp runs the same stages (lanes past L clamp
// their loads and skip the store), so the whole warp reaches every sync,
// and no branch encloses a product except the stage's kind and the grid's
// `plus_one`, which are the same for the whole warp.  Measured on an H100
// (PERF.md section 7): 4.9x (G1) and 10.7x (G2) the chain's latency at
// 2,560 lanes, where 10 or 19 warps share an SM and the stages of sums
// take most of the issue slots.
//
// The bucket loads do not coalesce (neighbouring lanes read columns 32
// apart): about 24 MB for G1 and 47 MB for G2 at the signed c = 13 plan,
// a few microseconds at the card's memory rate, far below the chain.
#include "ec_team.cuh"
#include "launch.cuh"

#define TPB_WSUM 64
#define WSUM_MAX_DEVICES 64

// The weighted sum's three tables for one group: scan step, ladder step, add.
struct WsumTables {
  TeamTable prog[3];
};

__constant__ WsumTables c_wsum[2];  // G1, G2

template <class C, int T>
__global__ void __launch_bounds__(TPB_WSUM)
k_wsum_team(const int* buckets, int* out, int W, int c, bool plus_one, int ns) {
  constexpr int NC = C::COMP_ROWS / (2 * FQN);
  extern __shared__ u32 smem[];
  TeamCode code[3];
  u32* at = smem;
  for (int k = 0; k < 3; k++) {
    const TeamTable& t = c_wsum[NC - 1].prog[k];
    for (int i = threadIdx.x; i < t.nops; i += TPB_WSUM) at[i] = t.op[i];
    for (int i = threadIdx.x; i < t.nstages; i += TPB_WSUM) at[t.nops + i] = t.stage[i];
    code[k] = TeamCode{at, at + t.nops, t.nstages};
    at += t.nops + t.nstages;
  }
  __syncthreads();
  const int team = threadIdx.x / T;
  const long lane = (long)blockIdx.x * (TPB_WSUM / T) + team;
  lane_wsum_team<C, T>(at + team * ns * FQN, ns, code, buckets, out, W, c, plus_one, lane,
                       threadIdx.x % T);
}

// The group's tables, built on the host at the first launch and copied to
// the current device's constant memory once; null if they do not fit or
// the copy failed.
static const WsumTables* wsum_tables(int ncomp) {
  static WsumTables tables[2];
  static int state[2] = {0, 0};  // 0: not built, 1: built, -1: failed
  static bool on_device[WSUM_MAX_DEVICES][2];
  const int g = ncomp - 1;
  if (state[g] == 0) {
    state[g] = 1;
    for (int k = 0; k < 3; k++)
      if (team_table(tables[g].prog[k], ncomp, TEAM_WSUM_SCAN + k) != 0) state[g] = -1;
  }
  int dev = 0;
  if (state[g] != 1 || cudaGetDevice(&dev) != cudaSuccess || dev >= WSUM_MAX_DEVICES) return nullptr;
  if (!on_device[dev][g]) {
    if (cudaMemcpyToSymbol(c_wsum, &tables[g], sizeof(WsumTables), g * sizeof(WsumTables)) !=
            cudaSuccess ||
        cudaDeviceSynchronize() != cudaSuccess)
      return nullptr;
    on_device[dev][g] = true;
  }
  return &tables[g];
}

// Launch at team size T (the production launcher below uses WSUM_T; a
// measurement may instantiate others).  -2 if the tables are missing.
template <class C, int T>
static int wsum_launch(const int* buckets, int* out, int W, int c, bool plus_one,
                       cudaStream_t st) {
  static_assert(32 % T == 0 && TPB_WSUM % T == 0, "a team must not span warps");
  constexpr int NC = C::COMP_ROWS / (2 * FQN);
  const WsumTables* tabs = wsum_tables(NC);
  if (!tabs) return -2;
  int words = 0, ns = 0;
  for (int k = 0; k < 3; k++) {
    words += tabs->prog[k].nops + tabs->prog[k].nstages;
    if (tabs->prog[k].nslots > ns) ns = tabs->prog[k].nslots;
  }
  constexpr int lanes_per_block = TPB_WSUM / T;
  const size_t smem = sizeof(u32) * ((size_t)words + (size_t)lanes_per_block * ns * FQN);
  const int e = smem_opt_in(k_wsum_team<C, T>, smem);
  if (e) return e;
  const long L = WSUM_LANES(W, c);
  k_wsum_team<C, T><<<GRID_FOR(L, lanes_per_block), TPB_WSUM, smem, st>>>(buckets, out, W, c,
                                                                         plus_one, ns);
  return LAUNCH_STATUS();
}

// buckets (rows, W 2^c) -> out (rows, W groups), groups = 2^c / min(2^c, 32).
// ncomp selects the group (1: G1, 2: G2); -1 for any other group, -2 if the
// tables did not build or reach the card, -3 for W or c out of range.
extern "C" int testudo_wsum_team(const int* buckets, int* out, int W, int c, int plus_one,
                                 int ncomp, void* stream) {
  if (ncomp != 1 && ncomp != 2) return -1;
  if (W <= 0 || c < 0 || c > 24) return -3;
  cudaStream_t st = (cudaStream_t)stream;
  return ncomp == 1 ? wsum_launch<FqCoord, WSUM_T(1)>(buckets, out, W, c, plus_one != 0, st)
                    : wsum_launch<Fq2Coord, WSUM_T(2)>(buckets, out, W, c, plus_one != 0, st);
}
