// K4c: the ladder [s_l] P_l of ladder.cu for the wide launches (above
// TEAM_LADDER_MAX_LANES: the sqrt-PST commit's Horner, 32,768 lanes at nv =
// 20 and 8,192 in the NIZK prove's witness commit; the small multi-MSM's
// 2,048-4,096 random lanes at nv = 11-12), for G1 (ncomp 1) and G2 (ncomp
// 2), in one launch, every lane a team's.
//
// Replaces, with ladder_team.cu and ladder.cu, testudo_tpu/tpu/
// pallas_curve.py:733 `_ladder_chain` (one `step` launch per scalar bit on
// the TPU), as testudo_tpu/tpu/msm.py:1082 `_multi_horner_packed` drives it.
//
// Bound on this card: operations, and for the longest lanes latency.  The
// commit's scalars are 2^(8 w), w = 0 .. 31: lane w needs 8 w doublings and
// one add, 125 steps on average, and after its top bit a step only selects
// acc again.  ladder.cu walks all 256 bits, and since a warp holds one
// column's 32 windows (lanes k-major), its warp-uniform skip of the add
// never skips.  Here (1) a lane stops after its top set bit, warp-uniformly
// (the ladder runs while any lane of the warp has bits left); (2) the lanes
// run in the caller's order (`order`, a permutation; none: index order):
// the commit's Horner passes them longest first, so a warp's lanes share
// one length, stop together and skip every add but the one at their bit;
// (3) each lane runs as a TEAM of WIDE_T threads (ec_team.cuh
// `lane_ladder_wide_team`: a doubling's independent products side by side,
// by the `dbl` table, and the ladder step's table at a set bit), so the
// longest lanes' chains, which set the pace, are a quarter (G1) or an
// eighth (G2) of one thread's.  Every thread of a block runs the same
// stages (positions past L clamp and skip the store).  The results land in
// their own lanes: out is as the order-free ladder writes it, limb for limb.
//
// Measured on an H100 (tools/exp_ladder.py --forms, PERF.md section 6): no
// split of a launch between teams and one thread a lane beat the better of
// all lanes as teams or none (the team blocks' shared memory takes L1 from
// the one-thread blocks, whose products keep their call frames there).
// Teams win wherever the card has room for their threads (random scalars
// up to 8,192 lanes) and, for G1, wherever the lanes come longest first
// (most steps only double); at 32,768 random lanes one thread a lane wins,
// and the wrapper sends such launches to ladder.cu (device/packed_curve.py,
// WIDE_LADDER_MAX_UNORDERED).  (G2 at 32,768 ordered lanes, which no path
// runs, would be 7% faster one thread a lane with the stop.)
#include "ec_team.cuh"
#include "launch.cuh"

// The two tables of a team, by value (3.6 KB of parameters).
struct WideTables {
  TeamTable step, dbl;
};

template <class C, int T, int TPB>
__global__ void __launch_bounds__(TPB)
k_ladder_wide(const int* pts, const int* scal, const int* order, int* out, int nl, long L,
              WideTables tabs) {
  extern __shared__ u32 smem[];
  const TeamTable& s = tabs.step;
  const TeamTable& d = tabs.dbl;
  u32* at = smem;
  for (int k = threadIdx.x; k < s.nops; k += TPB) at[k] = s.op[k];
  for (int k = threadIdx.x; k < s.nstages; k += TPB) at[s.nops + k] = s.stage[k];
  const TeamCode step = {at, at + s.nops, s.nstages};
  at += s.nops + s.nstages;
  for (int k = threadIdx.x; k < d.nops; k += TPB) at[k] = d.op[k];
  for (int k = threadIdx.x; k < d.nstages; k += TPB) at[d.nops + k] = d.stage[k];
  const TeamCode dbl = {at, at + d.nops, d.nstages};
  at += d.nops + d.nstages;
  __syncthreads();
  const int ns = s.nslots > d.nslots ? s.nslots : d.nslots;
  const int team = threadIdx.x / T;
  const long i = (long)blockIdx.x * (TPB / T) + team;
  lane_ladder_wide_team<C, T>(at + team * ns * FQN, ns, step, dbl, pts, scal, order, out, nl, L,
                              i, threadIdx.x % T);
}

// Launch at team size T and TPB threads a block (the production launcher
// below uses WIDE_T and WIDE_TPB; a measurement may pick others).  -2 if a
// table is missing.
template <class C, int T, int TPB>
static int ladder_wide_launch(const int* pts, const int* scal, const int* order, int* out, int nl,
                              long L, cudaStream_t st) {
  static_assert(32 % T == 0 && TPB % 32 == 0, "a team must not span warps; blocks are whole warps");
  constexpr int NC = C::COMP_ROWS / (2 * FQN);
  constexpr int TEAMS = TPB / T;
  if (L <= 0) return 0;
  const TeamTable* s = team_table_once(NC, TEAM_LADDER_STEP);
  const TeamTable* d = team_table_once(NC, TEAM_LADDER_DOUBLE);
  if (!s || !d) return -2;
  const int ns = s->nslots > d->nslots ? s->nslots : d->nslots;
  const size_t smem = sizeof(u32) * ((size_t)s->nops + s->nstages + d->nops + d->nstages +
                                     (size_t)TEAMS * ns * FQN);
  const int e = smem_opt_in(k_ladder_wide<C, T, TPB>, smem);
  if (e) return e;
  const WideTables tabs = {*s, *d};
  k_ladder_wide<C, T, TPB><<<(unsigned)((L + TEAMS - 1) / TEAMS), TPB, smem, st>>>(
      pts, scal, order, out, nl, L, tabs);
  return LAUNCH_STATUS();
}

// pts (rows, L) x canonical scalars (nl, L) -> out (rows, L); order: null
// or a permutation of the L lanes (not checked here: the wrapper checks
// it).  ncomp selects the group (1: G1, 2: G2); -1 for any other, -2 if a
// table did not build.
extern "C" int testudo_ladder_wide(const int* pts, const int* scal, const int* order, int* out,
                                   int nl, long L, int ncomp, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ncomp == 1)
    return ladder_wide_launch<FqCoord, WIDE_T(1), WIDE_TPB(1)>(pts, scal, order, out, nl, L, st);
  if (ncomp == 2)
    return ladder_wide_launch<Fq2Coord, WIDE_T(2), WIDE_TPB(2)>(pts, scal, order, out, nl, L, st);
  return -1;
}
