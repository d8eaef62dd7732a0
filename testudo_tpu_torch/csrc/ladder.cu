// K4: the whole LSB-first double-and-add ladder [s_l] P_l in ONE launch,
// accumulator and base held by the thread for all 16 * nl scalar bits, for
// G1 (ncomp 1) and G2 (ncomp 2).
//
// Replaces testudo_tpu/tpu/pallas_curve.py:733 `_ladder_chain`, which runs
// one `_ec_call("step")` launch per bit (256 for Fr scalars) because an
// in-kernel ladder did not compile for the TPU.
//
// Bound on this card: operations, and at the widths the MSM gives it
// (20 window sums, or a few thousand points) latency: 256 sequential
// add + double pairs per lane, 20 Montgomery products each (63 for G2).
// One launch removes 255 round trips of both points through device memory;
// small blocks spread few lanes over many SMs.
#include "ec.cuh"
#include "launch.cuh"

#define TPB_LADDER 32

template <class C>
__global__ void __launch_bounds__(TPB_LADDER)
k_ladder(const int* pts, const int* scal, int* out, int nl, long L) {
  long lane = LANE_INDEX(TPB_LADDER);
  if (lane < L) lane_ladder<C>(pts, scal, out, nl, L, lane);
}

// ncomp selects the group (1: G1, 2: G2); -1 for any other.
extern "C" int testudo_ladder(const int* pts, const int* scal, int* out, int nl,
                              long L, int ncomp, void* stream) {
  if (L <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (ncomp == 1)
    k_ladder<FqCoord><<<GRID_FOR(L, TPB_LADDER), TPB_LADDER, 0, st>>>(pts, scal, out, nl, L);
  else if (ncomp == 2)
    k_ladder<Fq2Coord><<<GRID_FOR(L, TPB_LADDER), TPB_LADDER, 0, st>>>(pts, scal, out, nl, L);
  else
    return -1;
  return LAUNCH_STATUS();
}
