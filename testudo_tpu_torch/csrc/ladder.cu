// K4: the whole LSB-first double-and-add ladder [s_l] P_l in ONE launch,
// accumulator and base in registers for all 16 * nl scalar bits.
//
// Replaces testudo_tpu/tpu/pallas_curve.py:733 `_ladder_chain`, which runs
// one `_ec_call("step")` launch per bit (256 for Fr scalars) because an
// in-kernel ladder did not compile for the TPU.
//
// Bound on this card: operations, and at the widths the MSM gives it
// (20 window sums, or a few thousand points) latency: 256 sequential
// add + double pairs per lane, 20 Montgomery products each.  One launch
// removes 255 round trips of both points through device memory; small
// blocks spread few lanes over many SMs.
#include "g1.cuh"
#include "launch.cuh"

#define TPB_LADDER 32

__global__ void __launch_bounds__(TPB_LADDER)
k_ladder(const int* pts, const int* scal, int* out, int nl, long L) {
  long lane = LANE_INDEX(TPB_LADDER);
  if (lane < L) lane_ladder(pts, scal, out, nl, L, lane);
}

extern "C" int testudo_ladder(const int* pts, const int* scal, int* out, int nl,
                              long L, void* stream) {
  if (L <= 0) return 0;
  k_ladder<<<GRID_FOR(L, TPB_LADDER), TPB_LADDER, 0, (cudaStream_t)stream>>>(
      pts, scal, out, nl, L);
  return LAUNCH_STATUS();
}
