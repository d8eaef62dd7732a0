// K2 add2, K3 step, K5 scan2b: one complete G1 group operation (or two) per
// lane over `(72, L)` packed point batches.
//
// Replace testudo_tpu/tpu/pallas_curve.py `_ec_call("add2")` (:415),
// `_ec_call("step")` (:424) and `_ec_call("scan2b")` (:450).
//
// Bound on this card: operations.  A complete add is 12 Montgomery
// products (3,600 32-bit multiply-adds) against 3 * 288 bytes moved per
// lane, far above the card's operations-per-byte balance.  Each thread
// holds its points in registers; limb rows load coalesced.  The step mask
// is one int per lane (the TPU kernel needed an 8-sublane broadcast).
#include "g1.cuh"
#include "launch.cuh"

#define TPB_EC 64

__global__ void __launch_bounds__(TPB_EC)
k_add2(const int* a, const int* b, int* out, long L) {
  long lane = LANE_INDEX(TPB_EC);
  if (lane < L) lane_add2(a, b, out, L, lane);
}

__global__ void __launch_bounds__(TPB_EC)
k_step(const int* acc, const int* base, const int* mask, int* out_acc,
       int* out_base, long L) {
  long lane = LANE_INDEX(TPB_EC);
  if (lane < L) lane_step(acc, base, mask, out_acc, out_base, L, lane);
}

__global__ void __launch_bounds__(TPB_EC)
k_scan2b(const int* run, const int* tot, const int* bl, int* out_run,
         int* out_tot, long L) {
  long lane = LANE_INDEX(TPB_EC);
  if (lane < L) lane_scan2b(run, tot, bl, out_run, out_tot, L, lane);
}

extern "C" int testudo_add2(const int* a, const int* b, int* out, long L,
                            void* stream) {
  if (L <= 0) return 0;
  k_add2<<<GRID_FOR(L, TPB_EC), TPB_EC, 0, (cudaStream_t)stream>>>(a, b, out, L);
  return LAUNCH_STATUS();
}

extern "C" int testudo_step(const int* acc, const int* base, const int* mask,
                            int* out_acc, int* out_base, long L, void* stream) {
  if (L <= 0) return 0;
  k_step<<<GRID_FOR(L, TPB_EC), TPB_EC, 0, (cudaStream_t)stream>>>(
      acc, base, mask, out_acc, out_base, L);
  return LAUNCH_STATUS();
}

extern "C" int testudo_scan2b(const int* run, const int* tot, const int* bl,
                              int* out_run, int* out_tot, long L, void* stream) {
  if (L <= 0) return 0;
  k_scan2b<<<GRID_FOR(L, TPB_EC), TPB_EC, 0, (cudaStream_t)stream>>>(
      run, tot, bl, out_run, out_tot, L);
  return LAUNCH_STATUS();
}
