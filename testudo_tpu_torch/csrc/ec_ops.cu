// K2 add2, K3 step, K5 scan2b, K7 add_mask, K8 scan2: one complete group
// operation (or two) per lane over packed point batches, for G1 (`(72, L)`,
// ncomp 1) and G2 (`(144, L)`, ncomp 2).
//
// Replace testudo_tpu/tpu/pallas_curve.py `_ec_call("add_mask")` (:403),
// `_ec_call("add2")` (:415), `_ec_call("step")` (:424), `_ec_call("scan2")`
// (:437) and `_ec_call("scan2b")` (:450), each at ncomp 1 and 2.
//
// Bound on this card: operations.  A complete G1 add is 12 Montgomery
// products (3,600 32-bit multiply-adds) against 3 * 288 bytes moved per
// lane; a G2 add is 38 products against 3 * 576 bytes: both far above the
// card's operations-per-byte balance.  Each thread holds its points itself
// (registers for G1; a G2 add's two points and temporaries are more than
// 255 registers, so part of them lives in local memory); limb rows load
// coalesced.  A mask is one int per lane (the TPU kernel needed an
// 8-sublane broadcast).
#include "ec.cuh"
#include "launch.cuh"

#define TPB_EC 64

template <class C>
__global__ void __launch_bounds__(TPB_EC)
k_add2(const int* a, const int* b, int* out, long L) {
  long lane = LANE_INDEX(TPB_EC);
  if (lane < L) lane_add2<C>(a, b, out, L, lane);
}

template <class C>
__global__ void __launch_bounds__(TPB_EC)
k_add_mask(const int* acc, const int* pts, const int* mask, int* out, long L,
           bool shared) {
  long lane = LANE_INDEX(TPB_EC);
  if (lane < L) lane_add_mask<C>(acc, pts, mask, out, L, shared, lane);
}

template <class C>
__global__ void __launch_bounds__(TPB_EC)
k_step(const int* acc, const int* base, const int* mask, int* out_acc,
       int* out_base, long L) {
  long lane = LANE_INDEX(TPB_EC);
  if (lane < L) lane_step<C>(acc, base, mask, out_acc, out_base, L, lane);
}

template <class C>
__global__ void __launch_bounds__(TPB_EC)
k_scan2(const int* run, const int* tot, const int* bl, int* out_run,
        int* out_tot, long L) {
  long lane = LANE_INDEX(TPB_EC);
  if (lane < L) lane_scan2<C>(run, tot, bl, out_run, out_tot, L, lane);
}

template <class C>
__global__ void __launch_bounds__(TPB_EC)
k_scan2b(const int* run, const int* tot, const int* bl, int* out_run,
         int* out_tot, long L) {
  long lane = LANE_INDEX(TPB_EC);
  if (lane < L) lane_scan2b<C>(run, tot, bl, out_run, out_tot, L, lane);
}

// Every launcher takes `ncomp` (1: G1, 2: G2) and returns the CUDA error
// code of the launch, or -1 for an unknown group.
#define EC_LAUNCH(kernel, L, st, ...)                                          \
  do {                                                                         \
    if ((L) <= 0) return 0;                                                    \
    if (ncomp == 1)                                                            \
      kernel<FqCoord><<<GRID_FOR(L, TPB_EC), TPB_EC, 0, st>>>(__VA_ARGS__);    \
    else if (ncomp == 2)                                                       \
      kernel<Fq2Coord><<<GRID_FOR(L, TPB_EC), TPB_EC, 0, st>>>(__VA_ARGS__);   \
    else                                                                       \
      return -1;                                                               \
    return LAUNCH_STATUS();                                                    \
  } while (0)

extern "C" int testudo_add2(const int* a, const int* b, int* out, long L,
                            int ncomp, void* stream) {
  EC_LAUNCH(k_add2, L, (cudaStream_t)stream, a, b, out, L);
}

// shared != 0: `pts` is one column, added to every lane.
extern "C" int testudo_add_mask(const int* acc, const int* pts, const int* mask,
                                int* out, long L, int shared, int ncomp,
                                void* stream) {
  EC_LAUNCH(k_add_mask, L, (cudaStream_t)stream, acc, pts, mask, out, L, shared != 0);
}

extern "C" int testudo_step(const int* acc, const int* base, const int* mask,
                            int* out_acc, int* out_base, long L, int ncomp,
                            void* stream) {
  EC_LAUNCH(k_step, L, (cudaStream_t)stream, acc, base, mask, out_acc, out_base, L);
}

extern "C" int testudo_scan2(const int* run, const int* tot, const int* bl,
                             int* out_run, int* out_tot, long L, int ncomp,
                             void* stream) {
  EC_LAUNCH(k_scan2, L, (cudaStream_t)stream, run, tot, bl, out_run, out_tot, L);
}

extern "C" int testudo_scan2b(const int* run, const int* tot, const int* bl,
                              int* out_run, int* out_tot, long L, int ncomp,
                              void* stream) {
  EC_LAUNCH(k_scan2b, L, (cudaStream_t)stream, run, tot, bl, out_run, out_tot, L);
}
