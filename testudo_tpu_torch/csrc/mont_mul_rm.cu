// Row-major Montgomery product a * b * R^{-1} mod p over `(n, nlimbs)` int32
// arrays of 16-bit limbs, an element's limbs contiguous (nlimbs = 24: Fq,
// 16: Fr), canonical in and out.  `b` is `(n, nlimbs)` too, or ONE element
// that every lane multiplies by (`shared_b`), which is how the protocol
// scales a whole table by a challenge, by 1 (out of Montgomery form) or by
// R^2 (into it): nothing is broadcast in memory.
//
// Replaces testudo_tpu/tpu/kernels.py:34 `mont_mul_pallas` (call :51, body
// `_mont_mul_body`).  The TPU kernel tiles 1024 elements per grid step
// through VMEM and needs n to be a multiple of the tile; here one thread
// takes one element and the ragged edge is masked.
//
// Bound on this card: bytes.  With a shared b an Fr element moves 2 * 64
// bytes against 136 multiply-adds, an Fq element 2 * 96 against 300.  An
// element is 64 or 96 contiguous, 16-byte aligned bytes, read and written
// as 128-bit words (`fp_load_row`, as the bucket kernel reads table
// entries): a warp touches 32 whole segments, so every sector fetched is
// used, but the 4 to 6 loads of a thread are strided across the warp, not
// coalesced.  Both operands and the running sum stay in registers.
#include "fp.cuh"
#include "launch.cuh"

#define TPB_MUL_RM 128

template <class F>
__global__ void __launch_bounds__(TPB_MUL_RM)
k_mont_mul_rm(const int* a, const int* b, int* out, long n, int shared_b) {
  long lane = LANE_INDEX(TPB_MUL_RM);
  if (lane < n) lane_mont_mul_rm<F>(a, b, out, lane, shared_b != 0);
}

// nlimbs selects the field: 24 -> Fq, 16 -> Fr.  Returns the CUDA error
// code of the launch, or -1 for an unknown field.
extern "C" int testudo_mont_mul_rm(const int* a, const int* b, int* out, int nlimbs,
                                   long n, int shared_b, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (nlimbs == 24)
    k_mont_mul_rm<FqParams><<<GRID_FOR(n, TPB_MUL_RM), TPB_MUL_RM, 0, st>>>(a, b, out, n, shared_b);
  else if (nlimbs == 16)
    k_mont_mul_rm<FrParams><<<GRID_FOR(n, TPB_MUL_RM), TPB_MUL_RM, 0, st>>>(a, b, out, n, shared_b);
  else
    return -1;
  return LAUNCH_STATUS();
}
