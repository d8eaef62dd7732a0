// K1: batched Montgomery product a * b * R^{-1} mod p over `(n, m)` int32
// arrays of 16-bit limb rows (n = 24: BLS12-377's Fq, n = 16: its Fr or
// BLS12-381's Fr), canonical in and out.
//
// Replaces testudo_tpu/tpu/pallas_field.py:226 `_mont_mul_call` (body
// `_mont_mul_rows`, :86), the launch `field.mont_mul` takes on the TPU.
//
// Bound on this card: operations.  A lane moves 3 * n * 4 bytes (288 for
// Fq) and does 2 N^2 + N 32-bit multiply-adds (300 for Fq) plus as many
// carry additions, so the integer pipes saturate long before the memory
// does.  The design keeps both operands and the running sum in registers
// (one thread per lane, word-serial CIOS, fully unrolled) and reads each
// limb row coalesced across the warp; the ragged edge is masked, there is
// no tile padding.
#include "fp.cuh"
#include "launch.cuh"

#define TPB_MUL 128

template <class F>
__global__ void __launch_bounds__(TPB_MUL)
k_mont_mul(const int* a, const int* b, int* out, long m) {
  long lane = LANE_INDEX(TPB_MUL);
  if (lane < m) lane_mont_mul<F>(a, b, out, m, lane);
}

// `field` (a FieldId, fp.cuh) selects the field: FIELD_FQ, FIELD_FR or
// FIELD_FR381.  Returns the CUDA error code of the launch, or -1 for any
// other field.
extern "C" int testudo_mont_mul(const int* a, const int* b, int* out, int field,
                                long m, void* stream) {
  if (field != FIELD_FQ && field != FIELD_FR && field != FIELD_FR381) return -1;
  if (m <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (field == FIELD_FQ)
    k_mont_mul<FqParams><<<GRID_FOR(m, TPB_MUL), TPB_MUL, 0, st>>>(a, b, out, m);
  else if (field == FIELD_FR)
    k_mont_mul<FrParams><<<GRID_FOR(m, TPB_MUL), TPB_MUL, 0, st>>>(a, b, out, m);
  else
    k_mont_mul<Fr381Params><<<GRID_FOR(m, TPB_MUL), TPB_MUL, 0, st>>>(a, b, out, m);
  return LAUNCH_STATUS();
}
