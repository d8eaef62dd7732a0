// One Poseidon permutation of each of a batch of sponge states (BLS12-377 Fr
// or Fq, t = 3), in place of the reference's XLA loops
// (testudo_tpu/tpu/sponge.py:57 `permute`; no Pallas kernel there).  A state
// is `(3, nlimbs)` int32 16-bit limbs in Montgomery form (nlimbs = 16: Fr,
// 24: Fq), states one after the other.
//
// One warp a state, three lanes an element (pos_permute_warp, poseidon.cuh):
// a permutation is 39 rounds of 6 dependent products, so one state is bound
// by one warp's product latency; the 96 or 144 bytes it moves are nothing
// beside that.  The fused sumcheck launches it for a round's leading
// permutation (the one an absorb after a squeeze runs first: it depends on
// the sponge state alone); the round tail (sumcheck_tail.cu) runs the rest
// through the same device function.
#include "launch.cuh"
#include "poseidon.cuh"

template <class F>
__global__ void __launch_bounds__(32) k_poseidon_permute(const int* in, int* out) {
  __shared__ u32 sh[POS_T * F::N];
  const int lane = threadIdx.x;
  const long first = (long)blockIdx.x * POS_T;
  u32 x[F::N];
  fp_load_row<F>(x, in + (first + lane % POS_T) * 2 * F::N);
  pos_permute_warp<F>(x, sh, lane);
  if (lane < POS_T) fp_store_row<F>(out + (first + lane) * 2 * F::N, x);
}

// `field` (a FieldId, fp.cuh) selects the field: FIELD_FQ or FIELD_FR, the
// two fields whose constants poseidon.cuh holds.  `in` and `out` may be the
// same array.  Returns the CUDA error code of the launch, or -1 for any other
// field.
extern "C" int testudo_poseidon_permute(const int* in, int* out, int field, long nstates,
                                        void* stream) {
  if (field != FIELD_FQ && field != FIELD_FR) return -1;
  if (nstates <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (field == FIELD_FQ)
    k_poseidon_permute<FqParams><<<(unsigned)nstates, 32, 0, st>>>(in, out);
  else
    k_poseidon_permute<FrParams><<<(unsigned)nstates, 32, 0, st>>>(in, out);
  return LAUNCH_STATUS();
}
