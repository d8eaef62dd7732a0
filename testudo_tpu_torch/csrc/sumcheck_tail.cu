// The tail of a fused sumcheck round, one warp: the partial sums of the
// round kernel summed and combined by the instances' coefficients, the
// round polynomial's coefficients, the transcript (absorb them, squeeze the
// challenge) on the device-resident Poseidon sponge, and the next claim by
// Horner (sumcheck.cuh).  In place of the reference's XLA ops between two
// rounds of the fused jit (testudo_tpu/core/sumcheck.py:241-251 and :574-584:
// `_unipoly_coeffs_dev`, the DeviceTranscript of tpu/sponge.py, `_horner_dev`).
//
// Bound on this card: the latency of one warp's dependent products, two or
// three Poseidon permutations of 39 x 6 products, not bytes (a few hundred
// bytes of partial sums).  Every lane computes the sums and coefficients
// (the same values; no product under a divergent branch); lane l holds
// sponge element l % 3 (WarpSponge).  Writes the coefficients, r, the next
// claim (lane 0) and the new sponge state (lanes 0-2).
#include "launch.cuh"
#include "sumcheck.cuh"

template <class S, int NPTS>
__global__ void __launch_bounds__(32)
k_sumcheck_tail(const int* partials, const int* inst_coeffs, const int* e_in, const int* state_in,
                int* coeffs_out, int* r_out, int* e_out, int* state_out, int k, int nblocks,
                int mode, int index) {
  __shared__ u32 sh[POS_T * S::N];
  const int lane = threadIdx.x;
  u32 ev[NPTS][FRN], s[NPTS][FRN], cf[FRN];
  FP_UNROLL
  for (int pt = 0; pt < NPTS; pt++) fp_zero<Fr>(ev[pt]);
  for (int i = 0; i < k; i++) {
    FP_UNROLL
    for (int pt = 0; pt < NPTS; pt++) fp_zero<Fr>(s[pt]);
    for (int b = lane; b < nblocks; b += 32) {
      const int* row = partials + ((long)i * nblocks + b) * NPTS * FR_ROW;
      FP_UNROLL
      for (int pt = 0; pt < NPTS; pt++) {
        fp_load_row<Fr>(cf, row + pt * FR_ROW);
        fp_add<Fr>(s[pt], s[pt], cf);
      }
    }
    fp_load_row<Fr>(cf, inst_coeffs + (long)i * FR_ROW);
    FP_UNROLL
    for (int pt = 0; pt < NPTS; pt++) {
      warp_sum<Fr>(s[pt]);
      fp_mul_inline<Fr>(s[pt], s[pt], cf);
      fp_add<Fr>(ev[pt], ev[pt], s[pt]);
    }
  }
  WarpSponge<S> sp;
  sp.sh = sh;
  sp.lane = lane;
  fp_load_row<S>(sp.x, state_in + (lane % POS_T) * 2 * S::N);
  u32 c[NPTS + 1][FRN], r[FRN], e[FRN];
  fp_load_row<Fr>(e, e_in);
  sc_tail_round<S, NPTS>(sp, c, r, e, ev, mode, index);
  if (lane < POS_T) fp_store_row<S>(state_out + lane * 2 * S::N, sp.x);
  if (lane != 0) return;
  FP_UNROLL
  for (int j = 0; j <= NPTS; j++) fp_store_row<Fr>(coeffs_out + j * FR_ROW, c[j]);
  fp_store_row<Fr>(r_out, r);
  fp_store_row<Fr>(e_out, e);
}

template <class S>
static int launch_tail(const int* partials, const int* inst_coeffs, const int* e_in,
                       const int* state_in, int* coeffs_out, int* r_out, int* e_out,
                       int* state_out, int npts, int k, int nblocks, int mode, int index,
                       cudaStream_t st) {
  if (npts == 2)
    k_sumcheck_tail<S, 2><<<1, 32, 0, st>>>(partials, inst_coeffs, e_in, state_in, coeffs_out,
                                            r_out, e_out, state_out, k, nblocks, mode, index);
  else
    k_sumcheck_tail<S, 3><<<1, 32, 0, st>>>(partials, inst_coeffs, e_in, state_in, coeffs_out,
                                            r_out, e_out, state_out, k, nblocks, mode, index);
  return LAUNCH_STATUS();
}

// partials: (k, nblocks, npts, 16); inst_coeffs: (k, 16); e_in, r_out, e_out:
// one Fr row; coeffs_out: (npts + 1, 16); state_in / state_out: (3, nlimbs)
// of the sponge's field, `sponge_field` (a FieldId, fp.cuh: FIELD_FR or
// FIELD_FQ);
// (mode, index) the sponge's before the round's first absorb.  Returns the
// CUDA error code of the launch, -1 for an unknown field, -3 for arguments it
// does not take.
extern "C" int testudo_sumcheck_tail(const int* partials, const int* inst_coeffs, const int* e_in,
                                     const int* state_in, int* coeffs_out, int* r_out, int* e_out,
                                     int* state_out, int npts, int k, int nblocks,
                                     int sponge_field, int mode, int index, void* stream) {
  if ((npts != 2 && npts != 3) || k < 1 || nblocks < 1 || (mode != 0 && mode != 1) ||
      index < 0 || index > POS_RATE)
    return -3;
  cudaStream_t st = (cudaStream_t)stream;
  if (sponge_field == FIELD_FR)
    return launch_tail<FrParams>(partials, inst_coeffs, e_in, state_in, coeffs_out, r_out, e_out,
                                 state_out, npts, k, nblocks, mode, index, st);
  if (sponge_field == FIELD_FQ)
    return launch_tail<FqParams>(partials, inst_coeffs, e_in, state_in, coeffs_out, r_out, e_out,
                                 state_out, npts, k, nblocks, mode, index, st);
  return -1;
}
