// One round of the fused sumcheck over Fr tables: the optional fold of every
// table by the previous round's challenge, then each instance's sums of the
// combination at X = 0, 2 (and 3), one partial sum a block
// (sumcheck.cuh).  In place of the reference's per-round XLA ops inside the
// fused jit (testudo_tpu/core/sumcheck.py:222-267 and :534-594 over
// `_round_evals_*` :62-114 and `dense.bound_top`), whose products over 512
// rows or more reach the Pallas product `_mont_mul_call`
// (testudo_tpu/tpu/pallas_field.py:226, through tpu/field.py:292-295).
//
// Bound on this card: bytes.  A round reads every table once (64 bytes a
// row) and, folding, writes half of it; its products (2 a table a pair for
// the fold, 2 or 3 a point for the combination) are 14 Fr products or fewer
// for each 256 bytes read, under the card's multiply-add rate.  One thread a
// pair of rows, reading each row straight (as the row-major product's narrow
// form: a warp's 64-byte rows land in L1), a grid-stride loop over at most
// SC_MAX_BLOCKS blocks of SC_TPB threads a y-row of instances; a block's sums
// by a warp butterfly and shared memory.  The partial sums stay exact, so the
// order of the additions does not matter.
#include "launch.cuh"
#include "sumcheck.cuh"

template <int KIND>
__global__ void __launch_bounds__(SC_TPB)
k_sumcheck_round(const int* src, int* dst, const int* r_row, int* partials, long n, int fold,
                 int kp, int ks) {
  constexpr int NP = ScKind<KIND>::NPTS;
  __shared__ u32 sh[SC_TPB / 32][NP][FRN];
  const int inst = blockIdx.y;
  const bool last = fold && n == 2;
  u32 r[FRN], acc[NP][FRN];
  if (fold)
    fp_load_row<Fr>(r, r_row);
  else
    fp_zero<Fr>(r);
  FP_UNROLL
  for (int pt = 0; pt < NP; pt++) fp_zero<Fr>(acc[pt]);
  const long pairs = sc_pairs(n, fold);
  for (long p = (long)blockIdx.x * SC_TPB + threadIdx.x; p < pairs; p += (long)gridDim.x * SC_TPB)
    sc_pair<KIND>(acc, src, dst, r, n, p, inst, kp, ks, fold, !last);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  FP_UNROLL
  for (int pt = 0; pt < NP; pt++) {
    warp_sum<Fr>(acc[pt]);
    if (lane == 0) fp_copy<Fr>(sh[warp][pt], acc[pt]);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  int* out = partials + ((long)inst * gridDim.x + blockIdx.x) * NP * FR_ROW;
  FP_UNROLL
  for (int pt = 0; pt < NP; pt++) {
    FP_UNROLL
    for (int w = 1; w < SC_TPB / 32; w++) fp_add<Fr>(sh[0][pt], sh[0][pt], sh[w][pt]);
    fp_store_row<Fr>(out + pt * FR_ROW, sh[0][pt]);
  }
}

template <int KIND>
static int launch_round(const int* src, int* dst, const int* r, int* partials, long n, int fold,
                        int kp, int ks, int nblocks, cudaStream_t st) {
  const unsigned k = KIND == SC_CUBIC ? (unsigned)(kp + ks) : 1u;
  k_sumcheck_round<KIND><<<dim3((unsigned)nblocks, k), SC_TPB, 0, st>>>(src, dst, r, partials, n,
                                                                       fold, kp, ks);
  return LAUNCH_STATUS();
}

// src: (T, n, 16) stacked tables; with `fold`, dst: (T, n / 2, 16) and r one
// Fr row; partials: (k, nblocks, points, 16).  Returns the CUDA error code of
// the launch, -1 for an unknown kind, -3 for arguments it does not take.
extern "C" int testudo_sumcheck_round(const int* src, int* dst, const int* r, int* partials,
                                      int kind, long n, int fold, int k_par, int k_seq,
                                      int nblocks, void* stream) {
  if (n < 2 || (n & (n - 1)) || nblocks < 1 || nblocks > SC_MAX_BLOCKS || k_par < 0 ||
      k_seq < 0 || (kind == SC_CUBIC && k_par + k_seq < 1))
    return -3;
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == SC_QUAD)
    return launch_round<SC_QUAD>(src, dst, r, partials, n, fold, k_par, k_seq, nblocks, st);
  if (kind == SC_CUBIC_TAU)
    return launch_round<SC_CUBIC_TAU>(src, dst, r, partials, n, fold, k_par, k_seq, nblocks, st);
  if (kind == SC_CUBIC)
    return launch_round<SC_CUBIC>(src, dst, r, partials, n, fold, k_par, k_seq, nblocks, st);
  return -1;
}
