// K chained Montgomery products a <- a * b inside one launch, on `(n, L)`
// limb rows and on G independent pairs `(G, n, L)`: the measuring kernels.
// The time of one product is the slope between K = 8 and K = 64, which
// takes the launch, the loads and the stores out of the figure.
//
// Replaces the kernels of the two TPU harnesses, tools/exp_montmul_block.py:114
// (`mk(K, variant)`, :95) and tools/exp_mulmany_wide.py:60 (`mk`, :36).  Their
// variants (`rows` / `block` / `block_splat`; `seq` / `wide`) are
// formulations of one product shaped by the TPU compiler's cost per vector
// op.  What carries over to this card:
//   - two formulations of one product, same limbs out: the body inlined at
//     the call site (how the Montgomery kernels run it) against the shared
//     out-of-line copy `fp_mul` (how the group-law kernels run it);
//   - G independent chains as G * L lanes of one launch (`wide`) against
//     one thread running its G products one after the other (`seq`): more
//     independent lanes, or more independent products per thread.
//
// Bound on this card: operations (2 N^2 + N multiply-adds per product,
// K products per 3 * n * 4 bytes moved).  Operands and the running product
// stay in registers for the whole chain; `seq` holds 2 G elements per
// thread (Fq, inlined: the full 255 registers and 8 bytes of spill).
#include "fp.cuh"
#include "launch.cuh"

#define TPB_CHAIN 128
#define CHAIN_G 6

template <class F, bool INLINE>
__global__ void __launch_bounds__(TPB_CHAIN)
k_mont_chain(const int* a, const int* b, int* out, long L, long groups, int K) {
  long t = LANE_INDEX(TPB_CHAIN);
  if (t < groups * L) lane_mont_chain<F, INLINE>(a, b, out, L, t / L, t % L, K);
}

template <class F, bool INLINE>
__global__ void __launch_bounds__(TPB_CHAIN)
k_mont_chain_seq(const int* a, const int* b, int* out, long L, int K) {
  long lane = LANE_INDEX(TPB_CHAIN);
  if (lane < L) lane_mont_chain_seq<F, INLINE, CHAIN_G>(a, b, out, L, lane, K);
}

template <class F>
static int launch_chain(const int* a, const int* b, int* out, long L, long groups, int K,
                        int inline_body, cudaStream_t st) {
  unsigned grid = GRID_FOR(groups * L, TPB_CHAIN);
  if (inline_body)
    k_mont_chain<F, true><<<grid, TPB_CHAIN, 0, st>>>(a, b, out, L, groups, K);
  else
    k_mont_chain<F, false><<<grid, TPB_CHAIN, 0, st>>>(a, b, out, L, groups, K);
  return LAUNCH_STATUS();
}

template <class F>
static int launch_chain_seq(const int* a, const int* b, int* out, long L, int K,
                            int inline_body, cudaStream_t st) {
  if (inline_body)
    k_mont_chain_seq<F, true><<<GRID_FOR(L, TPB_CHAIN), TPB_CHAIN, 0, st>>>(a, b, out, L, K);
  else
    k_mont_chain_seq<F, false><<<GRID_FOR(L, TPB_CHAIN), TPB_CHAIN, 0, st>>>(a, b, out, L, K);
  return LAUNCH_STATUS();
}

// K chained products on (nlimbs, L) rows of the field `field` (a FieldId,
// fp.cuh).  inline_body picks the formulation (1: inlined, 0: the shared
// `fp_mul`).  BW6-761's Fq and BLS12-381's Fr are here for one number each,
// the latency of one dependent product at one warp.  Returns the CUDA error
// code of the launch, or -1 for an unknown field.
extern "C" int testudo_mont_chain(const int* a, const int* b, int* out, int field, long L,
                                  int K, int inline_body, void* stream) {
  if (field < FIELD_FR || field > FIELD_FR381) return -1;
  if (L <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (field == FIELD_FQ) return launch_chain<FqParams>(a, b, out, L, 1, K, inline_body, st);
  if (field == FIELD_FR) return launch_chain<FrParams>(a, b, out, L, 1, K, inline_body, st);
  if (field == FIELD_FQ761)
    return launch_chain<Fq761Params>(a, b, out, L, 1, K, inline_body, st);
  return launch_chain<Fr381Params>(a, b, out, L, 1, K, inline_body, st);
}

// The same on (G, nlimbs, L), BLS12-377's Fq or Fr.  wide = 1: G * L lanes,
// one chain each; wide = 0: L lanes, each thread runs its G chains step by
// step (G must be 6, the size of the two product groups of the complete
// addition).  -1 for another field or group size.
extern "C" int testudo_mont_chain_group(const int* a, const int* b, int* out, int field,
                                        int G, long L, int K, int wide, int inline_body,
                                        void* stream) {
  if (field != FIELD_FQ && field != FIELD_FR) return -1;
  if (L <= 0 || G <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (wide) {
    if (field == FIELD_FQ) return launch_chain<FqParams>(a, b, out, L, G, K, inline_body, st);
    return launch_chain<FrParams>(a, b, out, L, G, K, inline_body, st);
  }
  if (G != CHAIN_G) return -1;
  if (field == FIELD_FQ) return launch_chain_seq<FqParams>(a, b, out, L, K, inline_body, st);
  return launch_chain_seq<FrParams>(a, b, out, L, K, inline_body, st);
}
