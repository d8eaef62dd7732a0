// One round of the fused sumcheck over Fr tables: the optional fold of every
// table by the previous round's challenge, then each instance's sums of the
// combination at X = 0, 2 (and 3), one partial sum a block
// (sumcheck.cuh).  In place of the reference's per-round XLA ops inside the
// fused jit (testudo_tpu/core/sumcheck.py:222-267 and :534-594 over
// `_round_evals_*` :62-114 and `dense.bound_top`), whose products over 512
// rows or more reach the Pallas product `_mont_mul_call`
// (testudo_tpu/tpu/pallas_field.py:226, through tpu/field.py:292-295).
//
// Bound on this card: bytes from about 2^15 rows up.  A round reads every
// table once (64 bytes a row) and, folding, writes half of it; its products
// (2 a table a pair for the fold, 1 or 2 a point for the combination) are 14
// Fr products or fewer for each 256 bytes read, under the card's
// multiply-add rate but near the rate a chain of products reaches, so what
// limits a launch is how many independent products the resident warps keep
// in flight.  Below, a round is one launch and one chain: the rows' loads,
// one fold product, one or two combination products and the block's sums.
//
// Two forms (sumcheck.cuh), as measured on the H100
// (tools/exp_sumcheck_round.py):
//   - tiled (k_sumcheck_round; every round with a fold, and rounds without
//     one below SC_STRAIGHT_MIN_PAIRS pairs): blocks of NT P threads, a
//     thread a (table, pair) folding both halves of its pair, the folded
//     rows through shared memory to a thread a (pair, point); 128
//     registers a thread; the chain of a pair is three products, not the 14
//     of one thread a pair.  Small tiles where their grid is at most
//     SC_SMALL_GRID blocks (a block's work is its chain), large tiles above
//     (128 pairs, 64 for quad); at most a block for 128 pairs.  Staging the
//     rows by cp.async ahead of the products, with a thread a folded row,
//     was slower at every shape.
//   - straight (k_sumcheck_round_straight; large rounds without a fold): a
//     thread a pair reads its rows and adds every point's combination, no
//     barrier between warps.
// Both take a persistent grid of the card's resident blocks (the occupancy
// of the kernel at its shared memory; fewer when there are fewer tiles or
// pairs), shared by the block rows; a block covers 128 pairs or more (or
// the grid is at most 32 blocks), so a round gives its tail no more lane
// steps of partial sums than one thread a pair did.  The partial sums stay exact, so the
// order of the additions does not matter; a block's sums by a warp
// butterfly (a warp holds one point) and shared memory.
#include <atomic>

#include "launch.cuh"
#include "sumcheck.cuh"

#define SC_MAX_DEVICES 64

// Tiled: resident blocks an SM the registers must allow, 128 registers a
// thread (as many blocks as 512 threads make; the shared memory allows
// them).
template <int KIND, int P>
constexpr int sc_min_blocks() {
  return ScTile<KIND, P>::TPB >= 512 ? 1 : 512 / ScTile<KIND, P>::TPB;
}

template <int KIND, int P, int MINB = sc_min_blocks<KIND, P>(), int TPB = ScTile<KIND, P>::TPB>
__global__ void __launch_bounds__(TPB, MINB)
k_sumcheck_round(const int* src, int* dst, const int* r_row, int* partials, long n, int fold,
                 int kp, int ks) {
  extern __shared__ Limb4 sc_smem[];
  __shared__ u32 sh[TPB / 32][FRN];
  const int tid = threadIdx.x;
  const ScRow row = sc_row<KIND>(blockIdx.y, kp, ks, n, fold);
  u32 r[FRN], acc[FRN];
  if (fold)
    fp_load_row<Fr>(r, r_row);
  else
    fp_zero<Fr>(r);
  fp_zero<Fr>(acc);
  const long pairs = sc_pairs(n, fold);
  const int PT = sc_tile_pairs(P, fold);
  for (long tile = blockIdx.x; tile * PT < pairs; tile += gridDim.x) {
    sc_load<KIND, P>(sc_smem, dst, src, r, n, tile * PT, pairs, fold, row, tid);
    __syncthreads();  // every row of the tile in shared memory
    if (row.eval) sc_comb_item<KIND, P, TPB>(acc, sc_smem, tile * PT, pairs, fold, tid);
    __syncthreads();  // the regions are free for the next tile
  }
  if ((int)blockIdx.y >= sc_instances<KIND>(kp, ks)) return;  // the fold-only row
  const int lane = tid & 31, warp = tid >> 5;
  warp_sum<Fr>(acc);
  if (lane == 0) fp_copy<Fr>(sh[warp], acc);
  __syncthreads();
  constexpr int NP = ScKind<KIND>::NPTS;
  if (tid >= NP) return;
  const int per = sc_comb_threads<KIND, TPB>(PT) / 32;  // warps a point
  u32 s[FRN];
  fp_copy<Fr>(s, sh[tid * per]);
  for (int w = 1; w < per; w++) fp_add<Fr>(s, s, sh[tid * per + w]);
  fp_store_row<Fr>(partials + (((long)blockIdx.y * gridDim.x + blockIdx.x) * NP + tid) * FR_ROW, s);
}

template <int KIND, int TPB = sc_straight_tpb<KIND>()>
__global__ void __launch_bounds__(TPB)
k_sumcheck_round_straight(const int* src, int* partials, long n, int kp, int ks) {
  constexpr int NP = ScKind<KIND>::NPTS;
  __shared__ u32 sh[TPB / 32][NP][FRN];
  const ScRow row = sc_row<KIND>(blockIdx.y, kp, ks, n, false);
  u32 acc[NP][FRN];
  FP_UNROLL
  for (int pt = 0; pt < NP; pt++) fp_zero<Fr>(acc[pt]);
  const long pairs = n / 2;
  for (long p = (long)blockIdx.x * TPB + threadIdx.x; p < pairs; p += (long)gridDim.x * TPB)
    sc_pair_straight<KIND>(acc, src, n, p, row);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  FP_UNROLL
  for (int pt = 0; pt < NP; pt++) {
    warp_sum<Fr>(acc[pt]);
    if (lane == 0) fp_copy<Fr>(sh[warp][pt], acc[pt]);
  }
  __syncthreads();
  if (threadIdx.x >= NP) return;
  const int pt = threadIdx.x;
  u32 s[FRN];
  fp_copy<Fr>(s, sh[0][pt]);
  for (int w = 1; w < TPB / 32; w++) fp_add<Fr>(s, s, sh[w][pt]);
  fp_store_row<Fr>(partials + (((long)blockIdx.y * gridDim.x + blockIdx.x) * NP + pt) * FR_ROW, s);
}

// Resident blocks of a kernel on the current device (after opting in to
// its dynamic shared memory: with the static block sums even 48 KB of it
// needs the opt-in), asked at the first use on a device and kept in `on`;
// 0 if a query fails.  Host threads that race to it store the same value.
template <class K>
static int sc_capacity(std::atomic<int>* on, K kernel, int tpb, int smem) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= SC_MAX_DEVICES) return 0;
  int cap = on[dev].load(std::memory_order_relaxed);
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    if ((smem > 0 && cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          smem) != cudaSuccess) ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, tpb, smem) != cudaSuccess)
      return 0;
    cap = per_sm * sms;
    on[dev].store(cap, std::memory_order_relaxed);
  }
  return cap;
}

template <int KIND, int P>
static int tiled_capacity() {
  static std::atomic<int> on[SC_MAX_DEVICES];
  return sc_capacity(on, k_sumcheck_round<KIND, P>, ScTile<KIND, P>::TPB, ScTile<KIND, P>::SMEM);
}

template <int KIND>
static int straight_capacity() {
  static std::atomic<int> on[SC_MAX_DEVICES];
  return sc_capacity(on, k_sumcheck_round_straight<KIND>, sc_straight_tpb<KIND>(), 0);
}

// Blocks a row of a grid that needs `want` blocks, at most the resident
// blocks `cap` shared by `rows` rows; 0 if the occupancy query failed.
static long sc_grid(long want, long cap, int rows) {
  const long most = cap / rows;
  return cap <= 0 ? 0 : want < most ? want : most > 0 ? most : 1;
}

// The most blocks a tiled round takes (SC_PAIRS_A_BLOCK).
SC_HD long sc_tiled_max(long n, bool fold) {
  const long a_block = (sc_pairs(n, fold) + SC_PAIRS_A_BLOCK - 1) / SC_PAIRS_A_BLOCK;
  return a_block > SC_SMALL_GRID ? a_block : SC_SMALL_GRID;
}

// The grid of a round in its form: the tiles (at most sc_tiled_max), or
// the straight form's blocks of pairs, at most the resident blocks shared
// by the rows.
template <int KIND>
static long round_grid(long n, bool fold, int kp, int ks) {
  constexpr int SP = ScKind<KIND>::P_SMALL, LP = ScKind<KIND>::P_LARGE;
  constexpr int TPB = sc_straight_tpb<KIND>();
  const int rows = sc_rows<KIND>(kp, ks, fold);
  const long most = sc_tiled_max(n, fold);
  switch (sc_form<KIND>(n, fold)) {
    case SC_STRAIGHT:
      return sc_grid((sc_pairs(n, fold) + TPB - 1) / TPB, straight_capacity<KIND>(), rows);
    case SC_TILED_SMALL: {
      const long t = sc_tiles(SP, n, fold);
      return sc_grid(t < most ? t : most, tiled_capacity<KIND, SP>(), rows);
    }
    default: {
      const long t = sc_tiles(LP, n, fold);
      return sc_grid(t < most ? t : most, tiled_capacity<KIND, LP>(), rows);
    }
  }
}

template <int KIND, int P>
static void launch_tiled(const int* src, int* dst, const int* r, int* partials, long n, int fold,
                         int kp, int ks, dim3 grid, cudaStream_t st) {
  constexpr int TPB = ScTile<KIND, P>::TPB, SMEM = ScTile<KIND, P>::SMEM;
  k_sumcheck_round<KIND, P><<<grid, TPB, SMEM, st>>>(src, dst, r, partials, n, fold, kp, ks);
}

template <int KIND>
static int launch_round(const int* src, int* dst, const int* r, int* partials, long n, int fold,
                        int kp, int ks, int nblocks, cudaStream_t st) {
  if (round_grid<KIND>(n, fold != 0, kp, ks) <= 0) {  // also opts in to shared memory
    const int err = LAUNCH_STATUS();
    return err ? err : -2;
  }
  const dim3 grid((unsigned)nblocks, (unsigned)sc_rows<KIND>(kp, ks, fold != 0));
  switch (sc_form<KIND>(n, fold != 0)) {
    case SC_STRAIGHT: {
      constexpr int TPB = sc_straight_tpb<KIND>();
      k_sumcheck_round_straight<KIND><<<grid, TPB, 0, st>>>(src, partials, n, kp, ks);
      break;
    }
    case SC_TILED_SMALL:
      launch_tiled<KIND, ScKind<KIND>::P_SMALL>(src, dst, r, partials, n, fold, kp, ks, grid, st);
      break;
    default:
      launch_tiled<KIND, ScKind<KIND>::P_LARGE>(src, dst, r, partials, n, fold, kp, ks, grid, st);
  }
  return LAUNCH_STATUS();
}

// src: (T, n, 16) stacked tables; with `fold`, dst: (T, n / 2, 16) and r one
// Fr row; partials: (k, nblocks, points, 16), nblocks what
// testudo_sumcheck_round_grid gives for the round (any number from 1 on
// computes the same sums; that one is the measured grid).  Returns the CUDA
// error code of the launch, -1 for an unknown kind, -2 when the occupancy
// query failed without one, -3 for arguments it does not take.
extern "C" int testudo_sumcheck_round(const int* src, int* dst, const int* r, int* partials,
                                      int kind, long n, int fold, int k_par, int k_seq,
                                      int nblocks, void* stream) {
  if (n < 2 || (n & (n - 1)) || nblocks < 1 || k_par < 0 || k_seq < 0 ||
      (kind == SC_CUBIC && k_par + k_seq < 1))
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

// Blocks a row of the round's grid on the current device; 0 if the
// occupancy query failed, -1 for an unknown kind, -3 for arguments the
// round does not take.  Launches nothing.
extern "C" int testudo_sumcheck_round_grid(int kind, long n, int fold, int k_par, int k_seq) {
  if (n < 2 || (n & (n - 1)) || k_par < 0 || k_seq < 0 || (kind == SC_CUBIC && k_par + k_seq < 1))
    return -3;
  if (kind == SC_QUAD) return (int)round_grid<SC_QUAD>(n, fold != 0, k_par, k_seq);
  if (kind == SC_CUBIC_TAU) return (int)round_grid<SC_CUBIC_TAU>(n, fold != 0, k_par, k_seq);
  if (kind == SC_CUBIC) return (int)round_grid<SC_CUBIC>(n, fold != 0, k_par, k_seq);
  return -1;
}
