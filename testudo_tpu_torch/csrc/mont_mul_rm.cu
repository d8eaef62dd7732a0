// Row-major Montgomery product a * b * R^{-1} mod p over `(n, nlimbs)` int32
// arrays of 16-bit limbs, an element's limbs contiguous (nlimbs = 24: Fq,
// 16: Fr, 48: BW6-761's 761-bit Fq, 16: BLS12-381's Fr; the caller names the
// field by its `FieldId`, fp.cuh), canonical in and out.  `b` is
// `(n, nlimbs)` too, or ONE element that every lane multiplies by
// (`shared_b`), which is how the protocol scales a whole table by a
// challenge, by 1 (out of Montgomery form) or by R^2 (into it): nothing is
// broadcast in memory.
//
// Replaces testudo_tpu/tpu/kernels.py:34 `mont_mul_pallas` (call :51, body
// `_mont_mul_body`).  The TPU kernel tiles 1024 elements per grid step
// through VMEM and needs n to be a multiple of the tile; here the ragged
// edge is masked.  At 48 limbs it replaces
// testudo_tpu/tpu/pallas_field.py:226 `_mont_mul_call(48, q761)`, which every
// product of the BW6-761 group (tpu/curve_generic.py) reaches on the TPU.  At
// BLS12-381's Fr it replaces `_mont_mul_call(16, r381)`, which every product
// of a 381 table of 512 elements or more reaches there (tpu/field.py:292-295;
// the call is keyed by the modulus, so the TPU builds a kernel of its own).
//
// Bound on this card: bytes at every shape (an Fr element moves 3 * 64
// bytes, or 2 * 64 with a shared b, against 136 multiply-adds; an Fq element
// 3 * 96 against 300; a 761-bit element 3 * 192 against 1,176: 0.180 ms of
// bytes at 2^20 elements, 0.074 of operations), down to the sumcheck's short
// tables, where a launch is one round trip to memory and one product's
// latency.  Two forms, picked
// by field, operand and length (`launch_rm`), as measured on the H100:
//   - tiled (k_mont_mul_rm; past RM_NARROW_MAX elements, Fq or a shared b):
//     a tile of RM_TPB rows of each operand is one contiguous span, copied
//     into shared memory with coalesced 16-byte cp.async copies (a warp of
//     threads reading their own 96-byte rows strides its loads across 3 KB),
//     and the products leave the same way; the staged rows are swizzled so
//     that a thread reading its row hits no bank twice in a quarter-warp.
//     The grid is persistent: the card's resident blocks (one a tile when
//     there are fewer tiles) walk the tiles with two stages, the next tile's
//     copy in flight while the current one is multiplied.  A shared b is
//     read once a thread, into registers.
//   - narrow (k_mont_mul_rm_narrow; everything else): one thread an element
//     reading its row straight, one warp a block.  Spreading the warps over
//     the SMs spreads the strided loads over their L1s; for Fr times Fr
//     (64-byte rows) that was as fast as the tiled form or faster at every
//     length, with the operands in L2 or not, and faster than one thread an
//     element at 128 threads a block.  Staging would add a barrier to a
//     short launch, and fewer launches are the fused sumcheck's work, not a
//     kernel's.
#include <atomic>

#include "launch.cuh"
#include "mont_rm.cuh"

template <class F, bool SHARED>
__global__ void __launch_bounds__(RM_TPB)
k_mont_mul_rm(const int* a, const int* b, int* out, long n) {
  extern __shared__ Limb4 rm_smem[];
  constexpr int STAGE = RmStage<F, SHARED>::CHUNKS;
  const int tid = threadIdx.x;
  const long ntiles = (n + RM_TPB - 1) / RM_TPB;
  u32 y[F::N];
  if (SHARED) fp_load_row<F>(y, b);
  long tile = blockIdx.x;
  rm_issue<F, SHARED>(rm_smem, a, b, n, tile, tid);  // the grid has no more blocks than tiles
  rm_commit();
  for (int it = 0; tile < ntiles; tile += gridDim.x, it++) {
    Limb4* cur = rm_smem + (it & 1) * STAGE;
    const long next = tile + gridDim.x;
    if (next < ntiles) rm_issue<F, SHARED>(rm_smem + ((it + 1) & 1) * STAGE, a, b, n, next, tid);
    rm_commit();
    rm_wait_older();
    __syncthreads();  // the tile has landed, every thread's chunks
    rm_row_mul<F, SHARED>(cur, y, tid);
    __syncthreads();  // every product is staged
    rm_drain<F>(out, cur, n, tile, tid);
    __syncthreads();  // the stage is free for the tile after next
  }
}

template <class F, bool SHARED>
__global__ void __launch_bounds__(RM_NARROW_TPB)
k_mont_mul_rm_narrow(const int* a, const int* b, int* out, long n) {
  rm_lane<F, SHARED>(a, b, out, n, LANE_INDEX(RM_NARROW_TPB));
}

#define RM_MAX_DEVICES 64

// The tiled form on a grid of min(tiles, resident blocks of the card).  A
// device's capacity (and the kernel's shared-memory opt-in there) is asked
// at the instantiation's first launch on it; host threads that race to it
// store the same value.
template <class F, bool SHARED>
static int launch_rm_tiled(const int* a, const int* b, int* out, long n, cudaStream_t st) {
  constexpr size_t SMEM = 2 * sizeof(Limb4) * RmStage<F, SHARED>::CHUNKS;
  static std::atomic<long> resident_on[RM_MAX_DEVICES];  // 0: not asked yet
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc != 0) return rc;
  if (dev >= RM_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  long resident = resident_on[dev].load(std::memory_order_relaxed);
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    rc = smem_opt_in(k_mont_mul_rm<F, SHARED>, SMEM);
    if (rc == 0) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == 0)
      rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_mont_mul_rm<F, SHARED>,
                                                              RM_TPB, SMEM);
    if (rc != 0) return rc;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident = (long)per_sm * sms;
    resident_on[dev].store(resident, std::memory_order_relaxed);
  }
  const long tiles = (n + RM_TPB - 1) / RM_TPB;
  const unsigned grid = (unsigned)(tiles < resident ? tiles : resident);
  k_mont_mul_rm<F, SHARED><<<grid, RM_TPB, SMEM, st>>>(a, b, out, n);
  return LAUNCH_STATUS();
}

template <class F, bool SHARED>
static int launch_rm_narrow(const int* a, const int* b, int* out, long n, cudaStream_t st) {
  k_mont_mul_rm_narrow<F, SHARED><<<GRID_FOR(n, RM_NARROW_TPB), RM_NARROW_TPB, 0, st>>>(a, b, out, n);
  return LAUNCH_STATUS();
}

#define RM_NARROW_MAX 8192  // longest array the narrow form always takes

// Past RM_NARROW_MAX elements, Fq arrays and arrays times a shared b take
// the tiled form; every other array takes the narrow one.  On the H100, with
// the L2 cache flushed before each launch, the tiled form won for Fq rows
// (96 bytes: a warp's own-row loads strided across 3 KB) from 2^14 elements
// and for a shared b at 2^16 and 2^20, and lost at 2^17; for Fr rows times
// Fr rows one thread an element at one warp a block was as fast or faster
// at every length (PERF.md, section 6), so the library has no tiled kernel
// for them (tools/exp_mont_rm.py builds one to time it).  The paths' Fq
// arrays are at most 2^12 elements long: the Fq tiled form serves callers
// at K1's widths, such as (393216, 24).
template <class F, bool SHARED>
static int launch_rm(const int* a, const int* b, int* out, long n, cudaStream_t st) {
  if constexpr (Rm<F>::CH == 6 || SHARED) {
    if (n > RM_NARROW_MAX) return launch_rm_tiled<F, SHARED>(a, b, out, n, st);
  }
  return launch_rm_narrow<F, SHARED>(a, b, out, n, st);
}

// `field` (a FieldId) selects the field.  BLS12-381's Fr takes the forms
// BLS12-377's Fr takes (the same 64-byte rows: narrow, and tiled past
// RM_NARROW_MAX with a shared b).  The 761-bit field takes the narrow form at
// every length, a shared b too: the tiled form's swizzle (`rm_slot`) is laid
// out for 4 and 6 chunks a row, and this field's rows have 12.  Returns the
// CUDA error code of the launch, or -1 for an unknown field.
extern "C" int testudo_mont_mul_rm(const int* a, const int* b, int* out, int field,
                                   long n, int shared_b, void* stream) {
  if (field < FIELD_FR || field > FIELD_FR381) return -1;
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (field) {
    case FIELD_FQ761:
      return shared_b ? launch_rm_narrow<Fq761Params, true>(a, b, out, n, st)
                      : launch_rm_narrow<Fq761Params, false>(a, b, out, n, st);
    case FIELD_FQ:
      return shared_b ? launch_rm<FqParams, true>(a, b, out, n, st)
                      : launch_rm<FqParams, false>(a, b, out, n, st);
    case FIELD_FR:
      return shared_b ? launch_rm<FrParams, true>(a, b, out, n, st)
                      : launch_rm<FrParams, false>(a, b, out, n, st);
    default:  // FIELD_FR381
      return shared_b ? launch_rm<Fr381Params, true>(a, b, out, n, st)
                      : launch_rm<Fr381Params, false>(a, b, out, n, st);
  }
}
