// K6: bucket accumulation.  Lane l sums, in order onto the identity, the
// `count[l]` table points at positions start[l], start[l] + 1, ... of a
// sorted index list (or of the table itself), with the complete mixed add
// for affine tables or the complete general add, for G1 (rows of 72 limbs,
// ncomp 1) and G2 (rows of 144, ncomp 2).
//
// Replaces testudo_tpu/tpu/pallas_curve.py `_ec_call("bucket")` and
// `_ec_call("bucket_mixed")` (:461-552) together with the gather that feeds
// them (testudo_tpu/tpu/msm.py:618-625, :664-670).  The TPU version
// materialises a `(T, 72, lanes)` run tensor with an XLA gather and streams
// it through double-buffered DMA, which forces a memory budget and lane
// chunking; here the kernel gathers by index itself, from a point-major
// table, so no run tensor exists.
//
// Bound on this card: operations.  One G1 mixed add is 11 Montgomery
// products (3,300 32-bit multiply-adds) against 192 bytes read, one G2 mixed
// add 35 products against 384 bytes.  The accumulator stays with the thread
// for the lane's whole run (lane_bucket in ec.cuh); a point's X and Y are 96
// contiguous bytes per Fq component, read as 128-bit words (the mixed
// variant never reads Z).
//
// What held it back (PERF.md section 6, PR 5): the schedule, not the
// gathers.  The MSM plan is tailed: at 2^20 its last 2,029 lanes (the top
// window's 32 buckets, cut into segments) run 512 adds, twice a mean lane,
// and a grid of one thread per lane in plan order started them only after
// the first wave, on a card that was then nearly empty; and the lanes of a
// warp differed in length (a warp runs as long as its longest lane).  Taking
// the lanes longest first cut the G1 launch from 33 to 23 ms; reading every
// row from a 1,024-row table instead of the 604 MB one moved it by 2-5%, and
// copying the next row ahead with cp.async by 1% (G1) or cost 9% (G2), so
// nothing is prefetched.  More resident blocks (__launch_bounds__ minimum
// blocks, fewer registers) made every variant slower: the call frames of
// fp_mul in local memory already exceed L1 at the natural occupancy.
//
// Design: a persistent grid of the card's resident capacity at the
// kernel's natural register count (queried once per group and mode).  Each
// warp takes the next 32 lanes of a longest-first order `perm` (the
// wrapper's stable argsort of count) from a device counter with one
// atomicAdd, until none are left: the longest runs start first, a warp's
// lanes have nearly equal counts, and the card stays full until the
// shortest lanes run out.  A thread writes its sum to column perm[i], so the
// order is invisible downstream, and one thread adds a lane's points in
// order, so no limb depends on the schedule.  The loop bound of a warp is
// uniform; inside, each thread's trip count is its lane's own.
#include "ec.cuh"
#include "launch.cuh"

#define TPB_BUCKET 64

template <class C, bool MIXED>
__global__ void __launch_bounds__(TPB_BUCKET)
k_bucket(const int* table, const int* idx, const int* start, const int* count,
         const int* perm, int* next, int* out, long L) {
  const unsigned lid = threadIdx.x & 31u;
  for (;;) {
    int first = 0;
    if (lid == 0) first = atomicAdd(next, 32);
    first = __shfl_sync(0xffffffffu, first, 0);
    if ((long)first >= L) return;
    long i = (long)first + lid;
    if (i < L) lane_bucket<C, MIXED>(table, idx, start, count, out, L, (long)perm[i]);
  }
}

// Resident blocks of k_bucket<C, MIXED> on the current card (its blocks per
// SM at TPB_BUCKET threads times the SM count), queried at the first call
// and kept; 0 if the query failed.
template <class C, bool MIXED>
static int bucket_capacity() {
  static int capacity = 0;
  if (capacity == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_bucket<C, MIXED>, TPB_BUCKET,
                                                      0) != cudaSuccess)
      return 0;
    capacity = per_sm * sms;
  }
  return capacity;
}

template <class C, bool MIXED>
static int launch_bucket(const int* table, const int* idx, const int* start, const int* count,
                         const int* perm, int* next, int* out, long L, cudaStream_t st) {
  int capacity = bucket_capacity<C, MIXED>();
  if (capacity <= 0) {
    int err = LAUNCH_STATUS();
    return err ? err : -1;
  }
  unsigned grid = GRID_FOR(L, TPB_BUCKET);
  if (grid > (unsigned)capacity) grid = (unsigned)capacity;
  k_bucket<C, MIXED><<<grid, TPB_BUCKET, 0, st>>>(table, idx, start, count, perm, next, out, L);
  return LAUNCH_STATUS();
}

// idx may be null: positions then index the table directly.  perm is a
// permutation of the L lanes (longest first); next is one int32 that is 0
// at the launch (the kernel's work counter).  ncomp selects the group (1:
// G1, 2: G2); -1 for any other, or for more than 2^30 lanes.
extern "C" int testudo_bucket(const int* table, const int* idx, const int* start,
                              const int* count, const int* perm, int* next, int* out, long L,
                              int mixed, int ncomp, void* stream) {
  if (L <= 0) return 0;
  if (L > (1L << 30)) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (ncomp == 1)
    return mixed ? launch_bucket<FqCoord, true>(table, idx, start, count, perm, next, out, L, st)
                 : launch_bucket<FqCoord, false>(table, idx, start, count, perm, next, out, L, st);
  if (ncomp == 2)
    return mixed ? launch_bucket<Fq2Coord, true>(table, idx, start, count, perm, next, out, L, st)
                 : launch_bucket<Fq2Coord, false>(table, idx, start, count, perm, next, out, L, st);
  return -1;
}

// Resident blocks the launch above would use for this group and mode
// (its grid is the smaller of this and one thread per lane); -1 for an
// unknown group, 0 if the query failed.
extern "C" int testudo_bucket_capacity(int mixed, int ncomp) {
  if (ncomp == 1) return mixed ? bucket_capacity<FqCoord, true>() : bucket_capacity<FqCoord, false>();
  if (ncomp == 2) return mixed ? bucket_capacity<Fq2Coord, true>() : bucket_capacity<Fq2Coord, false>();
  return -1;
}
