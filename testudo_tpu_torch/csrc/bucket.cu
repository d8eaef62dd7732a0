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
// for the lane's whole run; a point's X and Y are 96 contiguous bytes per
// Fq component, read as 128-bit words (the mixed variant never reads Z).  The loop bound is the
// lane's own count: lanes are sorted by (window, bucket), so the counts in
// a warp are close and little of a warp idles.
#include "ec.cuh"
#include "launch.cuh"

#define TPB_BUCKET 64

template <class C, bool MIXED>
__global__ void __launch_bounds__(TPB_BUCKET)
k_bucket(const int* table, const int* idx, const int* start, const int* count,
         int* out, long L) {
  long lane = LANE_INDEX(TPB_BUCKET);
  if (lane < L) lane_bucket<C, MIXED>(table, idx, start, count, out, L, lane);
}

template <class C>
static int launch_bucket(const int* table, const int* idx, const int* start,
                         const int* count, int* out, long L, int mixed,
                         cudaStream_t st) {
  if (mixed)
    k_bucket<C, true><<<GRID_FOR(L, TPB_BUCKET), TPB_BUCKET, 0, st>>>(
        table, idx, start, count, out, L);
  else
    k_bucket<C, false><<<GRID_FOR(L, TPB_BUCKET), TPB_BUCKET, 0, st>>>(
        table, idx, start, count, out, L);
  return LAUNCH_STATUS();
}

// idx may be null: positions then index the table directly.  ncomp selects
// the group (1: G1, 2: G2); -1 for any other.
extern "C" int testudo_bucket(const int* table, const int* idx, const int* start,
                              const int* count, int* out, long L, int mixed,
                              int ncomp, void* stream) {
  if (L <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (ncomp == 1) return launch_bucket<FqCoord>(table, idx, start, count, out, L, mixed, st);
  if (ncomp == 2) return launch_bucket<Fq2Coord>(table, idx, start, count, out, L, mixed, st);
  return -1;
}
