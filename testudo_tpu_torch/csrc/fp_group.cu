// BW6-761's group law as one kernel, a thread a lane, for both BW6 groups:
// the elementwise complete add, mixed add and double, the chunk sums of
// `msm_fp`'s bucket runs and the fixed-base multiplication of
// `fixed_base_mul` (device/curve_generic.py, device/msm.py).
//
// Replaces testudo_tpu/tpu/pallas_field.py:226 `_mont_mul_call(48, q761)` as
// testudo_tpu/tpu/curve_generic.py:29-91 `FpGroup` drives it: there every
// product of the RCB16 formulas (tpu/curve.py) is a batched `jf.mont_mul`
// (the Pallas kernel for 512 lanes or more) and every sum an XLA op, and the
// port's first form did the same, each formula stage's products one launch
// of the 761-bit row-major product and the sums int32 tensor ops: 87 ms for
// a complete add at 2^20 lanes, about 70% of it sums.  Here one thread runs
// a whole formula on its lane's point (ec.cuh's `ec_add`, `ec_add_mixed`,
// `ec_double` over the strict policy `Fq761Coord<B>`), in registers and its
// frame, and writes only the result.
//
// Bound on this card: operations.  A complete add is 12 761-bit products
// (1,176 32-bit multiply-adds each; the product by 3b is sums here), a mixed
// add 11, a double 8, against 9 coordinates of 192 bytes moved.
//
// Three entry points, each for G1 (b = -1) and G2 (b = 4):
//   - `testudo_fp_group_op`: one formula over n lanes (FpGroup.add,
//     add_mixed, double on CUDA tensors).
//   - `testudo_fp_chunk_sums`: lane l adds, in order onto the identity, the
//     count[l] points at idx[start[l]], idx[start[l] + 1], ... (the sort's
//     order of a bucket run read through its index: the gather is fused).
//     The caller cuts each run into chunks of at most `_FP_CHUNK` entries,
//     so a lane's serial work is bounded whatever the skew of the digits (a
//     boolean witness makes one run as long as its count of ones), and
//     halves the chunk sums pairwise with the elementwise add.
//   - `testudo_fp_fixed_base`: lane l holds its accumulator over all 2 nl
//     8-bit windows of its scalar: the digit, the affine table row it picks,
//     the mixed add and the select, the add skipped where no lane of the
//     warp has a nonzero digit (`lane_fpg_fixed_base`).
// A thread's point is 3 x 96 bytes, as large as a G2 point of BLS12-377, so
// the frames are G2's (255 registers, the products' operands in local
// memory: fp_mul is a real call); the launches are plain grids of
// FPG_TPB-thread blocks, one thread a lane.
#include "ec.cuh"
#include "launch.cuh"

#define FPG_TPB 64

template <class A, int OP>
__global__ void __launch_bounds__(FPG_TPB)
k_fpg_op(const int* x1, const int* y1, const int* z1, const int* x2, const int* y2,
         const int* z2, int* ox, int* oy, int* oz, long n) {
  const long lane = LANE_INDEX(FPG_TPB);
  if (lane < n) lane_fpg_op<A, OP>(x1, y1, z1, x2, y2, z2, ox, oy, oz, lane);
}

template <class A>
__global__ void __launch_bounds__(FPG_TPB)
k_fpg_chunk(const int* x, const int* y, const int* z, const int* idx, const int* start,
            const int* count, int* ox, int* oy, int* oz, long n) {
  const long lane = LANE_INDEX(FPG_TPB);
  if (lane < n) lane_fpg_chunk<A>(x, y, z, idx, start, count, ox, oy, oz, lane);
}

template <class A>
__global__ void __launch_bounds__(FPG_TPB)
k_fpg_fixed_base(const int* tx, const int* ty, const int* scal, int* ox, int* oy, int* oz,
                 int nl, long n) {
  const long lane = LANE_INDEX(FPG_TPB);
  if (lane < n) lane_fpg_fixed_base<A>(tx, ty, scal, ox, oy, oz, nl, lane);
}

template <class A>
static int launch_op(const int* x1, const int* y1, const int* z1, const int* x2, const int* y2,
                     const int* z2, int* ox, int* oy, int* oz, long n, int op, cudaStream_t st) {
  const unsigned grid = GRID_FOR(n, FPG_TPB);
  if (op == FPG_ADD)
    k_fpg_op<A, FPG_ADD><<<grid, FPG_TPB, 0, st>>>(x1, y1, z1, x2, y2, z2, ox, oy, oz, n);
  else if (op == FPG_ADD_MIXED)
    k_fpg_op<A, FPG_ADD_MIXED><<<grid, FPG_TPB, 0, st>>>(x1, y1, z1, x2, y2, z2, ox, oy, oz, n);
  else
    k_fpg_op<A, FPG_DOUBLE><<<grid, FPG_TPB, 0, st>>>(x1, y1, z1, x2, y2, z2, ox, oy, oz, n);
  return LAUNCH_STATUS();
}

template <class A>
static int launch_chunk(const int* x, const int* y, const int* z, const int* idx,
                        const int* start, const int* count, int* ox, int* oy, int* oz, long n,
                        cudaStream_t st) {
  k_fpg_chunk<A><<<GRID_FOR(n, FPG_TPB), FPG_TPB, 0, st>>>(x, y, z, idx, start, count, ox, oy,
                                                           oz, n);
  return LAUNCH_STATUS();
}

template <class A>
static int launch_fixed_base(const int* tx, const int* ty, const int* scal, int* ox, int* oy,
                             int* oz, long n, int nl, cudaStream_t st) {
  k_fpg_fixed_base<A><<<GRID_FOR(n, FPG_TPB), FPG_TPB, 0, st>>>(tx, ty, scal, ox, oy, oz, nl, n);
  return LAUNCH_STATUS();
}

// Each launcher takes the field (a FieldId: FIELD_FQ761 only) and the
// group's curve constant b (-1: G1, 4: G2), and returns -1 for any other.

// One formula (op: 0 add, 1 mixed add, 2 double) over n lanes; the second
// point's arrays are not read by the double, its z not by the mixed add.
extern "C" int testudo_fp_group_op(const int* x1, const int* y1, const int* z1, const int* x2,
                                   const int* y2, const int* z2, int* ox, int* oy, int* oz,
                                   long n, int op, int field, int b, void* stream) {
  if (field != FIELD_FQ761 || (b != -1 && b != 4) || op < FPG_ADD || op > FPG_DOUBLE) return -1;
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return b == -1 ? launch_op<Fq761Coord<-1>>(x1, y1, z1, x2, y2, z2, ox, oy, oz, n, op, st)
                 : launch_op<Fq761Coord<4>>(x1, y1, z1, x2, y2, z2, ox, oy, oz, n, op, st);
}

// n chunk sums: lane l adds the count[l] points idx[start[l] + t] of (x, y,
// z) in order; every idx entry a lane reads must index a point.
extern "C" int testudo_fp_chunk_sums(const int* x, const int* y, const int* z, const int* idx,
                                     const int* start, const int* count, int* ox, int* oy,
                                     int* oz, long n, int field, int b, void* stream) {
  if (field != FIELD_FQ761 || (b != -1 && b != 4)) return -1;
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return b == -1 ? launch_chunk<Fq761Coord<-1>>(x, y, z, idx, start, count, ox, oy, oz, n, st)
                 : launch_chunk<Fq761Coord<4>>(x, y, z, idx, start, count, ox, oy, oz, n, st);
}

// [s_l] B for n lanes: scal (n, nl) canonical 16-bit limbs, (tx, ty) the
// (2 nl 256, 48) affine rows of `_window_table`; nl in 1 .. 32.
extern "C" int testudo_fp_fixed_base(const int* tx, const int* ty, const int* scal, int* ox,
                                     int* oy, int* oz, long n, int nl, int field, int b,
                                     void* stream) {
  if (field != FIELD_FQ761 || (b != -1 && b != 4) || nl < 1 || nl > 32) return -1;
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return b == -1 ? launch_fixed_base<Fq761Coord<-1>>(tx, ty, scal, ox, oy, oz, n, nl, st)
                 : launch_fixed_base<Fq761Coord<4>>(tx, ty, scal, ox, oy, oz, n, nl, st);
}
