// K12: the fixed-base scalar multiplication [s_i] B of N scalars in one
// launch, from 8-bit windows of a table of B's affine multiples, for G1
// (ncomp 1) and G2 (ncomp 2): one thread a lane, above FIXED_TEAM_MAX_LANES
// (device/packed_curve.py; the team kernel of fixed_base_team.cu keeps the
// narrower launches).
//
// Replaces testudo_tpu/tpu/pallas_curve.py:403 `_ec_call("add_mask")` as
// testudo_tpu/tpu/curve.py:429-459 `fixed_base_mul_g1` (and :462-486, G2)
// drives it: a `fori_loop` of 256 dependent launches, bit k of every scalar
// selecting one complete add of the doubling 2^k B onto the accumulators.
// That is about 253 general adds a lane (12 Fq products for G1, 38 for G2)
// once a warp holds random scalars, of which about 126 are kept.  Here a
// lane takes its scalar 8 bits at a time: 32 complete mixed adds (11 / 35
// products) of the row d 2^(8 w) B its digit d picks in window w
// (`lane_fixed_base_window`, ec.cuh), the select keeping the accumulator
// where d = 0.  The sum is the same point as the JAX package's; its
// projective limbs are not (other adds in another order).
//
// The table, point-major (2 nl 256, rows) affine lifts, is built on the card
// by the port's own kernels (`PackedGroup.window_table`: one chain launch
// and one batched inversion of the Zs on the row-major product) once per
// base.  A lane gathers its row, 192 B (G1) or 384 B (G2) of X and Y as
// 128-bit words, from a table of 2.4 MB / 4.7 MB that stays in L2.
//
// Bound on this card: operations (a window's mixed add against one row's
// bytes).  The accumulator stays in the thread for all windows, in the lazy
// layer (the mixed bucket's arithmetic, for both groups) clamped after every
// window; no branch encloses a product but the warp-uniform skip of a
// window that is zero in every lane of the warp (`any_lane`).
#include "ec.cuh"
#include "launch.cuh"

#define TPB_FIXED_WINDOW_MAX 256  // a G2 mixed add takes up to 255 registers a thread
#define TPB_FIXED_WINDOW 64

template <class C>
__global__ void __launch_bounds__(TPB_FIXED_WINDOW_MAX)
k_fixed_base_window(const int* table, const int* scal, int* out, long N, int nl) {
  const long lane = LANE_INDEX(blockDim.x);
  if (lane < N) lane_fixed_base_window<C>(table, scal, out, N, nl, lane);
}

// One thread a lane on blocks of `tpb` (the production launcher below uses
// TPB_FIXED_WINDOW; a measurement may pick others); -3 for a block size
// that is not whole warps up to TPB_FIXED_WINDOW_MAX.
template <class C>
static int fixed_base_window_launch(const int* table, const int* scal, int* out, long N, int nl,
                                    int tpb, cudaStream_t st) {
  if (tpb < 32 || tpb > TPB_FIXED_WINDOW_MAX || tpb % 32) return -3;
  k_fixed_base_window<C><<<GRID_FOR(N, tpb), tpb, 0, st>>>(table, scal, out, N, nl);
  return LAUNCH_STATUS();
}

// Point-major (512 nl, rows) table of affine lifts, 16-byte aligned, and
// (N, nl) canonical scalar limbs -> packed (rows, N) multiples.  ncomp
// selects the group (1: G1, 2: G2); -1 for any other group, -3 for nl out of
// range.
extern "C" int testudo_fixed_base_window(const int* table, const int* scal, int* out, long N,
                                         int nl, int ncomp, void* stream) {
  if (ncomp != 1 && ncomp != 2) return -1;
  if (nl < 1 || nl > 16) return -3;
  if (N <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return ncomp == 1
             ? fixed_base_window_launch<FqCoord>(table, scal, out, N, nl, TPB_FIXED_WINDOW, st)
             : fixed_base_window_launch<Fq2Coord>(table, scal, out, N, nl, TPB_FIXED_WINDOW, st);
}
