// CPU build of the kernels' per-lane bodies (fp.cuh, g1.cuh compile as plain
// C++): the same arithmetic the CUDA kernels run, looped over lanes, with
// the same C interface minus the stream.  tests/test_torch_csrc.py builds
// this with the host compiler and holds it against the plain PyTorch
// versions, so the field and group code is checked where there is no GPU.
#include "g1.cuh"

extern "C" {

int host_mont_mul(const int* a, const int* b, int* out, int nlimbs, long m) {
  for (long lane = 0; lane < m; lane++) {
    if (nlimbs == 24)
      lane_mont_mul<FqParams>(a, b, out, m, lane);
    else if (nlimbs == 16)
      lane_mont_mul<FrParams>(a, b, out, m, lane);
    else
      return -1;
  }
  return 0;
}

int host_add2(const int* a, const int* b, int* out, long L) {
  for (long lane = 0; lane < L; lane++) lane_add2(a, b, out, L, lane);
  return 0;
}

int host_step(const int* acc, const int* base, const int* mask, int* out_acc,
              int* out_base, long L) {
  for (long lane = 0; lane < L; lane++)
    lane_step(acc, base, mask, out_acc, out_base, L, lane);
  return 0;
}

int host_scan2b(const int* run, const int* tot, const int* bl, int* out_run,
                int* out_tot, long L) {
  for (long lane = 0; lane < L; lane++)
    lane_scan2b(run, tot, bl, out_run, out_tot, L, lane);
  return 0;
}

int host_ladder(const int* pts, const int* scal, int* out, int nl, long L) {
  for (long lane = 0; lane < L; lane++) lane_ladder(pts, scal, out, nl, L, lane);
  return 0;
}

int host_bucket(const int* table, const int* idx, const int* start,
                const int* count, int* out, long L, int mixed) {
  for (long lane = 0; lane < L; lane++) {
    if (mixed)
      lane_bucket<true>(table, idx, start, count, out, L, lane);
    else
      lane_bucket<false>(table, idx, start, count, out, L, lane);
  }
  return 0;
}
}
