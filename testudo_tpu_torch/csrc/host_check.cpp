// CPU build of the kernels' per-lane bodies (fp.cuh, fp2.cuh, ec.cuh compile
// as plain C++): the same arithmetic the CUDA kernels run, looped over lanes,
// with the same C interface minus the stream.  tests/test_torch_csrc.py
// builds this with the host compiler and holds it against the plain PyTorch
// versions, so the field and group code is checked where there is no GPU.
#include "ec.cuh"

// Run the statement given (it names the policy C) for the group `ncomp` names.
#define FOR_GROUP(...)                          \
  do {                                          \
    if (ncomp == 1) {                           \
      typedef FqCoord C;                        \
      __VA_ARGS__;                              \
    } else if (ncomp == 2) {                    \
      typedef Fq2Coord C;                       \
      __VA_ARGS__;                              \
    } else {                                    \
      return -1;                                \
    }                                           \
    return 0;                                   \
  } while (0)

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

// Fq2 product and b3 multiple of lane `lane` of (48, m) arrays (c0 rows,
// then c1 rows); out_b3 = b3 * a.
int host_fp2_mul(const int* a, const int* b, int* out, int* out_b3, long m) {
  for (long lane = 0; lane < m; lane++) {
    Fq2 x, y, r;
    fp2_load(x, a, m, lane, 0);
    fp2_load(y, b, m, lane, 0);
    fp2_mul(r, x, y);
    fp2_store(out, m, lane, 0, r);
    fp2_mul_b3(x, x);
    fp2_store(out_b3, m, lane, 0, x);
  }
  return 0;
}

int host_add2(const int* a, const int* b, int* out, long L, int ncomp) {
  FOR_GROUP(for (long lane = 0; lane < L; lane++) lane_add2<C>(a, b, out, L, lane));
}

int host_add_mask(const int* acc, const int* pts, const int* mask, int* out, long L,
                  int shared, int ncomp) {
  FOR_GROUP(for (long lane = 0; lane < L; lane++)
                lane_add_mask<C>(acc, pts, mask, out, L, shared != 0, lane));
}

int host_step(const int* acc, const int* base, const int* mask, int* out_acc,
              int* out_base, long L, int ncomp) {
  FOR_GROUP(for (long lane = 0; lane < L; lane++)
                lane_step<C>(acc, base, mask, out_acc, out_base, L, lane));
}

int host_scan2(const int* run, const int* tot, const int* bl, int* out_run,
               int* out_tot, long L, int ncomp) {
  FOR_GROUP(for (long lane = 0; lane < L; lane++)
                lane_scan2<C>(run, tot, bl, out_run, out_tot, L, lane));
}

int host_scan2b(const int* run, const int* tot, const int* bl, int* out_run,
                int* out_tot, long L, int ncomp) {
  FOR_GROUP(for (long lane = 0; lane < L; lane++)
                lane_scan2b<C>(run, tot, bl, out_run, out_tot, L, lane));
}

int host_ladder(const int* pts, const int* scal, int* out, int nl, long L, int ncomp) {
  FOR_GROUP(for (long lane = 0; lane < L; lane++)
                lane_ladder<C>(pts, scal, out, nl, L, lane));
}

int host_bucket(const int* table, const int* idx, const int* start,
                const int* count, int* out, long L, int mixed, int ncomp) {
  FOR_GROUP(for (long lane = 0; lane < L; lane++) {
    if (mixed)
      lane_bucket<C, true>(table, idx, start, count, out, L, lane);
    else
      lane_bucket<C, false>(table, idx, start, count, out, L, lane);
  });
}
}
