"""The fused sumcheck's round kernel (csrc/sumcheck_round.cu) beside the
body it replaced, at every shape a TestudoNIZK prove at 2^16 and at 2^20
launches it, in one build of this tool's own (`_build/exp_sumcheck_round-<hash>/`).

Forms (`FORMS`):
  - "library": the library's launch (csrc/sumcheck_round.cu `sc_form`: the
    straight form for rounds without a fold from SC_STRAIGHT_MIN_PAIRS
    pairs, else the tiled form, on small tiles where they take at most 32
    blocks and on tiles of 128 pairs above);
  - "one thread a pair": the body before it (kept here only): a thread
    folds and sums a whole pair, reading its rows straight, 128 threads a
    block, at most 528 blocks;
  - "staged" (kept here only): the tile's rows copied into shared memory by
    coalesced cp.async copies, two stages a block (the next tile's copies
    in flight while one is worked), a thread a (table, folded row) for the
    fold, then the library's combination; small tiles, blocks of 2 NT P
    threads, 2 an SM;
  - "tiled, 128 pairs" / "tiled, small tiles": the library's tiled form on
    one tile size at every shape (small tiles: 64 pairs for quad, 32 for
    the others; 128 pairs on the grid of the resident blocks, small tiles
    at most a block for 128 pairs or 32, as the library's);
  - "tiled, small tiles, resident grid": small tiles on the grid of the
    card's resident blocks (more partial sums for the tail).

The forms after the first two are timed at 2^15 rows and up and at 2^12, 2^6 and
4 rows.  For each shape (the prove's phase one, cubic_tau on 4 tables: the first
round without the fold at 2^16 / 2^20 rows, then a fold at every n down to
2; phase two, quad on 2 tables, the same from 2^17 / 2^21; and the batched
(2, 1) layout at 2^12) every form is checked against the first (the folded
stack and the sums of the partials; at 2^12 rows and below also against
`sumcheck_round_plain`) and its kernel's device time (torch.profiler) taken
with the L2 cache flushed before each launch and back to back, the forms
in turns (`ROUNDS` times: forms in order, then reversed).  `bound_ms` is
the bytes bound (every table read once, the folded half written once,
over 3.35 TB/s), `latency_bound_ms` the new body's dependent Fr products
(one fold product and the combination's one or two) times one dependent
product's latency at one warp (tools/exp_montmul.py's latency mode).  The
tail (`sumcheck_tail.cu`, unchanged) is timed at the partial count each
form's round writes at phase one's and phase two's rounds, with and
without the fold, at 2^16 / 2^17 and 2^20 / 2^21 rows.

With `--prove` it also proves TestudoNIZK at 2^16 x 2^16 x 10 (BASELINE
config #3) warm under torch.profiler with every round launch sent to each
form in turns (the proof's bytes held to the library's): the round
kernel's summed device time and launches by shape in a prove.

Run on a machine with the GPU, from the root of a checkout:

    python3 -m testudo_tpu_torch.tools.exp_sumcheck_round [--prove]

Prints one JSON line last.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import functools
import json
import subprocess
import sys

import torch

from testudo_tpu_torch.device import build
from testudo_tpu_torch.device import field as tf
from testudo_tpu_torch.device import sumcheck_kernels as sk
from testudo_tpu_torch.device.field import FR
from testudo_tpu_torch.tools import exp_mont_rm, exp_montmul

HBM_BYTES_PER_S = 3.35e12
KERNEL = "k_sumcheck_round"  # the forms' device events all hold this name
FORMS = {"library": 0, "one thread a pair": 1, "staged": 2, "tiled, 128 pairs": 3,
         "tiled, small tiles": 4, "tiled, small tiles, resident grid": 5}
PARENT_TPB, PARENT_MAX_BLOCKS = 128, 528
ROUNDS = 2
# dependent Fr products of a pair in the tiled body: the fold's one, then
# the combination's chain (quad A B; cubic_tau tau (A B - C); cubic A B C)
CHAIN = {"quad": 1, "cubic_tau": 2, "cubic": 2}

_CODE = r"""
#include "sumcheck_round.cu"

// The body before the tiled one: a thread a pair of rows.
FP_FN void par_line(u32* lo, u32* hi, const int* src, int* dst, const u32* r, long n, long p,
                    int t, bool fold, bool store) {
  const int* tab = src + (long)t * n * FR_ROW;
  if (!fold) {
    fp_load_row<Fr>(lo, tab + p * FR_ROW);
    fp_load_row<Fr>(hi, tab + (p + n / 2) * FR_ROW);
    return;
  }
  const long s = n / 2, h = s / 2;
  u32 a[FRN], b[FRN];
  fp_load_row<Fr>(a, tab + p * FR_ROW);
  fp_load_row<Fr>(b, tab + (p + s) * FR_ROW);
  fp_sub<Fr>(b, b, a);
  fp_mul_inline<Fr>(b, b, r);
  fp_add<Fr>(lo, a, b);
  fp_load_row<Fr>(a, tab + (p + h) * FR_ROW);
  fp_load_row<Fr>(b, tab + (p + h + s) * FR_ROW);
  fp_sub<Fr>(b, b, a);
  fp_mul_inline<Fr>(b, b, r);
  fp_add<Fr>(hi, a, b);
  if (store) {
    int* d = dst + (long)t * s * FR_ROW;
    fp_store_row<Fr>(d + p * FR_ROW, lo);
    fp_store_row<Fr>(d + (p + h) * FR_ROW, hi);
  }
}

template <int KIND>
FP_FN void par_comb(u32* out, u32 (*x)[FRN]) {
  u32 t[FRN];
  if (KIND == SC_QUAD) {
    fp_mul_inline<Fr>(out, x[0], x[1]);
  } else if (KIND == SC_CUBIC_TAU) {
    fp_mul_inline<Fr>(t, x[1], x[2]);
    fp_sub<Fr>(t, t, x[3]);
    fp_mul_inline<Fr>(out, x[0], t);
  } else {
    fp_mul_inline<Fr>(t, x[0], x[1]);
    fp_mul_inline<Fr>(out, t, x[2]);
  }
}

template <int KIND>
FP_FN void par_pair(u32 (*acc)[FRN], const int* src, int* dst, const u32* r, long n, long p,
                    int inst, int kp, int ks, bool fold, bool eval) {
  constexpr int NT = ScKind<KIND>::NT;
  int tab[NT];
  bool own[NT];
  sc_tables<KIND>(tab, own, inst, kp, ks);
  u32 lo[NT][FRN], hi[NT][FRN], v[FRN];
  FP_UNROLL
  for (int j = 0; j < NT; j++) par_line(lo[j], hi[j], src, dst, r, n, p, tab[j], fold, own[j]);
  if (KIND == SC_CUBIC && fold && kp == 0 && inst == 0) {
    u32 w[FRN];
    par_line(v, w, src, dst, r, n, p, 0, true, true);
  }
  if (!eval) return;
  par_comb<KIND>(v, lo);
  fp_add<Fr>(acc[0], acc[0], v);
  FP_UNROLL
  for (int j = 0; j < NT; j++) {
    fp_sub<Fr>(hi[j], hi[j], lo[j]);
    fp_add<Fr>(lo[j], lo[j], hi[j]);
    fp_add<Fr>(lo[j], lo[j], hi[j]);
  }
  par_comb<KIND>(v, lo);
  fp_add<Fr>(acc[1], acc[1], v);
  if (ScKind<KIND>::NPTS == 3) {
    FP_UNROLL
    for (int j = 0; j < NT; j++) fp_add<Fr>(lo[j], lo[j], hi[j]);
    par_comb<KIND>(v, lo);
    fp_add<Fr>(acc[2], acc[2], v);
  }
}

#define PAR_TPB 128

template <int KIND>
__global__ void __launch_bounds__(PAR_TPB)
k_sumcheck_round_parent(const int* src, int* dst, const int* r_row, int* partials, long n,
                        int fold, int kp, int ks) {
  constexpr int NP = ScKind<KIND>::NPTS;
  __shared__ u32 sh[PAR_TPB / 32][NP][FRN];
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
  for (long p = (long)blockIdx.x * PAR_TPB + threadIdx.x; p < pairs; p += (long)gridDim.x * PAR_TPB)
    par_pair<KIND>(acc, src, dst, r, n, p, inst, kp, ks, fold, !last);
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
    for (int w = 1; w < PAR_TPB / 32; w++) fp_add<Fr>(sh[0][pt], sh[0][pt], sh[w][pt]);
    fp_store_row<Fr>(out + pt * FR_ROW, sh[0][pt]);
  }
}

// The staged form: a tile's rows copied into shared memory by coalesced
// cp.async copies (mont_rm.cuh's rm_copy16 into rm_slot slots), two stages
// a block (the next tile's copies in flight while one is worked), a thread
// a (table, folded row) for the fold, then the library's combination.
template <int KIND, int P>
struct StTile {
  static constexpr int NT = ScKind<KIND>::NT, TPB = 2 * NT * P, ROWS = 4 * P;
  static constexpr int REGION = 4 * ROWS, STAGE = NT * REGION, SMEM = 2 * STAGE * 16;
};

template <int KIND, int P>
__device__ void st_copy(Limb4* st, const int* src, long n, long p0, long pairs, bool fold,
                         const ScRow& row, int tid) {
  typedef StTile<KIND, P> G;
  const long s = n / 2, h = s / 2;
  const int seg = fold ? P : 2 * P;
  const Limb4* g4 = reinterpret_cast<const Limb4*>(src);
  FP_UNROLL
  for (int m = 0; m < G::STAGE / G::TPB; m++) {
    const int c = tid + m * G::TPB;
    const int j = c / G::REGION, w = (c / 4) % G::ROWS, k = c % 4;
    const int g = w / seg, i = w % seg;
    if (j < row.nt && p0 + i < pairs) {
      const long first = fold ? (g & 1) * h + (g >> 1) * s : g * s;
      rm_copy16(st + j * G::REGION + rm_slot<Fr>(w, k),
                g4 + ((long)row.tab[j] * n + first + p0 + i) * 4 + k);
    }
  }
}

template <int KIND, int P>
__device__ void st_fold(Limb4* st, const u32* r, int tid) {
  Limb4* t = st + (tid / (2 * P)) * StTile<KIND, P>::REGION;
  const int q = tid % (2 * P);
  u32 a[FRN], b[FRN];
  sc_get(a, t, q);
  sc_get(b, t, q + 2 * P);
  fp_sub<Fr>(b, b, a);
  fp_mul_inline<Fr>(b, b, r);
  fp_add<Fr>(a, a, b);
  sc_put(t, q, a);
}

template <int KIND, int P>
__device__ void st_drain(int* dst, const Limb4* st, long n, long p0, long pairs, const ScRow& row,
                         int tid) {
  typedef StTile<KIND, P> G;
  const long s = n / 2, h = s / 2;
  Limb4* d4 = reinterpret_cast<Limb4*>(dst);
  FP_UNROLL
  for (int m = 0; m < 4; m++) {
    const int c = tid + m * G::TPB;
    const int j = c / (8 * P), w = (c / 4) % (2 * P), k = c % 4;
    const int g = w / P, i = w % P;
    if (j < row.nt && row.own[j] && p0 + i < pairs && (g == 0 || h > 0))
      d4[((long)row.tab[j] * s + g * h + p0 + i) * 4 + k] = st[j * G::REGION + rm_slot<Fr>(w, k)];
  }
}

template <int KIND, int P, int TPB = StTile<KIND, P>::TPB>
__global__ void __launch_bounds__(TPB, 2)
k_sumcheck_round_staged(const int* src, int* dst, const int* r_row, int* partials, long n,
                        int fold, int kp, int ks) {
  typedef StTile<KIND, P> G;
  extern __shared__ Limb4 st_smem[];
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
  const long tiles = (pairs + PT - 1) / PT;
  long tile = blockIdx.x;
  if (tile < tiles) st_copy<KIND, P>(st_smem, src, n, tile * PT, pairs, fold, row, tid);
  rm_commit();
  for (int it = 0; tile < tiles; tile += gridDim.x, it++) {
    Limb4* cur = st_smem + (it & 1) * G::STAGE;
    const long next = tile + gridDim.x;
    if (next < tiles)
      st_copy<KIND, P>(st_smem + ((it + 1) & 1) * G::STAGE, src, n, next * PT, pairs, fold, row,
                        tid);
    rm_commit();
    rm_wait_older();
    __syncthreads();
    if (fold) {
      st_fold<KIND, P>(cur, r, tid);
      __syncthreads();
      st_drain<KIND, P>(dst, cur, n, tile * PT, pairs, row, tid);
    }
    if (row.eval) sc_comb_item<KIND, P, TPB>(acc, cur, tile * PT, pairs, fold, tid);
    __syncthreads();
  }
  if ((int)blockIdx.y >= sc_instances<KIND>(kp, ks)) return;
  const int lane = tid & 31, warp = tid >> 5;
  warp_sum<Fr>(acc);
  if (lane == 0) fp_copy<Fr>(sh[warp], acc);
  __syncthreads();
  constexpr int NP = ScKind<KIND>::NPTS;
  if (tid >= NP) return;
  const int per = sc_comb_threads<KIND, TPB>(PT) / 32;
  u32 v[FRN];
  fp_copy<Fr>(v, sh[tid * per]);
  for (int w = 1; w < per; w++) fp_add<Fr>(v, v, sh[tid * per + w]);
  fp_store_row<Fr>(partials + (((long)blockIdx.y * gridDim.x + blockIdx.x) * NP + tid) * FR_ROW, v);
}

template <int KIND>
static int staged_capacity() {
  constexpr int P = ScKind<KIND>::P_SMALL;
  static std::atomic<int> on[SC_MAX_DEVICES];
  return sc_capacity(on, k_sumcheck_round_staged<KIND, P>, StTile<KIND, P>::TPB,
                     StTile<KIND, P>::SMEM);
}

// The grid of form `form` for a round: 0 the library's, 1 the parent's (a
// block a 128 pairs, at most 528), 2 the staged form's (small tiles), 3
// the tiled form's on 128-pair tiles, 4 on small tiles (at most
// sc_tiled_max blocks) and 5 on small tiles (the resident blocks), at every
// shape.
template <int KIND>
static long form_grid(int form, long n, bool fold, int kp, int ks) {
  constexpr int SP = ScKind<KIND>::P_SMALL;
  const int rows = sc_rows<KIND>(kp, ks, fold);
  switch (form) {
    case 0: return round_grid<KIND>(n, fold, kp, ks);
    case 1: {
      const long b = (sc_pairs(n, fold) + PAR_TPB - 1) / PAR_TPB;
      return b < 528 ? b : 528;
    }
    case 2: return sc_grid(sc_tiles(SP, n, fold), staged_capacity<KIND>(), rows);
    case 3: return sc_grid(sc_tiles(SC_P, n, fold), tiled_capacity<KIND, SC_P>(), rows);
    case 5: return sc_grid(sc_tiles(SP, n, fold), tiled_capacity<KIND, SP>(), rows);
    case 4: {
      const long t = sc_tiles(SP, n, fold), most = sc_tiled_max(n, fold);
      return sc_grid(t < most ? t : most, tiled_capacity<KIND, SP>(), rows);
    }
    default: return -1;
  }
}

template <int KIND>
static int form_launch(int form, const int* src, int* dst, const int* r, int* partials, long n,
                       int fold, int kp, int ks, int nb, cudaStream_t st) {
  constexpr int SP = ScKind<KIND>::P_SMALL;
  if (form_grid<KIND>(form, n, fold != 0, kp, ks) <= 0) return -2;  // also opts in
  const dim3 grid((unsigned)nb, (unsigned)sc_rows<KIND>(kp, ks, fold != 0));
  switch (form) {
    case 0: return launch_round<KIND>(src, dst, r, partials, n, fold, kp, ks, nb, st);
    case 1:
      k_sumcheck_round_parent<KIND><<<dim3((unsigned)nb, (unsigned)sc_instances<KIND>(kp, ks)),
                                      PAR_TPB, 0, st>>>(src, dst, r, partials, n, fold, kp, ks);
      break;
    case 2: {
      constexpr int TPB = StTile<KIND, SP>::TPB, SMEM = StTile<KIND, SP>::SMEM;
      k_sumcheck_round_staged<KIND, SP><<<grid, TPB, SMEM, st>>>(src, dst, r, partials, n, fold,
                                                                 kp, ks);
      break;
    }
    case 3: launch_tiled<KIND, SC_P>(src, dst, r, partials, n, fold, kp, ks, grid, st); break;
    case 4: case 5: launch_tiled<KIND, SP>(src, dst, r, partials, n, fold, kp, ks, grid, st); break;
    default: return -1;
  }
  return LAUNCH_STATUS();
}

extern "C" int exp_round(int form, const int* src, int* dst, const int* r, int* partials,
                         int kind, long n, int fold, int kp, int ks, int nb, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == SC_QUAD) return form_launch<SC_QUAD>(form, src, dst, r, partials, n, fold, kp, ks, nb, st);
  if (kind == SC_CUBIC_TAU)
    return form_launch<SC_CUBIC_TAU>(form, src, dst, r, partials, n, fold, kp, ks, nb, st);
  if (kind == SC_CUBIC) return form_launch<SC_CUBIC>(form, src, dst, r, partials, n, fold, kp, ks, nb, st);
  return -1;
}

extern "C" int exp_round_grid(int form, int kind, long n, int fold, int kp, int ks) {
  if (kind == SC_QUAD) return (int)form_grid<SC_QUAD>(form, n, fold != 0, kp, ks);
  if (kind == SC_CUBIC_TAU) return (int)form_grid<SC_CUBIC_TAU>(form, n, fold != 0, kp, ks);
  if (kind == SC_CUBIC) return (int)form_grid<SC_CUBIC>(form, n, fold != 0, kp, ks);
  return -1;
}
"""


@functools.cache
def library():
    lib = ctypes.CDLL(str(build.build_tool("exp_sumcheck_round", _CODE)))
    lib.exp_round.argtypes = [ctypes.c_int, *[ctypes.c_void_p] * 4, ctypes.c_int, ctypes.c_long,
                              *[ctypes.c_int] * 4, ctypes.c_void_p]
    lib.exp_round_grid.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_long, *[ctypes.c_int] * 3]
    return lib


def form_blocks(form: int, kind: str, n: int, fold: bool, k_par: int = 1, k_seq: int = 0) -> int:
    """The grid's blocks a row for a form (csrc's `form_grid`)."""
    nb = library().exp_round_grid(form, sk.KINDS[kind], n, int(fold), k_par, k_seq)
    if nb <= 0:
        raise RuntimeError(f"exp_round_grid({form}, {kind}, {n}, {fold}) failed ({nb})")
    return nb


def run_form(form: int, kind: str, src: torch.Tensor, r, k_par: int = 1, k_seq: int = 0):
    """One round on form `form`: (the folded stack or src, the partials),
    as `sk.sumcheck_round` returns them."""
    T, n, nl = src.shape
    fold = r is not None
    k = len(sk.instance_tables(kind, k_par, k_seq))
    nb = form_blocks(form, kind, n, fold, k_par, k_seq)
    dst = torch.empty((T, n // 2, nl), dtype=torch.int32, device=src.device) if fold else src
    part = torch.empty((k, nb, sk.POINTS[kind], nl), dtype=torch.int32, device=src.device)
    rc = library().exp_round(form, src.data_ptr(), dst.data_ptr() if fold else None,
                             r.data_ptr() if fold else None, part.data_ptr(), sk.KINDS[kind], n,
                             int(fold), k_par, k_seq, nb, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"exp_round form {form} ({kind}, n {n}, fold {fold}) failed: {rc}")
    return dst, part


def prove_shapes(log2ns=(16, 20)):
    """(kind, k_par, k_seq, n, fold) of every round launch of a prove at
    each size, and the batched layout's at 2^12."""
    out = []
    for L in log2ns:
        for kind, top in (("cubic_tau", L), ("quad", L + 1)):
            out.append((kind, 1, 0, 1 << top, False))
            out += [(kind, 1, 0, 1 << e, True) for e in range(top, 0, -1)]
    out += [("cubic", 2, 1, 1 << 12, False), ("cubic", 2, 1, 1 << 12, True)]
    return list(dict.fromkeys(out))


def random_stack(T: int, n: int, seed: int, device) -> torch.Tensor:
    """T x n canonical Fr elements (limbs below r), from a seeded generator
    on the device; 0, 1 and r - 1 first."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, 1 << 16, (T, n, FR.nlimbs), generator=g, device=device, dtype=torch.int32)
    x[..., -1] &= 0x0FFF
    edges = torch.as_tensor(FR.to_limbs([0, 1, FR.modulus - 1])[:n], dtype=torch.int32,
                            device=device)
    x[:, : len(edges)] = edges
    return x


def round_work(kind: str, n: int, fold: bool, k_par: int = 1, k_seq: int = 0):
    """(bytes, dependent products) of a round: every table read once, the
    folded half written once; the new body's chain."""
    T = sk.stack_size(kind, k_par, k_seq)
    nbytes = T * n * 64 + (T * n // 2 * 64 if fold else 0)
    eval_ = not (fold and n == 2)
    return nbytes, int(fold) + (CHAIN[kind] if eval_ else 0)


def _sums(part):
    return tf.reduce_sum(FR, part, axis=1, mul=tf.mont_mul_plain)


def run_shapes(device, lat_fr_us: float, shapes=None, say=print) -> list:
    flush = exp_mont_rm.l2_flusher(device)
    prof = exp_mont_rm.profiled_ms
    rows = []
    for si, (kind, kp, ks, n, fold) in enumerate(shapes or prove_shapes()):
        src = random_stack(sk.stack_size(kind, kp, ks), n, 1000 + si, device)
        r = random_stack(1, 1, 7 + si, device)[0, 0].contiguous() if fold else None
        want_dst, want = run_form(FORMS["library"], kind, src, r, kp, ks)
        want = _sums(want)
        if n <= 1 << 12:
            p_dst, p_part = sk.sumcheck_round_plain(kind, src, r, kp, ks)
            if not (torch.equal(want_dst, p_dst) and torch.equal(want, p_part[:, 0])):
                raise AssertionError(f"sumcheck_round ({kind}, 2^{n.bit_length() - 1}, fold "
                                     f"{fold}) differs from the plain version")
        forms = FORMS if n >= 1 << 15 or n in (1 << 12, 1 << 6, 4) else dict(list(FORMS.items())[:2])
        times = {name: {"ms": [], "ms_l2_warm": []} for name in forms}
        order = list(forms.items())
        for turn in range(ROUNDS):
            for name, form in (order if turn % 2 == 0 else order[::-1]):
                dst, part = run_form(form, kind, src, r, kp, ks)
                if not (torch.equal(dst, want_dst) and torch.equal(_sums(part), want)):
                    raise AssertionError(f"form {name!r} differs at ({kind}, n {n}, fold {fold})")
                call = lambda: run_form(form, kind, src, r, kp, ks)
                times[name]["ms"].append(prof(call, KERNEL, reps=20, flush=flush))
                times[name]["ms_l2_warm"].append(prof(call, KERNEL, reps=20))
        nbytes, chain = round_work(kind, n, fold, kp, ks)
        row = {"kind": kind, "k_par": kp, "k_seq": ks, "n": n, "fold": fold,
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
               "latency_bound_ms": chain * lat_fr_us / 1e3, "dependent_products": chain,
               "blocks": {name: form_blocks(f, kind, n, fold, kp, ks) for name, f in forms.items()},
               "forms": times}
        rows.append(row)
        fmt = lambda v: "none" if v is None else f"{v:.5f}"
        say(f"round {kind} ({kp}, {ks}) 2^{n.bit_length() - 1}{' fold' if fold else ''}: "
            + "; ".join(f"{name} {', '.join(fmt(v) for v in t['ms'])} flushed / "
                        f"{', '.join(fmt(v) for v in t['ms_l2_warm'])} warm"
                        for name, t in times.items())
            + f" ms; bound {row['bound_ms']:.5f}, latency bound {row['latency_bound_ms']:.5f}; "
              f"blocks {row['blocks']}")
    return rows


def run_tail(device, say=print) -> list:
    """The tail at the partial count each form's round writes, on the Fr
    sponge from (absorbing, 0), in turns."""
    rows = []
    for kind, n, fold in [(k, n, f) for k, n in (("cubic_tau", 1 << 16), ("quad", 1 << 17),
                                                 ("cubic_tau", 1 << 20), ("quad", 1 << 21))
                          for f in (False, True)]:
        row = {"kind": kind, "n": n, "fold": fold, "ms": {}}
        for turn in range(ROUNDS):
            for name, form in (list(FORMS.items())[:2] if turn % 2 == 0
                               else list(FORMS.items())[1::-1]):
                nb = form_blocks(form, kind, n, fold)
                part = random_stack(1, nb * sk.POINTS[kind], 3 + nb, device).reshape(
                    1, nb, sk.POINTS[kind], FR.nlimbs)
                one = random_stack(1, 1, 5, device)[0]
                e = one[0].contiguous()
                state = random_stack(1, 3, 9, device)[0]
                got = sk.sumcheck_tail(kind, part, one, e, state, FR, 0, 0)
                want = sk.sumcheck_tail_plain(kind, part, one, e, state, FR, 0, 0)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"sumcheck_tail differs at {nb} partials")
                ms = exp_mont_rm.profiled_ms(
                    lambda: sk.sumcheck_tail(kind, part, one, e, state, FR, 0, 0),
                    "k_sumcheck_tail", reps=20)
                row["ms"].setdefault(f"{name} ({nb} partials)", []).append(ms)
        rows.append(row)
        say(f"tail after {shape_label(kind, n, fold)}: " + "; ".join(
            f"{k} {', '.join('none' if v is None else f'{v:.5f}' for v in vs)} ms"
            for k, vs in row["ms"].items()))
    return rows


def shape_label(kind: str, n: int, fold: bool) -> str:
    return f"{kind} 2^{n.bit_length() - 1}{' fold' if fold else ''}"


def prove_round_profile(prove, form: int | None = None) -> dict:
    """One call of `prove` under torch.profiler with every round launch
    recorded: the round kernel's launches and summed device time, in all
    and by shape (kind, n, fold).  With `form`, every round of the prove
    runs that form of this tool's build instead of the library's."""
    from torch.profiler import ProfilerActivity, profile

    shapes, orig = [], sk.sumcheck_round

    def recording(kind, src, r=None, k_par=1, k_seq=0):
        shapes.append(shape_label(kind, src.shape[1], r is not None))
        if form is None or not src.is_cuda:
            return orig(kind, src, r, k_par, k_seq)
        return run_form(form, kind, src.contiguous(), None if r is None else r.contiguous(),
                        k_par, k_seq)

    sk.sumcheck_round = recording
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = prove()
            torch.cuda.synchronize()
    finally:
        sk.sumcheck_round = orig
    evs = exp_mont_rm._device_events(prof, KERNEL)
    paired = len(evs) == len(shapes)
    by = collections.defaultdict(lambda: [0, 0.0])
    for i, lbl in enumerate(shapes):
        by[lbl][0] += 1
        if paired:
            by[lbl][1] += evs[i].time_range.elapsed_us() / 1e3
    return {"result": out, "launches": len(shapes), "device_events": len(evs),
            "device_ms": sum(e.time_range.elapsed_us() for e in evs) / 1e3,
            "by_shape": {k: {"launches": c, "device_ms": ms if paired else None}
                         for k, (c, ms) in by.items()}}


def run_prove(device, say=print) -> dict:
    """A warm prove at 2^16 with each form's rounds, in turns, under the
    profiler; the proof's bytes held to the library's."""
    from testudo_tpu_torch import proofs

    prove = exp_mont_rm.nizk_prover(16, device)
    want = proofs.ser_r1cs_proof(prove().r1cs_sat_proof)
    res = {}
    order = list(FORMS.items())
    for turn in range(ROUNDS):
        for name, form in (order if turn % 2 == 0 else order[::-1]):
            p = prove_round_profile(prove, form)
            if proofs.ser_r1cs_proof(p.pop("result").r1cs_sat_proof) != want:
                raise AssertionError(f"a prove on round form {name!r} gave other bytes")
            res.setdefault(name, []).append(p)
            say(f"warm prove at 2^16, rounds on {name!r}: {p['launches']} launches, "
                f"{p['device_ms']:.4f} ms of round device time")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prove", action="store_true",
                    help="also profile a warm TestudoNIZK prove at 2^16 on each form")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_sumcheck_round: no CUDA device; this tool times the kernel on the GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    say = lambda *a: print(*a, flush=True)
    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       check=True, capture_output=True, text=True, timeout=60).stdout.strip())
    lat = exp_montmul.measure_latency(FR, dev)["inline"]["us_per_product"]
    say(f"one dependent Fr product at one warp: {lat:.4f} us")
    library()
    ptxas = [ln for ln in (build.BUILD_ROOT.glob("exp_sumcheck_round-*/build.log"))]
    res = {"latency_us_per_product": lat, "shapes": run_shapes(dev, lat, say=say),
           "tail": run_tail(dev, say=say)}
    for log in ptxas:
        for ln in log.read_text().splitlines():
            if "registers" in ln or "Compiling entry" in ln:
                say(f"ptxas {ln.strip()}")
    if args.prove:
        res["prove"] = run_prove(dev, say=say)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
