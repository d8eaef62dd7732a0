"""The fixed-base kernel's form: the team kernel at T = 8, 16 and 32 threads a
lane and several teams a block, with the table of doublings read through L1
or staged in shared memory, and one thread per lane at several block sizes,
against the sequence of 256 `add_mask` launches they replaced, at every
width a path gives them; with --window, the 8-bit window kernel against
them.

`PackedGroup.fixed_base` runs the fixed-base multiplication [s_i] B in one
launch of csrc/fixed_base_team.cu: up to FIXED_TEAM_MAX_LANES lanes the team
kernel (its team size and teams a block fixed per group in ec_team.cuh:
FIXED_T, FIXED_TEAMS; every lane reads its table column through L1), above
it one thread per lane.  This harness measures those choices, and a team
kernel of its own that stages the table in shared memory instead.  Run on a
machine with the GPU:

    python3 -m testudo_tpu_torch.tools.exp_fixed_base

It builds its own instantiations of both kernels at every configuration
(one source that includes csrc/fixed_base_team.cu, built into
testudo_tpu_torch/_build/), and for G1 and G2 at 63, 255 and 2,047 lanes
(`pst.setup` at nv = 10, 14, 20: 2^(m_row + 1) - 1 scalars), 8,192 and
2^16 lanes (chip_smoke.py's fixed-base phase, and Groth16's key generation
to come), on random canonical scalars with 0, 1 and r - 1 among them,
checks that each configuration gives the limbs of the `add_mask` sequence
(`fixed_base_steps` on the kernel), times each, the sequence and the
wrapper as it runs ("in use") (CUDA events, mean of a few calls after a
warm-up), and prints one line per width: every time, the fastest
configuration, and the bounds: `bound_ms` (the set bits' complete adds at
the card's derived int32 rate), `latency_bound_ms` (the largest popcount of
a lane's scalar times the add's rounds of dependent products times one
dependent product's latency, `exp_montmul --latency`) and the same for a
form that runs all 256 steps.

    python3 -m testudo_tpu_torch.tools.exp_fixed_base --window

times the window kernel (csrc/fixed_base_window.cu, what `fixed_base` runs
above FIXED_TEAM_MAX_LANES) at 32, 64, 128 and 256 threads a block and a form
of its own that stages each window's 256 rows (X and Y: 48 KB for G1, 96 KB
for G2) in shared memory by cp.async, double-buffered, at 128 and 256
threads, beside the one-thread bit-serial kernel and the team kernel, at
2,047, 8,192, 32,767 and 2^16 lanes: every window form gives the kernel in
use's limbs, and that one the bit-serial kernel's points (`same_points`);
each width's line gives the times, the window work's bound (the nonzero
digits' mixed adds), the bit-serial bound and the window kernel's latency
bound (the most nonzero digits of a lane times a mixed add's products at one
dependent product's latency), and the crossover with the team kernel; the
window table's build (chain launch, batched inversion, products) is timed
once a group.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time

import numpy as np
import torch

from ..curves import host_curve as hc
from ..device import build
from ..device import curve as tc
from ..device.field import FQ, FR
from ..device.packed_curve import G1P, G2P
from ..fields.bls12_377 import R
from . import exp_ladder, exp_montmul

WIDTHS = (63, 255, 2047, 8192, 1 << 16)
WINDOW_WIDTHS = (2047, 8192, (1 << 15) - 1, 1 << 16)
WINDOW_TPB = (32, 64, 128, 256)
STAGED_TPB = (128, 256)
# (T, teams a block): whole warps of 32 to 128 threads
TEAM_CONFIGS = tuple((T, p) for T in (8, 16, 32) for p in (1, 2, 4, 8, 16) if 32 <= T * p <= 128)
ONE_TPB = (32, 64, 128)
# Fq products of a complete add (G2: three per Fq2 product, plus the b3
# products) and its rounds of dependent products; of a complete mixed add
ADD_PRODUCTS = {1: 12, 2: 38}
MIXED_PRODUCTS = {1: 11, 2: 35}
ADD_ROUNDS = {1: 2, 2: 3}

_CODE = r"""
#include <cuda_pipeline.h>

#include "fixed_base_team.cu"
#include "fixed_base_window.cu"

// The alternative measured against the team kernel's reads through L1: each
// block stages the whole packed table of doublings in shared memory as
// 32-bit words (36 KB for G1, 72 KB for G2), and a team copies column k from
// there into its lane's slots at step k.  Otherwise `lane_fixed_base_team`.
template <class C, int T>
__global__ void __launch_bounds__(TPB_FIXED_MAX)
k_staged(const int* table, const int* scal, int* out, long N, int nl, TeamTable tab) {
  constexpr int NC = C::COMP_ROWS / (2 * FQN);
  constexpr int W = 3 * NC * FQN;
  constexpr u32 DUMMY = TEAM_DUMMY_OP(TEAM_NFIXED(NC, PAIR_NPTS));
  extern __shared__ u32 smem[];
  const int nb = 16 * nl;
  u32* ops = smem;
  u32* stages = ops + tab.nops;
  u32* words = stages + tab.nstages;
  for (int i = threadIdx.x; i < tab.nops; i += blockDim.x) ops[i] = tab.op[i];
  for (int i = threadIdx.x; i < tab.nstages; i += blockDim.x) stages[i] = tab.stage[i];
  for (int i = threadIdx.x; i < nb * W; i += blockDim.x) {
    const int k = i / W, c = (i % W) / FQN, j = i % FQN;
    const int* q = table + (long)(2 * FQN * c + 2 * j) * nb + k;
    words[i] = (u32)q[0] | ((u32)q[nb] << 16);
  }
  __syncthreads();
  const int ns = tab.nslots, team = threadIdx.x / T, rank = threadIdx.x % T;
  u32* region = words + nb * W + team * ns * FQN;
  const TeamCode add = {ops, stages, tab.nstages};
  const long lane = (long)blockIdx.x * (blockDim.x / T) + team;
  const long src = lane < N ? lane : N - 1;
  team_consts(region, ns, TEAM_NFIXED(NC, PAIR_NPTS), rank, T);
  team_identity<NC>(region, ns, 0, rank, T);
  TEAM_SYNC();
  FP_NO_UNROLL
  for (int l = 0; l < nl; l++) {
    const u32 limb = (u32)scal[src * nl + l];
    FP_NO_UNROLL
    for (int b = 0; b < 16; b++) {
      const bool bit = ((limb >> b) & 1u) != 0;
      if (!team_any(bit)) continue;
      const u32* col = words + (16 * l + b) * W;
      for (int w = rank; w < W; w += T) region[(w % FQN) * ns + 3 * NC + w / FQN] = col[w];
      TEAM_SYNC();
      team_run<T>(region, ns, add, DUMMY, rank, bit);
    }
  }
  if (lane < N) team_store<NC>(out, 1, N, lane, region, ns, 0, rank, T);
}

template <class C, int T>
static int staged_launch(const int* table, const int* scal, int* out, long N, int nl, int teams,
                         cudaStream_t st) {
  constexpr int NC = C::COMP_ROWS / (2 * FQN);
  const TeamTable* tab = team_table_once(NC, TEAM_MASKED_ADD);
  if (!tab) return -2;
  if (teams < 1 || teams * T > TPB_FIXED_MAX || (teams * T) % 32) return -3;
  const size_t smem = sizeof(u32) * ((size_t)tab->nops + tab->nstages +
                                     (size_t)16 * nl * 3 * NC * FQN +
                                     (size_t)teams * tab->nslots * FQN);
  const int e = smem_opt_in(k_staged<C, T>, smem);
  if (e) return e;
  k_staged<C, T><<<GRID_FOR(N, teams), teams * T, smem, st>>>(table, scal, out, N, nl, *tab);
  return LAUNCH_STATUS();
}

#define EXP_TEAM(C, T)                                                        \
  (staged ? staged_launch<C, T>(table, scal, out, N, nl, teams, st)           \
          : fixed_base_launch<C, T>(table, scal, out, N, nl, teams, st))
#define EXP_T(T) \
  if (t == T) return ncomp == 1 ? EXP_TEAM(FqCoord, T) : EXP_TEAM(Fq2Coord, T);

// The team kernel at team size t (8, 16 or 32) and `teams` lanes a block,
// its table read through L1 or staged; -1 for another t or group.
extern "C" int exp_team(const int* table, const int* scal, int* out, long N, int nl, int ncomp,
                        int t, int teams, int staged, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ncomp != 1 && ncomp != 2) return -1;
  EXP_T(8)
  EXP_T(16)
  EXP_T(32)
  return -1;
}

// One thread a lane on blocks of tpb threads.
extern "C" int exp_one(const int* table, const int* scal, int* out, long N, int nl, int ncomp,
                       int tpb, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ncomp == 1) return fixed_base_one_launch<FqCoord>(table, scal, out, N, nl, tpb, st);
  if (ncomp == 2) return fixed_base_one_launch<Fq2Coord>(table, scal, out, N, nl, tpb, st);
  return -1;
}

// The window kernel on blocks of tpb threads.
extern "C" int exp_window(const int* table, const int* scal, int* out, long N, int nl,
                          int ncomp, int tpb, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ncomp == 1) return fixed_base_window_launch<FqCoord>(table, scal, out, N, nl, tpb, st);
  if (ncomp == 2) return fixed_base_window_launch<Fq2Coord>(table, scal, out, N, nl, tpb, st);
  return -1;
}

// The alternative measured against the window kernel's gathers from L2:
// each block stages window w's 256 rows (their X and Y, 2 C::COMP_ROWS
// words a row) in shared memory with cp.async while its lanes add from
// window w - 1's, two buffers in turn; a lane reads its row from there.
// Otherwise `lane_fixed_base_window`.
template <class C, int TPB>
__global__ void __launch_bounds__(TPB)
k_window_staged(const int* table, const int* scal, int* out, long N, int nl) {
  typedef typename BucketArith<C, true>::A A;
  constexpr int XY = 2 * A::COMP_ROWS;
  constexpr int WIN = XY << FB_WINDOW;
  extern __shared__ __align__(16) int staged[];
  const long lane = LANE_INDEX(TPB);
  const long src = lane < N ? lane : N - 1;
  const int nwin = 2 * nl;
  auto fetch = [&](int w) {
    int* dst = staged + (w & 1) * WIN;
    const int* from = table + ((long)w << FB_WINDOW) * A::ROWS;
    for (int i = threadIdx.x; i < WIN / 4; i += TPB) {
      const int r = i / (XY / 4), c = i % (XY / 4);
      __pipeline_memcpy_async(dst + r * XY + 4 * c, from + (long)r * A::ROWS + 4 * c, 16);
    }
    __pipeline_commit();
  };
  auto acc = A::carry(ec_identity<A>());
  fetch(0);
  FP_NO_UNROLL
  for (int w = 0; w < nwin; w++) {
    if (w + 1 < nwin) {
      fetch(w + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const u32 limb = (u32)scal[src * nl + w / 2];
    const u32 d = (limb >> (FB_WINDOW * (w & 1))) & ((1u << FB_WINDOW) - 1u);
    if (any_lane(d != 0)) {
      const int* row = staged + (w & 1) * WIN + d * XY;
      const typename A::E x2 = A::load_row(row), y2 = A::load_row(row + A::COMP_ROWS);
      acc = A::carry(ec_select<A>(d != 0, ec_add_mixed<A>(acc, x2, y2), acc));
    }
    __syncthreads();
  }
  if (lane < N) ec_store<A>(out, N, lane, acc);
}

template <class C, int TPB>
static int staged_window_launch(const int* table, const int* scal, int* out, long N, int nl,
                                cudaStream_t st) {
  const size_t smem = sizeof(int) * 2 * ((size_t)2 * C::COMP_ROWS << FB_WINDOW);
  const int e = smem_opt_in(k_window_staged<C, TPB>, smem);
  if (e) return e;
  k_window_staged<C, TPB><<<GRID_FOR(N, TPB), TPB, smem, st>>>(table, scal, out, N, nl);
  return LAUNCH_STATUS();
}

#define EXP_STAGED(TPB)                                                                   \
  if (tpb == TPB)                                                                         \
    return ncomp == 1 ? staged_window_launch<FqCoord, TPB>(table, scal, out, N, nl, st)  \
                      : staged_window_launch<Fq2Coord, TPB>(table, scal, out, N, nl, st);

// The staged form at 128 or 256 threads a block; -1 for another block size
// or group.
extern "C" int exp_window_staged(const int* table, const int* scal, int* out, long N, int nl,
                                 int ncomp, int tpb, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ncomp != 1 && ncomp != 2) return -1;
  EXP_STAGED(128)
  EXP_STAGED(256)
  return -1;
}

// What the kernel library uses for the group: T, teams a block, one-thread
// block size.
extern "C" void exp_kept(int ncomp, int* out) {
  out[0] = FIXED_T(ncomp);
  out[1] = FIXED_TEAMS(ncomp);
  out[2] = TPB_FIXED_ONE;
}
"""


def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.build_tool("exp_fixed_base", _CODE)))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.exp_team.argtypes = [P, P, P, L, I, I, I, I, I, P]
    lib.exp_team.restype = I
    lib.exp_one.argtypes = [P, P, P, L, I, I, I, P]
    lib.exp_one.restype = I
    lib.exp_kept.argtypes = [I, P]
    lib.exp_kept.restype = None
    for fn in (lib.exp_window, lib.exp_window_staged):
        fn.argtypes = [P, P, P, L, I, I, I, P]
        fn.restype = I
    return lib


def inputs(Gp, N: int, device, seed: int = 0):
    """(packed table of the 256 doublings of a base, (N, 16) canonical
    scalar limbs, the scalars as ints): random below r, lanes 0, 1, 2 hold
    0, 1 and r - 1."""
    base = (hc.g1_mul(hc.g1_generator(), 0xC0FFEE) if Gp is G1P
            else hc.g2_mul(hc.g2_generator(), 0xC0FFEE))
    table = tc.fixed_base_table(Gp, base, 16 * FR.nlimbs, device)
    rng = np.random.default_rng(seed + N)
    ks = [int.from_bytes(rng.bytes(40), "little") % R for _ in range(N)]
    ks[:3] = [0, 1, R - 1][: min(3, N)]
    return table, torch.as_tensor(FR.to_limbs(ks), device=device), ks


def bounds(Gp, ks, lat_us: float) -> dict:
    """bound_ms: the set bits' adds, each ADD_PRODUCTS Fq products of the
    multiply-adds `exp_montmul` counts, at the derived int32 rate;
    latency_bound_ms: the largest popcount times the add's rounds of
    dependent products times one product's latency; all_steps_ms: the same
    for all 256 steps."""
    pop = [bin(k).count("1") for k in ks]
    madds = sum(pop) * ADD_PRODUCTS[Gp.ncomp] * exp_montmul.madds_per_product(FQ)
    per_add = ADD_ROUNDS[Gp.ncomp] * lat_us / 1e3
    return {"bound_ms": madds / exp_montmul.DERIVED_INT32_MADD_PER_S * 1e3,
            "latency_bound_ms": max(pop) * per_add, "all_steps_ms": 16 * FR.nlimbs * per_add,
            "max_popcount": max(pop)}


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def team(lib, Gp, table, scal, T: int, teams: int, staged: bool) -> torch.Tensor:
    out = torch.empty((Gp.rows, scal.shape[0]), dtype=torch.int32, device=table.device)
    rc = lib.exp_team(table.data_ptr(), scal.data_ptr(), out.data_ptr(), scal.shape[0],
                      scal.shape[1], Gp.ncomp, T, teams, int(staged), _stream())
    if rc != 0:
        raise RuntimeError(f"exp_team (T = {T}, {teams} teams, staged {staged}) failed with {rc}")
    return out


def one(lib, Gp, table, scal, tpb: int) -> torch.Tensor:
    out = torch.empty((Gp.rows, scal.shape[0]), dtype=torch.int32, device=table.device)
    rc = lib.exp_one(table.data_ptr(), scal.data_ptr(), out.data_ptr(), scal.shape[0],
                     scal.shape[1], Gp.ncomp, tpb, _stream())
    if rc != 0:
        raise RuntimeError(f"exp_one ({tpb} threads a block) failed with {rc}")
    return out


def window(lib, Gp, wtable, scal, tpb: int, staged: bool) -> torch.Tensor:
    out = torch.empty((Gp.rows, scal.shape[0]), dtype=torch.int32, device=wtable.device)
    fn = lib.exp_window_staged if staged else lib.exp_window
    rc = fn(wtable.data_ptr(), scal.data_ptr(), out.data_ptr(), scal.shape[0], scal.shape[1],
            Gp.ncomp, tpb, _stream())
    if rc != 0:
        raise RuntimeError(f"exp_window ({tpb} threads a block, staged {staged}) failed with {rc}")
    return out


def same_points(Gp, a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two packed batches hold the same points lane by lane: Z zero
    in both or in neither, X1 Z2 = X2 Z1 and Y1 Z2 = Y2 Z1, by the plain
    product (no kernel launch, on the batches' device)."""
    ops = tc._G1PlainOps if Gp.ncomp == 1 else tc._G2PlainOps
    flat = (lambda v: v) if Gp.ncomp == 1 else (lambda v: torch.cat(v, dim=-1))
    zero = lambda z: (flat(z) == 0).all(dim=-1)
    (x1, y1, z1), (x2, y2, z2) = Gp.unpack(a), Gp.unpack(b)
    if not torch.equal(zero(z1), zero(z2)):
        return False
    p = [flat(v) for v in ops.mul_many([(x1, z2), (x2, z1), (y1, z2), (y2, z1)])]
    return torch.equal(p[0], p[1]) and torch.equal(p[2], p[3])


def window_bounds(Gp, scal: torch.Tensor, ks, lat_us: float) -> dict:
    """bound_ms: the nonzero digits' mixed adds, MIXED_PRODUCTS Fq products
    each, at the derived int32 rate; latency_bound_ms: the most nonzero
    digits of a lane times a mixed add's products, each at one dependent
    product's latency; bit_serial_bound_ms: `bounds`' bound_ms."""
    limbs = scal.cpu().numpy()
    digits = ((limbs & 0xFF) != 0).sum(axis=1) + ((limbs >> 8) != 0).sum(axis=1)
    madds = int(digits.sum()) * MIXED_PRODUCTS[Gp.ncomp] * exp_montmul.madds_per_product(FQ)
    return {"bound_ms": madds / exp_montmul.DERIVED_INT32_MADD_PER_S * 1e3,
            "latency_bound_ms": int(digits.max()) * MIXED_PRODUCTS[Gp.ncomp] * lat_us / 1e3,
            "bit_serial_bound_ms": bounds(Gp, ks, lat_us)["bound_ms"],
            "nonzero_digits": int(digits.sum())}


def run_window(device=torch.device("cuda"), widths=WINDOW_WIDTHS, reps: int = 5,
               say=print) -> dict:
    """The window kernel's forms beside the bit-serial kernels (the module's
    docstring); returns the figures."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("the harness times kernels: it needs a CUDA device")
    lib = _library()
    lat_us = exp_montmul.measure_latency(FQ, device)["inline"]["us_per_product"]
    say(f"one dependent Fq product at one warp: {lat_us:.4f} us")
    results = {"latency_us_per_product": lat_us}
    for Gp in (G1P, G2P):
        table, _, _ = inputs(Gp, 1, device)
        wtable = Gp.window_table(table)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Gp.window_table(table)
        torch.cuda.synchronize()
        res = {"window_table_ms": (time.perf_counter() - t0) * 1e3}
        say(f"{Gp.name}: window table ({tuple(wtable.shape)}) built in "
            f"{res['window_table_ms']:.3f} ms (host clock)")
        for N in widths:
            table, scal, ks = inputs(Gp, N, device)
            configs = {"window (in use)": lambda: Gp.fixed_base_window(wtable, scal)}
            for tpb in WINDOW_TPB:
                configs[f"window,tpb={tpb}"] = (
                    lambda tpb=tpb: window(lib, Gp, wtable, scal, tpb, False))
            for tpb in STAGED_TPB:
                configs[f"window,staged,tpb={tpb}"] = (
                    lambda tpb=tpb: window(lib, Gp, wtable, scal, tpb, True))
            one_fn = lambda: Gp.fixed_base_launch("fixed_base_one", table, scal)
            team_fn = lambda: Gp.fixed_base_launch("fixed_base", table, scal)
            want = configs["window (in use)"]()
            if not same_points(Gp, want, one_fn()):
                raise AssertionError(f"{Gp.name} N={N}: the window kernel's points differ from "
                                     f"fixed_base_one's")
            row = {}
            for key, fn in configs.items():
                if not torch.equal(fn(), want):
                    raise AssertionError(f"{Gp.name} N={N}: {key} differs from the kernel in use")
                row[key] = exp_ladder._time_ms(fn, reps)
            row["fixed_base_one"] = exp_ladder._time_ms(one_fn, reps)
            row["fixed_base (team)"] = exp_ladder._time_ms(team_fn, reps)
            forms = [k for k in configs if k.startswith("window,")]
            best = min(forms, key=lambda k: row[k])
            b = window_bounds(Gp, scal, ks, lat_us)
            res[N] = {"ms": row, "fastest_window": best, "in_use_kernel": Gp.fixed_base_kernel(N),
                      **b}
            say(f"{Gp.name} N={N}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()) +
                f" ms (window forms equal, same points as fixed_base_one); fastest window form "
                f"{best}; in use {Gp.fixed_base_kernel(N)}; window bound {b['bound_ms']:.5f} "
                f"({b['nonzero_digits']} nonzero digits), bit-serial bound "
                f"{b['bit_serial_bound_ms']:.5f}, latency bound {b['latency_bound_ms']:.4f} ms")
        wins = [N for N in widths
                if res[N]["ms"]["window (in use)"] < res[N]["ms"]["fixed_base (team)"]]
        res["window_beats_team_from"] = min(wins) if wins else None
        say(f"{Gp.name}: the window kernel beats the team kernel from "
            f"{res['window_beats_team_from']} lanes on (of {list(widths)})")
        results[Gp.name] = res
    return results


def run(device=torch.device("cuda"), widths=WIDTHS, reps: int = 5, say=print) -> dict:
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("the harness times kernels: it needs a CUDA device")
    lib = _library()
    lat_us = exp_montmul.measure_latency(FQ, device)["inline"]["us_per_product"]
    say(f"one dependent Fq product at one warp: {lat_us:.4f} us")
    results = {"latency_us_per_product": lat_us}
    for Gp in (G1P, G2P):
        kept = (ctypes.c_int * 3)()
        lib.exp_kept(Gp.ncomp, kept)
        res = {"kept": {"T": kept[0], "teams": kept[1], "one_tpb": kept[2]}}
        say(f"{Gp.name}: in use T = {kept[0]}, {kept[1]} teams a block, the table read through "
            f"L1; one thread on blocks of {kept[2]}")
        for N in widths:
            table, scal, ks = inputs(Gp, N, device)
            # above FIXED_TEAM_MAX_LANES the wrapper runs the window kernel,
            # whose limbs are not the sequence's (--window times it)
            configs = ({"in use": lambda: Gp.fixed_base(table, scal)}
                       if Gp.fixed_base_kernel(N) == "fixed_base" else {})
            for T, p in TEAM_CONFIGS:
                for staged in (False, True):
                    configs[f"T={T},teams={p}{',staged' if staged else ''}"] = (
                        lambda T=T, p=p, s=staged: team(lib, Gp, table, scal, T, p, s))
            for tpb in ONE_TPB:
                configs[f"one,tpb={tpb}"] = lambda tpb=tpb: one(lib, Gp, table, scal, tpb)
            sequence = lambda: Gp.fixed_base_steps(table, scal, Gp.add_mask)
            want = sequence()
            row = {"sequence": exp_ladder._time_ms(sequence, reps)}
            for key, fn in configs.items():
                if not torch.equal(fn(), want):
                    raise AssertionError(f"{Gp.name} N={N}: {key} differs from the add_mask sequence")
                row[key] = exp_ladder._time_ms(fn, reps)
            team_keys = [k for k in configs if k.startswith("T=")]
            one_keys = [k for k in configs if k.startswith("one")]
            best_team = min(team_keys, key=lambda k: row[k])
            best_one = min(one_keys, key=lambda k: row[k])
            b = bounds(Gp, ks, lat_us)
            res[N] = {"ms": row, "fastest_team": best_team, "fastest_one": best_one,
                      "in_use_kernel": Gp.fixed_base_kernel(N), **b}
            say(f"{Gp.name} N={N}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()) +
                f" ms (all equal); fastest team {best_team} {row[best_team]:.4f}, fastest one "
                f"thread {best_one} {row[best_one]:.4f}, in use {Gp.fixed_base_kernel(N)}; "
                f"bound {b['bound_ms']:.5f}, latency bound {b['latency_bound_ms']:.4f} (max "
                f"popcount {b['max_popcount']}), all 256 steps {b['all_steps_ms']:.4f} ms")
        results[Gp.name] = res
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true", help="print the figures as one JSON line too")
    ap.add_argument("--window", action="store_true",
                    help="the window kernel's forms beside the bit-serial kernels instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_fixed_base: no CUDA device; the harness times kernels on the GPU",
              file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0))
    results = run_window() if args.window else run()
    if args.json:
        print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
