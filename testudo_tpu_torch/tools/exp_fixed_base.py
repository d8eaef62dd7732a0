"""The fixed-base kernel's form: the team kernel at T = 8, 16 and 32 threads a
lane and several teams a block, with the table of doublings read through L1
or staged in shared memory, and one thread per lane at several block sizes,
against the sequence of 256 `add_mask` launches they replaced, at every
width a path gives them.

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
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys

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
# (T, teams a block): whole warps of 32 to 128 threads
TEAM_CONFIGS = tuple((T, p) for T in (8, 16, 32) for p in (1, 2, 4, 8, 16) if 32 <= T * p <= 128)
ONE_TPB = (32, 64, 128)
# Fq products of a complete add (G2: three per Fq2 product, plus the b3
# products) and its rounds of dependent products
ADD_PRODUCTS = {1: 12, 2: 38}
ADD_ROUNDS = {1: 2, 2: 3}

_CODE = r"""
#include "fixed_base_team.cu"

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
            configs = {"in use": lambda: Gp.fixed_base(table, scal)}
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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_fixed_base: no CUDA device; the harness times kernels on the GPU",
              file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0))
    results = run()
    if args.json:
        print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
