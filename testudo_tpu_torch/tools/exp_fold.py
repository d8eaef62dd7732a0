"""The chain and fold kernels' team sizes: both team kernels at T = 8, 16 and
32 threads a lane and several teams a block, against the sequences of `add2`
launches they replaced, at every path's shapes.

`PackedGroup.chain` builds the commit's table of multiples in one launch of
csrc/chain_team.cu and `PackedGroup.fold` reduces every segment of a batch
in one launch of csrc/fold_team.cu; each runs the complete add with a team
of threads per lane, the team size and the teams a block fixed per group in
ec_team.cuh (CHAIN_T, CHAIN_TEAMS, FOLD_T, FOLD_TEAMS).  This harness
measures that choice.  Run on a machine with the GPU:

    python3 -m testudo_tpu_torch.tools.exp_fold

It builds its own instantiations of both kernels at every team size (one
source that includes csrc/chain_team.cu and fold_team.cu, built into
testudo_tpu_torch/_build/), and for G1 and G2 at each shape of the paths
(the commit's table: 1,024 bases x 255 adds; the MSM's fold of the groups:
20 segments of 128; the Horner tree: one of 20; the commit's multi-Horner
fold: 1,024 segments of 32; the open's parts: 512, 256, ..., 1, and its two
segments of 512) checks that each configuration gives the limbs of the
`add2` launch sequence (`chain_steps`, `fold_steps`), times each, the
sequence and the kernel library's own launch ("in use": its team size and
teams a block) (CUDA events, mean of a few calls after a warm-up), and prints
one line per shape: every time and the fastest configuration.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys

import torch

from ..device import build
from ..device.packed_curve import G1P, G2P
from . import exp_ladder

TEAM_SIZES = (8, 16, 32)
CHAIN_TEAMS = (2, 4, 8, 16)
FOLD_TEAMS = (4, 8, 16, 32, 64)
CHAIN_N, CHAIN_B = 1024, 256
# name: (segment offsets, segment lengths)
FOLD_SHAPES = {
    "msm_groups": ([128 * w for w in range(20)], [128] * 20),
    "horner": ([0], [20]),
    "commit_horner": ([32 * k for k in range(1024)], [32] * 1024),
    "open_parts": ([1024 - (1 << (e + 1)) for e in range(9, -1, -1)],
                   [1 << e for e in range(9, -1, -1)]),
    "open_segments": ([0, 512], [512, 512]),
}

_CODE = r"""
#include "chain_team.cu"
#include "fold_team.cu"

#define EXP_T(T, launch)                                                         \
  if (t == T) return ncomp == 1 ? launch(FqCoord, T) : launch(Fq2Coord, T);

// The chain at team size t (8, 16 or 32) and `teams` lanes a block, or -1.
extern "C" int exp_chain(const int* base, int* out, long N, int B, int ncomp, int t, int teams,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define EXP_CHAIN(C, T) chain_launch<C, T>(base, out, N, B, teams, st)
  if (ncomp != 1 && ncomp != 2) return -1;
  EXP_T(8, EXP_CHAIN)
  EXP_T(16, EXP_CHAIN)
  EXP_T(32, EXP_CHAIN)
  return -1;
}

// The fold at team size t and at most `teams` teams a block, or -1.
extern "C" int exp_fold(const int* a, long L, const int* seg, int S, int max_len, int* scratch,
                        int* out, int ncomp, int t, int teams, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define EXP_FOLD(C, T) fold_launch<C, T>(a, L, seg, S, max_len, scratch, out, teams, st)
  if (ncomp != 1 && ncomp != 2) return -1;
  EXP_T(8, EXP_FOLD)
  EXP_T(16, EXP_FOLD)
  EXP_T(32, EXP_FOLD)
  return -1;
}

// What the kernel library uses for the group: chain T, chain teams, fold T,
// fold teams at most, at least, and teams in all a launch aims at.
extern "C" void exp_kept(int ncomp, int* out) {
  out[0] = CHAIN_T(ncomp);
  out[1] = CHAIN_TEAMS(ncomp);
  out[2] = FOLD_T(ncomp);
  out[3] = FOLD_TEAMS(ncomp);
  out[4] = FOLD_TEAMS_MIN;
  out[5] = FOLD_CARD_TEAMS;
}
"""


def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.build_tool("exp_fold", _CODE)))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.exp_chain.argtypes = [P, P, L, I, I, I, I, P]
    lib.exp_chain.restype = I
    lib.exp_fold.argtypes = [P, L, P, I, I, P, P, I, I, I, P]
    lib.exp_fold.restype = I
    lib.exp_kept.argtypes = [I, P]
    lib.exp_kept.restype = None
    # the kernel library's own launchers, built into this library too
    lib.testudo_chain_team.argtypes = [P, P, L, I, I, P]
    lib.testudo_chain_team.restype = I
    lib.testudo_fold_team.argtypes = [P, L, P, I, I, P, P, I, P]
    lib.testudo_fold_team.restype = I
    return lib


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def chain(lib, Gp, ptcat: torch.Tensor, B: int, T: int, teams: int) -> torch.Tensor:
    """The chain at team size T and `teams` lanes a block; T = 0: as the
    kernel library launches it."""
    out = torch.empty((ptcat.shape[0] * B, Gp.rows), dtype=torch.int32, device=ptcat.device)
    if T == 0:
        rc = lib.testudo_chain_team(ptcat.data_ptr(), out.data_ptr(), ptcat.shape[0], B,
                                    Gp.ncomp, _stream())
    else:
        rc = lib.exp_chain(ptcat.data_ptr(), out.data_ptr(), ptcat.shape[0], B, Gp.ncomp, T,
                           teams, _stream())
    if rc != 0:
        raise RuntimeError(f"exp_chain (T = {T}, {teams} teams) failed with {rc}")
    return out


def fold(lib, Gp, a: torch.Tensor, off, ln, T: int, teams: int) -> torch.Tensor:
    """The fold at team size T and at most `teams` teams a block; T = 0: as
    the kernel library launches it.  Uniform segments go without a table, as
    `PackedGroup.fold` passes them."""
    S, max_len = len(ln), max(ln)
    seg = None
    if not Gp.uniform_segments(off, ln):
        seg = torch.tensor([off, ln], dtype=torch.int32, device=a.device)
    seg_ptr = seg.data_ptr() if seg is not None else None
    half = (max_len + 1) // 2
    scratch = torch.empty(max(1, S * 2 * half * Gp.rows), dtype=torch.int32, device=a.device)
    out = torch.empty((Gp.rows, S), dtype=torch.int32, device=a.device)
    if T == 0:
        rc = lib.testudo_fold_team(a.data_ptr(), a.shape[1], seg_ptr, S, max_len,
                                   scratch.data_ptr(), out.data_ptr(), Gp.ncomp, _stream())
    else:
        rc = lib.exp_fold(a.data_ptr(), a.shape[1], seg_ptr, S, max_len,
                          scratch.data_ptr(), out.data_ptr(), Gp.ncomp, T, teams, _stream())
    if rc != 0:
        raise RuntimeError(f"exp_fold (T = {T}, {teams} teams) failed with {rc}")
    return out


def _sweep(name, sequence, configs, reps, say):
    """Time the sequence and every configuration (each must give the
    sequence's limbs); returns the row."""
    want = sequence()
    row = {"sequence": exp_ladder._time_ms(sequence, reps)}
    for key, fn in configs.items():
        if not torch.equal(fn(), want):
            raise AssertionError(f"{name}: {key} differs from the add2 sequence")
        row[key] = exp_ladder._time_ms(fn, reps)
    fastest = min((k for k in configs if k != "in use"), key=lambda k: row[k])
    say(f"{name}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()) +
        f" ms (all equal); fastest {fastest}")
    return {"ms": row, "fastest": fastest}


def run(device=torch.device("cuda"), reps: int = 5, say=print) -> dict:
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("the harness times kernels: it needs a CUDA device")
    lib = _library()
    results = {}
    for Gp in (G1P, G2P):
        kept = (ctypes.c_int * 6)()
        lib.exp_kept(Gp.ncomp, kept)
        res = {"kept": {"chain_T": kept[0], "chain_teams": kept[1], "fold_T": kept[2],
                        "fold_teams": kept[3], "fold_teams_min": kept[4],
                        "fold_card_teams": kept[5]}}
        say(f"{Gp.name}: in use chain T = {kept[0]}, {kept[1]} teams a block; fold T = "
            f"{kept[2]}, {kept[5]} / S teams a block, within {kept[4]} .. {kept[3]}")
        ptcat = exp_ladder.points(Gp, CHAIN_N, device).T.contiguous()
        res["chain"] = _sweep(
            f"{Gp.name} chain {CHAIN_N} x {CHAIN_B - 1}",
            lambda: Gp.chain_steps(ptcat, CHAIN_B, Gp.add2),
            {"in use": lambda: chain(lib, Gp, ptcat, CHAIN_B, 0, 0),
             **{f"T={T},teams={p}": (lambda T=T, p=p: chain(lib, Gp, ptcat, CHAIN_B, T, p))
                for T in TEAM_SIZES for p in CHAIN_TEAMS if T * p <= 512}},
            reps, say)
        del ptcat
        for shape, (off, ln) in FOLD_SHAPES.items():
            a = exp_ladder.points(Gp, max(o + n for o, n in zip(off, ln)), device)
            res[shape] = _sweep(
                f"{Gp.name} fold {shape} ({len(ln)} segments, {min(ln)}..{max(ln)} points)",
                lambda: Gp.fold_steps(a, off, ln, Gp.add2),
                {"in use": lambda: fold(lib, Gp, a, off, ln, 0, 0),
                 **{f"T={T},teams={p}": (lambda T=T, p=p: fold(lib, Gp, a, off, ln, T, p))
                    for T in TEAM_SIZES for p in FOLD_TEAMS if T * p <= 512}},
                reps, say)
        results[Gp.name] = res
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true", help="print the figures as one JSON line too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_fold: no CUDA device; the harness times kernels on the GPU", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0))
    results = run()
    if args.json:
        print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
