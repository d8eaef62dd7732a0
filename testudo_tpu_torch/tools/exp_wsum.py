"""The weighted bucket sum's team size: the fused kernel at T = 8, 16 and 32
threads a lane, against the sequence of launches it replaced.

`PackedGroup.weighted_sum` runs the per-group weighted sum of every MSM as
one launch of csrc/wsum_team.cu, a team of WSUM_T threads per lane (fixed
per group in ec_team.cuh); this harness measures the choice.  Run on a
machine with the GPU:

    python3 -m testudo_tpu_torch.tools.exp_wsum

For G1 and G2 at the shape of the signed c = 13 MSM (W = 20 windows of 2^12
buckets: 2,560 lanes of 32 buckets each, 12 weight bits, plus_one), it
builds the kernel at each team size (compile-time arguments of this tool's
own instantiations: one source that includes csrc/wsum_team.cu, built into
testudo_tpu_torch/_build/), checks that each gives the limbs of the launch
sequence it replaced (`weighted_sum_steps` on the `scan2b`, `step` and
`add2` kernels: 32 + 12 + 2 launches and the host loop between them), times
each and the sequence (CUDA events, mean of a few calls after a warm-up),
and prints one line per group with the fastest team size and the one in use.
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
W, C = 20, 12  # the signed c = 13 plan after the magnitude-0 slot is dropped

_CODE = r"""
#include "wsum_team.cu"

// The weighted sum at team size T (8, 16 or 32), or -1.
extern "C" int exp_wsum_team(const int* buckets, int* out, int W, int c, int plus_one,
                             int ncomp, int T, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool po = plus_one != 0;
#define EXP_WSUM_T(t)                                                            \
  if (T == t)                                                                    \
    return ncomp == 1 ? wsum_launch<FqCoord, t>(buckets, out, W, c, po, st)      \
                      : wsum_launch<Fq2Coord, t>(buckets, out, W, c, po, st);
  if (ncomp != 1 && ncomp != 2) return -1;
  EXP_WSUM_T(8)
  EXP_WSUM_T(16)
  EXP_WSUM_T(32)
  return -1;
}

// The team size the kernel library uses for the group.
extern "C" int exp_wsum_kept(int ncomp) { return WSUM_T(ncomp); }
"""


def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.build_tool("exp_wsum", _CODE)))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.exp_wsum_team.argtypes = [P, P, I, I, I, I, I, P]
    lib.exp_wsum_team.restype = I
    lib.exp_wsum_kept.argtypes = [I]
    lib.exp_wsum_kept.restype = I
    return lib


def launch(lib, Gp, buckets: torch.Tensor, T: int) -> torch.Tensor:
    """The weighted sum (W windows of 2^C buckets, plus_one) of `buckets`
    by the kernel at team size T."""
    _, groups, _ = Gp.wsum_plan(C)
    out = torch.empty((Gp.rows, W * groups), dtype=torch.int32, device=buckets.device)
    rc = lib.exp_wsum_team(buckets.data_ptr(), out.data_ptr(), W, C, 1, Gp.ncomp, T,
                           torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"exp_wsum_team (T = {T}) failed with {rc}")
    return out


def run(device=torch.device("cuda"), reps: int = 5, say=print) -> dict:
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("the harness times kernels: it needs a CUDA device")
    lib = _library()
    results = {}
    for Gp in (G1P, G2P):
        buckets = exp_ladder.points(Gp, W << C, device)
        sequence = lambda: Gp.weighted_sum_steps(buckets, W, C, True, Gp.scan2b, Gp.step, Gp.add2)
        want = sequence()
        row = {"sequence": exp_ladder._time_ms(sequence, reps)}
        for T in TEAM_SIZES:
            if not torch.equal(launch(lib, Gp, buckets, T), want):
                raise AssertionError(f"{Gp.name}: the team kernel at T = {T} differs from the sequence")
            row[f"T={T}"] = exp_ladder._time_ms(lambda: launch(lib, Gp, buckets, T), reps)
        fastest = min(TEAM_SIZES, key=lambda T: row[f"T={T}"])
        kept = lib.exp_wsum_kept(Gp.ncomp)
        say(f"{Gp.name} {W * Gp.wsum_plan(C)[1]} lanes: " +
            ", ".join(f"{k} {v:.4f}" for k, v in row.items()) +
            f" ms (all equal); fastest T = {fastest}, in use T = {kept}")
        results[Gp.name] = {"ms": row, "fastest": fastest, "kept": kept}
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true", help="print the figures as one JSON line too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_wsum: no CUDA device; the harness times kernels on the GPU", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0))
    results = run()
    if args.json:
        print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
