"""Where the team ladder stops paying: both ladder kernels at every width.

The scalar-mul ladder has two kernels (device/packed_curve.py): the team
kernel (csrc/ladder_team.cu, a team of threads per lane) and the one-thread
kernel (csrc/ladder.cu).  `PackedGroup.ladder` takes the team kernel up to
TEAM_LADDER_MAX_LANES lanes of its group and the one-thread kernel above;
this harness measures the crossover those constants come from.  Run on a
machine with the GPU:

    python3 -m testudo_tpu_torch.tools.exp_ladder

For G1 and G2, at L = 20 ... 32,768 lanes and two kinds of scalars (Horner:
lane l multiplies by 2^(13 (l mod 20)), as the MSM's Horner combine; random
253-bit scalars below r, as the MIPP folds), it times the one-thread kernel
and the team kernel (CUDA events, mean of a few launches after a warm-up),
checks that both give the same limbs, and prints one line per width and the
widest width at which the team kernel still beats the one-thread kernel for
both kinds of scalars.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..curves import host_curve as hc
from ..device import curve as tc
from ..device.field import FR
from ..device.packed_curve import G1P, G2P, TEAM_LADDER_MAX_LANES
from ..fields.bls12_377 import R

WIDTHS = (20, 64, 256, 1024, 4096, 8192, 32768)
HORNER_C, HORNER_W = 13, 20


def scalars(kind: str, L: int, device) -> torch.Tensor:
    """(16, L) canonical scalar rows: "horner" or "random"."""
    if kind == "horner":
        ks = [1 << (HORNER_C * (l % HORNER_W)) for l in range(L)]
    else:
        rng = np.random.default_rng(L)
        ks = [int.from_bytes(rng.bytes(40), "little") % R for _ in range(L)]
    return torch.as_tensor(FR.to_limbs(ks).T.copy(), device=device)


def points(Gp, L: int, device) -> torch.Tensor:
    """L distinct projective points: the generator times small scalars
    through the one-thread kernel."""
    gen = hc.g1_generator() if Gp is G1P else hc.g2_generator()
    lift = tc.g1_from_affine_host if Gp is G1P else tc.g2_from_affine_host
    g = Gp.pack(lift([gen], device=device)).repeat(1, L).contiguous()
    small = torch.zeros((1, L), dtype=torch.int32, device=device)
    small[0] = torch.arange(L, dtype=torch.int32, device=device) % 65521 + 3
    return Gp.ladder_launch("ladder", g, small)


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def run(device=torch.device("cuda"), widths=WIDTHS, say=print) -> dict:
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("the harness times kernels: it needs a CUDA device")
    results = {}
    for Gp in (G1P, G2P):
        rows = []
        for L in widths:
            pts = points(Gp, L, device)
            row = {"L": L}
            for kind in ("horner", "random"):
                scal = scalars(kind, L, device)
                want = Gp.ladder_launch("ladder", pts, scal)
                reps = 3 if L >= 8192 else 5
                row[kind] = {"one_thread": _time_ms(lambda: Gp.ladder_launch("ladder", pts, scal), reps)}
                got = Gp.ladder_launch("ladder_team", pts, scal)
                if not torch.equal(got, want):
                    raise AssertionError(f"{Gp.name}: team kernel differs at L={L} ({kind})")
                row[kind]["team"] = _time_ms(lambda: Gp.ladder_launch("ladder_team", pts, scal), reps)
            rows.append(row)
            say(f"{Gp.name} L={L:6d}: " + "; ".join(
                f"{kind} " + ", ".join(f"{k} {v:.4f}" for k, v in row[kind].items())
                for kind in ("horner", "random")) + " ms (both equal)")
        # the widest width up to which the team kernel beats one thread for both kinds
        best = 0
        for row in rows:
            if not all(row[k]["team"] < row[k]["one_thread"] for k in ("horner", "random")):
                break
            best = row["L"]
        say(f"{Gp.name}: team kernel faster than one thread up to L = {best} "
            f"(in use up to {TEAM_LADDER_MAX_LANES[Gp.ncomp]} lanes)")
        results[Gp.name] = {"rows": rows, "team_faster_up_to": best}
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true", help="print the figures as one JSON line too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_ladder: no CUDA device; the harness times kernels on the GPU", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0))
    results = run()
    if args.json:
        print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
