"""How much of a sqrt-PST open at nv = 20 is the ladder and the adds: device
time of every ladder launch and every tree of pairwise adds of warm opens,
beside the open's wall clock and the warm commit.

An open launches the scalar-mul ladder 33 times (the MIPP cross MSMs and
folds, the PST opens), each followed by trees of pairwise adds, between
host pairings and transcript work.  This tool wraps `PackedGroup.ladder`,
`PackedGroup.fold` and `PackedGroup.add2` with CUDA events for the length
of each open and sums, per group, the device time between the events around
each call (the kernels, and whatever wait for the host falls inside: the
wrapper's own few microseconds).  Folds and `add2` calls are summed
together as "adds": a checkout from before the fold kernel launches `add2`
once a level where this one launches one fold a tree.  Run on a machine with the GPU, from the root of a
checkout:

    python3 -m testudo_tpu_torch.tools.time_open

It imports the package by absolute name only, so the same file measures
another checkout's package: `cd other && PYTHONPATH=. python3
/path/to/testudo_tpu_torch/tools/time_open.py` (how a parent and a change
are compared in one call).  The inputs are chip_smoke.py's at nv = 20: the
ark test_rng setup, a table from numpy.random.default_rng(7), a point from
random.Random(7).  Prints one JSON line.
"""
from __future__ import annotations

import json
import random
import statistics
import sys
import time

import numpy as np
import torch

from testudo_tpu_torch.core import pst, sqrt_pst
from testudo_tpu_torch.curves import profile as cprof
from testudo_tpu_torch.device import packed_curve
from testudo_tpu_torch.device.field import FR
from testudo_tpu_torch.fields.bls12_377 import R
from testudo_tpu_torch.poly import dense
from testudo_tpu_torch.poseidon.transcript import PoseidonTranscript, fq_params


# what is timed: `PackedGroup` methods by kind (a method the checkout lacks
# is left out)
KINDS = {"ladder": ("ladder",), "adds": ("fold", "add2")}


def device_ms(fn, kinds=KINDS):
    """(fn(), {kind: {group: [ms, calls]}}): device milliseconds between CUDA
    events around every call of the `PackedGroup` methods of each kind that
    fn makes."""
    cls = packed_curve.PackedGroup
    marks, saved = [], {}

    def wrap(kind, orig):
        def timed(self, *args):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = orig(self, *args)
            e1.record()
            marks.append((kind, self.name, e0, e1))
            return out
        return timed

    for kind, methods in kinds.items():
        for m in methods:
            if hasattr(cls, m):
                saved[m] = getattr(cls, m)
                setattr(cls, m, wrap(kind, saved[m]))
    try:
        out = fn()
    finally:
        for m, orig in saved.items():
            setattr(cls, m, orig)
    torch.cuda.synchronize()
    sums = {kind: {} for kind in kinds}
    for kind, name, e0, e1 in marks:
        tot = sums[kind].setdefault(name, [0.0, 0])
        tot[0] += e0.elapsed_time(e1)
        tot[1] += 1
    return out, sums


def run(nv: int = 20, opens: int = 3, device=torch.device("cuda")) -> dict:
    pf = cprof.bls12_377(device)
    ck, _ = pst.setup(nv // 2 + nv % 2, profile=pf)
    rng = np.random.default_rng(7)
    limbs = rng.integers(0, 1 << 16, size=(1 << nv, FR.nlimbs), dtype=np.int64)
    limbs[:, -1] &= 0x0FFF
    table = dense._to_mont_dev(torch.as_tensor(limbs.astype(np.int32), device=device))
    prng = random.Random(7)
    point = [prng.randrange(R) for _ in range(nv)]
    pl = sqrt_pst.Polynomial.from_evaluations(table, pf)
    pl.eval(point)

    def timed_call(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    commits = []
    for _ in range(4):  # the first commit is cold
        (comm, T), secs = timed_call(lambda: pl.commit(ck))
        commits.append(secs)
    commits = commits[1:]

    def do_open():
        pl.q = None
        return pl.open(PoseidonTranscript(fq_params()), comm, ck, point, T)

    first, open_cold = timed_call(do_open)
    rows = []
    for _ in range(opens):
        (out, secs), timed = device_ms(lambda: timed_call(do_open))
        if out[0] != first[0]:
            raise AssertionError("a warm open differs from the first")
        row = {"open_s": secs}
        for kind, sums in timed.items():
            row[kind + "_ms"] = {g: v[0] for g, v in sums.items()}
            row[kind + "_calls"] = {g: v[1] for g, v in sums.items()}
        rows.append(row)
    return {"nv": nv, "device": torch.cuda.get_device_name(0),
            "commit_warm_s": commits, "commit_median_s": statistics.median(commits),
            "open_cold_s": open_cold, "opens": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("time_open: no CUDA device; this tool times the GPU", file=sys.stderr)
        return 1
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
