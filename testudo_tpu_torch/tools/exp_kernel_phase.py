"""chip_smoke.py's kernel phase of the one-thread group-law kernels alone, so
that two checkouts are compared on one card: every kernel row of
`kernels_group` for G1 and G2 at the default run's shapes (G1 compared and
timed at the 2^20 plan, G2 compared at 2^16 and timed at 2^20) and the
commit's general bucket at nv = 20 (`kernels_commit_bucket`), each printed as
chip_smoke.py prints it, after the build's ptxas lines.  Run on a machine with
the GPU, from the root of a checkout:

    python3 -m testudo_tpu_torch.tools.exp_kernel_phase [--commit-only]

`--commit-only` times the commit's bucket alone.  It imports chip_smoke.py
and the package by absolute name only, so the same file measures another
checkout: `cd other && PYTHONPATH=. python3
/path/to/testudo_tpu_torch/tools/exp_kernel_phase.py` (how a parent and a
change are compared in one call, in turns).  The last line is `AB` and one
JSON object: the `ms` of the bucket, fixed-base, ladder and kernel-phase EC
rows, and `bucket_commit`, the commit's bucket.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

KEEP = ("bucket", "bucket_mixed", "fixed_base_one", "fixed_base_one_key", "add2", "ladder",
        "step", "scan2b", "add_mask")


def run(commit_only: bool) -> dict:
    sys.path.insert(0, os.getcwd())  # this checkout's chip_smoke.py
    import chip_smoke as cs
    from testudo_tpu_torch.device.field import FQ
    from testudo_tpu_torch.tools import exp_montmul

    dev = torch.device("cuda")
    t0 = time.time()
    cs.phase_device()
    rep = cs.Report()
    rep.rows["bucket"] = {}
    if not commit_only:
        lat = exp_montmul.measure_latency(FQ, dev)["inline"]["us_per_product"]
        for name in ("g1", "g2"):
            grp = cs.GROUPS[name]
            proj, affine, ks = cs.make_points(dev, grp, t0)
            big = cs.phase_main(dev, grp, affine, ks, 20, False)[:2]
            cmp = big if name == "g1" else cs.phase_main(dev, grp, affine, ks, 16, False)[:2]
            cs.kernels_group(dev, grp, rep, proj, *cmp, *big, lat, quick=False)
    _, canon, basis = cs.phase_sqrt_pst(dev, 20, full=True)
    cs.kernels_commit_bucket(dev, rep, canon, basis)
    out = {k: row["ms"] for k, row in rep.rows.items()
           if k.removesuffix("_g2") in KEEP and "ms" in row}
    out["bucket_commit"] = rep.rows["bucket"].get("commit_ms")
    print(f"total {time.time() - t0:.1f} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--commit-only", action="store_true", help="time the commit's bucket alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_kernel_phase: no CUDA device; the harness times kernels on the GPU",
              file=sys.stderr)
        return 1
    print("AB " + json.dumps(run(args.commit_only)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
