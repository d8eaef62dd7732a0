"""The Groth16 setup's key batches of the SNARK with Groth16 at 2^log2n
constraints (BASELINE config #4: `TestudoSnarkGens.setup(n, n, 10, n)`),
timed on the host clock by their Timer labels.

The verifier circuit of that setup (`CircuitGens.setup`: the circuit of a
dummy proof of the padded shape) is built once; then `groth16.setup` runs on
it `--reps` + 1 times on the card, each with the Timer labels recorded:
`groth16::keys` and its parts `groth16::keys G1` (the a, b_g1, h, l and
gamma_abc batches) and `groth16::keys G2` (b_g2), both ending in a
synchronise, and, where the checkout has them, `fixed_base::window table`
(the window tables of g1 and g2, built by the first setup and kept) and
`fixed_base::host doublings`, each label's seconds listed in the order its
timer stopped.  The first setup is the cold one.  Run on a
machine with the GPU, from the root of a checkout:

    python3 -m testudo_tpu_torch.tools.time_keys [--log2n 16] [--reps 2]

It imports the package by absolute name only, so the same file measures
another checkout's package: `cd other && PYTHONPATH=. python3
/path/to/testudo_tpu_torch/tools/time_keys.py` (how a parent and a change
are compared in one call).  Prints the card's name and one JSON line.

    python3 -m testudo_tpu_torch.tools.time_keys --table-parts

instead builds the window table of a multiple of each generator twice in a
fresh process, G1 then G2, and times its parts on the host clock, each
synchronised: the host doublings, the chain launch of the window bases, the
batched inversion of their Zs, and `PackedGroup.window_table` as a whole
(which repeats the chain and the inversion and adds the affine products and
the Fq2 sums); the first round is what a cold setup pays.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from testudo_tpu_torch.core import groth16, r1cs, r1csproof
from testudo_tpu_torch.curves import profile as cprof
from testudo_tpu_torch.utils import timer

INPUTS = 10  # config #4's public inputs
LABELS = ("groth16::lagrange", "groth16::keys", "groth16::keys G1", "groth16::keys G2",
          "fixed_base::window table", "fixed_base::host doublings")


def run(log2n: int, reps: int, device=torch.device("cuda")) -> dict:
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("time_keys times the card: it needs a CUDA device")
    n = 1 << log2n
    nc, nv = r1cs.pad_params(n, n, INPUTS)
    t0 = time.perf_counter()
    cs = r1csproof.build_verifier_circuit(r1csproof.dummy_verifier_config(nc, nv, INPUTS))
    build_s = time.perf_counter() - t0
    pf = cprof.bls12_377(device)
    setups = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        with timer.record() as rec:
            t0 = time.perf_counter()
            groth16.setup(cs, profile=pf)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        split = {}  # a label's seconds each time it stopped, in order
        for label, secs in rec:
            if label in LABELS:
                split.setdefault(label, []).append(secs)
        setups.append({"wall_s": wall, **split})
    return {"log2n": log2n, "circuit_vars": len(cs.values), "circuit_build_s": build_s,
            "cold": setups[0], "warm": setups[1:]}


def table_parts(rounds: int = 2, device=torch.device("cuda")) -> list:
    """[(round, group, {part: ms})] of `rounds` window-table builds a group
    (the module's docstring)."""
    from testudo_tpu_torch.curves import host_curve as hc
    from testudo_tpu_torch.device import curve as tc, field as tf
    from testudo_tpu_torch.device.curve_generic import FIXED_BASE_WINDOW as FB_WINDOW
    from testudo_tpu_torch.device.field import FQ
    from testudo_tpu_torch.device.packed_curve import G1P, G2P

    def timed(parts, name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[name] = (time.perf_counter() - t0) * 1e3
        return out

    one = torch.as_tensor(FQ.to_limbs(FQ.r_mod_p), device=device)
    res = []
    for r in range(rounds):
        for Gp, gen, mul in ((G1P, hc.g1_generator, hc.g1_mul), (G2P, hc.g2_generator, hc.g2_mul)):
            parts = {}
            base = mul(gen(), 7 + r)
            table = timed(parts, "host doublings", lambda: tc.fixed_base_table(Gp, base, 256, device))
            bases = table[:, ::FB_WINDOW].T.contiguous()
            multiples = timed(parts, "chain", lambda: Gp.chain(bases, 1 << FB_WINDOW))
            z = Gp.unpack(multiples.T)[2]
            z = (z if Gp.ncomp == 1 else z[0]).clone()
            z[:: 1 << FB_WINDOW] = one  # the identity rows' stand-ins
            timed(parts, "batch_inv", lambda: tf.batch_inv(FQ, z))
            timed(parts, "window_table", lambda: Gp.window_table(table))
            res.append((r, Gp.name, parts))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2n", type=int, default=16)
    ap.add_argument("--reps", type=int, default=2, help="warm setups after the cold one")
    ap.add_argument("--table-parts", action="store_true",
                    help="time the window table's parts instead (this checkout's package)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_keys: no CUDA device; the tool times the card", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0), flush=True)
    print(json.dumps(table_parts() if args.table_parts else run(args.log2n, args.reps)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
