"""The BW6-761 group's costs on the card, layer by layer: the 761-bit
Montgomery product alone, a field sum and difference in the two forms the
port has (`field.add` / `sub`, which widen every limb to int64, and
`curve_generic.add` / `sub` in int32, the group's), a complete add of
`FpGroup` and the same formula with `field.add` / `sub` for its sums, a
double, `fixed_base_mul` and `msm_fp`, at the widths the one-level wrap gives
them.  Run on a machine with the GPU:

    python3 -m testudo_tpu_torch.tools.exp_bw6

Every timed call is first checked: the product against its plain version,
the two forms of the sums against each other, a group add made with each
against the other, `fixed_base_mul` and `msm_fp` against the host (the
bases' discrete logs are known).  Times are CUDA events around back-to-back
calls after a warm-up (mean), or the host clock around one synchronised call
for `fixed_base_mul` and `msm_fp`; the product's rows also give its device
time with the L2 cache flushed (torch.profiler, as tools/exp_mont_rm.py).
"""
from __future__ import annotations

import argparse
import json
import random
import sys
import time

import numpy as np
import torch

from ..curves import bw6_761 as bw
from ..device import build, packed_field
from ..device import curve_generic as cg
from ..device import field as tf
from ..device import msm
from ..device.curve import _complete_add
from ..device.field import FQ
from ..fields.bls12_377 import P as R_BW6
from . import exp_mont_rm

WIDTHS = (384, 4096, 1 << 16, 1 << 18, 1 << 20)  # the weighted sum's lanes .. a bucket slice


def _events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _once_s(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


class _FieldSums(cg._Ops):
    """The group's ops with `field.add` / `sub` (int64 limbs) for its sums."""

    def add(self, a, b_):
        return tf.add(self.spec, a, b_)

    def sub(self, a, b_):
        return tf.sub(self.spec, a, b_)


def _elements(n: int, rng, dev) -> torch.Tensor:
    v = rng.integers(0, 1 << 16, size=(n, 48), dtype=np.int64)
    v[:, -1] &= 0x00FF  # below q
    return torch.as_tensor(v.astype(np.int32), device=dev)


def run(device=torch.device("cuda"), say=print) -> dict:
    if torch.device(device).type != "cuda":
        raise RuntimeError("exp_bw6 times kernels on the GPU")
    dev = torch.device(device)
    S = cg.FQ761
    rng = np.random.default_rng(5)
    out = {"product": [], "sums": [], "group": []}
    flush = exp_mont_rm.l2_flusher(dev)
    for n in WIDTHS:
        a, b = _elements(n, rng, dev), _elements(n, rng, dev)
        res = torch.empty_like(a)
        raw = lambda: build.launch("mont_mul_rm", a.data_ptr(), b.data_ptr(), res.data_ptr(),
                                   packed_field.field_id(S), n, 0, counted_as="mont_mul_rm_bw6fq")
        raw()
        if not torch.equal(res, tf.mont_mul_plain(S, a, b)):
            raise AssertionError(f"761-bit product differs from its plain version at {n}")
        row = {"n": n, "kernel_ms": exp_mont_rm.profiled_ms(raw, exp_mont_rm.KERNEL, flush=flush),
               "raw_ms": _events_ms(raw, 20), "bound_ms": 3 * 48 * 4 * n / 3.35e12 * 1e3}
        out["product"].append(row)
        if not (torch.equal(cg.add(S, a, b), tf.add(S, a, b))
                and torch.equal(cg.sub(S, a, b), tf.sub(S, a, b))):
            raise AssertionError(f"the two forms of the sums differ at {n}")
        sums = {"n": n,
                "field_add_ms": _events_ms(lambda: tf.add(S, a, b), 5),
                "field_sub_ms": _events_ms(lambda: tf.sub(S, a, b), 5),
                "int32_add_ms": _events_ms(lambda: cg.add(S, a, b), 5),
                "int32_sub_ms": _events_ms(lambda: cg.sub(S, a, b), 5)}
        out["sums"].append(sums)
        G = cg.bw6_g1()
        field_ops = _FieldSums(S, G.b)
        P1, P2 = (a, b, _elements(n, rng, dev)), (b, a, _elements(n, rng, dev))
        mine, theirs = G.add(P1, P2), _complete_add(field_ops, P1, P2)
        if not all(torch.equal(x, y) for x, y in zip(mine, theirs)):
            raise AssertionError(f"a group add differs between the two forms of sums at {n}")
        grp = {"n": n, "add_ms": _events_ms(lambda: G.add(P1, P2), 3),
               "double_ms": _events_ms(lambda: G.double(P1), 3),
               "add_field_sums_ms": _events_ms(lambda: _complete_add(field_ops, P1, P2), 3)}
        out["group"].append(grp)
        say(f"n={n}: product {row['kernel_ms']:.4f} ms (L2 flushed), raw {row['raw_ms']:.4f}, "
            f"bound {row['bound_ms']:.5f}; sums field {sums['field_add_ms']:.4f} / "
            f"{sums['field_sub_ms']:.4f} ms, int32 {sums['int32_add_ms']:.4f} / "
            f"{sums['int32_sub_ms']:.4f}; complete add {grp['add_ms']:.3f} ms (with field sums "
            f"{grp['add_field_sums_ms']:.3f}), double {grp['double_ms']:.3f}")
    pyr = random.Random(3)
    G, g = cg.bw6_g1(), bw.g1_generator()
    N = 1 << 16
    ks = [pyr.randrange(1, 1 << 20) for _ in range(N)]
    kst = torch.as_tensor(FQ.to_limbs(ks), device=dev)
    bases, cold = _once_s(lambda: cg.fixed_base_mul(G, kst, g, bw.g1_add))
    bases, warm = _once_s(lambda: cg.fixed_base_mul(G, kst, g, bw.g1_add))
    if G.to_affine_host(tuple(c[:3] for c in bases)) != [bw.g1_mul(g, k) for k in ks[:3]]:
        raise AssertionError("fixed_base_mul differs from the host")
    out["fixed_base"] = {"lanes": N, "cold_s": cold, "warm_s": warm}
    say(f"fixed_base_mul G1 at {N} lanes: cold {cold:.3f} s (the host table), warm {warm:.3f} s")
    out["msm_fp"] = []
    for kind in ("random", "half booleans"):
        sc = [pyr.randrange(R_BW6) for _ in range(N)]
        if kind != "random":
            sc = [pyr.randrange(2) if i % 2 else s for i, s in enumerate(sc)]
        st = torch.as_tensor(FQ.to_limbs(sc), device=dev)
        got, secs = _once_s(lambda: msm.msm_fp(G, bw.g1_add, bases, st))
        if got != bw.g1_mul(g, sum(k * s for k, s in zip(ks, sc)) % R_BW6):
            raise AssertionError(f"msm_fp ({kind}) differs from the host")
        out["msm_fp"].append({"lanes": N, "scalars": kind, "s": secs})
        say(f"msm_fp G1 at {N} lanes, {kind} scalars: {secs:.3f} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true", help="print the figures as one JSON line too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_bw6: no CUDA device; the harness times kernels on the GPU", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0))
    results = run()
    if args.json:
        print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
