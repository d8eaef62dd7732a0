"""What one Montgomery product costs on the card: the chained-product harness.

Counterpart of tools/exp_montmul_block.py and tools/exp_mulmany_wide.py.
Both run K chained products `a <- a * b` inside ONE kernel launch and take
the time of a product from the slope between K = 8 and K = 64, so the
launch, the loads and the stores drop out.  Run on a machine with the GPU:

    python3 -m testudo_tpu_torch.tools.exp_montmul

It prints, for Fq and Fr:
  - single chains `(n, L)`: that the two formulations of the product agree
    (the body inlined at the call site; the shared out-of-line `fp_mul` the
    group-law kernels call), then K8 / K64 times and microseconds per
    product (per launch, as the TPU harness prints) and the products per
    second of the whole card that the slope gives;
  - grouped chains `(6, n, L)`: that `seq` (a thread runs its 6 products
    one after the other) and `wide` (6 L lanes, one product each) agree,
    and the same figures per 6-product group;
at the TPU harnesses' own sizes (L = 1024; 6 x 256) and at a size that fills
the card (132 SMs x 2048 lanes).  The last lines give the measured
multiply-adds per second beside the derived peak the bounds in PERF.md use.

The latency mode (`--latency`, and the last figures of every run) launches
the single chain at one warp (32 lanes) with K = 256 dependent Fq products,
inlined and called: the slope between K = 8 and K = 256 is what one product
costs a thread that waits for it, the floor of any kernel whose products
depend on each other (the ladders: PERF.md).

`check_edges` (chip_smoke.py runs it) holds one product, inlined and
called, against the plain product at every field of the chain kernel (Fq,
Fr, BW6-761's Fq, BLS12-381's Fr) on edge operands: 0, 1, p - 1, and
operands below R but not below p, as `field._fold_wide` hands them.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..device import packed_field as pf
from ..device.curve_generic import FQ761
from ..device.field import FQ, FR, FR381, FieldSpec

K_LO, K_HI = 8, 64
GROUP = pf.CHAIN_GROUP
L_REFERENCE = 1024  # tools/exp_montmul_block.py
L_REFERENCE_GROUP = 256  # tools/exp_mulmany_wide.py
L_CARD = 132 * 2048  # every SM holds 2048 resident threads
L_LATENCY, K_LATENCY = 32, 256  # one warp, a chain as long as a ladder's
EDGE_FIELDS = (FQ, FR, FQ761, FR381)  # every field of the chain kernel
# 32-bit multiply-adds a second: 67 TFLOP/s float32 is 33.5e12 fused
# multiply-adds on 128 lanes per SM; an SM has 64 int32 lanes
DERIVED_INT32_MADD_PER_S = 67e12 / 2 / 2


def madds_per_product(spec: FieldSpec) -> int:
    """32-bit multiply-adds of one word-serial CIOS product of N-word
    operands: N^2 for a * b, N^2 for m * p, N for the m's."""
    n = spec.nlimbs // 2
    return 2 * n * n + n


def random_rows(spec: FieldSpec, shape, seed: int, device) -> torch.Tensor:
    """Canonical elements as limb rows: `shape` ends in (nlimbs, L)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 16, size=shape, dtype=np.int64)
    top_bits = spec.modulus.bit_length() - 16 * (spec.nlimbs - 1)
    a[..., -1, :] &= (1 << (top_bits - 1)) - 1  # below p
    return torch.as_tensor(a.astype(np.int32), device=device)


def _time_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _slope(call, chains: int) -> dict:
    """K8 / K64 times of `call(K)` and what the slope says: microseconds per
    chain step of one launch, and steps of single chains per second."""
    lo, hi = _time_ms(lambda: call(K_LO)), _time_ms(lambda: call(K_HI))
    per_step_ms = (hi - lo) / (K_HI - K_LO)
    return {"k8_ms": lo, "k64_ms": hi, "us_per_step": per_step_ms * 1e3,
            "chain_steps_per_s": chains / (per_step_ms * 1e-3)}


def measure_single(spec: FieldSpec, L: int, device) -> dict:
    """Single chains on (n, L): agreement of the two formulations, slopes."""
    a = random_rows(spec, (spec.nlimbs, L), 0, device)
    b = random_rows(spec, (spec.nlimbs, L), 1, device)
    inl = pf.mont_mul_chain(spec, a, b, K_LO, inline_body=True)
    call = pf.mont_mul_chain(spec, a, b, K_LO, inline_body=False)
    if not torch.equal(inl, call):
        raise AssertionError(f"{spec.name}: the two formulations of the product disagree")
    out = {"field": spec.name, "L": L, "formulations_agree": True}
    for name, flag in (("inline", True), ("call", False)):
        out[name] = _slope(lambda K: pf.mont_mul_chain(spec, a, b, K, inline_body=flag), L)
    return out


def measure_group(spec: FieldSpec, L: int, device) -> dict:
    """Grouped chains on (6, n, L): agreement of seq and wide, slopes."""
    a = random_rows(spec, (GROUP, spec.nlimbs, L), 2, device)
    b = random_rows(spec, (GROUP, spec.nlimbs, L), 3, device)
    seq = pf.mont_mul_chain_group(spec, a, b, K_LO, "seq")
    wide = pf.mont_mul_chain_group(spec, a, b, K_LO, "wide")
    if not torch.equal(seq, wide):
        raise AssertionError(f"{spec.name}: seq and wide disagree")
    singles = torch.stack([pf.mont_mul_chain(spec, a[g], b[g], K_LO) for g in range(GROUP)])
    if not torch.equal(wide, singles):
        raise AssertionError(f"{spec.name}: the grouped chain disagrees with the single chain")
    out = {"field": spec.name, "L": L, "G": GROUP, "variants_agree": True}
    for variant in ("seq", "wide"):
        out[variant] = _slope(
            lambda K: pf.mont_mul_chain_group(spec, a, b, K, variant), GROUP * L)
    return out


def measure_latency(spec: FieldSpec, device) -> dict:
    """One warp of single chains, K = 8 and K = 256, both formulations:
    microseconds per dependent product from the slope."""
    a = random_rows(spec, (spec.nlimbs, L_LATENCY), 4, device)
    b = random_rows(spec, (spec.nlimbs, L_LATENCY), 5, device)
    out = {"field": spec.name, "L": L_LATENCY, "K": K_LATENCY}
    for name, flag in (("inline", True), ("call", False)):
        call = lambda K: pf.mont_mul_chain(spec, a, b, K, inline_body=flag)
        lo, hi = _time_ms(lambda: call(K_LO)), _time_ms(lambda: call(K_LATENCY))
        out[name] = {"k8_ms": lo, "k256_ms": hi,
                     "us_per_product": (hi - lo) / (K_LATENCY - K_LO) * 1e3}
    return out


def edge_operands(spec: FieldSpec, L: int, seed: int, device):
    """(a, b) limb rows for one product: b canonical, a any value below R.
    Their first columns are the edges: 0, 1, p - 1 against 0, 1, p - 1,
    R mod p, R^2 mod p; a = p, p + 1, R - 1 and values in [p, R) against
    canonical b, as `_fold_wide`'s low and high words meet R mod p and
    R^2 mod p."""
    p, n = spec.modulus, spec.nlimbs
    R = 1 << (16 * n)
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 16, size=(n, L), dtype=np.int64)  # below R
    b = random_rows(spec, (n, L), seed + 1, "cpu").numpy().astype(np.int64)
    cols = [(x, y) for x in (0, 1, p - 1) for y in (0, 1, p - 1, spec.r_mod_p, spec.r2_mod_p)]
    cols += [(x, y) for x in (p, p + 1, R - 1, R - p, p + (R - p) // 3)
             for y in (1, p - 1, spec.r_mod_p, spec.r2_mod_p)]
    a[:, :len(cols)] = np.asarray(spec.to_limbs([x for x, _ in cols])).T
    b[:, :len(cols)] = np.asarray(spec.to_limbs([y for _, y in cols])).T
    return (torch.as_tensor(a.astype(np.int32), device=device),
            torch.as_tensor(b.astype(np.int32), device=device))


def check_edges(spec: FieldSpec, L: int, device) -> dict:
    """One product, inlined and called, against the plain product on
    edge_operands: the largest limb difference of each (both must be 0)."""
    a, b = edge_operands(spec, L, 60, device)
    want = pf.mont_mul_chain_plain(spec, a, b, 1).to(torch.int64)
    errs = {name: int((pf.mont_mul_chain(spec, a, b, 1, inline_body=flag).to(torch.int64)
                       - want).abs().max())
            for name, flag in (("inline", True), ("call", False))}
    if any(errs.values()):
        raise AssertionError(f"{spec.name}: the product differs from the plain product on edge "
                             f"operands: {errs}")
    return errs


def run_latency(device=torch.device("cuda"), say=print) -> dict:
    """The latency mode alone: Fq then Fr."""
    if torch.device(device).type != "cuda":
        raise RuntimeError("the harness times kernels: it needs a CUDA device")
    results = {}
    for spec in (FQ, FR):
        r = results[spec.name] = measure_latency(spec, device)
        for name in ("inline", "call"):
            m = r[name]
            say(f"latency {spec.name} ({spec.nlimbs}, {L_LATENCY}), {name:6s}: K8 {m['k8_ms']:.4f} ms "
                f"K{K_LATENCY} {m['k256_ms']:.4f} ms -> {m['us_per_product']:.4f} us per dependent product")
    return results


def run(device=torch.device("cuda"), sizes=(L_REFERENCE, L_CARD), say=print) -> dict:
    """The whole harness; returns every figure it printed."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("the harness times kernels: it needs a CUDA device")
    results = {"single": [], "group": []}
    for spec in (FQ, FR):
        for L in sizes:
            r = measure_single(spec, L, device)
            results["single"].append(r)
            say(f"{spec.name} ({spec.nlimbs}, {L}): inline == call: {r['formulations_agree']}")
            for name in ("inline", "call"):
                m = r[name]
                say(f"  {name:6s}: K8 {m['k8_ms']:.4f} ms K64 {m['k64_ms']:.4f} ms -> "
                    f"{m['us_per_step']:8.3f} us/mul per launch, "
                    f"{m['chain_steps_per_s']:.4g} products/s")
        for L in sizes:
            Lg = L_REFERENCE_GROUP if L == L_REFERENCE else L // GROUP
            r = measure_group(spec, Lg, device)
            results["group"].append(r)
            say(f"{spec.name} ({GROUP}, {spec.nlimbs}, {Lg}): wide == seq: {r['variants_agree']}")
            for name in ("seq", "wide"):
                m = r[name]
                say(f"  {name:6s}: K8 {m['k8_ms']:.4f} ms K64 {m['k64_ms']:.4f} ms -> "
                    f"{m['us_per_step']:8.3f} us per {GROUP}-mul group per launch, "
                    f"{m['chain_steps_per_s']:.4g} products/s")
    # the card's rate: the best slope of each field at the largest size
    peak = {}
    for spec in (FQ, FR):
        rates = [r[k]["chain_steps_per_s"] for r in results["single"]
                 if r["field"] == spec.name and r["L"] == max(sizes) for k in ("inline", "call")]
        rates += [r[k]["chain_steps_per_s"] for r in results["group"]
                  if r["field"] == spec.name and r["L"] == max(sizes) // GROUP
                  for k in ("seq", "wide")]
        best = max(rates)
        peak[spec.name] = {"products_per_s": best,
                           "madds_per_s": best * madds_per_product(spec)}
        say(f"measured {spec.name}: {best:.4g} products/s = "
            f"{best * madds_per_product(spec):.4g} 32-bit multiply-adds/s "
            f"(derived peak {DERIVED_INT32_MADD_PER_S:.4g})")
    results["peak"] = peak
    results["derived_madds_per_s"] = DERIVED_INT32_MADD_PER_S
    results["latency"] = run_latency(device, say)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true", help="print the figures as one JSON line too")
    ap.add_argument("--latency", action="store_true",
                    help="the latency mode alone: one warp, K = 256 dependent products")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_montmul: no CUDA device; the harness times kernels on the GPU",
              file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0))
    results = run_latency() if args.latency else run()
    if args.json:
        print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
