"""Proof that the PyTorch/CUDA port starts and is right on the GPU.

Run `python3 chip_smoke.py` from the repository root on a machine with one
NVIDIA H100 (or newer sm_90a part).  It builds the CUDA kernels from
testudo_tpu_torch/csrc/, then

  1. prints the card's name and power limit and the build time;
  2. drives the port's main paths over BLS12-377, `msm_g1(points, scalars,
     affine=True)` and `msm_g2(points, scalars, affine=True)`, each at
     N = 2^16 and N = 2^20 points, and checks every result exactly against
     the host (the points' discrete logs are known), timing cold and warm
     calls and the phases of one call, and counting the kernel launches of
     one warm call at the largest size; `msm_g2(affine=False)` at 2^16 on
     projective bases with identity rows among them, exact;
  3. drives the rest of the group layer: `fixed_base_mul_g1/g2` on 2^16
     scalars (256 `add_mask` launches each), `scalar_mul_batch_g2`,
     `msm_segmented` and `msm_multi_small` for both groups, each against the
     host, and the field path (`curve.g1_add` / `curve.g2_add` through the
     Montgomery kernel) against the fused add kernels;
  4. calls every kernel's wrapper at the shapes the main paths gave it and
     holds the result against the kernel's plain PyTorch version on the
     same inputs (integers: the tolerance is exact equality, max_abs_err
     must be 0), at a lane count that is no multiple of the block size and
     with edge cases mixed in, and times both;
  5. checks a small MSM against the host oracle;
  6. prints one JSON line {"kernels": [...]} and, last,
     {"ok": true, "device": {...}}.

Any failure raises and the process exits non-zero.  It imports neither jax
nor the JAX package.  `--kernels-only` stops after a short build-and-compare
pass at small shapes (a first call after editing a kernel); the default run
is the full check.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from testudo_tpu_torch.curves import host_curve as hc
from testudo_tpu_torch.device import build, msm
from testudo_tpu_torch.device import curve as tc
from testudo_tpu_torch.device import packed_field
from testudo_tpu_torch.device.field import FQ, FR
from testudo_tpu_torch.device.packed_curve import G1P, G2P
from testudo_tpu_torch.fields.bls12_377 import R

# Least-time model.  Bytes: every input read once, every output written
# once, over the H100's 3.35 TB/s.  Operations: the 32-bit multiply-adds of
# the Montgomery products (2 N^2 + N per product of N-word operands; the
# carry additions around them are left out, so the bound is a lower one),
# over the card's int32 rate.  NVIDIA's data sheet gives 67 TFLOP/s float32
# outside the tensor cores, i.e. 33.5e12 fused multiply-adds a second on
# 128 float32 lanes per SM; an SM has 64 int32 lanes, so the int32
# multiply-add peak is taken as half of that.
HBM_BYTES_PER_S = 3.35e12
INT32_MADD_PER_S = 67e12 / 2 / 2
MADD_FQ = 2 * 12 * 12 + 12
MADD_FR = 2 * 8 * 8 + 8

# TPU kernel each port kernel replaces (both groups come from the same
# `_ec_call` factory, at ncomp 1 and 2) and its CUDA source.
_EC = "testudo_tpu/tpu/pallas_curve.py"
_REPLACES = {
    "mont_mul": "testudo_tpu/tpu/pallas_field.py:226",
    "add_mask": _EC + ":403", "add2": _EC + ":415", "step": _EC + ":424",
    "scan2": _EC + ":437", "scan2b": _EC + ":450", "bucket": _EC + ":461",
    "bucket_mixed": _EC + ":509", "ladder": _EC + ":733",
}
_CSRC = "testudo_tpu_torch/csrc/"
_SOURCE = {
    "mont_mul": "mont_mul.cu", "add_mask": "ec_ops.cu", "add2": "ec_ops.cu",
    "step": "ec_ops.cu", "scan2": "ec_ops.cu", "scan2b": "ec_ops.cu",
    "ladder": "ladder.cu", "bucket": "bucket.cu", "bucket_mixed": "bucket.cu",
}
N_UNIQUE = 1 << 13
ODD = 37  # extra lanes so no compared batch is a multiple of a block size

# One entry per group: the packed group, the host oracle and the Fq products
# of a complete add / mixed add / double (G2: three per Fq2 product by
# Karatsuba, plus the b3 products: 12*3+2, 11*3+2, 8*3+1).
GROUPS = {
    "g1": SimpleNamespace(
        name="g1", Gp=G1P, gen=hc.g1_generator, mul=hc.g1_mul, on_curve=hc.g1_is_on_curve,
        host_msm=hc.g1_msm, from_affine=tc.g1_from_affine_host, to_affine=tc.g1_to_affine_host,
        neg=tc.g1_neg, add=tc.g1_add, msm=msm.msm_g1, fixed=tc.fixed_base_mul_g1,
        scalar_mul_batch=tc.scalar_mul_batch_g1, muls=(12, 11, 8)),
    "g2": SimpleNamespace(
        name="g2", Gp=G2P, gen=hc.g2_generator, mul=hc.g2_mul, on_curve=hc.g2_is_on_curve,
        host_msm=hc.g2_msm, from_affine=tc.g2_from_affine_host, to_affine=tc.g2_to_affine_host,
        neg=tc.g2_neg, add=tc.g2_add, msm=msm.msm_g2, fixed=tc.fixed_base_mul_g2,
        scalar_mul_batch=tc.scalar_mul_batch_g2, muls=(38, 35, 25)),
}


def say(*a):
    print(*a, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of `reps` calls, CUDA events around all of them,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def timed_once(fn):
    """(result, milliseconds) of one call, synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def max_abs_err(got, want) -> int:
    """Largest limb difference over one or several (got, want) tensors."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    worst = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        worst = max(worst, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return worst


def bound(nbytes: float, madds: float):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = madds / INT32_MADD_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def counter(grp, kernel: str) -> str:
    """Name of a kernel's row and launch counter: bare for G1, `_g2` for G2."""
    return grp.Gp._counter(kernel)


class Report:
    """Collects one row per kernel for the `kernels` line."""

    def __init__(self):
        self.rows = {}
        self.max_nseg = {}  # per group: longest run the segment reduce was given

    def add(self, name, got, want, ms, plain_ms, nbytes, madds, shape):
        err = max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"kernel {name} differs from its plain version: {err}")
        b_ms, b_by = bound(nbytes, madds)
        kernel = name[:-3] if name.endswith("_g2") else name
        self.rows[name] = {
            "name": name, "route": "cuda", "source": _CSRC + _SOURCE[kernel],
            "replaces": _REPLACES[kernel], "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "shape": shape,
        }
        say(f"kernel {name}: equal to plain version at {shape}; "
            f"ms={ms:.4f} plain_ms={plain_ms:.2f} bound_ms={b_ms:.5f} ({b_by})")


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def ladder_multiples(dev, grp):
    """2^13 multiples k_i * G through the ladder kernel: projective packed
    points (rows, 2^13) and the k_i as Python ints (bench.py:32-54)."""
    rng = np.random.default_rng(5)
    scal = rng.integers(0, 1 << 16, size=(N_UNIQUE, FR.nlimbs), dtype=np.int64)
    scal[:, -1] &= 0x0FFF
    ks = FR.from_limbs(scal)
    g = grp.Gp.pack(grp.from_affine([grp.gen()] * N_UNIQUE, device=dev))
    proj = grp.Gp.ladder(g, torch.as_tensor(scal.T.astype(np.int32).copy(), device=dev))
    return proj, ks


def make_points(dev, grp, t_start):
    """(projective packed multiples, their affine lifts, the discrete logs),
    three of them checked against the host."""
    proj, ks = ladder_multiples(dev, grp)
    torch.cuda.synchronize()
    aff_host = grp.to_affine(grp.Gp.unpack(proj))
    for i in (0, 1, N_UNIQUE - 1):
        if aff_host[i] != grp.mul(grp.gen(), ks[i]):
            raise AssertionError(f"ladder kernel ({grp.name}): k * G differs from the host")
    affine_pts = grp.from_affine(aff_host, device=dev)
    say(f"points: 2^13 ladder multiples of the {grp.name} generator, checked against the "
        f"host ({time.time() - t_start:.1f} s)")
    return proj, affine_pts, ks


def random_scalars(N: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    scal = rng.integers(0, 1 << 16, size=(N, FR.nlimbs), dtype=np.int64)
    scal[:, -1] &= 0x0FFF  # 252-bit scalars, all below r
    return scal.astype(np.int32)


def dlog_of_msm(scal: np.ndarray, ks) -> int:
    """sum_j s_j * k_(j mod len(ks)) mod r for limb scalars (N, 16)."""
    reps = scal.shape[0] // len(ks)
    limb_sums = scal.astype(np.int64).reshape(reps, len(ks), FR.nlimbs).sum(axis=0)
    total = 0
    for row, k in zip(limb_sums, ks):
        s = sum(int(v) << (16 * i) for i, v in enumerate(row))
        total = (total + s * k) % R
    return total


def expected_msm(grp, scal: np.ndarray, ks) -> tuple:
    return grp.mul(grp.gen(), dlog_of_msm(scal, ks))


def tile(points, reps: int):
    return msm._map_coords(lambda c: c.repeat(reps, 1), points)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(smi)
    t0 = time.time()
    build.library()
    rep = build.build_report()
    say(f"kernel build: {time.time() - t0:.1f} s (nvcc {rep['seconds']:.1f} s)")
    for line in rep["ptxas"]:
        say("  " + line)
    return smi


def phase_small_guard(dev, grp):
    import random

    prng = random.Random(3)
    G = grp.gen()
    pts = [grp.mul(G, prng.randrange(1, R)) for _ in range(32)]
    scl = [prng.randrange(R) for _ in range(32)]
    got = grp.msm(grp.from_affine(pts, device=dev), scl, affine=True, device=dev)
    if got != grp.host_msm(pts, scl):
        raise AssertionError(f"small msm_{grp.name} disagrees with the host oracle")
    say(f"small guard: msm_{grp.name} on 32 points equals the host MSM")


def phase_main(dev, grp, affine_pts, ks, log2n: int, count_launches: bool):
    """msm(affine=True) at N = 2^log2n: exact check, cold and warm timing,
    phase split, and (optionally) launch counts of one warm call."""
    N = 1 << log2n
    what = f"msm_{grp.name}"
    pts = tile(affine_pts, N // N_UNIQUE)
    scal_np = random_scalars(N, 7)
    scal = torch.as_tensor(scal_np, device=dev)
    want = expected_msm(grp, scal_np, ks)

    def call(hook=None):
        out = grp.msm(pts, scal, affine=True, device=dev, on_phase=hook)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    got = call()
    cold = time.perf_counter() - t0
    if got != want or got is None or not grp.on_curve(got):
        raise AssertionError(f"{what} at 2^{log2n} disagrees with the host value")
    walls, devs = [], []
    counts = None
    for i in range(3):
        if count_launches and i == 2:
            build.reset_launches()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        got = call()
        e1.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        devs.append(e0.elapsed_time(e1) / 1e3)
        if count_launches and i == 2:
            counts = dict(build.LAUNCHES)
        if got != want:
            raise AssertionError(f"warm {what} at 2^{log2n} changed its answer")
    wall = statistics.median(walls)
    say(f"{what} N=2^{log2n}: exact; cold {cold:.3f} s, warm {[round(w, 4) for w in walls]} s "
        f"(CUDA events {[round(d, 4) for d in devs]} s), median {wall:.4f} s, "
        f"{N / wall:.0f} points/s")

    # phase split of one more call: synchronise at every stage boundary
    marks = []

    def hook(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call(hook)
    prev = t0
    split = {}
    for name, t in marks:
        split[name.split()[0]] = round((t - prev) * 1e3, 3)
        if name.startswith("plan_host"):
            say(f"  plan: {name}")
        prev = t
    say(f"  phase split (ms, synchronised): {json.dumps(split)}")
    return pts, scal, counts


def phase_projective_msm(dev, grp, proj, ks):
    """msm(affine=False) at 2^16 on the raw ladder outputs (Z != 1) with a
    few identity rows among the bases: general adds in the bucket phase."""
    N = 1 << 16
    packed = proj.repeat(1, N // N_UNIQUE)
    holes = [3, 4097, N - 1]  # rows that hold the identity
    for i in holes:
        packed[:, i] = grp.Gp.identity_packed(1, device=dev)[:, 0]
    pts = grp.Gp.unpack(packed.contiguous())
    scal_np = random_scalars(N, 11)
    total = dlog_of_msm(scal_np, ks)
    for i in holes:  # an identity base contributes nothing
        s = sum(int(v) << (16 * j) for j, v in enumerate(scal_np[i]))
        total = (total - s * ks[i % N_UNIQUE]) % R
    got = grp.msm(pts, torch.as_tensor(scal_np, device=dev), affine=False, device=dev)
    torch.cuda.synchronize()
    if got != grp.mul(grp.gen(), total) or not grp.on_curve(got):
        raise AssertionError(f"msm_{grp.name}(affine=False) at 2^16 disagrees with the host value")
    say(f"msm_{grp.name}(affine=False) N=2^16, projective bases, {len(holes)} identity rows: exact")


def msm_plan(grp, pts, scal):
    """The arguments a main path hands the bucket kernels at this size: the
    first half of msm._msm_packed, stage by stage."""
    c = msm._SIGNED_C
    ptcat = msm._cat_points(pts)
    N = ptcat.shape[0]
    order, sgn, starts, counts = msm._digit_counts_signed(scal, c)
    table = msm._with_neg_y_table(ptcat, grp.Gp.ncomp)
    order_flat = (order + sgn * N).reshape(-1).contiguous()
    starts_np, counts_np = starts.cpu().numpy(), counts.cpu().numpy()
    W, B = counts_np.shape
    T_cap = msm._pick_t_cap(counts_np, W, B)
    wnd, seg_start, seg_count, lane_off, nseg, L = msm._plan_segments(starts_np, counts_np, T_cap)
    start = (wnd.astype(np.int64) * N + seg_start).astype(np.int32)
    return table, order_flat, start, seg_count, lane_off, nseg


def phase_field_path(dev, grp, proj):
    """curve.g1_add / g2_add on 2^16 lanes goes through field.mont_mul -> the
    Montgomery kernel; it must equal the fused add kernel limb for limb."""
    L = 1 << 16
    a = proj.repeat(1, L // N_UNIQUE)
    b = torch.roll(a, 1, dims=1).contiguous()
    build.reset_launches()
    got = grp.add(grp.Gp.unpack(a), grp.Gp.unpack(b))
    torch.cuda.synchronize()
    launches = build.LAUNCHES["mont_mul"]
    if launches == 0:
        raise AssertionError(f"curve.{grp.name}_add did not launch the Montgomery kernel")
    if not torch.equal(grp.Gp.pack(got), grp.Gp.add2(a, b)):
        raise AssertionError(f"curve.{grp.name}_add differs from the fused add kernel")
    say(f"field path: curve.{grp.name}_add on 2^16 lanes ({launches} Montgomery launches) "
        f"equals the add2 kernel")
    return launches


def phase_fixed_base(dev, grp):
    """fixed_base_mul on 2^16 scalars (0, 1, r-1 among them): spot lanes
    against the host; one add_mask launch per scalar bit."""
    N = 1 << 16
    scal_np = random_scalars(N, 13)
    edge = [0, 1, R - 1]
    scal_np[: len(edge)] = FR.to_limbs(edge)
    base = grp.mul(grp.gen(), 0xC0FFEE)
    name = counter(grp, "add_mask")
    build.reset_launches()
    t0 = time.perf_counter()
    out = grp.fixed(torch.as_tensor(scal_np, device=dev), base, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = build.LAUNCHES[name]
    if launches != 16 * FR.nlimbs:
        raise AssertionError(f"fixed_base_mul_{grp.name}: {launches} add_mask launches, expected 256")
    lanes = [0, 1, 2, 3, 777, N - 1]
    spot = msm._map_coords(lambda c: c[lanes], out)
    want = [grp.mul(base, k) for k in FR.from_limbs(scal_np[lanes])]
    if grp.to_affine(spot) != want or want[0] is not None:
        raise AssertionError(f"fixed_base_mul_{grp.name} disagrees with the host")
    say(f"fixed_base_mul_{grp.name} on 2^16 scalars: {launches} {name} launches, {secs:.3f} s, "
        f"{len(lanes)} lanes equal the host")
    return launches


def phase_small_msms(dev, grp, affine_pts, ks):
    """scalar_mul_batch, msm_segmented (2 x 2^10 lanes: a MIPP fold) and
    msm_multi_small (parts of 2^9 ... 1: a PST opening) against the host,
    through the bases' discrete logs."""
    G = grp.gen()
    take = lambda lo, hi: msm._map_coords(lambda c: c[lo:hi].contiguous(), affine_pts)

    k = 0x1D0C0FFEE1234567890ABCDEF % R
    got = grp.to_affine(grp.scalar_mul_batch(take(0, 64), torch.as_tensor(FR.to_limbs(k), device=dev)))
    if got[:3] + got[-1:] != [grp.mul(G, ks[i] * k % R) for i in (0, 1, 2, 63)]:
        raise AssertionError(f"scalar_mul_batch_{grp.name} disagrees with the host")

    n = 2 << 10
    scal_np = random_scalars(n, 17)
    build.reset_launches()
    got = msm.msm_segmented(grp.name, take(0, n), torch.as_tensor(scal_np, device=dev), 2, device=dev)
    want = [grp.mul(G, dlog_of_msm(scal_np[s * 1024:(s + 1) * 1024], ks[s * 1024:(s + 1) * 1024]))
            for s in range(2)]
    if got != want or build.LAUNCHES[counter(grp, "ladder")] != 1:
        raise AssertionError(f"msm_segmented({grp.name}) disagrees with the host")

    sizes = [1 << e for e in range(9, -1, -1)]  # 512 ... 1
    parts, want, off = [], [], 0
    for i, sz in enumerate(sizes):
        s_np = random_scalars(sz, 100 + i)
        parts.append((take(off, off + sz), torch.as_tensor(s_np, device=dev)))
        want.append(grp.mul(G, dlog_of_msm(s_np, ks[off:off + sz])))
        off += sz
    build.reset_launches()
    got = msm.msm_multi_small(grp.name, parts, device=dev)
    if got != want or build.LAUNCHES[counter(grp, "ladder")] != 1:
        raise AssertionError(f"msm_multi_small({grp.name}) disagrees with the host")
    say(f"{grp.name}: scalar_mul_batch (64 lanes), msm_segmented (2 x 2^10, one ladder launch) "
        f"and msm_multi_small ({len(sizes)} parts of 512..1, one ladder launch) equal the host")


def edge_points(dev, grp, proj, L: int):
    """Two (rows, L) projective batches whose first lanes hold P+P, P+(-P),
    P+O, O+P and O+O."""
    Gp = grp.Gp
    reps = -(-L // N_UNIQUE)
    a = proj.repeat(1, reps)[:, :L].clone()
    b = torch.roll(proj, 7, dims=1).repeat(1, reps)[:, :L].clone()
    ident = Gp.identity_packed(1, device=dev)[:, 0]
    b[:, 0] = a[:, 0]
    b[:, 1] = Gp.pack(grp.neg(Gp.unpack(a[:, 1:2].contiguous())))[:, 0]
    b[:, 2] = ident
    a[:, 3] = ident
    a[:, 4] = ident
    b[:, 4] = ident
    return a.contiguous(), b.contiguous()


def kernels_montgomery(dev, rep: Report, quick: bool):
    """K1 Montgomery product: the field path's stacked shape (6 products of
    2^16 lanes) for Fq, 2^16 lanes for Fr, edge values mixed in."""
    for spec, m_main, madd in ((FQ, 6 << 16, MADD_FQ), (FR, 1 << 16, MADD_FR)):
        p = spec.modulus
        m = (1 << 12 if quick else m_main) + ODD
        rng = np.random.default_rng(21)
        vals = rng.integers(0, 1 << 16, size=(2, m, spec.nlimbs), dtype=np.int64)
        vals[:, :, -1] &= 0x00FF if spec is FQ else 0x0FFF  # below p
        edges = np.asarray(spec.to_limbs([0, 1, p - 1, spec.r_mod_p, p - 1]))
        vals[0, :5] = edges
        vals[1, :5] = edges[::-1]
        at, bt = (torch.as_tensor(v.T.astype(np.int32).copy(), device=dev) for v in vals)
        got = packed_field.mont_mul_rows(spec, at, bt)
        want = packed_field.mont_mul_rows_plain(spec, at, bt)
        a0, b0 = at[:, : m - ODD].contiguous(), bt[:, : m - ODD].contiguous()
        ms = time_ms(lambda: packed_field.mont_mul_rows(spec, a0, b0), 20)
        plain = time_ms(lambda: packed_field.mont_mul_rows_plain(spec, a0, b0), 1)
        lanes = m - ODD
        if spec is FQ:
            rep.add("mont_mul", got, want, ms, plain, 3 * spec.nlimbs * 4 * lanes,
                    madd * lanes, f"(24, {lanes}) Fq")
        else:
            if max_abs_err(got, want) != 0:
                raise AssertionError("Montgomery kernel (Fr) differs from its plain version")
            b_ms, b_by = bound(3 * spec.nlimbs * 4 * lanes, madd * lanes)
            say(f"kernel mont_mul (Fr, (16, {lanes})): equal to plain version; "
                f"ms={ms:.4f} plain_ms={plain:.2f} bound_ms={b_ms:.5f} ({b_by})")


def kernels_group(dev, grp, rep: Report, proj, pts_cmp, scal_cmp, pts_time, scal_time,
                  quick: bool):
    """Every EC kernel of one group against its plain version.  The bucket
    kernels are compared at the plan of (pts_cmp, scal_cmp) and timed at the
    plan of (pts_time, scal_time); the two may be the same batch."""
    Gp = grp.Gp
    rows = Gp.rows
    pt_bytes = rows * 4
    m_add, m_mixed, m_double = (m * MADD_FQ for m in grp.muls)
    nm = lambda kernel: counter(grp, kernel)

    # the weighted sum's lane count: W * (2^12 / 32) lanes
    lanes = 20 * 128
    L = (256 if quick else lanes) + ODD
    a, b = edge_points(dev, grp, proj, L)
    c3 = torch.roll(b, 3, dims=1).contiguous()
    cut = lambda t: t[..., : L - ODD].contiguous()
    a0, b0, c0 = cut(a), cut(b), cut(c3)
    n0 = L - ODD
    shape = f"({rows}, {n0})"

    got, want = Gp.add2(a, b), Gp.add2_plain(a, b)
    rep.add(nm("add2"), got, want, time_ms(lambda: Gp.add2(a0, b0), 20),
            time_ms(lambda: Gp.add2_plain(a0, b0), 1),
            3 * pt_bytes * n0, m_add * n0, shape)

    mask = torch.as_tensor(np.random.default_rng(22).integers(0, 2, size=L).astype(np.int32), device=dev)
    mask[:5] = 1
    m0 = cut(mask)
    live = int(m0.sum())
    got, want = Gp.step(a, b, mask), Gp.step_plain(a, b, mask)
    rep.add(nm("step"), got, want, time_ms(lambda: Gp.step(a0, b0, m0), 20),
            time_ms(lambda: Gp.step_plain(a0, b0, m0), 1),
            (4 * pt_bytes + 4) * n0, m_add * live + m_double * n0,
            f"{shape}, {live} lanes masked in")

    got, want = Gp.scan2b(a, c3, b), Gp.scan2b_plain(a, c3, b)
    rep.add(nm("scan2b"), got, want, time_ms(lambda: Gp.scan2b(a0, c0, b0), 20),
            time_ms(lambda: Gp.scan2b_plain(a0, c0, b0), 1),
            5 * pt_bytes * n0, 2 * m_add * n0, shape)

    # no package code calls scan2: it is launched here only
    got, want = Gp.scan2(a, c3, b), Gp.scan2_plain(a, c3, b)
    rep.add(nm("scan2"), got, want, time_ms(lambda: Gp.scan2(a0, c0, b0), 20),
            time_ms(lambda: Gp.scan2_plain(a0, c0, b0), 1),
            5 * pt_bytes * n0, 2 * m_add * n0, shape + ", on no path")

    # add_mask at fixed_base_mul's shape: 2^16 accumulators, one shared
    # table column, a random bit per lane; and with a full point batch
    La = (256 if quick else 1 << 16) + ODD
    acc, full = edge_points(dev, grp, proj, La)
    col = proj[:, 11:12].contiguous()
    bits = torch.as_tensor(np.random.default_rng(24).integers(0, 2, size=La).astype(np.int32), device=dev)
    bits[:5] = 1
    got = (Gp.add_mask(acc, col, bits), Gp.add_mask(acc, full, bits))
    want = (Gp.add_mask_plain(acc, col, bits), Gp.add_mask_plain(acc, full, bits))
    na = La - ODD
    acc0, bits0 = acc[:, :na].contiguous(), bits[:na].contiguous()
    rep.add(nm("add_mask"), got, want, time_ms(lambda: Gp.add_mask(acc0, col, bits0), 20),
            time_ms(lambda: Gp.add_mask_plain(acc0, col, bits0), 1),
            (2 * pt_bytes + 4) * na + pt_bytes, m_add * int(bits0.sum()),
            f"({rows}, {na}) + one shared column, {int(bits0.sum())} lanes masked in")

    # the ladder at the Horner combine's shape and data: 20 window sums times
    # 2^(13 w); behind them lanes with scalars 0, 1, r-1, 2 and random ones
    Lh = 20 + ODD
    pts_h, _ = edge_points(dev, grp, proj, Lh)
    ks = [1 << (msm._SIGNED_C * w) for w in range(20)] + [0, 1, R - 1, 2]
    ks += [int(v) for v in FR.from_limbs(random_scalars(Lh - len(ks), 23))]
    scal_h = torch.as_tensor(FR.to_limbs(ks).T.copy(), device=dev)
    if quick:  # the plain ladder walks all 256 bits: two limb rows are enough here
        scal_h = scal_h[:2].contiguous()
    # the plain ladder is a chain of 512 group operations whose time hardly
    # depends on the lane count: it is timed once, on the compared call
    got = Gp.ladder(pts_h, scal_h)
    want, plain = timed_once(lambda: Gp.ladder_plain(pts_h, scal_h))
    scal_full = torch.as_tensor(FR.to_limbs(ks[:20]).T.copy(), device=dev)
    p0 = pts_h[:, :20].contiguous()
    # what these scalars need: an add per set bit, a double per bit below the top one
    need = sum(grp.muls[0] * bin(k).count("1") + grp.muls[2] * k.bit_length() for k in ks[:20])
    rep.add(nm("ladder"), got, want, time_ms(lambda: Gp.ladder(p0, scal_full), 5), plain,
            (2 * pt_bytes + 16 * 4) * 20, need * MADD_FQ,
            f"({rows}, 20) x 256 bits, scalars 2^(13 w); compared at {Lh} lanes, "
            f"plain_ms from there")

    # the bucket kernels with the exact arguments of a main path, plus a tail
    # of hand-made lanes: count 0, a doubling lane, a long lane.  The plain
    # version walks every lane through the longest run, so it is timed once,
    # on the compared call.
    table, order_flat, start, count, lane_off, nseg = msm_plan(grp, pts_cmp, scal_cmp)
    extra_idx = torch.as_tensor([5, 5, 9, 11, 13, 17, 19, 23, 29], dtype=torch.int32, device=dev)
    idx = torch.cat([order_flat, extra_idx])
    base = order_flat.shape[0]
    st = np.concatenate([start, [base, base, base + 2]]).astype(np.int32)
    ct = np.concatenate([count, [2, 0, 7]]).astype(np.int32)
    if quick:
        st, ct = st[-(256 + 3):], ct[-(256 + 3):]
    st_t, ct_t = torch.as_tensor(st, device=dev), torch.as_tensor(ct, device=dev)
    got = Gp.bucket_phase(table, idx, st_t, ct_t, mixed=True)
    want, plain = timed_once(lambda: Gp.bucket_phase_plain(table, idx, st_t, ct_t, mixed=True))
    if max_abs_err(got, want) != 0:
        raise AssertionError(f"kernel {nm('bucket_mixed')} differs from its plain version")
    seg_cmp = Gp.bucket_phase(table, order_flat, st_t[:-3].contiguous(), ct_t[:-3].contiguous(), mixed=True)
    if quick:
        lane_off = np.arange(0, seg_cmp.shape[1] - 8, 4, dtype=np.int32)
        nseg = (np.arange(len(lane_off)) % 5).astype(np.int32)
    tab2 = seg_cmp.T.contiguous()
    lo_t, ns_t = torch.as_tensor(lane_off, device=dev), torch.as_tensor(nseg, device=dev)
    got2 = Gp.bucket_phase(tab2, None, lo_t, ns_t)
    want2, plain2 = timed_once(lambda: Gp.bucket_phase_plain(tab2, None, lo_t, ns_t))
    cmp_note = f"compared at table ({table.shape[0]}, {rows}), {len(st)} lanes, plain_ms from there"

    # timing (and the bound) at the plan of the largest size
    if pts_time is not pts_cmp:
        del table, order_flat, idx, tab2, seg_cmp
        table, order_flat, start, count, lane_off, nseg = msm_plan(grp, pts_time, scal_time)
        st_t, ct_t = torch.as_tensor(start, device=dev), torch.as_tensor(count, device=dev)
        s0, c0 = st_t, ct_t
    else:
        s0, c0 = st_t[:-3].contiguous(), ct_t[:-3].contiguous()
    adds = int(c0.sum())
    lanes6 = s0.shape[0]
    ms = time_ms(lambda: Gp.bucket_phase(table, order_flat, s0, c0, mixed=True), 3)
    comp_bytes = 24 * 4 * Gp.ncomp  # one coordinate of one point
    rep.add(nm("bucket_mixed"), got, want, ms, plain,
            adds * (2 * comp_bytes + 4) + lanes6 * (8 + pt_bytes), adds * m_mixed,
            f"table ({table.shape[0]}, {rows}), {lanes6} lanes, {adds} adds; {cmp_note}")

    seg_sums = Gp.bucket_phase(table, order_flat, s0, c0, mixed=True)
    if quick:
        lane_off = np.arange(0, lanes6 - 8, 4, dtype=np.int32)
        nseg = (np.arange(len(lane_off)) % 5).astype(np.int32)
    tab2 = seg_sums.T.contiguous()
    lo_t, ns_t = torch.as_tensor(lane_off, device=dev), torch.as_tensor(nseg, device=dev)
    adds = int(nseg.sum())
    rep.add(nm("bucket"), got2, want2,
            time_ms(lambda: Gp.bucket_phase(tab2, None, lo_t, ns_t), 3), plain2,
            adds * pt_bytes + len(nseg) * (8 + pt_bytes), adds * m_add,
            f"table ({tab2.shape[0]}, {rows}), {len(nseg)} lanes, {adds} adds; "
            f"compared at {len(want2[0])} lanes, plain_ms from there")
    rep.max_nseg[grp.name] = int(nseg.max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build, compare every kernel at small shapes, stop")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the GPU", file=sys.stderr)
        return 1
    t_start = time.time()
    dev = torch.device("cuda")
    phase_device()
    g1, g2 = GROUPS["g1"], GROUPS["g2"]
    rep = Report()

    proj, affine, ks = {}, {}, {}
    for grp in (g1, g2):
        proj[grp.name], affine[grp.name], ks[grp.name] = make_points(dev, grp, t_start)

    if args.kernels_only:
        N = 1 << 14
        kernels_montgomery(dev, rep, quick=True)
        for grp in (g1, g2):
            pts = tile(affine[grp.name], N // N_UNIQUE)
            scal = torch.as_tensor(random_scalars(N, 7), device=dev)
            kernels_group(dev, grp, rep, proj[grp.name], pts, scal, pts, scal, quick=True)
        say("kernels-only pass done; run without arguments for the full check")
        return 0

    # main paths: launches of each are counted over one warm call at 2^20,
    # the counters zeroed just before it and read just after
    counts = {name: 0 for name in build.LAUNCHES}
    batches = {}
    sizes = (16, 20)
    for grp in (g1, g2):
        phase_small_guard(dev, grp)
        for log2n in sizes:
            pts, scal, got = phase_main(dev, grp, affine[grp.name], ks[grp.name], log2n,
                                        log2n == sizes[-1])
            batches[grp.name, log2n] = (pts, scal)
        for name, n in got.items():
            counts[name] += n
        say(f"launches in one warm msm_{grp.name} at 2^{sizes[-1]}: "
            f"{json.dumps({k: v for k, v in got.items() if v})}")
    phase_projective_msm(dev, g2, proj["g2"], ks["g2"])

    # the rest of the group layer; add_mask's launches come from here, the
    # Montgomery kernel's from the field path
    for grp in (g1, g2):
        counts[counter(grp, "add_mask")] += phase_fixed_base(dev, grp)
        phase_small_msms(dev, grp, affine[grp.name], ks[grp.name])
        counts["mont_mul"] += phase_field_path(dev, grp, proj[grp.name])

    # every kernel against its plain version.  G1 buckets: compared and timed
    # at the 2^20 plan.  G2 buckets: compared at the 2^16 plan (the plain
    # version would walk 80,000 lanes through 512 G2 adds at 2^20), timed at
    # the 2^20 plan.
    kernels_montgomery(dev, rep, quick=False)
    kernels_group(dev, g1, rep, proj["g1"], *batches["g1", 20], *batches["g1", 20], quick=False)
    kernels_group(dev, g2, rep, proj["g2"], *batches["g2", 16], *batches["g2", 20], quick=False)

    for name, row in rep.rows.items():
        row["launches"] = counts[name]
        if name.startswith("scan2") and not name.startswith("scan2b"):
            continue  # on no path: launched in the kernel phase only
        group = "g2" if name.endswith("_g2") else "g1"
        if name.startswith("bucket") and "mixed" not in name and rep.max_nseg[group] <= 1:
            continue  # one segment per bucket: the segment reduce only copies
        if row["launches"] == 0:
            raise AssertionError(f"no path launched kernel {name}")
    missing = set(build.LAUNCHES) - set(rep.rows)
    if missing:
        raise AssertionError(f"kernels without a row: {sorted(missing)}")
    say(f"total {time.time() - t_start:.1f} s")
    say(json.dumps({"kernels": list(rep.rows.values())}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
