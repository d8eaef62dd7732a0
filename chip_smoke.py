"""Proof that the PyTorch/CUDA port starts and is right on the GPU.

Run `python3 chip_smoke.py` from the repository root on a machine with one
NVIDIA H100 (or newer sm_90a part).  It builds the CUDA kernels from
testudo_tpu_torch/csrc/, then

  1. prints the card's name and power limit and the build time;
  2. drives the port's main path, `msm_g1(points, scalars, affine=True)`
     over BLS12-377 G1, at N = 2^16 and N = 2^20 points and checks both
     results exactly against the host (the points' discrete logs are
     known), timing cold and warm calls and the phases of one call, and
     counting the kernel launches of one warm call at the largest size;
  3. drives the field path (`curve.g1_add` through the Montgomery kernel)
     and holds it against the fused add kernel;
  4. calls every kernel's wrapper at the shapes the main path gave it and
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

import numpy as np
import torch

from testudo_tpu_torch.curves import host_curve as hc
from testudo_tpu_torch.device import build, msm
from testudo_tpu_torch.device import curve as tc
from testudo_tpu_torch.device import packed_field
from testudo_tpu_torch.device.field import FQ, FR
from testudo_tpu_torch.device.packed_curve import G1P
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
MULS_ADD, MULS_MIXED, MULS_DOUBLE = 12, 11, 8

REPLACES = {
    "mont_mul": "testudo_tpu/tpu/pallas_field.py:226",
    "add2": "testudo_tpu/tpu/pallas_curve.py:415",
    "step": "testudo_tpu/tpu/pallas_curve.py:424",
    "ladder": "testudo_tpu/tpu/pallas_curve.py:733",
    "scan2b": "testudo_tpu/tpu/pallas_curve.py:450",
    "bucket": "testudo_tpu/tpu/pallas_curve.py:461",
    "bucket_mixed": "testudo_tpu/tpu/pallas_curve.py:509",
}
SOURCE = {
    "mont_mul": "testudo_tpu_torch/csrc/mont_mul.cu",
    "add2": "testudo_tpu_torch/csrc/ec_ops.cu",
    "step": "testudo_tpu_torch/csrc/ec_ops.cu",
    "scan2b": "testudo_tpu_torch/csrc/ec_ops.cu",
    "ladder": "testudo_tpu_torch/csrc/ladder.cu",
    "bucket": "testudo_tpu_torch/csrc/bucket.cu",
    "bucket_mixed": "testudo_tpu_torch/csrc/bucket.cu",
}
N_UNIQUE = 1 << 13
ODD = 37  # extra lanes so no compared batch is a multiple of a block size


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


class Report:
    """Collects one row per kernel for the `kernels` line."""

    def __init__(self):
        self.rows = {}
        self.max_nseg = 0  # longest segment run the segment reduce was given

    def add(self, name, got, want, ms, plain_ms, nbytes, madds, shape):
        err = max_abs_err(got, want)
        if err != 0:
            raise AssertionError(f"kernel {name} differs from its plain version: {err}")
        b_ms, b_by = bound(nbytes, madds)
        self.rows[name] = {
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "shape": shape,
        }
        say(f"kernel {name}: equal to plain version at {shape}; "
            f"ms={ms:.4f} plain_ms={plain_ms:.2f} bound_ms={b_ms:.5f} ({b_by})")


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def ladder_multiples(dev):
    """2^13 multiples k_i * G through the ladder kernel: projective packed
    points (72, 2^13) and the k_i as Python ints (bench.py:32-54)."""
    rng = np.random.default_rng(5)
    scal = rng.integers(0, 1 << 16, size=(N_UNIQUE, FR.nlimbs), dtype=np.int64)
    scal[:, -1] &= 0x0FFF
    ks = FR.from_limbs(scal)
    g = G1P.pack(tc.g1_from_affine_host([hc.g1_generator()] * N_UNIQUE, device=dev))
    proj = G1P.ladder(g, torch.as_tensor(scal.T.astype(np.int32).copy(), device=dev))
    return proj, ks


def random_scalars(N: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    scal = rng.integers(0, 1 << 16, size=(N, FR.nlimbs), dtype=np.int64)
    scal[:, -1] &= 0x0FFF  # 252-bit scalars, all below r
    return scal.astype(np.int32)


def expected_msm(scal: np.ndarray, ks) -> tuple:
    """g1_mul(G, sum_j s_j * k_(j mod 2^13) mod r) on the host."""
    reps = scal.shape[0] // N_UNIQUE
    limb_sums = scal.astype(np.int64).reshape(reps, N_UNIQUE, FR.nlimbs).sum(axis=0)
    total = 0
    for row, k in zip(limb_sums, ks):
        s = sum(int(v) << (16 * i) for i, v in enumerate(row))
        total = (total + s * k) % R
    return hc.g1_mul(hc.g1_generator(), total)


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


def phase_small_guard(dev):
    import random

    prng = random.Random(3)
    G = hc.g1_generator()
    pts = [hc.g1_mul(G, prng.randrange(1, R)) for _ in range(32)]
    scl = [prng.randrange(R) for _ in range(32)]
    got = msm.msm_g1(tc.g1_from_affine_host(pts, device=dev), scl, affine=True, device=dev)
    if got != hc.g1_msm(pts, scl):
        raise AssertionError("small msm_g1 disagrees with the host oracle")
    say("small guard: msm_g1 on 32 points equals host g1_msm")


def phase_main(dev, affine_pts, ks, log2n: int, count_launches: bool):
    """msm_g1(affine=True) at N = 2^log2n: exact check, cold and warm
    timing, phase split, and (optionally) launch counts of one warm call."""
    N = 1 << log2n
    pts = tuple(c.repeat(N // N_UNIQUE, 1) for c in affine_pts)
    scal_np = random_scalars(N, 7)
    scal = torch.as_tensor(scal_np, device=dev)
    want = expected_msm(scal_np, ks)

    def call(hook=None):
        out = msm.msm_g1(pts, scal, affine=True, device=dev, on_phase=hook)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    got = call()
    cold = time.perf_counter() - t0
    if got != want or got is None or not hc.g1_is_on_curve(got):
        raise AssertionError(f"msm_g1 at 2^{log2n} disagrees with the host value")
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
            raise AssertionError(f"warm msm_g1 at 2^{log2n} changed its answer")
    wall = statistics.median(walls)
    say(f"msm_g1 N=2^{log2n}: exact; cold {cold:.3f} s, warm {[round(w, 4) for w in walls]} s "
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


def msm_plan(pts, scal):
    """The arguments the main path hands the bucket kernels at this size:
    the first half of msm._msm_packed, stage by stage."""
    c = msm._SIGNED_C
    ptcat = msm._cat_points(pts)
    N = ptcat.shape[0]
    order, sgn, starts, counts = msm._digit_counts_signed(scal, c)
    table = msm._with_neg_y_table(ptcat)
    order_flat = (order + sgn * N).reshape(-1).contiguous()
    starts_np, counts_np = starts.cpu().numpy(), counts.cpu().numpy()
    W, B = counts_np.shape
    T_cap = msm._pick_t_cap(counts_np, W, B)
    wnd, seg_start, seg_count, lane_off, nseg, L = msm._plan_segments(starts_np, counts_np, T_cap)
    start = (wnd.astype(np.int64) * N + seg_start).astype(np.int32)
    return table, order_flat, start, seg_count, lane_off, nseg


def phase_field_path(dev, proj):
    """curve.g1_add on 2^16 lanes goes through field.mont_mul -> the
    Montgomery kernel; it must equal the fused add kernel limb for limb."""
    L = 1 << 16
    a = proj.repeat(1, L // N_UNIQUE)
    b = torch.roll(a, 1, dims=1).contiguous()
    build.reset_launches()
    got = tc.g1_add(G1P.unpack(a), G1P.unpack(b))
    torch.cuda.synchronize()
    launches = build.LAUNCHES["mont_mul"]
    if launches == 0:
        raise AssertionError("curve.g1_add did not launch the Montgomery kernel")
    if not torch.equal(G1P.pack(got), G1P.add2(a, b)):
        raise AssertionError("curve.g1_add differs from the fused add kernel")
    say(f"field path: curve.g1_add on 2^16 lanes ({launches} Montgomery launches) "
        f"equals the add2 kernel")
    return launches


def edge_points(dev, proj, L: int):
    """Two (72, L) projective batches whose first lanes hold P+P, P+(-P),
    P+O, O+P and O+O."""
    reps = -(-L // N_UNIQUE)
    a = proj.repeat(1, reps)[:, :L].clone()
    b = torch.roll(proj, 7, dims=1).repeat(1, reps)[:, :L].clone()
    ident = G1P.identity_packed(1, device=dev)[:, 0]
    b[:, 0] = a[:, 0]
    X, Y, Z = G1P.unpack(a[:, 1:2].contiguous())
    b[:, 1] = G1P.pack(tc.g1_neg((X, Y, Z)))[:, 0]
    b[:, 2] = ident
    a[:, 3] = ident
    a[:, 4] = ident
    b[:, 4] = ident
    return a.contiguous(), b.contiguous()


def phase_kernels(dev, proj, pts20, scal20, quick: bool) -> Report:
    rep = Report()
    pt_bytes = 72 * 4

    # K1 Montgomery product: the field path's stacked shape (6 products of
    # 2^16 lanes) for Fq, 2^16 lanes for Fr, edge values mixed in
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

    # K2 / K3 / K5 at the weighted sum's lane count: W * (2^12 / 32) lanes
    lanes = 20 * 128
    L = (256 if quick else lanes) + ODD
    a, b = edge_points(dev, proj, L)
    c3 = torch.roll(b, 3, dims=1).contiguous()
    cut = lambda t: t[..., : L - ODD].contiguous()
    a0, b0, c0 = cut(a), cut(b), cut(c3)
    n0 = L - ODD

    got, want = G1P.add2(a, b), G1P.add2_plain(a, b)
    rep.add("add2", got, want, time_ms(lambda: G1P.add2(a0, b0), 20),
            time_ms(lambda: G1P.add2_plain(a0, b0), 1),
            3 * pt_bytes * n0, MULS_ADD * MADD_FQ * n0, f"(72, {n0})")

    mask = torch.as_tensor(np.random.default_rng(22).integers(0, 2, size=L).astype(np.int32), device=dev)
    mask[:5] = 1
    m0 = cut(mask)
    got, want = G1P.step(a, b, mask), G1P.step_plain(a, b, mask)
    live = int(m0.sum())
    rep.add("step", got, want, time_ms(lambda: G1P.step(a0, b0, m0), 20),
            time_ms(lambda: G1P.step_plain(a0, b0, m0), 1),
            (4 * pt_bytes + 4) * n0, (MULS_ADD * live + MULS_DOUBLE * n0) * MADD_FQ,
            f"(72, {n0}), {live} lanes masked in")

    got, want = G1P.scan2b(a, c3, b), G1P.scan2b_plain(a, c3, b)
    rep.add("scan2b", got, want, time_ms(lambda: G1P.scan2b(a0, c0, b0), 20),
            time_ms(lambda: G1P.scan2b_plain(a0, c0, b0), 1),
            5 * pt_bytes * n0, 2 * MULS_ADD * MADD_FQ * n0, f"(72, {n0})")

    # K4 ladder at the Horner combine's shape and data: 20 window sums times
    # 2^(13 w); behind them lanes with scalars 0, 1, r-1, 2 and random ones
    Lh = 20 + ODD
    pts_h, _ = edge_points(dev, proj, Lh)
    ks = [1 << (msm._SIGNED_C * w) for w in range(20)] + [0, 1, R - 1, 2]
    ks += [int(v) for v in FR.from_limbs(random_scalars(Lh - len(ks), 23))]
    scal_h = torch.as_tensor(FR.to_limbs(ks).T.copy(), device=dev)
    got, want = G1P.ladder(pts_h, scal_h), G1P.ladder_plain(pts_h, scal_h)
    p0, s0 = pts_h[:, :20].contiguous(), scal_h[:, :20].contiguous()
    # what these scalars need: an add per set bit, a double per bit below the top one
    need = sum(MULS_ADD * bin(k).count("1") + MULS_DOUBLE * k.bit_length() for k in ks[:20])
    rep.add("ladder", got, want, time_ms(lambda: G1P.ladder(p0, s0), 5),
            time_ms(lambda: G1P.ladder_plain(p0, s0), 1),
            (2 * pt_bytes + 16 * 4) * 20, need * MADD_FQ,
            "(72, 20) x 256 bits, scalars 2^(13 w)")

    # K6 with the exact arguments of the main path's largest size, plus a
    # tail of hand-made lanes: count 0, a doubling lane, a long lane
    table, order_flat, start, count, lane_off, nseg = msm_plan(pts20, scal20)
    Ntab = table.shape[0]
    extra_idx = torch.as_tensor([5, 5, 9, 11, 13, 17, 19, 23, 29], dtype=torch.int32, device=dev)
    idx = torch.cat([order_flat, extra_idx])
    base = order_flat.shape[0]
    st = np.concatenate([start, [base, base, base + 2]]).astype(np.int32)
    ct = np.concatenate([count, [2, 0, 7]]).astype(np.int32)
    if quick:
        st, ct = st[-(256 + 3):], ct[-(256 + 3):]
    st_t, ct_t = torch.as_tensor(st, device=dev), torch.as_tensor(ct, device=dev)
    # the plain version walks every lane through the longest run: it is
    # timed once, on the compared call (three hand-made lanes more)
    got = G1P.bucket_phase(table, idx, st_t, ct_t, mixed=True)
    want, plain = timed_once(lambda: G1P.bucket_phase_plain(table, idx, st_t, ct_t, mixed=True))
    s0, c0 = st_t[:-3].contiguous(), ct_t[:-3].contiguous()
    adds = int(c0.sum())
    lanes6 = s0.shape[0]
    ms = time_ms(lambda: G1P.bucket_phase(table, order_flat, s0, c0, mixed=True), 3)
    rep.add("bucket_mixed", got, want, ms, plain,
            adds * (2 * 24 * 4 + 4) + lanes6 * (8 + pt_bytes),
            adds * MULS_MIXED * MADD_FQ,
            f"table ({Ntab}, 72), {lanes6} lanes, {adds} adds")

    seg_sums = G1P.bucket_phase(table, order_flat, s0, c0, mixed=True)
    if quick:
        lane_off = np.arange(0, lanes6 - 8, 4, dtype=np.int32)
        nseg = (np.arange(len(lane_off)) % 5).astype(np.int32)
    tab2 = seg_sums.T.contiguous()
    lo_t, ns_t = torch.as_tensor(lane_off, device=dev), torch.as_tensor(nseg, device=dev)
    got = G1P.bucket_phase(tab2, None, lo_t, ns_t)
    want, plain = timed_once(lambda: G1P.bucket_phase_plain(tab2, None, lo_t, ns_t))
    adds = int(nseg.sum())
    rep.add("bucket", got, want,
            time_ms(lambda: G1P.bucket_phase(tab2, None, lo_t, ns_t), 3), plain,
            adds * pt_bytes + len(nseg) * (8 + pt_bytes),
            adds * MULS_ADD * MADD_FQ,
            f"table ({tab2.shape[0]}, 72), {len(nseg)} lanes, {adds} adds")
    rep.max_nseg = int(nseg.max())
    return rep


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

    proj, ks = ladder_multiples(dev)
    torch.cuda.synchronize()
    aff_host = tc.g1_to_affine_host(G1P.unpack(proj))
    for i in (0, 1, N_UNIQUE - 1):
        if aff_host[i] != hc.g1_mul(hc.g1_generator(), ks[i]):
            raise AssertionError("ladder kernel: k * G differs from the host")
    affine_pts = tc.g1_from_affine_host(aff_host, device=dev)
    say(f"points: 2^13 ladder multiples of G, checked against the host ({time.time() - t_start:.1f} s)")

    if args.kernels_only:
        N = 1 << 14
        pts = tuple(c.repeat(N // N_UNIQUE, 1) for c in affine_pts)
        scal = torch.as_tensor(random_scalars(N, 7), device=dev)
        phase_kernels(dev, proj, pts, scal, quick=True)
        say("kernels-only pass done; run without arguments for the full check")
        return 0

    phase_small_guard(dev)
    sizes = (16, 20)
    for log2n in sizes:
        pts, scal, counts = phase_main(dev, affine_pts, ks, log2n, log2n == sizes[-1])
    k1_launches = phase_field_path(dev, proj)
    counts["mont_mul"] = k1_launches
    say(f"launches in one warm msm_g1 at 2^{sizes[-1]} (mont_mul: in the field path): {json.dumps(counts)}")

    rep = phase_kernels(dev, proj, pts, scal, quick=False)
    for name, row in rep.rows.items():
        row["launches"] = counts[name]
        if name == "bucket" and rep.max_nseg <= 1:
            continue  # one segment per bucket: the segment reduce only copies
        if row["launches"] == 0:
            raise AssertionError(f"the main path never launched kernel {name}")
    say(f"total {time.time() - t_start:.1f} s")
    say(json.dumps({"kernels": list(rep.rows.values())}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
