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
     scalars (one fixed-base launch each, no `add_mask`), `scalar_mul_batch_g2`,
     `msm_segmented` and `msm_multi_small` for both groups, each against the
     host, and the field path (`curve.g1_add` / `curve.g2_add` through the
     Montgomery kernel) against the fused add kernels;
  4. drives the sqrt-PST polynomial commitment end to end (`pst.setup`,
     `Polynomial.from_evaluations`, `eval`, `commit`, `open` with MIPP,
     `sqrt_pst.verify`) at nv = 10, 14 and, at full width, nv = 20 (a
     2^20-entry table): the verifier accepts, rejects the value + 1, `eval`
     equals a host evaluation in Python ints, T equals the multi-pairing of
     the affine column commitments, spot columns equal host MSMs, the proof
     has its hardware-independent size; commit, open and verify are timed
     with their parts, and the launches of the cold setup, one warm commit,
     open and verify are counted, and the device time of one open's ladder
     launches and of its trees of adds; the cold setup at nv = 20 is split
     into its host doublings, scalar conversion, fixed-base device time
     (CUDA events) and host mask muls;
  5. drives TestudoNIZK (core/snark.py: setup, `nizk_prove`, `nizk_verify`
     on the Fr-sponge transcript), with the fused sumcheck (the default) and
     the looped one beside it: the golden 16 x 16 x 2 instance of
     tests/fixtures/golden_nizk.json proves to the fixture's bytes and
     sponge states on the card with both; BASELINE config #3,
     `produce_synthetic_r1cs(2^16, 2^16, 10)`, proves to a 17,192 B sat
     proof that round-trips through the codec and verifies, the verifier
     rejects eval_vars_at_ry + 1 and a wrong input, and eval_vars_at_ry,
     the phase-2 claims and the verifier's (A, B, C)~(rx, ry) equal Python-int
     evaluations; setup, prove (cold, then three warm, split by the Timer
     labels commit / phase one / phase two / open) and verify (cold, warm)
     are timed, three warm looped proves beside them (byte-equal), the
     Poseidon permutations left on the host timed, each prover's CUDA kernels
     counted under torch.profiler, by phase too (the fused prove's with the
     row-major product's device time and launches by size class), and the
     launches of one warm fused prove, one looped prove and one verify
     counted (paths nizk_prove, nizk_prove_looped, nizk_verify: the fused
     sumcheck's three kernels must run in the first and not in the second),
     and the round kernel's launches by shape in one warm fused prove with
     their summed device time;
  6. runs the chained-product harness (tools/exp_montmul.py), which
     measures the card's Montgomery products per second;
  7. calls every kernel's wrapper at the shapes the main paths gave it and
     holds the result against the kernel's plain PyTorch version on the
     same inputs (integers: the tolerance is exact equality, max_abs_err
     must be 0), at a lane count that is no multiple of the block size and
     with edge cases mixed in, and times both; the row-major product's rows
     give its own device time (torch.profiler; L2 flushed before each
     launch, and left warm) beside the rate of raw
     launches and the time of a call through `field.mont_mul`, at its wide
     shapes and at the NIZK's tables of 2^15 .. 1 elements
     (tools/exp_mont_rm.py); the bucket kernel's rows and a
     line each give the run-length profile of its launch (lanes, longest run,
     lanes at T_cap, resident blocks per SM, grid); the three ladder
     kernels (the team kernel, a team of threads per lane, on narrow
     launches; the wide kernel, lanes longest first, each stopping after its
     top bit, every lane a team's, on wide ones; the one-thread kernel over
     all bits it replaced there) are held against the plain ladder at the
     widths each takes (20 lanes of Horner scalars and 1,024 random lanes;
     the commit's Horner at 32,768 and 8,192 lanes; random scalars at
     4,096 and 32,768) beside each other and `latency_bound_ms`;
     the weighted-sum kernel (a team of threads per lane, one launch for
     all per-group sums of an MSM) against the plain sequence of scan,
     ladder and add steps at the MSM's 2,560 lanes (one more window) and
     at 2,560 + ODD lanes, timed beside the launch sequence it replaced;
     the chain kernel (the commit's table of multiples) at 1,024 + ODD bases
     x 255 adds and the fold kernel (every tree of pairwise adds) at each
     path's segments plus one of ODD points, against their plain versions
     (the `add2_plain` sequences) and timed beside the `add2` launches they
     replaced; the fixed-base kernels (the team kernel at the setup's widths,
     one thread per lane at wide ones) at 2,047 + ODD and 2^16 + ODD lanes
     with edge scalars (0, 1, r - 1, 2, 2^252), against the plain sequence of
     masked adds (on a stride of the lanes at 2^16), timed beside the 256
     `add_mask` launches they replaced, `bound_ms` and `latency_bound_ms`;
     the fused sumcheck's kernels: the Poseidon permutation on Fr and Fq
     states, the round kernel for each kind at the NIZK's 2^16 and 2^17 rows,
     phase one's and phase two's at 2^20 and 2^21, and at 2, 4 and 8 rows,
     with and without the fold (and the fold as launches of its own beside
     it), the round tail on both sponges at the round's partial count, each
     against its plain version, timed beside `bound_ms` and
     `latency_bound_ms`;
  8. checks a small MSM against the host oracle;
  9. prints one JSON line {"kernels": [...]} (each row's `launches` is the
     sum of `launches_by_path`, the kernel's count on each driven path: msm,
     fixed_base, field, setup, commit, open, verify, nizk_prove,
     nizk_prove_looped, nizk_verify, harness; the run fails if a
     kernel was not launched on a path it belongs to) and, last,
     {"ok": true, "device": {...}}.

Any failure raises and the process exits non-zero.  It imports neither jax
nor the JAX package.  `--kernels-only` stops after a short build-and-compare
pass at small shapes and the golden NIZK proof (a first call after editing a
kernel); `--msm-only`
stops after `msm_g1` and `msm_g2` at 2^20 (exact check, cold and warm times,
phase split: to compare two checkouts on one card, run it from each in turn
within one shell command); `--nizk-only` stops after the NIZK phase at 2^16
and at 2^20 (a 21,192 B sat proof; the 2^20 instance takes most of a minute
of host Python to build), for the same use; the default run is the full
check.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from testudo_tpu_torch import native, proofs
from testudo_tpu_torch.core import pst, r1cs, r1csproof, snark, sqrt_pst
from testudo_tpu_torch.curves import host_curve as hc
from testudo_tpu_torch.curves import pairing as pr
from testudo_tpu_torch.curves import profile as cprof
from testudo_tpu_torch.device import build, msm
from testudo_tpu_torch.device import curve as tc
from testudo_tpu_torch.device import field as tf
from testudo_tpu_torch.device import packed_field
from testudo_tpu_torch.device import sponge as dsponge
from testudo_tpu_torch.device import sumcheck_kernels as sk
from testudo_tpu_torch.device.field import FQ, FR
from testudo_tpu_torch.device.packed_curve import G1P, G2P
from testudo_tpu_torch.fields.bls12_377 import R
from testudo_tpu_torch.poly import dense
from testudo_tpu_torch.poseidon import sponge
from testudo_tpu_torch.poseidon.transcript import PoseidonTranscript, fq_params, fr_params
from testudo_tpu_torch.tools import exp_mont_rm, exp_montmul, exp_sumcheck_round, time_open
from testudo_tpu_torch.utils import timer

# Least-time model.  Bytes: every input read once, every output written
# once, over the H100's 3.35 TB/s.  Operations: the 32-bit multiply-adds of
# the Montgomery products (2 N^2 + N per product of N-word operands; the
# carry additions around them are left out, so the bound is a lower one),
# over the card's int32 rate as derived from the data sheet (half the
# float32 rate: tools/exp_montmul.py has the derivation, and measures what a
# chain of products really reaches, which is lower; a bound must not be
# beatable, so the derived figure stays the bound).
HBM_BYTES_PER_S = 3.35e12
INT32_MADD_PER_S = exp_montmul.DERIVED_INT32_MADD_PER_S
MADD_FQ = exp_montmul.madds_per_product(FQ)
MADD_FR = exp_montmul.madds_per_product(FR)

# TPU kernel each port kernel replaces (both groups come from the same
# `_ec_call` factory, at ncomp 1 and 2) and its CUDA source.
_EC = "testudo_tpu/tpu/pallas_curve.py"
_REPLACES = {
    "mont_mul": "testudo_tpu/tpu/pallas_field.py:226",
    "mont_mul_rm_fq": "testudo_tpu/tpu/kernels.py:34",
    "mont_mul_rm_fr": "testudo_tpu/tpu/kernels.py:34",
    "mont_mul_rm_fr_full": "testudo_tpu/tpu/kernels.py:34",
    "mont_chain": "tools/exp_montmul_block.py:114",
    "mont_chain_seq": "tools/exp_mulmany_wide.py:60",
    "mont_chain_wide": "tools/exp_mulmany_wide.py:60",
    "add_mask": _EC + ":403", "add2": _EC + ":415", "step": _EC + ":424",
    "scan2": _EC + ":437", "scan2b": _EC + ":450", "bucket": _EC + ":461",
    "bucket_mixed": _EC + ":509", "ladder": _EC + ":733", "ladder_team": _EC + ":733",
    "ladder_wide": _EC + ":733",
    "wsum": _EC + ":450", "chain_team": _EC + ":415", "fold_team": _EC + ":415",
    "fixed_base": _EC + ":403", "fixed_base_one": _EC + ":403",
    # the fused sumcheck: its products over 512 rows or more reach the Pallas
    # product inside the reference's fused jit (tpu/field.py:292-295); the
    # permutation and the tail are XLA ops there (row key "replaces_also")
    "sumcheck_round": "testudo_tpu/tpu/pallas_field.py:226",
    "poseidon_permute": "testudo_tpu/tpu/pallas_field.py:226",
    "sumcheck_tail": "testudo_tpu/tpu/pallas_field.py:226",
}
_REPLACES_ALSO = {
    "sumcheck_round": ["testudo_tpu/core/sumcheck.py:62", "testudo_tpu/core/sumcheck.py:222",
                       "testudo_tpu/core/sumcheck.py:534", "testudo_tpu/poly/dense.py"],
    "poseidon_permute": ["testudo_tpu/tpu/sponge.py:57"],
    "sumcheck_tail": ["testudo_tpu/core/sumcheck.py:162", "testudo_tpu/core/sumcheck.py:187",
                      "testudo_tpu/tpu/sponge.py:141", "testudo_tpu/tpu/sponge.py:213"],
}
_CSRC = "testudo_tpu_torch/csrc/"
_SOURCE = {
    "mont_mul_rm_fq": "mont_mul_rm.cu", "mont_mul_rm_fr": "mont_mul_rm.cu",
    "mont_mul_rm_fr_full": "mont_mul_rm.cu",
    "mont_chain": "mont_chain.cu", "mont_chain_seq": "mont_chain.cu",
    "mont_chain_wide": "mont_chain.cu",
    "mont_mul": "mont_mul.cu", "add_mask": "ec_ops.cu", "add2": "ec_ops.cu",
    "step": "ec_ops.cu", "scan2": "ec_ops.cu", "scan2b": "ec_ops.cu",
    "ladder": "ladder.cu", "ladder_team": "ladder_team.cu", "ladder_wide": "ladder_wide.cu",
    "bucket": "bucket.cu",
    "bucket_mixed": "bucket.cu", "wsum": "wsum_team.cu", "chain_team": "chain_team.cu",
    "fold_team": "fold_team.cu", "fixed_base": "fixed_base_team.cu",
    "fixed_base_one": "fixed_base_team.cu", "poseidon_permute": "poseidon.cu",
    "sumcheck_round": "sumcheck_round.cu", "sumcheck_tail": "sumcheck_tail.cu",
}
# proof bytes (PST opening + MIPP proof) of sqrt-PST per number of variables:
# counts of group and field elements, the same on any hardware
PROOF_BYTES = {10: 7136, 14: 9920, 20: 14096}
# TestudoNIZK (BASELINE config #3, benches/testudo.py): 2^k constraints, 2^k
# variables, 10 inputs; its sat proof's bytes per k (testudo_nizk.csv,
# testudo.csv: counts of group and field elements, the same on any hardware)
NIZK_INPUTS = 10
NIZK_SAT_BYTES = {16: 17192, 20: 21192}
GOLDEN_NIZK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                           "golden_nizk.json")
# the Timer labels that split a prove (core/r1csproof.py)
NIZK_LABELS = {"polycommit (sqrt-PST)": "commit", "prove_sc_phase_one": "phase one",
               "prove_sc_phase_two": "phase two", "polyeval (sqrt-PST open)": "open"}
# The paths on which each kernel must be launched at least once (each path is
# driven with the counters zeroed just before and read just after).  K1
# (`mont_mul`) serves (n, m) callers and `scan2` is on no path: both are
# launched in the kernel phase only.  So are `scan2b` and `step`, whose work
# on the paths the weighted-sum kernel does in one launch; `add2`, whose
# work on the paths the chain kernel (the commit's table) and the fold
# kernel (every tree of pairwise sums) do in one launch each; `add_mask`,
# whose 256 launches a fixed-base multiplication the fixed-base kernels do in
# one (the team kernel at the setup's widths, one thread per lane at the
# fixed-base phase's 2^16: FIXED_TEAM_MAX_LANES); the G2 chain
# (the commit is over G1 only); the one-thread ladder over all bits, whose
# wide launches (the commit's Horner) the wide kernel runs (it keeps only
# unordered launches above WIDE_LADDER_MAX_UNORDERED, which no path makes);
# and the wide G2
# ladder: every G2 ladder of the paths is at most TEAM_LADDER_MAX_LANES
# wide (the MSM's 20-lane Horner, the open's folds), so the team kernel
# takes it; the wide G1 ladder runs the commit's Horner, 32,768 lanes at
# nv = 20 and 8,192 in a prove.  A kernel of the kernel phase only must
# show no launch on any path.
_MSM_KERNELS = ("fold_team", "wsum", "ladder_team", "bucket", "bucket_mixed")
_KERNEL_PHASE_ONLY = ("mont_mul", "scan2", "scan2_g2", "ladder", "ladder_g2", "ladder_wide_g2",
                      "step", "step_g2", "scan2b", "scan2b_g2", "add2", "add2_g2",
                      "chain_team_g2", "add_mask", "add_mask_g2")
MUST_LAUNCH = {
    **{k: () for k in _KERNEL_PHASE_ONLY},
    "mont_mul_rm_fq": ("field", "open"),
    "mont_mul_rm_fr": ("commit", "open"),
    "mont_chain": ("harness",), "mont_chain_seq": ("harness",), "mont_chain_wide": ("harness",),
    "fixed_base": ("setup",), "fixed_base_g2": ("setup",),
    "fixed_base_one": ("fixed_base",), "fixed_base_one_g2": ("fixed_base",),
    **{k: ("msm",) for k in _MSM_KERNELS},
    **{k + "_g2": ("msm",) for k in _MSM_KERNELS},
}
MUST_LAUNCH.update({
    "chain_team": ("commit",), "fold_team": ("msm", "commit", "open"),
    "fold_team_g2": ("msm", "open"), "ladder_wide": ("commit",),
    "ladder_team": ("msm", "open"), "ladder_team_g2": ("msm", "open"),
    "bucket": ("msm", "commit", "open"), "wsum": ("msm", "open"),
})
# TestudoNIZK: one warm prove with the fused sumcheck (the default), one with
# the looped one, each a path (their witness commit and opening are the
# sqrt-PST paths' kernels at nv = 16; the R1CS and eq-table products are
# row-major Fr products; the fused prove's sumcheck rounds are the round,
# Poseidon and tail kernels, the looped prove's are row-major Fr products of
# two full operands), and one verify (the verifier's A~, B~, C~(rx, ry); the
# rest of a verify is on the host)
_NIZK_PROVE_KERNELS = ("mont_mul_rm_fr", "mont_mul_rm_fq", "chain_team", "bucket", "ladder_wide",
                       "fold_team", "ladder_team", "ladder_team_g2", "fold_team_g2", "wsum")
for _name in _NIZK_PROVE_KERNELS:
    MUST_LAUNCH[_name] += ("nizk_prove", "nizk_prove_looped")
MUST_LAUNCH["mont_mul_rm_fr"] += ("nizk_verify",)
FUSED_KERNELS = build.SUMCHECK_KERNELS  # launched by the fused prove only
for _name in FUSED_KERNELS:
    MUST_LAUNCH[_name] = ("nizk_prove",)
# A row that times a kernel at a second shape reads its launches from the
# kernel's counter, on the paths that give it that shape.
ROW_COUNTER = {"mont_mul_rm_fr_full": ("mont_mul_rm_fr",
                                       ("nizk_prove", "nizk_prove_looped", "nizk_verify"))}
MUST_LAUNCH["mont_mul_rm_fr_full"] = ("nizk_prove_looped",)
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


def ladder_launches(grp) -> int:
    """Launches of any ladder kernel of the group since the last reset."""
    return sum(build.LAUNCHES[counter(grp, k)] for k in ("ladder", "ladder_team", "ladder_wide"))


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
            "replaces": _REPLACES[kernel], "launches": 0, "launches_by_path": {},
            "max_abs_err": err,
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
    say(f"kernel build: {time.time() - t0:.1f} s (nvcc {rep['seconds']:.1f} s; each source, "
        f"compiled side by side: {json.dumps(rep['per_source'])})")
    for line in rep["ptxas"]:
        say("  " + line)
    # the host library (pairings, GT powers, host MSMs): the port's own copy
    t0 = time.time()
    if native.available():
        where = native.library_path()
        if not where.startswith(str(build.BUILD_ROOT)):
            raise AssertionError(f"native library loaded from {where}")
        say(f"host pairing: native library (g++, {time.time() - t0:.1f} s), "
            f"{native.lib().tn_nthreads()} threads")
    elif native.compiler() is not None:
        raise AssertionError(f"the native host library did not build or load: {native.build_error()}")
    else:
        say("host pairing: pure Python (no g++ on this machine)")
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
    return table, order_flat, start, seg_count, lane_off, nseg, T_cap


def run_profile(Gp, count, mixed: bool, cap=None) -> str:
    """What a bucket launch is given and how it runs it: lanes, the run
    lengths (longest, how many lanes reach it or `cap`, mean), and the grid
    (resident blocks of 64 threads per SM and on the card; the grid is the
    smaller of that and one thread per lane)."""
    c = np.asarray(count.cpu() if isinstance(count, torch.Tensor) else count, dtype=np.int64)
    top = int(c.max()) if len(c) else 0
    cap = top if cap is None else cap
    resident = Gp.bucket_capacity(mixed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = min(resident, -(-len(c) // 64))
    return (f"{len(c)} lanes, max count {top}, {int((c == cap).sum())} lanes at {cap}, "
            f"mean {c.mean() if len(c) else 0:.1f}; {resident // sms} blocks of 64 per SM x {sms} "
            f"SMs = {resident} resident, grid {grid}")


def phase_field_path(dev, grp, proj):
    """curve.g1_add / g2_add on 2^16 lanes goes through field.mont_mul -> the
    row-major Montgomery kernel; it must equal the fused add kernel limb for
    limb."""
    L = 1 << 16
    a = proj.repeat(1, L // N_UNIQUE)
    b = torch.roll(a, 1, dims=1).contiguous()
    build.reset_launches()
    got = grp.add(grp.Gp.unpack(a), grp.Gp.unpack(b))
    torch.cuda.synchronize()
    snap = dict(build.LAUNCHES)
    launches = snap["mont_mul_rm_fq"]
    if launches == 0 or snap["mont_mul"] != 0:
        raise AssertionError(f"curve.{grp.name}_add did not launch the row-major Montgomery kernel")
    if not torch.equal(grp.Gp.pack(got), grp.Gp.add2(a, b)):
        raise AssertionError(f"curve.{grp.name}_add differs from the fused add kernel")
    say(f"field path: curve.{grp.name}_add on 2^16 lanes ({launches} Montgomery launches) "
        f"equals the add2 kernel")
    return snap


def phase_fixed_base(dev, grp):
    """fixed_base_mul on 2^16 scalars (0, 1, r-1 among them): spot lanes
    against the host; one fixed-base launch, no add_mask."""
    N = 1 << 16
    scal_np = random_scalars(N, 13)
    edge = [0, 1, R - 1]
    scal_np[: len(edge)] = FR.to_limbs(edge)
    base = grp.mul(grp.gen(), 0xC0FFEE)
    name = counter(grp, grp.Gp.fixed_base_kernel(N))
    build.reset_launches()
    t0 = time.perf_counter()
    out = grp.fixed(torch.as_tensor(scal_np, device=dev), base, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    snap = dict(build.LAUNCHES)
    launches = snap[name]
    if launches != 1 or snap[counter(grp, "add_mask")] != 0:
        raise AssertionError(f"fixed_base_mul_{grp.name}: {launches} {name} launches and "
                             f"{snap[counter(grp, 'add_mask')]} add_mask, expected 1 and 0")
    lanes = [0, 1, 2, 3, 777, N - 1]
    spot = msm._map_coords(lambda c: c[lanes], out)
    want = [grp.mul(base, k) for k in FR.from_limbs(scal_np[lanes])]
    if grp.to_affine(spot) != want or want[0] is not None:
        raise AssertionError(f"fixed_base_mul_{grp.name} disagrees with the host")
    say(f"fixed_base_mul_{grp.name} on 2^16 scalars: {launches} {name} launches, {secs:.3f} s, "
        f"{len(lanes)} lanes equal the host")
    return snap


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
    if got != want or ladder_launches(grp) != 1:
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
    if got != want or ladder_launches(grp) != 1:
        raise AssertionError(f"msm_multi_small({grp.name}) disagrees with the host")
    say(f"{grp.name}: scalar_mul_batch (64 lanes), msm_segmented (2 x 2^10, one ladder launch) "
        f"and msm_multi_small ({len(sizes)} parts of 512..1, one ladder launch) equal the host")


# ---------------------------------------------------------------------------
# sqrt-PST: commit, open, verify
# ---------------------------------------------------------------------------


def host_evaluate(Z, point) -> int:
    """Multilinear evaluation in Python ints, MSB-first binding."""
    for r in point:
        half = len(Z) // 2
        Z = [(lo + r * (hi - lo)) % R for lo, hi in zip(Z[:half], Z[half:])]
    return Z[0]


def _split(records) -> dict:
    out = {}
    for label, secs in records:
        out[label] = round(out.get(label, 0.0) + secs, 4)
    return out


def phase_sqrt_pst(dev, nv: int, full: bool):
    """One sqrt-PST run at 2^nv evaluations: exactness, reject path, proof
    size; with `full` also timings, their parts and the launch counts of one
    warm commit, one open and one verify (returned, each on its own)."""
    import random

    pf = cprof.bls12_377(dev)
    m_row = nv // 2 + nv % 2
    m_col = nv // 2
    build.reset_launches()
    with timer.record() as rec:  # the cold setup, its parts and the fixed-base device time
        ((ck, vk), setup_ms), fb = time_open.device_ms(
            lambda: timed_once(lambda: pst.setup(m_row, profile=pf)), {"fixed_base": ("fixed_base",)})
    counts_setup = dict(build.LAUNCHES)
    setup_parts = _split(rec)
    limbs = random_scalars(1 << nv, 7)
    table = dense._to_mont_dev(torch.as_tensor(limbs, device=dev))
    prng = random.Random(7)
    point = [prng.randrange(R) for _ in range(nv)]
    pl = sqrt_pst.Polynomial.from_evaluations(table, pf)
    v, eval_ms = timed_once(lambda: pl.eval(point))
    Z = FR.from_limbs(limbs)
    if v != host_evaluate(Z, point):
        raise AssertionError(f"sqrt-PST nv={nv}: eval differs from the host evaluation")

    (comm, T), commit_cold = timed_once(lambda: pl.commit(ck))
    level = ck.nv - pl.m_row
    # the host side of the commit, piece by piece
    comm_aff, aff1_ms = timed_once(lambda: pf.g1b.to_affine(comm))
    h_aff, aff2_ms = timed_once(lambda: pf.g2b.to_affine(ck.powers_of_h[level + pl.odd]))
    T_host, pair_ms = timed_once(lambda: pr.multi_pairing(comm_aff, h_aff))
    if len(comm_aff) != 1 << m_col or T != T_host:
        raise AssertionError(f"sqrt-PST nv={nv}: T differs from the multi-pairing of the commitments")
    tr = PoseidonTranscript(fq_params())
    t0 = time.perf_counter()
    tr.append_bytes(pf.ser_gt(T))
    tr.append_bytes(pf.ser_gt(T))
    tr.challenge_scalar(R)
    sponge_ms = (time.perf_counter() - t0) * 1e3
    host_parts = (f"to_affine of {len(comm_aff)} G1 points {aff1_ms:.1f} ms, of {len(h_aff)} G2 points "
                  f"{aff2_ms:.1f} ms, multi-pairing of {len(h_aff)} pairs {pair_ms:.1f} ms, transcript "
                  f"(two GT absorbs and a challenge, as one MIPP round) {sponge_ms:.1f} ms")
    basis_aff = pf.g1b.to_affine(ck.powers_of_g[level])
    ncols = 1 << m_col
    spots = sorted({0, 1, ncols // 3, ncols // 2, ncols - 2, ncols - 1, 5 % ncols, 77 % ncols})
    host_msm = native.g1_msm if native.available() else hc.g1_msm
    for k in spots:  # column k holds Z[(j << m_col) | k]
        if comm_aff[k] != host_msm(basis_aff, Z[k::ncols]):
            raise AssertionError(f"sqrt-PST nv={nv}: column commitment {k} differs from the host MSM")

    def do_open():
        pl.q = None  # the opening recomputes q, as a prover that did not call eval would
        return pl.open(PoseidonTranscript(fq_params()), comm, ck, point, T)

    def do_verify(value):
        return sqrt_pst.verify(PoseidonTranscript(fq_params()), vk, U, point, value,
                               pst_proof, mipp_proof, T)

    (U, pst_proof, mipp_proof), open_cold = timed_once(do_open)
    ok, verify_cold = timed_once(lambda: do_verify(v))
    if ok is not True:
        raise AssertionError(f"sqrt-PST nv={nv}: the verifier rejected an honest proof")
    if do_verify((v + 1) % R) is not False:
        raise AssertionError(f"sqrt-PST nv={nv}: the verifier accepted a wrong value")
    size = len(proofs.ser_pst_proof(pst_proof)) + len(proofs.ser_mipp(mipp_proof))
    if size != PROOF_BYTES[nv]:
        raise AssertionError(f"sqrt-PST nv={nv}: proof of {size} bytes, expected {PROOF_BYTES[nv]}")
    say(f"sqrt-PST nv={nv} ({1 << m_row} x {ncols}): eval, T and {len(spots)} spot columns exact; "
        f"verify true, v + 1 rejected; proof {size} B; setup {setup_ms / 1e3:.3f} s, "
        f"eval {eval_ms / 1e3:.3f} s, cold commit {commit_cold / 1e3:.3f} s, "
        f"open {open_cold / 1e3:.3f} s, verify {verify_cold / 1e3:.3f} s")
    if not full:
        return None
    fb_each = ", ".join(f"{g} {ms:.3f} ms over {n} calls"
                        for g, (ms, n) in sorted(fb["fixed_base"].items()))
    say(f"  setup parts, cold (s, host clock: {json.dumps(setup_parts)}); fixed-base device time "
        f"(CUDA events around each call): {fb_each}; the whole setup {setup_ms / 1e3:.3f} s")

    # warm timings and their parts; launches of the last warm commit, one
    # open and one verify
    commits, parts = [], {}
    for i in range(3):
        build.reset_launches()
        with timer.record() as rec:
            (comm2, T2), ms = timed_once(lambda: pl.commit(ck))
        commits.append(ms / 1e3)
        parts = _split(rec)
        if T2 != T:
            raise AssertionError("a warm commit changed T")
    counts_commit = dict(build.LAUNCHES)
    build.reset_launches()
    with timer.record() as rec:
        (U2, pst2, mipp2), open_warm = timed_once(do_open)
    open_parts = _split(rec)
    counts_open = dict(build.LAUNCHES)
    if U2 != U or proofs.ser_mipp(mipp2) != proofs.ser_mipp(mipp_proof):
        raise AssertionError("a second opening differs from the first")
    # one more warm open, with CUDA events around every ladder launch and
    # every tree of pairwise adds
    (_, open_ms), timed = time_open.device_ms(lambda: timed_once(do_open))
    for kind, sums in timed.items():
        each = ", ".join(f"{g} {ms:.3f} ms over {n} calls" for g, (ms, n) in sorted(sums.items()))
        say(f"  {kind} device time of one warm open (CUDA events around each call): {each}; "
            f"together {sum(v[0] for v in sums.values()):.3f} ms of the open's {open_ms:.1f} ms")
    build.reset_launches()
    with timer.record() as rec:
        ok, verify_warm = timed_once(lambda: do_verify(v))
    verify_parts = _split(rec)
    counts_verify = dict(build.LAUNCHES)
    if ok is not True:
        raise AssertionError("the warm verify rejected")
    say(f"sqrt-PST nv={nv} warm: commit {[round(c, 4) for c in commits]} s "
        f"(median {statistics.median(commits):.4f} s), open {open_warm / 1e3:.4f} s, "
        f"verify {verify_warm / 1e3:.4f} s")
    say(f"  commit parts (s): {json.dumps(parts)}")
    say(f"  host side of a commit: {host_parts}")
    say(f"  open parts (s): {json.dumps(open_parts)}")
    say(f"  verify parts (s): {json.dumps(verify_parts)}")

    # the multi-MSM of the commit, stage by stage (synchronised)
    canon = pst._to_canon_scalars(pl.matrix.transpose(0, 1), FR)
    marks = []

    def hook(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    torch.cuda.synchronize()
    prev = time.perf_counter()
    msm._multi_msm_device("g1", ck.powers_of_g[level], canon, msm._pick_window(canon.shape[1]),
                          on_phase=hook)
    stages = {}
    for name, t in marks:
        stages[name] = round((t - prev) * 1e3, 3)
        prev = t
    say(f"  multi-MSM stages (ms, synchronised; K={canon.shape[0]} N={canon.shape[1]} c={msm._pick_window(canon.shape[1])}): "
        f"{json.dumps(stages)}")
    nz = lambda d: {k: n for k, n in d.items() if n}
    say(f"  launches, cold setup: {json.dumps(nz(counts_setup))}")
    say(f"  launches, one warm commit: {json.dumps(nz(counts_commit))}")
    say(f"  launches, one open: {json.dumps(nz(counts_open))}")
    say(f"  launches, one verify: {json.dumps(nz(counts_verify))}")
    if counts_commit["mont_mul_rm_fr"] == 0 or counts_open["mont_mul_rm_fr"] == 0:
        raise AssertionError("sqrt-PST did not launch the row-major Montgomery kernel")
    by_path = {"setup": counts_setup, "commit": counts_commit, "open": counts_open,
               "verify": counts_verify}
    return by_path, canon, ck.powers_of_g[level]


# ---------------------------------------------------------------------------
# TestudoNIZK: setup, prove, verify
# ---------------------------------------------------------------------------


def host_eq(point) -> list:
    """The MSB-first eq table of `point` in Python ints."""
    evals = [1]
    for r in point:
        nxt = []
        for e in evals:
            hi = e * r % R
            nxt += [(e - hi) % R, hi]
        evals = nxt
    return evals


def host_mat_vec(m, z, nrows: int) -> list:
    out = [0] * nrows
    for r_, c_, v in zip(m.rows.tolist(), m.cols.tolist(), m.vals):
        out[r_] = (out[r_] + v * z[c_]) % R
    return out


def _nizk_split(records) -> dict:
    """A prove's seconds by the Timer labels, and the rest of it."""
    split = _split(records)
    out = {short: split.get(label, 0.0) for label, short in NIZK_LABELS.items()}
    out["rest"] = round(split["r1csproof::prove"] - sum(out.values()), 4)
    return out


def phase_nizk_golden(dev):
    """The golden instance of tests/fixtures/golden_nizk.json proved on the
    card: byte-equal sat proof, equal final sponge states."""
    with open(GOLDEN_NIZK) as f:
        fix = json.load(f)
    p = fix["params"]
    inst, vars_, inputs = r1cs.Instance.produce_synthetic_r1cs(
        p["num_cons"], p["num_vars"], p["num_inputs"], seed=p["seed"])
    gens = snark.TestudoNizkGens.setup(p["num_cons"], p["num_vars"], p["num_inputs"],
                                       profile=cprof.bls12_377(dev))
    for fused in (True, False):
        which = "fused" if fused else "looped"
        build.reset_launches()
        tp = PoseidonTranscript(fr_params())
        proof = snark.nizk_prove(inst, vars_, inputs, gens, tp, fused=fused)
        launched = sum(build.LAUNCHES[k] for k in FUSED_KERNELS)
        if (launched == 0) == fused:
            raise AssertionError(f"the golden NIZK prove ({which}) launched {launched} fused "
                                 f"sumcheck kernels")
        blob = proofs.ser_r1cs_proof(proof.r1cs_sat_proof)
        if hashlib.sha256(blob).hexdigest() != fix["sat_proof_sha256"] or blob.hex() != fix["sat_proof_hex"]:
            raise AssertionError(f"the golden NIZK proof ({which}) on the card differs from the "
                                 f"fixture's bytes")
        if [hex(v) for v in tp.sponge.state] != fix["prover_final_sponge_state"]:
            raise AssertionError(f"the golden NIZK prover ({which}) ends in another sponge state")
        tv = PoseidonTranscript(fr_params())
        if snark.nizk_verify(proof, gens, inst, inputs, tv) is not True:
            raise AssertionError(f"the golden NIZK proof ({which}) did not verify on the card")
        if [hex(v) for v in tv.sponge.state] != fix["verifier_final_sponge_state"]:
            raise AssertionError("the golden NIZK verifier ends in another sponge state")
        say(f"NIZK golden ({p['num_cons']} x {p['num_vars']} x {p['num_inputs']}, seed {p['seed']}) "
            f"on the card, {which} sumcheck: sat proof {len(blob)} B byte-equal to the fixture "
            f"(sha256 {fix['sat_proof_sha256'][:12]}...), both final sponge states equal, verified")


def phase_nizk(dev, log2n: int):
    """TestudoNIZK on produce_synthetic_r1cs(2^log2n, 2^log2n, 10), as
    benches/testudo.py builds BASELINE config #3: proof size, codec round
    trip, verifier accepts and rejects two corruptions, exact host-int checks
    of eval_vars_at_ry, the phase-2 claims and the instance's evaluation;
    cold and warm times split by the Timer labels; launches of one warm
    prove and one verify (returned by path)."""
    n = 1 << log2n
    what = f"NIZK 2^{log2n}"
    t0 = time.perf_counter()
    inst, vars_, inputs = r1cs.Instance.produce_synthetic_r1cs(n, n, NIZK_INPUTS)
    inst_s = time.perf_counter() - t0
    pf = cprof.bls12_377(dev)
    gens, setup_ms = timed_once(
        lambda: snark.TestudoNizkGens.setup(n, n, NIZK_INPUTS, profile=pf))

    def prove(fused=True):
        tp = PoseidonTranscript(fr_params())
        return snark.nizk_prove(inst, vars_, inputs, gens, tp, fused=fused), tp

    def prove_looped():
        return prove(False)

    def verify(proof, ins=inputs):
        return snark.nizk_verify(proof, gens, inst, ins, PoseidonTranscript(fr_params()))

    with timer.record() as rec:
        (proof, tp), prove_cold = timed_once(prove)
    split_cold = _nizk_split(rec)
    sat = proof.r1cs_sat_proof
    blob = proofs.ser_r1cs_proof(sat)
    if len(blob) != NIZK_SAT_BYTES[log2n]:
        raise AssertionError(f"{what}: sat proof of {len(blob)} B, expected {NIZK_SAT_BYTES[log2n]}")
    if proofs.ser_r1cs_proof(proofs.parse_r1cs_proof(blob)) != blob:
        raise AssertionError(f"{what}: the sat proof does not re-serialize to its bytes")
    ok, verify_cold = timed_once(lambda: verify(proof))
    if ok is not True:
        raise AssertionError(f"{what}: the verifier rejected an honest proof")
    bad = proofs.parse_r1cs_proof(blob)
    bad.eval_vars_at_ry = (bad.eval_vars_at_ry + 1) % R
    if verify(snark.TestudoNizk(bad, proof.r)) is not False:
        raise AssertionError(f"{what}: the verifier accepted eval_vars_at_ry + 1")
    wrong = r1cs.Assignment([(inputs.assignment[0] + 1) % R] + inputs.assignment[1:])
    if verify(proof, wrong) is not False:
        raise AssertionError(f"{what}: the verifier accepted a wrong input")

    # exact checks in Python ints, independent of the verifier
    t0 = time.perf_counter()
    rx, ry = proof.r
    nv = inst.inst.num_vars
    w = vars_.assignment + [0] * (nv - len(vars_.assignment))
    if sat.eval_vars_at_ry != host_evaluate(w, ry[1:]):
        raise AssertionError(f"{what}: eval_vars_at_ry differs from the witness at ry[1:]")
    z = inst.inst.z_vector(w, inputs.assignment)
    mats = (inst.inst.A, inst.inst.B, inst.inst.C)
    claims = [host_evaluate(host_mat_vec(m, z, inst.inst.num_cons), rx) for m in mats]
    if list(sat.claims_phase2[:3]) != claims or sat.claims_phase2[3] != claims[0] * claims[1] % R:
        raise AssertionError(f"{what}: the phase-2 claims differ from A z, B z, C z at rx")
    eq_x, eq_y = host_eq(rx), host_eq(ry)
    want = tuple(sum(v * eq_x[r_] * eq_y[c_] for r_, c_, v in
                     zip(m.rows.tolist(), m.cols.tolist(), m.vals)) % R for m in mats)
    evals, eval_ms = timed_once(lambda: inst.inst.evaluate(rx, ry, dev))
    if evals != want:
        raise AssertionError(f"{what}: inst.evaluate(rx, ry) on the card differs from the host sum")
    host_s = time.perf_counter() - t0

    # warm: three fused proves, then three looped ones (the last of each
    # counted), all byte-equal
    walls, splits, counts = {}, {}, {}
    for which, fn in (("fused", prove), ("looped", prove_looped)):
        walls[which], splits[which] = [], []
        for i in range(3):
            build.reset_launches()
            with timer.record() as rec:
                (p2, _), ms = timed_once(fn)
            counts[which] = dict(build.LAUNCHES)
            walls[which].append(ms / 1e3)
            splits[which].append(_nizk_split(rec))
            if proofs.ser_r1cs_proof(p2.r1cs_sat_proof) != blob:
                raise AssertionError(f"{what}: a warm {which} prove gave other bytes")
    counts_prove = counts["fused"]
    if any(counts["looped"][k] for k in FUSED_KERNELS) or not all(counts_prove[k] for k in FUSED_KERNELS):
        raise AssertionError(f"{what}: the fused sumcheck kernels ran in the looped prove or not "
                             f"in the fused one")
    build.reset_launches()
    with timer.record() as rec:
        ok, verify_warm = timed_once(lambda: verify(proof))
    counts_verify = dict(build.LAUNCHES)
    verify_parts = _split(rec)
    if ok is not True:
        raise AssertionError(f"{what}: the warm verify rejected")

    # one more warm prove with the Poseidon permutations timed on the host
    perm = [0.0, 0]
    orig = sponge.PoseidonSponge.permute

    def timed_permute(self):
        t = time.perf_counter()
        orig(self)
        perm[0] += time.perf_counter() - t
        perm[1] += 1

    perms = {}
    sponge.PoseidonSponge.permute = timed_permute
    try:
        for which, fn in (("fused", prove), ("looped", prove_looped)):
            perm[:] = [0.0, 0]
            _, ms = timed_once(fn)
            perms[which] = (perm[0], perm[1], ms)
    finally:
        sponge.PoseidonSponge.permute = orig
    # and under the profiler: the device's kernels, by count and time, by phase
    # for both provers; the largest kernels and the row-major product's share
    # for the fused one (the default)
    prof_lines = {"fused": nizk_profile(prove) + "\n    " + nizk_phase_profile(prove),
                  "looped": nizk_phase_profile(prove_looped)}
    # and the round kernel's launches by shape with their device time
    rounds = exp_sumcheck_round.prove_round_profile(prove)
    by_shape = {k: [c["launches"], None if c["device_ms"] is None else round(c["device_ms"], 5)]
                for k, c in rounds["by_shape"].items()}

    nz = lambda d: {k: v for k, v in d.items() if v}
    say(f"{what} ({n} constraints, {n} variables, {NIZK_INPUTS} inputs): sat proof {len(blob)} B, "
        f"codec round trip, verified; eval_vars_at_ry + 1 and a wrong input rejected; "
        f"eval_vars_at_ry, Az/Bz/Cz at rx and (A, B, C)~(rx, ry) equal Python ints "
        f"({host_s:.1f} s of host checks); instance built in {inst_s:.1f} s")
    say(f"  {what} times: setup (cold) {setup_ms / 1e3:.4f} s; prove cold (fused) "
        f"{prove_cold / 1e3:.4f} s {json.dumps(split_cold)}; verify cold {verify_cold / 1e3:.4f} s, "
        f"warm {verify_warm / 1e3:.4f} s")
    for which in ("fused", "looped"):
        say(f"  {what} warm proves, {which} sumcheck: {[round(x, 4) for x in walls[which]]} s, "
            f"median {statistics.median(walls[which]):.4f} s")
        for i, sp in enumerate(splits[which]):
            say(f"  {what} warm {which} prove {i} split (s): {json.dumps(sp)}")
    say(f"  {what} verify parts (s): {json.dumps(verify_parts)}; A~, B~, C~(rx, ry) alone "
        f"{eval_ms:.1f} ms")
    for which, (secs, calls, ms) in perms.items():
        say(f"  {what} Poseidon permutations on the host in one warm {which} prove: {calls} calls, "
            f"{secs:.4f} s (that prove {ms / 1e3:.4f} s)")
    for which, line in prof_lines.items():
        say(f"  {what} {which} {line}")
    say(f"  {what} k_sumcheck_round in one warm fused prove (torch.profiler): {rounds['launches']} "
        f"launches, {rounds['device_ms']:.5f} ms of device time; by shape [launches, device ms]: "
        f"{json.dumps(by_shape)}")
    say(f"  {what} launches of the fused sumcheck's kernels in one warm prove: "
        f"{json.dumps({k: counts_prove[k] for k in FUSED_KERNELS})}")
    say(f"  {what} launches, one warm fused prove: {json.dumps(nz(counts_prove))}")
    say(f"  {what} launches, one warm looped prove: {json.dumps(nz(counts['looped']))}")
    say(f"  {what} launches, one verify: {json.dumps(nz(counts_verify))}")
    return {"nizk_prove": counts_prove, "nizk_prove_looped": counts["looped"],
            "nizk_verify": counts_verify}


def nizk_profile(prove) -> str:
    """One prove under torch.profiler: the number of CUDA kernels it ran
    and their summed device time, the six largest by name, and the
    row-major product's device time and launches, by size class too
    (tools/exp_mont_rm.py)."""
    p = exp_mont_rm.prove_profile(prove)
    if not p["kernels"]:
        return "device kernels of one prove under torch.profiler: not measured (no device events)"
    classes = "; ".join(
        f"{k} {c['launches']}" + ("" if c["device_ms"] is None else f" ({c['device_ms']:.4f} ms)")
        for k, c in p["by_class"].items())
    return (f"one prove under torch.profiler: {p['kernels']} CUDA kernels, {p['device_ms']:.1f} ms "
            f"of device time in a {p['wall_ms_profiled']:.1f} ms prove (profiled); largest: "
            + "; ".join(f"{name[:60]} {ms:.1f} ms x {cnt}" for name, ms, cnt in p["largest"])
            + f"\n    mont_mul_rm: {p['mont_mul_rm_ms']:.4f} ms of device time over "
            f"{p['mont_mul_rm_launches']} launches; by size class: {classes}")


def nizk_phase_profile(prove) -> str:
    """One prove under torch.profiler with a synchronise where each of the
    prover's timer labels starts and stops (so that a phase's kernels run
    inside its range): the CUDA kernels and their device time by phase,
    each kernel given to the range its device start falls in."""
    from torch.profiler import ProfilerActivity, profile, record_function

    plain_timer = r1csproof.Timer
    labels = set()

    class RangeTimer(plain_timer):
        def __init__(self, label):
            torch.cuda.synchronize()
            labels.add(label)
            self.range = record_function(label)
            self.range.__enter__()
            super().__init__(label)

        def stop(self):
            torch.cuda.synchronize()
            self.range.__exit__(None, None, None)
            return super().stop()

    r1csproof.Timer = RangeTimer
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prove()
            torch.cuda.synchronize()
    finally:
        r1csproof.Timer = plain_timer
    events = prof.events()
    # the ranges themselves also appear on the device's timeline: leave them out
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in labels]
    if not kernels:
        return "kernels by phase: not measured (no device events)"
    ranges = {e.name: (e.time_range.start, e.time_range.end) for e in events
              if e.name in NIZK_LABELS and e.device_type == torch.autograd.DeviceType.CPU}
    split, left = {}, list(kernels)
    for label, short in NIZK_LABELS.items():
        if label not in ranges:
            split[short] = "not measured (no range)"
            continue
        lo, hi = ranges[label]
        inside = [k for k in left if lo <= k.time_range.start <= hi]
        left = [k for k in left if not lo <= k.time_range.start <= hi]
        split[short] = [len(inside), round(sum(k.time_range.elapsed_us() for k in inside) / 1e3, 4)]
    split["rest"] = [len(left), round(sum(k.time_range.elapsed_us() for k in left) / 1e3, 4)]
    split["all"] = [len(kernels), round(sum(k.time_range.elapsed_us() for k in kernels) / 1e3, 4)]
    return f"kernels by phase [count, device ms] (profiled, synchronised at the labels): {json.dumps(split)}"


def phase_harness(dev):
    """The chained-product harness as its user runs it; returns the launches
    it made."""
    build.reset_launches()
    exp_montmul.run(dev, say=say)
    return dict(build.LAUNCHES)


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


def wsum_buckets(dev, grp, proj, ncols: int):
    """(rows, ncols) buckets for the weighted sum: the projective multiples
    tiled, with the identity in columns 0, 5 and 33, and in the first group
    of 32 columns 31 = 30 (the scan's run doubles) and 29 = -(30 + 31) (the
    run returns to the identity)."""
    Gp = grp.Gp
    b = proj.repeat(1, -(-ncols // N_UNIQUE))[:, :ncols].clone()
    for i in (0, 5, 33):
        b[:, i] = Gp.identity_packed(1, device=dev)[:, 0]
    b[:, 31] = b[:, 30]
    two = Gp.add2(b[:, 30:31].contiguous(), b[:, 31:32].contiguous())
    b[:, 29] = Gp.pack(grp.neg(Gp.unpack(two)))[:, 0]
    return b.contiguous()


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


def kernels_rowmajor(dev, rep: Report, quick: bool):
    """The row-major Montgomery product: Fr at (2^20, 16) with ONE shared
    second operand (a table times a scalar), Fq at (393216, 24) with two full
    operands (K1's shape), and Fr at (2^16, 16) with two full operands (the
    sumcheck's products of two tables, TestudoNIZK at 2^16), each compared at
    a ragged length.  A row's `ms` is the kernel's own device time
    (torch.profiler) with the L2 cache flushed before each launch, so that
    the operands come from HBM as `bound_ms` assumes, beside `kernel_l2_ms`
    (back-to-back launches, operands that fit left in L2), `raw_ms` (CUDA
    events around back-to-back raw launches) and `call_ms` (through
    `field.mont_mul`, as the paths call it),
    and the compiler's resource lines; the (2^16, 16) row also carries the
    NIZK's smaller tables (2^15 .. 1) and the floor of one launch plus one
    dependent product (tools/exp_mont_rm.py).  Beside each, the path it
    replaced behind `field.mont_mul`: K1 on (n, m) rows plus the copies
    around it."""
    ptxas = exp_mont_rm.ptxas()
    flush = exp_mont_rm.l2_flusher(dev)
    for name, spec, n_main, shared, madd in (
            ("mont_mul_rm_fr", FR, 1 << 20, True, MADD_FR),
            ("mont_mul_rm_fq", FQ, 6 << 16, False, MADD_FQ),
            ("mont_mul_rm_fr_full", FR, 1 << 16, False, MADD_FR)):
        p = spec.modulus
        n = (1 << 12 if quick else n_main) + ODD
        rng = np.random.default_rng(31)
        vals = rng.integers(0, 1 << 16, size=(2, n, spec.nlimbs), dtype=np.int64)
        vals[:, :, -1] &= 0x00FF if spec is FQ else 0x0FFF  # below p
        edges = np.asarray(spec.to_limbs([0, 1, p - 1, spec.r_mod_p, p - 1]))
        vals[0, :5] = edges
        vals[1, :5] = edges[::-1]
        a, b = (torch.as_tensor(v.astype(np.int32), device=dev) for v in vals)
        if shared:
            b = b[7].clone()
        got = tf.mont_mul(spec, a, b)
        want = tf.mont_mul_plain(spec, a, b)
        if shared:  # a broadcast that is no single element is expanded: same limbs
            three = a[: 3 * (n // 3)].reshape(3, n // 3, spec.nlimbs)
            row = a[None, : n // 3]
            if not torch.equal(tf.mont_mul(spec, three, row), tf.mont_mul_plain(spec, three, row)):
                raise AssertionError("row-major kernel: a broadcast operand gives other limbs")
        a0 = a[: n - ODD].contiguous()
        b0 = b if shared else b[: n - ODD].contiguous()
        plain = time_ms(lambda: tf.mont_mul_plain(spec, a0, b0), 1)

        def old_path():  # what field.mont_mul did before: to (n, m) rows, K1, back
            at = a0.T.contiguous()
            bt = b0.expand(a0.shape).T.contiguous()
            return packed_field.mont_mul_rows(spec, at, bt).T.contiguous()

        if not torch.equal(old_path(), got[: n - ODD]):
            raise AssertionError("row-major kernel differs from K1 on transposed operands")
        old_ms = time_ms(old_path, 20)
        lanes = n - ODD
        label = (f"({lanes}, {spec.nlimbs}) {spec.name}, " +
                 ("one shared second operand" if shared else "two full operands"))
        m = exp_mont_rm.measure_shape(label, spec, lanes, shared, dev, flush=flush)
        if m["kernel_ms"] is None:
            raise AssertionError("torch.profiler saw no device time of the row-major kernel")
        nbytes = (2 if shared else 3) * spec.nlimbs * 4 * lanes + (spec.nlimbs * 4 if shared else 0)
        rep.add(name, got, want, m["kernel_ms"], plain, nbytes, madd * lanes,
                label + f"; K1 with its transposes at this shape: {old_ms:.4f} ms")
        extra = {"kernel_ms": m["kernel_ms"], "kernel_l2_ms": m["kernel_l2_ms"],
                 "raw_ms": m["raw_ms"], "call_ms": m["call_ms"], "ptxas": ptxas}
        if name == "mont_mul_rm_fr_full":
            extra["floor_ms"] = exp_mont_rm.floor_ms(dev)["floor_ms"]
            extra["shapes"] = [
                {k: v for k, v in exp_mont_rm.measure_shape(lbl, sp, k_n, sh, dev, flush).items()
                 if k in ("shape", "kernel_ms", "kernel_l2_ms", "raw_ms", "call_ms", "bound_ms")}
                for lbl, sp, k_n, sh in exp_mont_rm.SHAPES if k_n < n_main]
            for r in extra["shapes"]:
                say(f"  {r['shape']}: kernel {r['kernel_ms']:.5f} ms, L2-warm "
                    f"{r['kernel_l2_ms']:.5f}, raw {r['raw_ms']:.5f}, "
                    f"call {r['call_ms']:.5f}, bound {r['bound_ms']:.6f}")
            say(f"  floor (one launch plus one dependent Fr product): {extra['floor_ms']:.5f} ms")
        rep.rows[name].update(extra)
        say(f"  raw launches {m['raw_ms']:.5f} ms, through field.mont_mul {m['call_ms']:.5f} ms; "
            f"the same product through K1 and its transposes: {old_ms:.4f} ms")


def kernels_chain(dev, rep: Report, quick: bool):
    """The chained-product kernels against K applications of the plain
    product (compared at K = 8, at the TPU harnesses' shapes plus a ragged
    edge), both formulations and both variants; timed at K = 64 on the lanes
    that fill the card."""
    K = exp_montmul.K_LO
    G = exp_montmul.GROUP
    for spec in (FQ, FR):
        L = exp_montmul.L_REFERENCE + ODD
        a = exp_montmul.random_rows(spec, (spec.nlimbs, L), 41, dev)
        b = exp_montmul.random_rows(spec, (spec.nlimbs, L), 42, dev)
        a[:, :3] = torch.as_tensor(spec.to_limbs([0, 1, spec.modulus - 1]).T.copy(), device=dev)
        want, plain = timed_once(lambda: packed_field.mont_mul_chain_plain(spec, a, b, K))
        got = [packed_field.mont_mul_chain(spec, a, b, K, inline_body=f) for f in (True, False)]
        Lg = exp_montmul.L_REFERENCE_GROUP + ODD
        ag = exp_montmul.random_rows(spec, (G, spec.nlimbs, Lg), 43, dev)
        bg = exp_montmul.random_rows(spec, (G, spec.nlimbs, Lg), 44, dev)
        want_g, plain_g = timed_once(lambda: packed_field.mont_mul_chain_plain(spec, ag, bg, K))
        got_g = {v: [packed_field.mont_mul_chain_group(spec, ag, bg, K, v, inline_body=f)
                     for f in (True, False)] for v in ("seq", "wide")}
        for t in got:
            if max_abs_err(t, want) != 0:
                raise AssertionError(f"chain kernel ({spec.name}) differs from its plain version")
        for v, ts in got_g.items():
            for t in ts:
                if max_abs_err(t, want_g) != 0:
                    raise AssertionError(f"chain kernel {v} ({spec.name}) differs from its plain version")
        say(f"chain kernels ({spec.name}): inline, call, seq and wide equal K = {K} applications "
            f"of the plain product at ({spec.nlimbs}, {L}) and ({G}, {spec.nlimbs}, {Lg})")
        if spec is not FQ:
            continue
        # rows: Fq, K = 64, the card-filling lane count
        Lc = 1 << 12 if quick else exp_montmul.L_CARD
        K64 = exp_montmul.K_HI
        ac = exp_montmul.random_rows(spec, (G, spec.nlimbs, Lc // G), 45, dev)
        bc = exp_montmul.random_rows(spec, (G, spec.nlimbs, Lc // G), 46, dev)
        a1 = exp_montmul.random_rows(spec, (spec.nlimbs, Lc), 47, dev)
        b1 = exp_montmul.random_rows(spec, (spec.nlimbs, Lc), 48, dev)
        lanes = (Lc // G) * G
        rep.add("mont_chain", got[0], want,
                time_ms(lambda: packed_field.mont_mul_chain(spec, a1, b1, K64), 5), plain,
                3 * spec.nlimbs * 4 * Lc, MADD_FQ * K64 * Lc,
                f"({spec.nlimbs}, {Lc}) Fq, K = {K64}, inlined body; compared at K = {K}, "
                f"({spec.nlimbs}, {L}), both formulations, plain_ms from there")
        for v in ("seq", "wide"):
            rep.add("mont_chain_" + v, got_g[v][0], want_g,
                    time_ms(lambda: packed_field.mont_mul_chain_group(spec, ac, bc, K64, v), 5),
                    plain_g, 3 * spec.nlimbs * 4 * lanes, MADD_FQ * K64 * lanes,
                    f"({G}, {spec.nlimbs}, {Lc // G}) Fq, K = {K64}; compared at K = {K}, "
                    f"({G}, {spec.nlimbs}, {Lg}), both formulations, plain_ms from there")


def kernels_commit_bucket(dev, rep: Report, canon, basis):
    """The general bucket kernel at the commit's own arguments (the shared
    table, K * W lanes of N adds each).  A ragged subset of the real lanes
    (taken across all columns and windows, most with the full run of N, a few
    cut short or empty) goes through the kernel and through its plain version
    on the same table and index list, and must agree limb for limb; the whole
    launch is timed beside its bound.  The figures go into the `bucket` row as
    extra keys."""
    Gp = G1P
    c = msm._pick_window(canon.shape[1])
    ptcat = msm._cat_points(basis)
    table = msm._multi_msm_table(Gp, ptcat, c)
    K, N, _ = canon.shape
    idx, start, count = msm._multi_msm_index(canon, c)
    lanes = start.shape[0]
    n_cmp = 64 + ODD
    W = lanes // K
    # top window first (its digits are nearly all 0: identity adds), then a
    # stride through every column and window
    pick = torch.as_tensor([W - 1] + [(i * (lanes // n_cmp + 1)) % lanes for i in range(1, n_cmp)],
                           device=dev)
    st, ct = start[pick].contiguous(), count[pick].clone()
    ct[-4:] = torch.as_tensor([N - 3, N // 2 + 5, 1, 0], dtype=torch.int32, device=dev)
    got = Gp.bucket_phase(table, idx, st, ct)
    want, plain = timed_once(lambda: Gp.bucket_phase_plain(table, idx, st, ct))
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"kernel bucket differs from its plain version at the commit's shape: {err}")
    ms = time_ms(lambda: Gp.bucket_phase(table, idx, start, count), 3)
    adds = lanes * N
    b_ms, b_by = bound(adds * (Gp.rows * 4 + 4) + lanes * (8 + Gp.rows * 4), adds * 12 * MADD_FQ)
    profile = run_profile(Gp, count, False)
    say(f"run-length profile, bucket at the commit's shape: {profile}")
    shape = (f"table ({table.shape[0]}, {Gp.rows}), {lanes} lanes x {N} adds = {adds} general adds, "
             f"{profile}; compared on {n_cmp} of these lanes ({int(ct.sum())} adds, runs of {N} "
             f"down to 0), plain_ms from there")
    say(f"kernel bucket at the commit's shape: equal to plain version at {shape}: "
        f"ms={ms:.3f} plain_ms={plain:.2f} bound_ms={b_ms:.4f} ({b_by})")
    idx_ms = time_ms(lambda: msm._multi_msm_index(canon, c), 3)
    tab_ms = time_ms(lambda: msm._multi_msm_table(Gp, ptcat, c), 3)
    seq_ms = time_ms(lambda: Gp.chain_steps(ptcat, 1 << c, Gp.add2), 3)
    say(f"  digit extraction and index build: {idx_ms:.3f} ms; table build (one chain_team launch "
        f"over {N} bases): {tab_ms:.3f} ms; the {(1 << c) - 1} add2 launches and re-layout it "
        f"replaced: {seq_ms:.3f} ms")
    rep.rows["bucket"].update({"commit_shape": shape, "commit_max_abs_err": err, "commit_ms": ms,
                               "commit_plain_ms": plain, "commit_bound_ms": b_ms,
                               "commit_bound_by": b_by})


def kernels_wsum(dev, grp, rep: Report, proj, rounds: int, lat_us: float, quick: bool):
    """The weighted-sum kernel of one group: one launch for all per-group
    sums of an MSM.  Compared with the plain version (the sequence of scan,
    ladder and add steps on the plain ops) at the signed c = 13 plan's shape
    with one more window (21 x 128 lanes: every weight bit, plus_one), and
    at 2,560 + ODD lanes of one group of 32 each (c = 5: a ragged last
    block), plus_one both ways; the buckets hold the identity and
    neighbours that make the scan double and cancel.  Timed at the plan's
    2,560 lanes beside the plain version (once, on the compared call) and
    the launch sequence it replaced (32 scan2b, 12 step, 2 add2 and the host
    loop).  latency_bound_ms: the lane's chain of dependent group operations
    (h scan steps, maxbits ladder steps, the closing adds) times the
    `rounds` of dependent products each needs (2 for G1, 3 for G2) times one
    product's latency."""
    Gp = grp.Gp
    rows = Gp.rows
    pt_bytes = rows * 4
    m_add, _, m_double = (m * MADD_FQ for m in grp.muls)
    nm = lambda kernel: counter(grp, kernel)

    cw = msm._SIGNED_C - 1
    Ww = 2 if quick else 20
    Wo = 256 + ODD if quick else 20 * 128 + ODD
    g_buckets = wsum_buckets(dev, grp, proj, (Ww + 1) << cw)
    o_buckets = wsum_buckets(dev, grp, proj, Wo << 5)
    got = (Gp.weighted_sum(g_buckets, Ww + 1, cw, True),
           Gp.weighted_sum(o_buckets, Wo, 5, True), Gp.weighted_sum(o_buckets, Wo, 5, False))
    want_w, plain = timed_once(lambda: Gp.weighted_sum_plain(g_buckets, Ww + 1, cw, True))
    want = (want_w, Gp.weighted_sum_plain(o_buckets, Wo, 5, True),
            Gp.weighted_sum_plain(o_buckets, Wo, 5, False))
    t_buckets = g_buckets[:, : Ww << cw].contiguous()
    ms = time_ms(lambda: Gp.weighted_sum(t_buckets, Ww, cw, True), 20)
    seq = lambda: Gp.weighted_sum_steps(t_buckets, Ww, cw, True, Gp.scan2b, Gp.step, Gp.add2)
    if not torch.equal(seq(), Gp.weighted_sum(t_buckets, Ww, cw, True)):
        raise AssertionError(f"kernel {nm('wsum')} differs from the launch sequence it replaced")
    seq_ms = time_ms(seq, 5)
    h, groups, maxbits = Gp.wsum_plan(cw)
    nl = Ww * groups
    chain = h + maxbits + 2  # plus_one: two closing adds
    rep.add(nm("wsum"), got, want, ms, plain, (Ww << cw) * pt_bytes + nl * pt_bytes,
            nl * ((2 * h + maxbits + 2) * m_add + maxbits * m_double),
            f"({rows}, {Ww << cw}) buckets -> {nl} lanes (W = {Ww}, c = {cw}: {h} buckets a "
            f"group, {maxbits} weight bits, plus_one); compared at {(Ww + 1) * groups} lanes and "
            f"at {Wo} lanes of c = 5 (plus_one both ways), plain_ms from the first")
    rep.rows[nm("wsum")].update({
        # with scan2b (:450), the step kernel as the reference's weighted sum drives them
        "replaces_also": [_EC + ":424", "testudo_tpu/tpu/msm.py:673"],
        "latency_bound_ms": chain * rounds * lat_us / 1e3, "latency_us_per_product": lat_us,
        "launch_sequence_ms": seq_ms})
    say(f"  {nm('wsum')}: {ms:.4f} ms at {nl} lanes (the launch sequence it replaced: "
        f"{seq_ms:.4f} ms); latency bound {chain * rounds * lat_us / 1e3:.4f} ms")


def ptxas_of(kernel: str, ncomp: int) -> list:
    """The compiler's resource lines of a kernel template's instantiations
    for the group (build report)."""
    coord = "FqCoord" if ncomp == 1 else "Fq2Coord"
    return [ln for ln in build.build_report()["ptxas"]
            if ln.startswith((f"{kernel}<{coord},", f"{kernel}<{coord}>"))]


def fold_shapes(ncomp: int, quick: bool) -> dict:
    """The segments (offsets, lengths) each path hands the fold kernel: the
    MSM's fold of 20 windows' 128 groups, its Horner tree of 20, the open's
    parts 512 .. 1 (`msm_multi_small`) and two segments of 512
    (`msm_segmented`), and for G1 the commit's 1,024 columns of 32 windows."""
    k = 8 if quick else 1  # quick: narrower segments
    shapes = {
        "msm": ([128 * w for w in range(20)], [128] * 20),
        "horner": ([0], [20]),
        "open_parts": ([1024 // k - (1 << (e + 1)) for e in range(9 - k.bit_length() + 1, -1, -1)],
                       [1 << e for e in range(9 - k.bit_length() + 1, -1, -1)]),
        "open_segments": ([0, 512 // k], [512 // k] * 2),
    }
    if ncomp == 1:
        shapes["commit"] = ([32 * i for i in range(1024 // k)], [32] * (1024 // k))
    return shapes


def fold_batch(dev, grp, proj, L: int) -> torch.Tensor:
    """(rows, L) projective points for the folds: the multiples tiled, the
    identity in columns 3 and 4, and where L > 65 column 64 = column 0 (a
    doubling in the first level of a segment of 128) and column 65 =
    -column 1 (a sum that is the identity)."""
    Gp = grp.Gp
    a, _ = edge_points(dev, grp, proj, L)
    if L > 65:
        a[:, 64] = a[:, 0]
        a[:, 65] = Gp.pack(grp.neg(Gp.unpack(a[:, 1:2].contiguous())))[:, 0]
    return a.contiguous()


def kernels_chain_fold(dev, grp, rep: Report, proj, rounds: int, lat_us: float, quick: bool):
    """The chain kernel (the commit's table of multiples) and the fold kernel
    (every tree of pairwise adds) of one group against their plain versions,
    the sequences of `add2_plain` calls they replaced, and timed beside the
    `add2` launch sequences (`chain_steps`, `fold_steps` on the kernel).

    Chain: compared at 1,024 + ODD bases (the identity and a base and its
    negative among them) and B = 256, timed at the commit's 1,024.  Fold:
    compared at every shape of `fold_shapes` with one more segment of ODD
    points, timed at each shape as it is; the row's `ms` is the MSM's.
    bound_ms: the points read and written once against the adds' products;
    latency_bound_ms: the dependent adds of a lane (B - 1; a fold's levels)
    times the add's rounds of dependent products times one product's
    latency."""
    Gp = grp.Gp
    rows = Gp.rows
    pt_bytes = rows * 4
    m_add = grp.muls[0] * MADD_FQ
    nm = lambda kernel: counter(grp, kernel)
    lat = lambda chain: chain * rounds * lat_us / 1e3

    N, B = (64, 16) if quick else (1024, 256)
    ptcat = fold_batch(dev, grp, proj, N + ODD).T.contiguous()
    got = Gp.chain(ptcat, B)
    want, plain = timed_once(lambda: Gp.chain_plain(ptcat, B))
    p0 = ptcat[:N].contiguous()
    ms = time_ms(lambda: Gp.chain(p0, B), 5)
    seq = lambda: Gp.chain_steps(p0, B, Gp.add2)
    if not torch.equal(seq(), Gp.chain(p0, B)):
        raise AssertionError(f"kernel {nm('chain_team')} differs from the launch sequence it replaced")
    seq_ms = time_ms(seq, 2)
    rep.add(nm("chain_team"), got, want, ms, plain, N * pt_bytes + N * B * pt_bytes,
            N * (B - 1) * m_add,
            f"({N}, {rows}) bases -> ({N * B}, {rows}) table, {B - 1} adds a base; compared at "
            f"{N + ODD} bases, plain_ms from there")
    rep.rows[nm("chain_team")].update({
        "replaces_also": ["testudo_tpu/tpu/msm.py:1045"],
        "latency_bound_ms": lat(B - 1), "latency_us_per_product": lat_us,
        "launch_sequence_ms": seq_ms, "ptxas": ptxas_of("k_chain_team", Gp.ncomp)})
    say(f"  {nm('chain_team')}: {ms:.4f} ms at {N} bases x {B - 1} adds (the {B - 1} add2 "
        f"launches it replaced: {seq_ms:.4f} ms); latency bound {lat(B - 1):.4f} ms")

    gots, wants, extra, plain = [], [], {}, None
    for name, (off, ln) in fold_shapes(Gp.ncomp, quick).items():
        end = max(o + n for o, n in zip(off, ln))
        a = fold_batch(dev, grp, proj, end + ODD)
        off_c, ln_c = off + [end], ln + [ODD]
        gots.append(Gp.fold(a, off_c, ln_c))
        want, p_ms = timed_once(lambda: Gp.fold_plain(a, off_c, ln_c))
        wants.append(want)
        a0 = a[:, :end].contiguous()
        k_ms = time_ms(lambda: Gp.fold(a0, off, ln), 10)
        seq = lambda: Gp.fold_steps(a0, off, ln, Gp.add2)
        if not torch.equal(seq(), Gp.fold(a0, off, ln)):
            raise AssertionError(f"kernel {nm('fold_team')} differs from the add2 sequence at {name}")
        s_ms = time_ms(seq, 5)
        b_ms, b_by = bound(sum(ln) * pt_bytes + len(ln) * pt_bytes, (sum(ln) - len(ln)) * m_add)
        l_ms = lat(max((n - 1).bit_length() for n in ln))
        if name == "msm":
            main = (k_ms, p_ms, sum(ln) * pt_bytes + len(ln) * pt_bytes, (sum(ln) - len(ln)) * m_add)
            extra.update({"latency_bound_ms": l_ms, "launch_sequence_ms": s_ms})
        extra.update({f"ms_{name}": k_ms, f"launch_sequence_ms_{name}": s_ms,
                      f"bound_ms_{name}": b_ms, f"latency_bound_ms_{name}": l_ms,
                      f"segments_{name}": f"{len(ln)} of {min(ln)}..{max(ln)}"})
        say(f"  {nm('fold_team')} at {name} ({len(ln)} segments of {min(ln)}..{max(ln)}): "
            f"{k_ms:.4f} ms (the add2 launches it replaced: {s_ms:.4f} ms); bound {b_ms:.5f} "
            f"({b_by}), latency bound {l_ms:.4f} ms")
    k_ms, p_ms, nbytes, madds = main
    rep.add(nm("fold_team"), tuple(gots), tuple(wants), k_ms, p_ms, nbytes, madds,
            f"({rows}, 2560) -> 20 segments of 128 (the MSM's fold of the groups); compared at "
            f"every path's segments plus one of {ODD} points, plain_ms from the MSM's")
    rep.rows[nm("fold_team")].update({
        "replaces_also": [_EC + ":717", "testudo_tpu/tpu/msm.py:712", "testudo_tpu/tpu/msm.py:1100"],
        "latency_us_per_product": lat_us, "ptxas": ptxas_of("k_fold_team", Gp.ncomp), **extra})


def fixed_base_inputs(dev, grp, N: int, seed: int):
    """(packed table of the 256 doublings of a base, (N, 16) canonical scalar
    limbs, the scalars): 252-bit random ones behind 0, 1, r - 1, 2 and
    2^252 (the top bit a canonical scalar can have)."""
    table = tc.fixed_base_table(grp.Gp, grp.mul(grp.gen(), 0xC0FFEE), 16 * FR.nlimbs, dev)
    scal = random_scalars(N, seed)
    edge = [0, 1, R - 1, 2, 1 << 252][:N]
    scal[: len(edge)] = FR.to_limbs(edge)
    return table, torch.as_tensor(scal, device=dev), [int(k) for k in FR.from_limbs(scal)]


def kernels_fixed_base(dev, grp, rep: Report, rounds: int, lat_us: float, quick: bool):
    """The fixed-base kernels of one group: the team kernel (`fixed_base`)
    at the setup's 2,047 lanes (nv = 20) and one thread per lane
    (`fixed_base_one`) at the fixed-base phase's 2^16.  Each is compared with
    the plain version (256 `add_mask_plain` calls) at its width + ODD lanes,
    edge scalars first (the 2^16 one on a stride of the lanes: a lane's
    result depends on its own scalar only), and with the other form; each is
    timed at its width beside the other form and the sequence of 256
    `add_mask` launches it replaced.  bound_ms: the set bits' complete adds
    against the products' multiply-adds (the `add_mask` row's convention);
    latency_bound_ms: the largest popcount of a lane's scalar times the
    add's rounds of dependent products times one product's latency, and for
    a form that runs all 256 steps the same with 256."""
    Gp = grp.Gp
    rows = Gp.rows
    m_add = grp.muls[0] * MADD_FQ
    nm = lambda kernel: counter(grp, kernel)
    kern = lambda kernel: (lambda t, k: Gp.fixed_base_launch(kernel, t, k))
    lat = lambda steps: steps * rounds * lat_us / 1e3
    for kernel, entry, other, N in (
            ("fixed_base", "k_fixed_base_team", "fixed_base_one", 63 if quick else 2047),
            ("fixed_base_one", "k_fixed_base_one", "fixed_base", 256 if quick else 1 << 16)):
        table, scal, ks = fixed_base_inputs(dev, grp, N + ODD, 37)
        got = kern(kernel)(table, scal)
        if not torch.equal(kern(other)(table, scal), got):
            raise AssertionError(f"{nm(kernel)} and {nm(other)} differ at {N + ODD} lanes")
        pick = torch.arange(N + ODD, device=dev)
        if N + ODD > 4096:  # the edge lanes, then a stride
            pick = torch.as_tensor(sorted({*range(5), *np.linspace(0, N + ODD - 1, 96).astype(int)}),
                                   device=dev)
        want, plain = timed_once(lambda: Gp.fixed_base_plain(table, scal[pick].contiguous()))
        t0, s0, k0 = table, scal[:N].contiguous(), ks[:N]
        ms = time_ms(lambda: kern(kernel)(t0, s0), 5)
        other_ms = time_ms(lambda: kern(other)(t0, s0), 3)
        seq_ms = time_ms(lambda: Gp.fixed_base_steps(t0, s0, Gp.add_mask), 3)
        pop = [bin(k).count("1") for k in k0]
        rep.add(nm(kernel), got[:, pick].contiguous(), want, ms, plain,
                table.numel() * 4 + N * FR.nlimbs * 4 + N * rows * 4, sum(pop) * m_add,
                f"({rows}, 256) table x ({N}, 16) scalars -> ({rows}, {N}), {sum(pop)} set bits; "
                f"compared at {N + ODD} lanes" + (f" on {len(pick)} of them" if len(pick) < N + ODD
                                                   else "") + ", plain_ms from there")
        rep.rows[nm(kernel)].update({
            "replaces_also": ["testudo_tpu/tpu/curve.py:429"],
            "latency_bound_ms": lat(max(pop)), "latency_bound_all_steps_ms": lat(16 * FR.nlimbs),
            "latency_us_per_product": lat_us, "launch_sequence_ms": seq_ms,
            f"{other}_ms": other_ms, "ptxas": ptxas_of(entry, Gp.ncomp)})
        say(f"  {nm(kernel)}: {ms:.4f} ms at {N} lanes ({other} {other_ms:.4f} ms; the 256 add_mask "
            f"launches it replaced: {seq_ms:.4f} ms); latency bound {lat(max(pop)):.4f} ms (all "
            f"256 steps {lat(16 * FR.nlimbs):.4f})")


def kernels_group(dev, grp, rep: Report, proj, pts_cmp, scal_cmp, pts_time, scal_time,
                  lat_us: float, quick: bool):
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

    rounds = 2 if Gp.ncomp == 1 else 3  # rounds of dependent products of an add or a step
    got, want = Gp.add2(a, b), Gp.add2_plain(a, b)
    rep.add(nm("add2"), got, want, time_ms(lambda: Gp.add2(a0, b0), 20),
            time_ms(lambda: Gp.add2_plain(a0, b0), 1),
            3 * pt_bytes * n0, m_add * n0, shape)
    rep.rows[nm("add2")].update({"latency_bound_ms": rounds * lat_us / 1e3,
                                 "latency_us_per_product": lat_us})

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

    # The ladders.  The team kernel takes the narrow launches: compared with
    # the plain version at the Horner combine's shape and data (20 window
    # sums times 2^(13 w); behind them lanes with scalars 0, 1, r-1, 2 and
    # random ones), timed there and at the open's widest fold (1,024 lanes,
    # random scalars).  The wide kernel takes the commit's Horner (scalars
    # 2^(8 w), lanes longest first as `_multi_horner_packed` orders them):
    # 32,768 lanes at nv = 20 and 8,192 in a prove, each compared on a
    # stride of its lanes.  The one-thread kernel over all bits, which it
    # replaced there, is compared and timed beside it, and so is the team
    # kernel.  Random scalars in no order at 4,096 lanes (the wide kernel's)
    # and 32,768 (the one-thread kernel's): each kernel timed, the
    # wrapper's pick beside them.  At every shape every
    # kernel must give the same limbs.  The plain ladder is a chain of 512
    # group operations whose time hardly depends on the lane count: it is
    # timed once, on the compared call.  latency_bound_ms: the scalars' top
    # bit times the rounds of dependent products a step needs (2, G2 3)
    # times one dependent product's latency at one warp (the harness's
    # latency mode).
    team = lambda p, k: Gp.ladder_launch("ladder_team", p, k)
    one = lambda p, k: Gp.ladder_launch("ladder", p, k)
    wide = lambda p, k, o=None: Gp.ladder_wide_launch(p, k, o)

    def ladder_need(ks):  # products an add per set bit and a double per bit need
        return sum(grp.muls[0] * bin(k).count("1") + grp.muls[2] * k.bit_length() for k in ks)

    def latency_ms(ks):
        return max(k.bit_length() for k in ks) * rounds * lat_us / 1e3

    def rows_of(ks):
        return torch.as_tensor(FR.to_limbs(ks).T.copy(), device=dev)

    Lh = 20 + ODD
    pts_h, _ = edge_points(dev, grp, proj, Lh)
    ks = [1 << (msm._SIGNED_C * w) for w in range(20)] + [0, 1, R - 1, 2]
    ks += [int(v) for v in FR.from_limbs(random_scalars(Lh - len(ks), 23))]
    scal_h = rows_of(ks)
    if quick:  # the plain ladder walks all 256 bits: two limb rows are enough here
        scal_h = scal_h[:2].contiguous()
    got = team(pts_h, scal_h)
    want, plain = timed_once(lambda: Gp.ladder_plain(pts_h, scal_h))
    if not torch.equal(one(pts_h, scal_h), want):
        raise AssertionError(f"kernel {nm('ladder')} differs from its plain version at the Horner shape")
    p20, s20 = pts_h[:, :20].contiguous(), rows_of(ks[:20])
    t20, o20 = time_ms(lambda: team(p20, s20), 5), time_ms(lambda: one(p20, s20), 5)
    L1 = 64 if quick else 1024
    p1, _ = edge_points(dev, grp, proj, L1)
    k1 = [int(v) for v in FR.from_limbs(random_scalars(L1, 29))]
    s1 = rows_of(k1)
    if not torch.equal(team(p1, s1), one(p1, s1)):
        raise AssertionError(f"{nm('ladder_team')} and {nm('ladder')} differ at {L1} lanes")
    t1, o1 = time_ms(lambda: team(p1, s1), 5), time_ms(lambda: one(p1, s1), 5)
    b1, _ = bound((2 * pt_bytes + 16 * 4) * L1, ladder_need(k1) * MADD_FQ)
    rep.add(nm("ladder_team"), got, want, t20, plain, (2 * pt_bytes + 16 * 4) * 20,
            ladder_need(ks[:20]) * MADD_FQ,
            f"({rows}, 20) x 256 bits, scalars 2^(13 w); compared at "
            f"{Lh} lanes, plain_ms from there; also timed at ({rows}, {L1}), random scalars")
    rep.rows[nm("ladder_team")].update({
        "latency_bound_ms": latency_ms(ks[:20]), "latency_us_per_product": lat_us,
        "one_thread_ms": o20, f"ms_{L1}": t1, f"one_thread_ms_{L1}": o1,
        f"bound_ms_{L1}": b1, f"latency_bound_ms_{L1}": latency_ms(k1)})
    say(f"  {nm('ladder_team')}: 20 lanes {t20:.4f} ms (one thread {o20:.4f}), {L1} lanes "
        f"{t1:.4f} ms (one thread {o1:.4f}); latency bound {latency_ms(ks[:20]):.4f} / "
        f"{latency_ms(k1):.4f} ms")

    # the commit's Horner: K columns of 32 windows, lanes k-major
    # points in and out, scalars, and the wide kernel's order
    ladder_bytes = lambda L, order=True: (2 * pt_bytes + 16 * 4 + 4 * order) * L
    shapes = {}
    for Lc in ((2048, 512) if quick else (32768, 8192)):
        pc, _ = edge_points(dev, grp, proj, Lc)
        kc = [1 << (8 * (l % 32)) for l in range(Lc)]
        sc = rows_of(kc)
        oc = torch.as_tensor(np.argsort([-k.bit_length() for k in kc], kind="stable")
                             .astype(np.int32), device=dev)
        gotw, goto = wide(pc, sc, oc), one(pc, sc)
        if not torch.equal(gotw, goto) or not torch.equal(team(pc, sc), goto):
            raise AssertionError(f"the ladder kernels of {grp.name} differ at {Lc} lanes")
        pick = torch.as_tensor(sorted({int(i) for i in np.linspace(0, Lc - 1, 64 + ODD)}), device=dev)
        wantc, plainc = timed_once(
            lambda: Gp.ladder_plain(pc[:, pick].contiguous(), sc[:, pick].contiguous()))
        shapes[Lc] = dict(
            got_wide=gotw[:, pick].contiguous(), got_one=goto[:, pick].contiguous(), want=wantc,
            plain=plainc, wide=time_ms(lambda: wide(pc, sc, oc), 3),
            one=time_ms(lambda: one(pc, sc), 3), team=time_ms(lambda: team(pc, sc), 3),
            need=ladder_need(kc) * MADD_FQ,
            latency=latency_ms(kc), compared=len(pick))
        del pc, sc, oc, gotw, goto
    (Lc, sh), (Lp, sp) = shapes.items()
    # random scalars in no order
    random_rows = {}
    for Lr in ((256, 2048) if quick else (4096, 32768)):
        pr_, _ = edge_points(dev, grp, proj, Lr)
        sr = rows_of([int(v) for v in FR.from_limbs(random_scalars(Lr, 31))])
        goto = one(pr_, sr)
        if not torch.equal(wide(pr_, sr), goto):
            raise AssertionError(f"{nm('ladder_wide')} and {nm('ladder')} differ at {Lr} random lanes")
        random_rows[Lr] = (Gp.ladder_kernel(Lr), time_ms(lambda: wide(pr_, sr), 3),
                           time_ms(lambda: one(pr_, sr), 3))
        del pr_, sr, goto
    notes = {
        "ladder_wide": "lanes longest first, each to its top bit",
        "ladder": "lanes in index order, every bit",
    }
    for name, got_key, ms_key in (("ladder_wide", "got_wide", "wide"), ("ladder", "got_one", "one")):
        rep.add(nm(name), sh[got_key], sh["want"], sh[ms_key], sh["plain"],
                ladder_bytes(Lc, name == "ladder_wide"), sh["need"],
                f"({rows}, {Lc}) x 256 bits, scalars 2^(8 w) (the commit's Horner), "
                f"{notes[name]}; compared on {sh['compared']} of these lanes, plain_ms from "
                f"there; also at ({rows}, {Lp}) (a prove's witness commit) and random scalars at "
                f"{' and '.join(str(L) for L in random_rows)} lanes")
        if max_abs_err(sp[got_key], sp["want"]) != 0:
            raise AssertionError(f"kernel {nm(name)} differs from its plain version at {Lp} lanes")
    b_p, _ = bound(ladder_bytes(Lp), sp["need"])
    rep.rows[nm("ladder_wide")].update({
        "latency_bound_ms": sh["latency"], "latency_us_per_product": lat_us,
        "one_thread_ms": sh["one"], "team_ms": sh["team"],
        f"ms_{Lp}": sp["wide"], f"one_thread_ms_{Lp}": sp["one"], f"team_ms_{Lp}": sp["team"],
        f"plain_ms_{Lp}": sp["plain"], f"bound_ms_{Lp}": b_p, f"latency_bound_ms_{Lp}": sp["latency"],
        **{f"random_{key}_{Lr}": v for Lr, row in random_rows.items()
           for key, v in zip(("in_use", "ms", "one_thread_ms"), row)},
        "ptxas": ptxas_of("k_ladder_wide", Gp.ncomp)})
    rep.rows[nm("ladder")].update({
        "latency_bound_ms": sh["latency"], "latency_us_per_product": lat_us,
        "wide_ms": sh["wide"], "team_ms": sh["team"], f"ms_{Lp}": sp["one"],
        f"plain_ms_{Lp}": sp["plain"], f"bound_ms_{Lp}": bound(ladder_bytes(Lp, False), sp["need"])[0]})
    say(f"  {nm('ladder_wide')}: {Lc} lanes {sh['wide']:.4f} ms (one thread over all bits "
        f"{sh['one']:.4f}, team kernel {sh['team']:.4f}), {Lp} lanes {sp['wide']:.4f} ms "
        f"({sp['one']:.4f}, {sp['team']:.4f}); random: " +
        ", ".join(f"{Lr} lanes {w:.4f} ms (one thread over all bits {o:.4f}; the wrapper takes "
                  f"{k})" for Lr, (k, w, o) in random_rows.items()) + "; bound "
        f"{rep.rows[nm('ladder_wide')]['bound_ms']:.4f} / {b_p:.4f} ms, latency bound "
        f"{sh['latency']:.4f} / {sp['latency']:.4f} ms")

    kernels_wsum(dev, grp, rep, proj, rounds, lat_us, quick)
    kernels_chain_fold(dev, grp, rep, proj, rounds, lat_us, quick)
    kernels_fixed_base(dev, grp, rep, rounds, lat_us, quick)

    # the bucket kernels with the exact arguments of a main path, plus a tail
    # of hand-made lanes: count 0, a doubling lane, a long lane that ends at
    # the last entry of idx (the kernel must not read past it).  The plain
    # version walks every lane through the longest run, so it is timed once,
    # on the compared call.
    table, order_flat, start, count, lane_off, nseg, T_cap = msm_plan(grp, pts_cmp, scal_cmp)
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
    cmp_note = (f"compared at table ({table.shape[0]}, {rows}), {len(st)} lanes "
                f"({run_profile(Gp, ct, True, T_cap)}), plain_ms from there")
    seg_cmp_note = f"compared at {len(nseg)} lanes ({run_profile(Gp, nseg, False)}), plain_ms from there"

    # timing (and the bound) at the plan of the largest size
    if pts_time is not pts_cmp:
        del table, order_flat, idx, tab2, seg_cmp
        table, order_flat, start, count, lane_off, nseg, T_cap = msm_plan(grp, pts_time, scal_time)
        st_t, ct_t = torch.as_tensor(start, device=dev), torch.as_tensor(count, device=dev)
        s0, c0 = st_t, ct_t
    else:
        s0, c0 = st_t[:-3].contiguous(), ct_t[:-3].contiguous()
    adds = int(c0.sum())
    lanes6 = s0.shape[0]
    ms = time_ms(lambda: Gp.bucket_phase(table, order_flat, s0, c0, mixed=True), 3)
    comp_bytes = 24 * 4 * Gp.ncomp  # one coordinate of one point
    profile = run_profile(Gp, c0, True, T_cap)
    say(f"run-length profile, {nm('bucket_mixed')} at the timed plan: {profile}")
    rep.add(nm("bucket_mixed"), got, want, ms, plain,
            adds * (2 * comp_bytes + 4) + lanes6 * (8 + pt_bytes), adds * m_mixed,
            f"table ({table.shape[0]}, {rows}), {adds} adds, {profile}; {cmp_note}")

    seg_sums = Gp.bucket_phase(table, order_flat, s0, c0, mixed=True)
    if quick:
        lane_off = np.arange(0, lanes6 - 8, 4, dtype=np.int32)
        nseg = (np.arange(len(lane_off)) % 5).astype(np.int32)
    tab2 = seg_sums.T.contiguous()
    lo_t, ns_t = torch.as_tensor(lane_off, device=dev), torch.as_tensor(nseg, device=dev)
    adds = int(nseg.sum())
    profile = run_profile(Gp, nseg, False)
    say(f"run-length profile, {nm('bucket')} (segment reduce) at the timed plan: {profile}")
    rep.add(nm("bucket"), got2, want2,
            time_ms(lambda: Gp.bucket_phase(tab2, None, lo_t, ns_t), 3), plain2,
            adds * pt_bytes + len(nseg) * (8 + pt_bytes), adds * m_add,
            f"table ({tab2.shape[0]}, {rows}), {adds} adds, {profile}; {seg_cmp_note}")
    rep.max_nseg[grp.name] = int(nseg.max())


def _random_elements(spec, shape, rng, dev) -> torch.Tensor:
    """Canonical elements (limbs below p) of the given leading shape, 0, 1 and
    p - 1 first along the flattened order."""
    vals = rng.integers(0, 1 << 16, size=tuple(shape) + (spec.nlimbs,), dtype=np.int64)
    vals[..., -1] &= 0x00FF if spec is FQ else 0x0FFF
    flat = vals.reshape(-1, spec.nlimbs)
    edges = spec.to_limbs([0, 1, spec.modulus - 1])[: len(flat)]
    flat[: len(edges)] = edges
    return torch.as_tensor(flat.reshape(vals.shape).astype(np.int32), device=dev)


def all_kernels_ms(fn, once: str, reps: int = 20) -> float:
    """Device milliseconds a call of fn, all its CUDA kernels summed
    (torch.profiler over `reps` calls after a warm-up), over the calls the
    profiler saw: those of the kernel named `once`, which fn launches once
    (the profiler drops an event now and then)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    calls = sum(once in e.name for e in evs)
    return sum(e.time_range.elapsed_us() for e in evs) / calls / 1e3 if calls else None


POS_PRODUCTS = 5 * (3 * 8 + 31) + 9 * 39  # a permutation: S-boxes (x^17) and MDS rows
POS_DEPENDENT = 39 * 6  # its chain of dependent products: 5 a round's S-box, 1 its MDS


def _round_work(kind, n, k_par, k_seq, fold, nblocks):
    """(bytes, products, dependent products) of one round launch on n-row
    tables over `nblocks` blocks a row: every table read once, the folded
    half written once, the partial sums; the fold's 2 products a table a
    pair and the combination's products; a thread's chain in the tiled
    body (one fold product, then the combination's one or two)."""
    T = sk.stack_size(kind, k_par, k_seq)
    k = len(sk.instance_tables(kind, k_par, k_seq))
    pairs = n // 4 if fold else n // 2
    comb = exp_sumcheck_round.CHAIN[kind] * sk.POINTS[kind] * k
    nbytes = T * n * 64 + (T * n // 2 * 64 if fold else 0) + k * nblocks * sk.POINTS[kind] * 64
    return (nbytes, pairs * ((2 * T if fold else 0) + comb),
            exp_sumcheck_round.round_work(kind, n, fold, k_par, k_seq)[1])


def kernels_sumcheck(dev, rep: Report, lat_fq: float, lat_fr: float, quick: bool):
    """The fused sumcheck's kernels against their plain versions, exactly.

    Poseidon: one launch on ODD Fr and ODD Fq states (0, 1, p - 1 among the
    limbs), timed on one state (the prove's shape) by its device time
    (torch.profiler); latency_bound_ms: the permutation's 234 dependent
    products times one product's latency at one warp.  Round: each kind at
    the NIZK's widths (phase one's cubic_tau at 2^16 and 2^20 rows, phase
    two's quad at 2^17 and 2^21) and the batched layout (k_par, k_seq) =
    (2, 1) at 2^12, with and without the fold, and at 2, 4 and 8 rows (the
    last fold among them); the folded tables and the sums of the partials
    compared; timed with and without the fold, with the L2 cache flushed
    before each launch and back to back, beside `bound_ms` and
    `latency_bound_ms` (the tiled body's dependent products times one
    product's latency at one warp), and beside the fold as launches of its
    own.  Tail: both sponges, both point counts, from (absorbing, 0) (the
    path's start) and (squeezing, 2) (the CPU tests take every start), three
    instances over the partials of phase one's 2^16 round; timed at that
    round's partial count (the blocks of its launch) on the Fr sponge from
    (absorbing, 0), as the prove runs it."""
    rng = np.random.default_rng(61)
    flush = exp_mont_rm.l2_flusher(dev)
    prof = lambda fn, name, fl=None: exp_mont_rm.profiled_ms(fn, name, reps=20, flush=fl)

    # -- Poseidon
    pos = {}
    for spec, lat in ((FR, lat_fr), (FQ, lat_fq)):
        st = _random_elements(spec, (ODD, 3), rng, dev)
        got, want = dsponge.permute(spec, st), dsponge.permute_plain(spec, st)
        one = st[5].contiguous()
        ms = prof(lambda: dsponge.permute(spec, one), "k_poseidon_permute")
        plain = time_ms(lambda: dsponge.permute_plain(spec, one), 1)
        b_ms, b_by = bound(2 * 3 * spec.nlimbs * 4, POS_PRODUCTS * exp_montmul.madds_per_product(spec))
        pos[spec.name] = (got, want, ms, plain, b_ms, b_by, POS_DEPENDENT * lat / 1e3)
    got, want, ms, plain, _, _, lat_ms = pos["fr"]
    rep.add("poseidon_permute", (got, pos["fq"][0]), (want, pos["fq"][1]), ms, plain,
            2 * 3 * FR.nlimbs * 4, POS_PRODUCTS * MADD_FR,
            f"one (3, 16) Fr state (the NIZK's sponge); compared on {ODD} Fr and {ODD} Fq states")
    _, _, ms_q, plain_q, b_q, by_q, lat_q = pos["fq"]
    rep.rows["poseidon_permute"].update({
        "latency_bound_ms": lat_ms, "latency_us_per_product": lat_fr, "ms_fq": ms_q,
        "plain_ms_fq": plain_q, "bound_ms_fq": b_q, "bound_by_fq": by_q,
        "latency_bound_ms_fq": lat_q, "latency_us_per_product_fq": lat_fq})
    say(f"  poseidon_permute: Fr {ms:.5f} ms (latency bound {lat_ms:.5f}), Fq {ms_q:.5f} ms "
        f"(latency bound {lat_q:.5f})")

    # -- round
    big = [("cubic_tau", 1, 0, 1 << (10 if quick else 16)), ("quad", 1, 0, 1 << (11 if quick else 17)),
           ("cubic", 2, 1, 1 << 12)]
    if not quick:
        big += [("cubic_tau", 1, 0, 1 << 20), ("quad", 1, 0, 1 << 21)]
    small = [(kind, kp, ks, n) for kind, kp, ks in (("quad", 1, 0), ("cubic_tau", 1, 0),
                                                     ("cubic", 1, 0), ("cubic", 2, 1))
             for n in (2, 4, 8)]
    gots, wants, timed = [], [], {}
    for kind, kp, ks, n in big + small:
        src = _random_elements(FR, (sk.stack_size(kind, kp, ks), n), rng, dev)
        r = _random_elements(FR, (1,), rng, dev)[0].contiguous()
        for rr in (None, r):
            dst, part = sk.sumcheck_round(kind, src, rr, kp, ks)
            w_dst, w_part = sk.sumcheck_round_plain(kind, src, rr, kp, ks)
            gots += [dst, tf.reduce_sum(FR, part, axis=1, mul=tf.mont_mul_plain)]
            wants += [w_dst, w_part[:, 0]]
        if (kind, kp, ks, n) in big:
            for rr in (r, None):
                run = lambda: sk.sumcheck_round(kind, src, rr, kp, ks)
                cold = prof(run, "k_sumcheck_round", flush)
                warm = prof(run, "k_sumcheck_round")
                plain = time_ms(lambda: sk.sumcheck_round_plain(kind, src, rr, kp, ks), 1)
                fold = rr is not None
                nb = sk.round_blocks(kind, n, fold, dev, kp, ks)
                timed[f"{kind} ({kp}, {ks}) 2^{n.bit_length() - 1}" + (" fold" if fold else "")] = (
                    cold, warm, plain, *_round_work(kind, n, kp, ks, fold, nb), nb)
        del src
    # the fold inside the round against the fold as launches of its own
    # (dense.bound_top of each table, then the round without a fold), at
    # phase one's shape: device time of all their kernels, and CUDA events
    # around back-to-back calls (the host's launches included)
    kind, kp, ks, n = big[0]
    src = _random_elements(FR, (sk.stack_size(kind, kp, ks), n), rng, dev)
    r = _random_elements(FR, (1,), rng, dev)[0].contiguous()
    inside = lambda: sk.sumcheck_round(kind, src, r, kp, ks)
    apart = lambda: sk.sumcheck_round(kind, torch.stack([dense.bound_top(t, r) for t in src]))
    (d_in, p_in), (d_ap, p_ap) = inside(), apart()
    psum = lambda part: tf.reduce_sum(FR, part, axis=1, mul=tf.mont_mul_plain)
    if not (torch.equal(d_in, d_ap) and torch.equal(psum(p_in), psum(p_ap))):
        raise AssertionError("sumcheck_round: the fold inside the round and apart differ")
    fold_cmp = {"inside_device_ms": all_kernels_ms(inside, "k_sumcheck_round"),
                "apart_device_ms": all_kernels_ms(apart, "k_sumcheck_round"),
                "inside_events_ms": time_ms(inside, 20), "apart_events_ms": time_ms(apart, 20)}
    say(f"  sumcheck_round at phase one's 2^{n.bit_length() - 1}: the fold inside the round "
        f"{fold_cmp['inside_device_ms']} ms of device time ({fold_cmp['inside_events_ms']:.5f} ms "
        f"a call back to back); apart {fold_cmp['apart_device_ms']} "
        f"({fold_cmp['apart_events_ms']:.5f})")
    label = f"cubic_tau (1, 0) 2^{big[0][3].bit_length() - 1} fold"
    cold, warm, plain, nbytes, products, chain, nb = timed[label]
    rep.add("sumcheck_round", tuple(gots), tuple(wants), cold, plain, nbytes, products * MADD_FR,
            f"{label}: phase one's round with the fold, 4 tables, {nb} blocks, L2 flushed; compared "
            f"at {len(big) + len(small)} shapes with and without the fold")
    extra = {}
    for lbl, (c, w, pl, nbytes_, pr, ch, nb_) in timed.items():
        b_ms, b_by = bound(nbytes_, pr * MADD_FR)
        extra[lbl] = {"ms": c, "ms_l2_warm": w, "plain_ms": pl, "bound_ms": b_ms, "bound_by": b_by,
                      "latency_bound_ms": ch * lat_fr / 1e3, "blocks": nb_}
        say(f"  sumcheck_round {lbl}: {c:.5f} ms L2 flushed, {w:.5f} warm, bound {b_ms:.5f} "
            f"({b_by}), latency bound {ch * lat_fr / 1e3:.5f}, {nb_} blocks, plain {pl:.2f}")
    rep.rows["sumcheck_round"].update({"shapes": extra, "ms_l2_warm": warm, "fold": fold_cmp,
                                       "latency_bound_ms": chain * lat_fr / 1e3,
                                       "latency_us_per_product": lat_fr, "blocks": nb})

    # -- tail, at the partial count of phase one's round with the fold
    nb = timed[label][-1]
    gots, wants = [], []
    for spec in (FR, FQ):
        for kind in ("quad", "cubic_tau"):
            part = _random_elements(FR, (3, nb, sk.POINTS[kind]), rng, dev)
            coeffs = _random_elements(FR, (3,), rng, dev)
            e = _random_elements(FR, (1,), rng, dev)[0].contiguous()
            state = _random_elements(spec, (3,), rng, dev)
            for mode, index in ((0, 0), (1, 2)):  # the path's start and one more
                gots.append(sk.sumcheck_tail(kind, part, coeffs, e, state, spec, mode, index))
                wants.append(sk.sumcheck_tail_plain(kind, part, coeffs, e, state, spec, mode, index))
    part = _random_elements(FR, (1, nb, 3), rng, dev)
    one = _random_elements(FR, (1,), rng, dev)
    e = one[0].contiguous()
    state = _random_elements(FR, (3,), rng, dev)
    run = lambda: sk.sumcheck_tail("cubic_tau", part, one, e, state, FR, 0, 0)
    ms = prof(run, "k_sumcheck_tail")
    plain = time_ms(lambda: sk.sumcheck_tail_plain("cubic_tau", part, one, e, state, FR, 0, 0), 1)
    # from (absorbing, 0): absorb d, c, then a permutation, b, a, then the
    # squeeze's permutation; the products of the sums, coefficients, Horner
    products = 2 * POS_PRODUCTS + 3 + 2 + 3
    dependent = 2 * POS_DEPENDENT + 1 + 1 + 3
    rep.add("sumcheck_tail", tuple(t for g in gots for t in g), tuple(t for w in wants for t in w),
            ms, plain, nb * 3 * 64 + 4 * 64 + 6 * 64 + 4 * 64, products * MADD_FR,
            f"phase one's tail: {nb} blocks x 3 points, Fr sponge from (absorbing, 0); compared on "
            f"both sponges, 2 and 3 points, 3 instances, 2 (mode, index) starts")
    rep.rows["sumcheck_tail"].update({"latency_bound_ms": dependent * lat_fr / 1e3,
                                      "latency_us_per_product": lat_fr, "partials": nb})
    say(f"  sumcheck_tail: {ms:.5f} ms at {nb} partials (latency bound "
        f"{dependent * lat_fr / 1e3:.5f})")
    for name in FUSED_KERNELS:
        rep.rows[name]["replaces_also"] = _REPLACES_ALSO[name]
        rep.rows[name]["ptxas"] = [ln for ln in build.build_report()["ptxas"]
                                   if ln.startswith("k_" + name)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build, compare every kernel at small shapes, stop")
    ap.add_argument("--msm-only", action="store_true",
                    help="build, check and time msm_g1 and msm_g2 at 2^20, stop")
    ap.add_argument("--nizk-only", action="store_true",
                    help="build, check and time TestudoNIZK at 2^16 and 2^20, stop")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the GPU", file=sys.stderr)
        return 1
    t_start = time.time()
    dev = torch.device("cuda")
    phase_device()
    if args.nizk_only:
        phase_nizk_golden(dev)
        for log2n in (16, 20):
            phase_nizk(dev, log2n)
            say(f"NIZK 2^{log2n} done ({time.time() - t_start:.1f} s)")
        say("nizk-only pass done; run without arguments for the full check")
        return 0
    g1, g2 = GROUPS["g1"], GROUPS["g2"]
    rep = Report()

    proj, affine, ks = {}, {}, {}
    for grp in (g1, g2):
        proj[grp.name], affine[grp.name], ks[grp.name] = make_points(dev, grp, t_start)

    # one dependent Fq product at one warp: the ladders' latency bound
    lat_us = exp_montmul.measure_latency(FQ, dev)["inline"]["us_per_product"]
    lat_fr = exp_montmul.measure_latency(FR, dev)["inline"]["us_per_product"]
    say(f"latency of one dependent product at one warp (inlined): Fq {lat_us:.4f} us, "
        f"Fr {lat_fr:.4f} us")

    if args.kernels_only:
        N = 1 << 14
        kernels_montgomery(dev, rep, quick=True)
        kernels_rowmajor(dev, rep, quick=True)
        kernels_chain(dev, rep, quick=True)
        kernels_sumcheck(dev, rep, lat_us, lat_fr, quick=True)
        phase_nizk_golden(dev)
        phase_sqrt_pst(dev, 10, full=False)
        for grp in (g1, g2):
            pts = tile(affine[grp.name], N // N_UNIQUE)
            scal = torch.as_tensor(random_scalars(N, 7), device=dev)
            kernels_group(dev, grp, rep, proj[grp.name], pts, scal, pts, scal, lat_us, quick=True)
        say("kernels-only pass done; run without arguments for the full check")
        return 0

    # main paths: the launches of each are counted on their own, the
    # counters zeroed just before the path and read just after
    by_path = {}

    def note(path, snap):
        tot = by_path.setdefault(path, {name: 0 for name in build.LAUNCHES})
        for name, n in snap.items():
            tot[name] += n

    batches = {}
    sizes = (20,) if args.msm_only else (16, 20)
    for grp in (g1, g2):
        phase_small_guard(dev, grp)
        for log2n in sizes:
            pts, scal, got = phase_main(dev, grp, affine[grp.name], ks[grp.name], log2n,
                                        log2n == sizes[-1])
            batches[grp.name, log2n] = (pts, scal)
        note("msm", got)
        say(f"launches in one warm msm_{grp.name} at 2^{sizes[-1]}: "
            f"{json.dumps({k: v for k, v in got.items() if v})}")
    if args.msm_only:
        say("msm-only pass done; run without arguments for the full check")
        return 0
    phase_projective_msm(dev, g2, proj["g2"], ks["g2"])

    # the rest of the group layer: the one-thread fixed-base kernel runs under
    # fixed_base_mul at 2^16, the Fq row-major product under the field path
    for grp in (g1, g2):
        note("fixed_base", phase_fixed_base(dev, grp))
        phase_small_msms(dev, grp, affine[grp.name], ks[grp.name])
        note("field", phase_field_path(dev, grp, proj[grp.name]))

    # the protocol path: sqrt-PST at two small sizes, then at full width
    phase_sqrt_pst(dev, 10, full=False)
    phase_sqrt_pst(dev, 14, full=False)
    pst_counts, canon, basis = phase_sqrt_pst(dev, 20, full=True)
    for path, snap in pst_counts.items():
        note(path, snap)
    say(f"sqrt-PST done ({time.time() - t_start:.1f} s)")

    # the protocol on top: TestudoNIZK, the golden proof, then config #3 at 2^16
    phase_nizk_golden(dev)
    for path, snap in phase_nizk(dev, 16).items():
        note(path, snap)
    say(f"NIZK done ({time.time() - t_start:.1f} s)")

    # the measuring harness: the chain kernels' own path
    note("harness", phase_harness(dev))

    # every kernel against its plain version.  G1 buckets: compared and timed
    # at the 2^20 plan.  G2 buckets: compared at the 2^16 plan (the plain
    # version would walk 80,000 lanes through 512 G2 adds at 2^20), timed at
    # the 2^20 plan.
    kernels_montgomery(dev, rep, quick=False)
    kernels_rowmajor(dev, rep, quick=False)
    kernels_chain(dev, rep, quick=False)
    kernels_sumcheck(dev, rep, lat_us, lat_fr, quick=False)
    kernels_group(dev, g1, rep, proj["g1"], *batches["g1", 20], *batches["g1", 20], lat_us,
                  quick=False)
    kernels_commit_bucket(dev, rep, canon, basis)
    del canon, basis
    kernels_group(dev, g2, rep, proj["g2"], *batches["g2", 16], *batches["g2", 20], lat_us,
                  quick=False)

    for name, row in rep.rows.items():
        ctr, paths = ROW_COUNTER.get(name, (name, tuple(by_path)))
        row["launches_by_path"] = {path: tot[ctr] for path, tot in by_path.items()
                                   if tot[ctr] and path in paths}
        row["launches"] = sum(row["launches_by_path"].values())
        group = "g2" if name.endswith("_g2") else "g1"
        for path in MUST_LAUNCH[name]:
            if path == "msm" and name.startswith("bucket") and "mixed" not in name \
                    and rep.max_nseg[group] <= 1:
                continue  # one segment per bucket: the segment reduce only copies
            if by_path[path][ctr] == 0:
                raise AssertionError(f"path {path} did not launch kernel {name}")
        if not MUST_LAUNCH[name] and row["launches"]:
            raise AssertionError(f"kernel {name} belongs to the kernel phase only, but the paths "
                                 f"launched it: {row['launches_by_path']}")
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
