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
     `sqrt_pst.verify`) at nv = 10 and, at full width, nv = 20 (a
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
     evaluations; setup, prove (cold, then one warm, three with --nizk-only,
     split by the Timer labels commit / phase one / phase two / open) and
     verify (cold, warm) are timed, as many warm looped proves beside them
     (byte-equal), and the launches of one warm fused prove, one looped
     prove and one verify counted (paths nizk_prove, nizk_prove_looped,
     nizk_verify: the fused sumcheck's three kernels must run in the first
     and not in the second); with --nizk-only also the Poseidon
     permutations left on the host timed, each prover's CUDA kernels counted
     under torch.profiler, by phase too (the fused prove's with the
     row-major product's device time and launches by size class), and the
     round kernel's launches by shape in one warm fused prove with their
     summed device time;
  5a. drives the sharded paths (parallel/mesh.py) on a mesh of 4 shards
     (the card listed 4 times on a one-card machine, printed on a line of
     its own): `msm_g1` and `msm_g2` (affine=True) at 2^20, equal to the
     unsharded results and the host values; the sqrt-PST commit at nv =
     20, its column commitments limb-equal and T byte-equal to the
     unsharded commit's; the golden NIZK instance, byte-equal to the
     fixture with both sumchecks; TestudoNIZK at 2^16 with the fused and
     the looped sumcheck, byte-equal to the unsharded proofs with equal
     sponge states, verified, eval_vars_at_ry + 1 rejected; each sharded
     wall beside the unsharded one, in turns; the launches of one warm
     sharded call of each (paths mesh_msm, mesh_commit, mesh_nizk,
     mesh_nizk_looped); then the fused 2^16 prove on 8 shards (three
     remnant rounds), byte-equal;
  5b. drives TestudoSNARK (core/snark.py: `TestudoSnarkGens.setup`,
     `snark_encode`, `snark_prove`, `snark_verify`; Spark in core/spark.py
     over the product trees, the row-wise Pedersen commitment and the
     dot-product argument; the Groth16-compressed verifier in
     core/groth16.py, core/circuit.py, core/ntt.py): without Groth16, a 16 x
     16 x 3 instance proved on the card and on the CPU with host groups under
     one seeded blind stream, byte-equal with equal commitments (with
     --snark-only also config #4, `produce_synthetic_r1cs(n, n, 10)` with n
     nonzero entries a matrix as benches/testudo.py builds it, at 2^12 to
     its 57,905 B); the port's twin of examples/cubic.py (config #1 with
     Groth16: setup, prove, verify, y + 1 rejected); then config #4 with
     Groth16 (the default) at 2^16 (2^12 and 2^20 with --snark-only):
     sat, eval and total bytes (testudo.csv's 13,192 + 43,800 B at 2^12,
     58,097 B in all; 100,881 B at 2^16; the Groth16 proof 192 B; the total's
     identity), codec round trip, verify, inst_evals + 1, a flipped byte of
     the eval proof and the Groth16 proof with -C rejected, the evaluations
     against Python ints; at 2^12 (--snark-only) 8 lanes of each key batch
     against the host's multiples of the setup's scalars and the five MSMs
     against native host MSMs over the keys in affine; setup (split: circuit build, lagrange,
     keys G1 / G2), encode, prove (cold and one warm, three with
     --snark-only, byte-equal, split by
     the Timer labels: sat proof, evaluate A,B,C, derefs commit, product
     layers, hash layer, prove_verifier and Groth16's circuit build, row
     evals, witness_h and five MSMs) and verify (cold, warm; Groth16, the
     sqrt-PST check, Spark) timed; with --snark-only each size's warm prove
     under torch.profiler (CUDA kernels, device time); the launches of the setup, the
     encode, one warm prove, one `groth16.prove` and one warm verify (paths
     snark_groth16_setup, snark_encode, snark_prove, groth16_prove,
     snark_verify);
  5c. drives BW6-761 and the one-level recursion (device/curve_generic.py,
     msm.msm_fp, core/circuit_verifier.py, core/groth16_bw6.py): `msm_fp` on
     G1 and G2 at 983,040 points (2^13 bases k_i G tiled, random scalars
     below r; exact: one host multiplication of G by sum k_i s_i), cold and
     warm, and one 50-point MSM of the small path against a host MSM; the toy
     Fq circuit of tests/test_groth16_bw6.py proved over BW6 on the card, its
     public input + 1 rejected; the wrap of tests/test_groth16_bw6.py:50 at
     nv = 16: a random 2^16 table committed and opened on the card with the
     Fq transcript, the port's verifier accepting, the TestudoCommVerifier
     built (983,727 constraints, 983,426 variables, no public input, domain
     2^20: held to BW6_SHAPES) and satisfied, Groth16 over BW6 set up (8
     lanes of each key batch and gamma_abc against the host's multiples of
     the setup's scalars), proved and verified, -C and another A rejected;
     times split by the Timer labels, the launches of the setup and of the
     prove counted (paths bw6_setup, bw6_prove);
  5d. drives the R1CS proof over BLS12-381 (curves/profile.py's
     `bls12_381(dev)`: Fr tables on the card, groups, pairings and Poseidon
     on the host, the looped sumcheck) at Testudo's own size for this curve,
     `produce_synthetic_r1cs(1024, 1024, 10)`: `R1CSGens.setup`, `prove`,
     the verifier's `inst.evaluate` and `verify_native`, which accepts;
     eval_vars_at_ry + 1 and a wrong input rejected; the evaluation, the
     phase-2 claims and (A~, B~, C~)(rx, ry) against Python ints mod r381;
     a PST commit -> open -> check round trip on the setup's key, the value
     + 1 rejected; setup and prove split by the Timer labels (eq tables,
     keys, masks; commit, phase one, phase two, open, the rest), one more
     prove under torch.profiler for the device's busy time in it; the
     launches of each path counted (bls381_setup, bls381_prove,
     bls381_verify, bls381_pst), where the row-major product at fr381 must
     run and no other kernel may;
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
     `latency_bound_ms`; the 761-bit row-major product at the BW6 group's
     shapes (a complete add's six stacked products over 2^20 lanes, the b3
     pair times a shared element, the weighted sum's 384 lanes, 2^16 + ODD
     with 0, 1, q - 1, R mod q and r mixed in), its device time at 2^20
     (torch.profiler, L2 flushed, and warm) beside `bound_ms` and the latency
     of one dependent 761-bit product at one warp; the row-major product at
     BLS12-381's Fr at 2^20 + ODD with two full operands and times a shared
     element, at 8,192 + ODD and at the proof's 2^10 and 2^11 tables, with
     R - 1, r - 1, 0, 1 and R mod r among the operands, against its plain
     version and on a stride against Python ints, K1 at fr381 beside it, its
     device time at 2^20 (L2 flushed) beside `bound_ms` and the latency of
     one dependent product;
  8. checks a small MSM against the host oracle;
  9. prints one JSON line {"kernels": [...]} (each row's `launches` is the
     sum of `launches_by_path`, the kernel's count on each driven path: msm,
     fixed_base, field, setup, commit, open, verify, nizk_prove,
     nizk_prove_looped, nizk_verify, mesh_msm, mesh_commit, mesh_nizk,
     mesh_nizk_looped, snark_groth16_setup, snark_encode,
     snark_prove, groth16_prove, snark_verify, bw6_setup, bw6_prove,
     bls381_setup, bls381_prove, bls381_verify, bls381_pst, harness; the
     run fails if a
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
of host Python to build), for the same use; `--snark-only` stops after the
SNARK phase, with Groth16 at 2^12, 2^16 and 2^20 (config #4 at 2^20: 21,192 +
180,504 B, 203,313 B in all; each size profiled); `--bw6-only` compares and
times the 761-bit product, runs the BW6 MSMs and toy circuit and the wrap at
nv = 16 and at nv = 10 (650,138 constraints), and stops; `--bls381-only`
compares and times the fr381 product and runs the BLS12-381 phase at 2^10,
2^12 and 2^14 (the last without the profiled prove), and stops; `--mesh-only`
runs the mesh phase (5a), then TestudoNIZK at 2^20 on 4 shards with both
sumchecks against its unsharded proofs, then tries 2^24 on 4 shards (its
instance's host build stopped after 600 s; the prove's peak device memory or
the allocation that failed), and stops; the default run is the full check.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import random
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from testudo_tpu_torch import native, proofs
from testudo_tpu_torch.core import (circuit, circuit_verifier, groth16, groth16_bw6, pst, r1cs,
                                   r1csproof, snark, sqrt_pst)
from testudo_tpu_torch.curves import bw6_761 as bw
from testudo_tpu_torch.curves import host_curve as hc
from testudo_tpu_torch.curves import pairing as pr
from testudo_tpu_torch.curves import profile as cprof
from testudo_tpu_torch.device import build, msm
from testudo_tpu_torch.device import curve as tc
from testudo_tpu_torch.device import curve_generic as cg
from testudo_tpu_torch.device import field as tf
from testudo_tpu_torch.device import packed_field
from testudo_tpu_torch.device import sponge as dsponge
from testudo_tpu_torch.device import sumcheck_kernels as sk
from testudo_tpu_torch.device.field import FQ, FR, FR381
from testudo_tpu_torch.device.packed_curve import G1P, G2P
from testudo_tpu_torch.examples import cubic
from testudo_tpu_torch.parallel import mesh as pmesh
from testudo_tpu_torch.fields.bls12_377 import P as R_BW6  # BW6-761's scalar field
from testudo_tpu_torch.fields.bls12_377 import R
from testudo_tpu_torch.poly import dense
from testudo_tpu_torch.poseidon import sponge
from testudo_tpu_torch.poseidon.transcript import (PoseidonTranscript, fq_params, fr_params,
                                                   fr_params_381)
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
    # the 761-bit field: every product of tpu/curve_generic.py's FpGroup
    # (tpu/field.py:292-295 sends batches of 512 or more to the Pallas call)
    "mont_mul_rm_bw6fq": "testudo_tpu/tpu/pallas_field.py:226",
    # BLS12-381's Fr: every product of a 381 Fr table of 512 elements or more
    # (`_mont_mul_call(16, r381)`, keyed by the modulus)
    "mont_mul_rm_fr381": "testudo_tpu/tpu/pallas_field.py:226",
    "mont_chain": "tools/exp_montmul_block.py:114",
    "mont_chain_seq": "tools/exp_mulmany_wide.py:60",
    "mont_chain_wide": "tools/exp_mulmany_wide.py:60",
    "add_mask": _EC + ":403", "add2": _EC + ":415", "step": _EC + ":424",
    "scan2": _EC + ":437", "scan2b": _EC + ":450", "bucket": _EC + ":461",
    "bucket_mixed": _EC + ":509", "ladder": _EC + ":733", "ladder_team": _EC + ":733",
    "ladder_wide": _EC + ":733",
    "wsum": _EC + ":450", "chain_team": _EC + ":415", "fold_team": _EC + ":415",
    "fixed_base": _EC + ":403", "fixed_base_one": _EC + ":403",
    "fixed_base_one_key": _EC + ":403",
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
    "mont_mul_rm_fr_full": "mont_mul_rm.cu", "mont_mul_rm_bw6fq": "mont_mul_rm.cu",
    "mont_mul_rm_fr381": "mont_mul_rm.cu",
    "mont_chain": "mont_chain.cu", "mont_chain_seq": "mont_chain.cu",
    "mont_chain_wide": "mont_chain.cu",
    "mont_mul": "mont_mul.cu", "add_mask": "ec_ops.cu", "add2": "ec_ops.cu",
    "step": "ec_ops.cu", "scan2": "ec_ops.cu", "scan2b": "ec_ops.cu",
    "ladder": "ladder.cu", "ladder_team": "ladder_team.cu", "ladder_wide": "ladder_wide.cu",
    "bucket": "bucket.cu",
    "bucket_mixed": "bucket.cu", "wsum": "wsum_team.cu", "chain_team": "chain_team.cu",
    "fold_team": "fold_team.cu", "fixed_base": "fixed_base_team.cu",
    "fixed_base_one": "fixed_base_team.cu", "fixed_base_one_key": "fixed_base_team.cu",
    "poseidon_permute": "poseidon.cu",
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
# TestudoSNARK on the same instances (config #4, with num_nz_entries = n):
# (sat, eval, total) bytes per k, from testudo.csv's sat and eval columns and
# ser_testudo_snark's layout (total = sat + eval + 3 x 32 + rx + ry + the
# Option's tag + the 192-B Groth16 proof: testudo.csv's totals 58,097 B at
# 2^12 and 203,313 B at 2^20); at 2^16 the 100,689 B measured without
# Groth16 + 192; without Groth16 (the empty Option) 57,905 B at 2^12
SNARK_BYTES = {12: (13192, 43800, 58097), 16: (17192, 82328, 100881),
               20: (21192, 180504, 203313)}
GROTH16_BYTES = 192
SNARK_BYTES_NO_GROTH16 = {12: 57905}
# the small instance proved on the card and on the CPU under one blind stream
SNARK_SMALL = (16, 16, 3, 5)  # constraints, variables, inputs, seed
SNARK_LABELS = {"r1csproof::prove": "sat proof", "snark_prove::evaluate A,B,C": "evaluate A,B,C",
                "spark::derefs commit": "derefs commit", "spark::product layers": "product layers",
                "spark::hash layer": "hash layer", "snark_prove::prove_verifier": "prove_verifier"}
# the Groth16 parts of a setup, a prove and a verify (core/groth16.py, core/r1csproof.py)
GROTH16_SETUP_LABELS = ("groth16::circuit build", "groth16::lagrange", "groth16::keys",
                        "groth16::keys G1", "groth16::keys G2")
GROTH16_PROVE_LABELS = ("groth16::circuit build", "groth16::row evals", "groth16::witness_h",
                        "groth16::msm a", "groth16::msm b_g1", "groth16::msm b_g2",
                        "groth16::msm h", "groth16::msm l")
GROTH16_VERIFY_LABELS = ("snark_verify::groth16", "snark_verify::sqrt-PST check",
                         "snark_verify::sat proof", "snark_verify::spark")
# the Groth16 key batches of the 2^16 circuit (31,654 variables, domain 2^15):
# the widths chip_smoke times `fixed_base_one` at, G1 the h query's, G2 b_g2's
KEY_LANES = {"g1": (1 << 15) - 1, "g2": 31654}

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
# TestudoSNARK at 2^16 (the kernels these paths launch on the H100, as their
# counters read): the encode's two row commitments
# are shared-basis multi-MSMs (the general bucket kernel, the chain, the
# wide ladder, the fold) over Montgomery tables turned canonical by the Fr
# row-major product; the prove adds the NIZK's kernels, Spark's product
# layers on the fused sumcheck (the round kernel's `cubic` kind, the
# permutation, the tail), the dot-product arguments' MSMs (ladder, bucket,
# weighted sum, fold) and generator folds (the team ladder, G1 adds through
# the Fq product); the verify's device work is the dot-product verifiers'
# MSMs over the generators
# With Groth16 (the default): the setup's keys are fixed-base batches, the
# one-thread kernel above FIXED_TEAM_MAX_LANES (every batch of the 2^16
# circuit but gamma_abc's) and the team kernel for gamma_abc and sqrt-PST's
# key; the Groth16 prove (path groth16_prove: `groth16.prove` alone on the
# circuit of the warm proof) runs four general-bucket `msm_g1` and one
# `msm_g2` over the projective keys (bucket, weighted sum, the MSM's Horner
# on the team ladder, folds) and seven NTTs on the row-major Fr product; the
# SNARK prove holds it, so its G2 MSM's kernels join that path too
_SNARK_MUST = {
    "snark_groth16_setup": ("fixed_base_one", "fixed_base_one_g2", "fixed_base"),
    "snark_encode": ("mont_mul_rm_fr", "ladder_wide", "bucket", "chain_team", "fold_team"),
    "snark_prove": ("mont_mul_rm_fq", "mont_mul_rm_fr", "poseidon_permute", "sumcheck_round",
                    "sumcheck_tail", "ladder_team", "ladder_wide", "bucket", "wsum", "chain_team",
                    "fold_team", "ladder_team_g2", "fold_team_g2", "bucket_g2", "wsum_g2"),
    "groth16_prove": ("mont_mul_rm_fr", "bucket", "wsum", "ladder_team", "fold_team",
                      "bucket_g2", "wsum_g2", "ladder_team_g2", "fold_team_g2"),
    "snark_verify": ("ladder_team", "bucket", "wsum", "fold_team"),
}
for _path, _names in _SNARK_MUST.items():
    for _name in _names:
        MUST_LAUNCH[_name] += (_path,)
# BW6-761 (the one-level wrap at nv = 16): every group operation of the
# Groth16 setup's six fixed-base batches and of the prove's five msm_fp is
# complete formulas over the 761-bit product (the prove's NTTs run on the Fq
# row-major product)
MUST_LAUNCH["mont_mul_rm_bw6fq"] = ("bw6_setup", "bw6_prove")
MUST_LAUNCH["mont_mul_rm_fq"] += ("bw6_prove",)
# BLS12-381 (curves/profile.py's bls12_381: Fr tables on the card; groups,
# pairing and Poseidon on the host, as in the JAX package): the setup's eq
# tables, the prove's R1CS products, eq tables, looped sumcheck rounds and
# folds, the verifier's A~, B~, C~(rx, ry) and the PST round trip's
# quotients and folds are all row-major products at BLS12-381's Fr, and no
# other kernel may run on these paths
BLS381_PATHS = ("bls381_setup", "bls381_prove", "bls381_verify", "bls381_pst")
MUST_LAUNCH["mont_mul_rm_fr381"] = BLS381_PATHS
BLS381_INPUTS = 10  # Testudo's check_r1cs_proof_bls12_381 (r1csproof.rs:754-801)
# the wrap's TestudoCommVerifier at each nv (constraints, variables, domain
# log): counts of the circuit, the same on any hardware (the JAX package's
# build_comm_verifier gives the same)
BW6_SHAPES = {16: (983727, 983426, 20), 10: (650138, 649957, 20)}
BW6_MSM_LANES = 120 * (1 << 13)  # 983,040: a key's width at nv = 16
BW6_SMALL = 50  # points of the small-path check
# A row that times a kernel at a second shape reads its launches from the
# kernel's counter, on the paths that give it that shape.
ROW_COUNTER = {"mont_mul_rm_fr_full": ("mont_mul_rm_fr",
                                       ("nizk_prove", "nizk_prove_looped", "nizk_verify",
                                        "mesh_nizk", "mesh_nizk_looped")),
               "fixed_base_one_key": ("fixed_base_one", ("snark_groth16_setup",)),
               "fixed_base_one_key_g2": ("fixed_base_one_g2", ("snark_groth16_setup",))}
MUST_LAUNCH["mont_mul_rm_fr_full"] = ("nizk_prove_looped",)
# The mesh (parallel/mesh.py) on MESH_SHARDS shards of the card: one warm
# sharded msm_g1 and msm_g2 at 2^20 (path mesh_msm: each shard's pipeline),
# one warm sharded sqrt-PST commit at nv = 20 (mesh_commit: each shard's
# multi-MSM over its block of columns, the canonical scalars through the Fr
# product), one warm sharded TestudoNIZK prove at 2^16 with each sumcheck
# (mesh_nizk: the NIZK prove's kernels and the fused sumcheck's three, the
# round kernel on every shard, the permutation and the tail on the first
# device; mesh_nizk_looped: the NIZK prove's kernels, the sumcheck's
# products on every shard).  A shard's segment reduce may only copy (one
# segment a bucket at 2^18 points), so mesh_msm may skip the general bucket;
# a prove's one Pippenger MSM (the open's U-fold over 256 points) is 64
# points a shard, the ladder's, so the mesh_nizk paths launch no `wsum`.
MESH_SHARDS, MESH_SHARDS_WIDE = 4, 8  # the second: the fused 2^16 prove, three remnant rounds
_MESH_MSM_KERNELS = tuple(k for k in _MSM_KERNELS if k != "bucket")
_MESH_NIZK_KERNELS = tuple(k for k in _NIZK_PROVE_KERNELS if k != "wsum")
MESH_MUST = {
    "mesh_msm": _MESH_MSM_KERNELS + tuple(k + "_g2" for k in _MESH_MSM_KERNELS),
    "mesh_commit": ("mont_mul_rm_fr", "chain_team", "bucket", "ladder_wide", "fold_team"),
    "mesh_nizk": _MESH_NIZK_KERNELS + FUSED_KERNELS,
    "mesh_nizk_looped": _MESH_NIZK_KERNELS,
}
for _path, _names in MESH_MUST.items():
    for _name in _names:
        MUST_LAUNCH[_name] += (_path,)
MUST_LAUNCH["mont_mul_rm_fr_full"] += ("mesh_nizk_looped",)
MUST_LAUNCH["fixed_base_one_key"] = MUST_LAUNCH["fixed_base_one_key_g2"] = ("snark_groth16_setup",)
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


def host_evaluate(Z, point, modulus: int = R) -> int:
    """Multilinear evaluation in Python ints, MSB-first binding."""
    for r in point:
        half = len(Z) // 2
        Z = [(lo + r * (hi - lo)) % modulus for lo, hi in zip(Z[:half], Z[half:])]
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


def host_eq(point, modulus: int = R) -> list:
    """The MSB-first eq table of `point` in Python ints."""
    evals = [1]
    for r in point:
        nxt = []
        for e in evals:
            hi = e * r % modulus
            nxt += [(e - hi) % modulus, hi]
        evals = nxt
    return evals


def host_mat_vec(m, z, nrows: int, modulus: int = R) -> list:
    out = [0] * nrows
    for r_, c_, v in zip(m.rows.tolist(), m.cols.tolist(), m.vals):
        out[r_] = (out[r_] + v * z[c_]) % modulus
    return out


def _nizk_split(records) -> dict:
    """A prove's seconds by the Timer labels, and the rest of it."""
    split = _split(records)
    out = {short: split.get(label, 0.0) for label, short in NIZK_LABELS.items()}
    out["rest"] = round(split["r1csproof::prove"] - sum(out.values()), 4)
    return out


def phase_nizk_golden(dev, mesh=None):
    """The golden instance of tests/fixtures/golden_nizk.json proved on the
    card (under `mesh`, sharded, when one is given): byte-equal sat proof,
    equal final sponge states."""
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
        with pmesh.use_mesh(mesh):
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
        where = "on the card" if mesh is None else f"on {mesh.size} shards of the card"
        say(f"NIZK golden ({p['num_cons']} x {p['num_vars']} x {p['num_inputs']}, seed {p['seed']}) "
            f"{where}, {which} sumcheck: sat proof {len(blob)} B byte-equal to the fixture "
            f"(sha256 {fix['sat_proof_sha256'][:12]}...), both final sponge states equal, verified")


def phase_nizk(dev, log2n: int, warm: int = 3, profiled: bool = True):
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

    # warm: `warm` fused proves, then as many looped ones (the last of each
    # counted), all byte-equal
    walls, splits, counts = {}, {}, {}
    for which, fn in (("fused", prove), ("looped", prove_looped)):
        walls[which], splits[which] = [], []
        for i in range(warm):
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

    perms, prof_lines, rounds = {}, {}, None
    if profiled:
        # one more warm prove with the Poseidon permutations timed on the host
        perm = [0.0, 0]
        orig = sponge.PoseidonSponge.permute

        def timed_permute(self):
            t = time.perf_counter()
            orig(self)
            perm[0] += time.perf_counter() - t
            perm[1] += 1

        sponge.PoseidonSponge.permute = timed_permute
        try:
            for which, fn in (("fused", prove), ("looped", prove_looped)):
                perm[:] = [0.0, 0]
                _, ms = timed_once(fn)
                perms[which] = (perm[0], perm[1], ms)
        finally:
            sponge.PoseidonSponge.permute = orig
        # and under the profiler: the device's kernels, by count and time, by
        # phase for both provers; the largest kernels and the row-major
        # product's share for the fused one (the default)
        prof_lines = {"fused": nizk_profile(prove) + "\n    " + nizk_phase_profile(prove),
                      "looped": nizk_phase_profile(prove_looped)}
        # and the round kernel's launches by shape with their device time
        rounds = exp_sumcheck_round.prove_round_profile(prove)

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
    if rounds is not None:
        by_shape = {k: [c["launches"], None if c["device_ms"] is None else round(c["device_ms"], 5)]
                    for k, c in rounds["by_shape"].items()}
        say(f"  {what} k_sumcheck_round in one warm fused prove (torch.profiler): "
            f"{rounds['launches']} launches, {rounds['device_ms']:.5f} ms of device time; by shape "
            f"[launches, device ms]: {json.dumps(by_shape)}")
    else:
        say(f"  {what} not profiled in this run")
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


# ---------------------------------------------------------------------------
# TestudoSNARK: setup, encode, prove, verify, with and without Groth16
# ---------------------------------------------------------------------------


def _snark_setup(n_cons, n_vars, n_inputs, seed, profile):
    inst, vars_, inputs = r1cs.Instance.produce_synthetic_r1cs(n_cons, n_vars, n_inputs, seed=seed)
    gens = snark.TestudoSnarkGens.setup(n_cons, n_vars, n_inputs, inst.inst.A.nnz,
                                        with_groth16=False, profile=profile)
    return inst, vars_, inputs, gens


def _snark_sizes(proof) -> tuple:
    sat = len(proofs.ser_r1cs_proof(proof.r1cs_sat_proof))
    ev = len(proofs.ser_spark_proof(proof.r1cs_eval_proof.proof))
    return sat, ev, len(proofs.ser_testudo_snark(proof))


def phase_snark_small(dev):
    """The small instance proved on the card (fused sumchecks, the default)
    and on the CPU with host groups (looped sumchecks: the same bytes, the
    CPU tests hold the two provers equal) under one seeded blind stream,
    without Groth16: byte-equal proofs and equal commitments; the card's
    proof verifies on the card."""
    nc, nv, ni, seed = SNARK_SMALL
    out = {}
    for where, pf, fused in (("card", cprof.bls12_377(dev), True),
                             ("cpu", cprof.bls12_377("cpu", host_groups=True), False)):
        inst, vars_, inputs, gens = _snark_setup(nc, nv, ni, seed, pf)
        comm, decomm = snark.snark_encode(inst, gens)
        proof = snark.snark_prove(inst, comm, decomm, vars_, inputs, gens,
                                  PoseidonTranscript(fr_params()), fused=fused,
                                  rng=random.Random(seed))
        out[where] = (proofs.ser_testudo_snark(proof), comm, proof, gens, inputs)
    blob, comm, proof, gens, inputs = out["card"]
    if blob != out["cpu"][0]:
        raise AssertionError("SNARK small: the card's proof differs from the CPU's")
    if comm != out["cpu"][1]:
        raise AssertionError("SNARK small: the card's computation commitment differs from the CPU's")
    if snark.snark_verify(proof, gens, comm, inputs, PoseidonTranscript(fr_params())) is not True:
        raise AssertionError("SNARK small: the card's proof did not verify on the card")
    say(f"SNARK small ({nc} x {nv} x {ni}, seed {seed}): {len(blob)} B proof on the card "
        f"byte-equal to the CPU's (host groups) under one blind stream, commitments equal, "
        f"verified on the card")


def phase_cubic(dev):
    """The port's twin of examples/cubic.py (config #1 with Groth16) on the
    card: setup, prove, verify, the proof read back verified, y + 1
    rejected (testudo_tpu_torch/examples/cubic.py)."""
    cubic.run(cprof.bls12_377(dev), random.Random(1), say=say)


def _labels(records, labels) -> dict:
    sp = _split(records)
    return {label: sp.get(label, 0.0) for label in labels}


def groth16_spot_checks(what, gens, inst, inputs, proof, log_m: int):
    """The Groth16 keys and the five MSMs against the host: 8 lanes of each
    key batch against the native host's multiples of the generator by the
    setup's scalars (recomputed from its seed), and the five MSMs' sums over
    the keys read back in affine against native host MSMs on the scalars
    of the warm proof's circuit (its variables, h's coefficients)."""
    if not native.available():
        raise AssertionError(f"{what}: the Groth16 spot checks need the native host library")
    pk = gens.gens_gc.pk
    pf = pk.profile
    nc, nv = inst.inst.num_cons, inst.inst.num_vars
    dummy = circuit.build_verifier_circuit(r1csproof.dummy_verifier_config(
        nc, nv, len(inputs.assignment)))
    sc = groth16.setup_scalars(dummy)
    g1, g2 = hc.g1_generator(), hc.g2_generator()
    affine = {}
    for name, scal, g2_batch in (("a_query", sc.a, False), ("b_g1_query", sc.b, False),
                                 ("b_g2_query", sc.b, True), ("h_query", sc.h, False),
                                 ("l_query", sc.l, False)):
        backend = pf.g2b if g2_batch else pf.g1b
        pts = backend.to_affine(getattr(pk, name))
        affine[name] = pts
        if len(pts) != len(scal):
            raise AssertionError(f"{what}: {name} has {len(pts)} points, {len(scal)} scalars")
        lanes = sorted({0, 1, len(pts) - 1, *np.linspace(0, len(pts) - 1, 5).astype(int)})
        mul = native.g2_batch_mul if g2_batch else native.g1_batch_mul
        want = mul([g2 if g2_batch else g1] * len(lanes), [scal[i] for i in lanes])
        if [pts[i] for i in lanes] != want:
            raise AssertionError(f"{what}: {name} differs from the host's multiples")
    if pk.vk.gamma_abc_g1 != native.g1_batch_mul([g1] * len(sc.gamma_abc), sc.gamma_abc):
        raise AssertionError(f"{what}: gamma_abc differs from the host's multiples")
    sat, evals = proof.r1cs_sat_proof, proof.inst_evals
    cs = circuit.build_verifier_circuit(r1csproof.verifier_config(
        sat, nv, nc, inputs.assignment, evals))
    z = cs.values
    h = dense.decode_table(groth16._witness_h(cs, 1 << log_m, pf.device))[: (1 << log_m) - 1]
    for name, scal, g2_batch in (("a_query", z, False), ("b_g1_query", z, False),
                                 ("b_g2_query", z, True), ("h_query", h, False),
                                 ("l_query", z[pk.num_pub:], False)):
        backend = pf.g2b if g2_batch else pf.g1b
        host_msm = native.g2_msm if g2_batch else native.g1_msm
        if backend.msm(getattr(pk, name), scal) != host_msm(affine[name], scal):
            raise AssertionError(f"{what}: the device MSM over {name} differs from the host's")
    say(f"  {what} Groth16: 8 lanes of each key batch equal the host's multiples, gamma_abc "
        f"({len(sc.gamma_abc)}) too; the five MSMs ({len(z)}, {len(z)}, {len(z)} G2, {len(h)}, "
        f"{len(z) - pk.num_pub} points) equal native host MSMs over the keys in affine")
    return cs


def phase_snark(dev, log2n: int, profiled: bool = True, groth16_part: bool = True,
                warm: int = 3):
    """TestudoSNARK on produce_synthetic_r1cs(2^log2n, 2^log2n, 10) with
    2^log2n nonzero entries a matrix (config #4), with its Groth16 part
    unless `groth16_part` is False: sizes (testudo.csv's totals; the Groth16
    proof 192 B), codec round trip, the verifier accepts the proof and its
    bytes read back and rejects inst_evals[0] + 1, a flipped byte of the eval
    proof and (with Groth16) C replaced by -C; the evaluations against Python
    ints; at 2^12 the Groth16 keys and MSMs against the host
    (`groth16_spot_checks`); setup, encode, prove (cold, then `warm` warm
    ones under the same blinds, byte-equal) and verify (cold, warm) timed and
    split by the Timer labels; with `profiled`, one more warm prove under
    torch.profiler; the launches of the setup, the encode, one warm prove,
    one `groth16.prove` on the warm proof's circuit and one warm verify
    (returned by path), each path's kernels of _SNARK_MUST launched."""
    n = 1 << log2n
    what = f"SNARK 2^{log2n}" + ("" if groth16_part else " without Groth16")
    t0 = time.perf_counter()
    inst, vars_, inputs = r1cs.Instance.produce_synthetic_r1cs(n, n, NIZK_INPUTS)
    inst_s = time.perf_counter() - t0
    pf = cprof.bls12_377(dev)
    build.reset_launches()
    with timer.record() as rec:
        gens, setup_ms = timed_once(lambda: snark.TestudoSnarkGens.setup(
            n, n, NIZK_INPUTS, n, with_groth16=groth16_part, profile=pf))
    counts_setup = dict(build.LAUNCHES)
    setup_split = _labels(rec, GROTH16_SETUP_LABELS) if groth16_part else {}
    build.reset_launches()
    with timer.record() as rec:
        (comm, decomm), encode_ms = timed_once(lambda: snark.snark_encode(inst, gens))
    counts_encode = dict(build.LAUNCHES)
    encode_split = _split(rec)

    def prove():
        return snark.snark_prove(inst, comm, decomm, vars_, inputs, gens,
                                 PoseidonTranscript(fr_params()), rng=random.Random(log2n))

    def verify(proof):
        return snark.snark_verify(proof, gens, comm, inputs, PoseidonTranscript(fr_params()))

    def split_of(records) -> dict:
        sp = _split(records)
        out = {short: sp.get(label, 0.0) for label, short in SNARK_LABELS.items()}
        if groth16_part:
            out.update(_labels(records, GROTH16_PROVE_LABELS))
        return out

    with timer.record() as rec:
        proof, prove_cold = timed_once(prove)
    split_cold = split_of(rec)
    blob = proofs.ser_testudo_snark(proof)
    sizes = _snark_sizes(proof)
    rx, ry = proof.r
    g16 = GROTH16_BYTES if groth16_part else 0
    if sizes[2] != sizes[0] + sizes[1] + 96 + (8 + 32 * len(rx)) + (8 + 32 * len(ry)) + 1 + g16:
        raise AssertionError(f"{what}: the proof's sizes {sizes} break the total's identity")
    want_sizes = SNARK_BYTES[log2n] if groth16_part else \
        SNARK_BYTES[log2n][:2] + (SNARK_BYTES_NO_GROTH16[log2n],)
    for got, want, part in zip(sizes, want_sizes, ("sat", "eval", "total")):
        if got != want:
            raise AssertionError(f"{what}: {part} proof of {got} B, expected {want}")
    if groth16_part:
        vp = proof.r1cs_verifier_proof
        if vp is None or len(proofs.ser_groth16_proof(vp.circuit_proof)) != GROTH16_BYTES:
            raise AssertionError(f"{what}: no Groth16 proof of {GROTH16_BYTES} B")
    elif proof.r1cs_verifier_proof is not None:
        raise AssertionError(f"{what}: a Groth16 proof without the Groth16 keys")
    back = proofs.parse_testudo_snark(blob)
    if proofs.ser_testudo_snark(back) != blob:
        raise AssertionError(f"{what}: the proof does not re-serialize to its bytes")
    with timer.record() as rec:
        ok, verify_cold = timed_once(lambda: verify(proof))
    verify_cold_split = _labels(rec, GROTH16_VERIFY_LABELS)
    if ok is not True:
        raise AssertionError(f"{what}: the verifier rejected an honest proof")
    if verify(back) is not True:
        raise AssertionError(f"{what}: the verifier rejected the proof read back by the codec")
    e = proof.inst_evals
    bumped = snark.TestudoSnark(proof.r1cs_sat_proof, proof.r1cs_eval_proof,
                                ((e[0] + 1) % R, e[1], e[2]), proof.r, proof.r1cs_verifier_proof)
    if verify(bumped) is not False:
        raise AssertionError(f"{what}: the verifier accepted inst_evals[0] + 1")
    flipped = bytearray(blob)
    flipped[sizes[0] + sizes[1] - 32] ^= 1  # the low byte of the eval proof's last scalar
    if verify(proofs.parse_testudo_snark(bytes(flipped))) is not False:
        raise AssertionError(f"{what}: the verifier accepted a flipped byte of the eval proof")
    rejects = "inst_evals[0] + 1 and a flipped byte of the eval proof"
    if groth16_part:
        cp = proof.r1cs_verifier_proof.circuit_proof
        neg_c = r1csproof.R1CSVerifierProof(**{**vars(proof.r1cs_verifier_proof),
                                               "circuit_proof": groth16.Proof(cp.a, cp.b,
                                                                              hc.g1_neg(cp.c))})
        if verify(snark.TestudoSnark(proof.r1cs_sat_proof, proof.r1cs_eval_proof, e, proof.r,
                                     neg_c)) is not False:
            raise AssertionError(f"{what}: the verifier accepted the Groth16 proof with -C")
        rejects += ", a Groth16 proof with -C"

    # the evaluations Spark proves, in Python ints
    t0 = time.perf_counter()
    eq_x, eq_y = host_eq(rx), host_eq(ry)
    want = tuple(sum(v * eq_x[r_] * eq_y[c_] for r_, c_, v in
                     zip(m.rows.tolist(), m.cols.tolist(), m.vals)) % R
                 for m in (inst.inst.A, inst.inst.B, inst.inst.C))
    if tuple(e) != want:
        raise AssertionError(f"{what}: inst_evals differ from the host sums at (rx, ry)")
    host_s = time.perf_counter() - t0

    walls, splits, counts_prove = [], [], {}
    for _ in range(warm):
        build.reset_launches()
        with timer.record() as rec:
            p2, ms = timed_once(prove)
        counts_prove = dict(build.LAUNCHES)
        walls.append(ms / 1e3)
        splits.append(split_of(rec))
        if proofs.ser_testudo_snark(p2) != blob:
            raise AssertionError(f"{what}: a warm prove under the same blinds gave other bytes")
    build.reset_launches()
    with timer.record() as rec:
        ok, verify_warm = timed_once(lambda: verify(proof))
    counts_verify = dict(build.LAUNCHES)
    verify_parts = _split(rec)
    if ok is not True:
        raise AssertionError(f"{what}: the warm verify rejected")
    by_path = {"snark_encode": counts_encode, "snark_verify": counts_verify}
    if warm:
        by_path["snark_prove"] = counts_prove
    if groth16_part:
        by_path["snark_groth16_setup"] = counts_setup
        cs = None
        if log2n == 12:
            t0 = time.perf_counter()
            cs = groth16_spot_checks(what, gens, inst, inputs, proof, gens.gens_gc.pk.domain_log)
            say(f"  {what} Groth16 spot checks: {time.perf_counter() - t0:.1f} s")
        if cs is None:
            cs = circuit.build_verifier_circuit(r1csproof.verifier_config(
                proof.r1cs_sat_proof, n, n, inputs.assignment, e))
        build.reset_launches()
        gp = groth16.prove(gens.gens_gc.pk, cs, random.Random(log2n))
        by_path["groth16_prove"] = dict(build.LAUNCHES)
        if not groth16.verify(gens.gens_gc.vk, cs.public_inputs(), gp):
            raise AssertionError(f"{what}: groth16.prove on the proof's circuit did not verify")
    for path, names in _SNARK_MUST.items():
        if path not in by_path:
            continue
        missing = [k for k in names if not by_path[path][k]]
        if missing:
            raise AssertionError(f"{what}: path {path} launched none of {missing}")
    prof_line = nizk_profile(prove) if profiled else "not profiled in this run"

    nz = lambda d: {k: v for k, v in d.items() if v}
    say(f"{what} ({n} constraints, {n} variables, {NIZK_INPUTS} inputs, {n} nonzero entries a "
        f"matrix): sat {sizes[0]} B, eval {sizes[1]} B, total {sizes[2]} B"
        + (f" (Groth16 proof {GROTH16_BYTES} B; circuit of {gens.gens_gc.pk.num_vars} variables, "
           f"domain 2^{gens.gens_gc.pk.domain_log})" if groth16_part else "")
        + f"; codec round trip, verified; {rejects} rejected; inst_evals "
        f"equal Python ints ({host_s:.1f} s of host checks); instance built in {inst_s:.1f} s")
    say(f"  {what} times: setup (cold) {setup_ms / 1e3:.4f} s {json.dumps(setup_split)}; encode "
        f"(cold) {encode_ms / 1e3:.4f} s {json.dumps(encode_split)}; prove cold "
        f"{prove_cold / 1e3:.4f} s {json.dumps(split_cold)}; verify cold {verify_cold / 1e3:.4f} s "
        f"{json.dumps(verify_cold_split)}, warm {verify_warm / 1e3:.4f} s")
    if walls:
        say(f"  {what} warm proves: {[round(x, 4) for x in walls]} s, median "
            f"{statistics.median(walls):.4f} s")
    for i, sp in enumerate(splits):
        say(f"  {what} warm prove {i} split (s): {json.dumps(sp)}")
    say(f"  {what} verify parts (s): {json.dumps(verify_parts)}")
    say(f"  {what} {prof_line}")
    for path, counts in by_path.items():
        say(f"  {what} launches, {path}: {json.dumps(nz(counts))}")
    return by_path


# ---------------------------------------------------------------------------
# BW6-761: the one-level wrap (device/curve_generic.py, msm_fp,
# core/circuit_verifier.py, core/groth16_bw6.py)
# ---------------------------------------------------------------------------


def bw6_groups():
    return (("g1", cg.bw6_g1(), bw.g1_generator, bw.g1_add, bw.g1_mul),
            ("g2", cg.bw6_g2(), bw.g2_generator, bw.g2_add, bw.g2_mul))


def phase_bw6_msm(dev):
    """msm_fp on BW6 G1 and G2 at a key's width: 2^13 bases k_i * G with
    known 20-bit k_i (one fixed_base_mul), tiled to BW6_MSM_LANES, times
    random scalars below r (24 limbs); the result is checked exactly as one
    host multiplication of G by sum k_i s_i mod r.  Cold and warm calls are
    timed.  Then one MSM of the small path (50 points, G1) against a host MSM."""
    rng = np.random.default_rng(61)
    reps = BW6_MSM_LANES // N_UNIQUE
    ks = [int(k) for k in rng.integers(1, 1 << 20, size=N_UNIQUE)]
    scal = rng.integers(0, 1 << 16, size=(BW6_MSM_LANES, FQ.nlimbs), dtype=np.int64)
    scal[:, -1] &= 0x00FF  # 376-bit scalars, all below r
    sums = scal.reshape(reps, N_UNIQUE, FQ.nlimbs).sum(axis=0)
    dlog = sum(sum(int(v) << (16 * i) for i, v in enumerate(row)) * k
               for row, k in zip(sums, ks)) % R_BW6
    st = torch.as_tensor(scal.astype(np.int32), device=dev)
    ks_t = torch.as_tensor(FQ.to_limbs(ks), device=dev)
    out = {}
    for name, G, gen, add, mul in bw6_groups():
        (uniq, fb_ms) = timed_once(lambda: cg.fixed_base_mul(G, ks_t, gen(), add))
        if G.to_affine_host(tuple(c[:2] for c in uniq)) != [mul(gen(), k) for k in ks[:2]]:
            raise AssertionError(f"BW6 {name}: fixed_base_mul differs from the host")
        bases = tuple(c.repeat(reps, 1) for c in uniq)
        want = mul(gen(), dlog)
        got, cold = timed_once(lambda: msm.msm_fp(G, add, bases, st))
        got2, warm = timed_once(lambda: msm.msm_fp(G, add, bases, st))
        if got != want or got2 != want:
            raise AssertionError(f"BW6 {name}: msm_fp differs from the host at {BW6_MSM_LANES}")
        small_ms = None
        if name == "g1":  # one MSM of the small path against a host MSM
            pts = [mul(gen(), int(k)) for k in rng.integers(1, 1 << 62, size=BW6_SMALL)]
            ss = [int.from_bytes(rng.bytes(48), "little") % R_BW6 for _ in range(BW6_SMALL)]
            small, small_ms = timed_once(lambda: msm.msm_fp(
                G, add, G.from_affine_host(pts, device=dev),
                torch.as_tensor(FQ.to_limbs(ss), device=dev)))
            acc = None
            for p_, s_ in zip(pts, ss):
                acc = add(acc, mul(p_, s_))
            if small != acc:
                raise AssertionError(f"BW6 {name}: the small path of msm_fp differs from the host")
        out[name] = {"lanes": BW6_MSM_LANES, "cold_s": cold / 1e3, "warm_s": warm / 1e3,
                     "small_ms": small_ms, "fixed_base_2^13_ms": fb_ms}
        tail = "" if small_ms is None else (
            f"; the small path ({BW6_SMALL} points) = host MSM, {small_ms:.1f} ms")
        say(f"BW6 {name}: msm_fp at {BW6_MSM_LANES} = host (G * sum k_i s_i), cold "
            f"{cold / 1e3:.3f} s, warm {warm / 1e3:.3f} s{tail}; fixed_base_mul of 2^13 bases "
            f"{fb_ms:.1f} ms")
        del bases
    return out


def _toy_fq_circuit(x: int, y: int):
    """public x and x * y + 3, witness y (tests/test_groth16_bw6.py:16-25)."""
    cs = circuit.ConstraintSystem(modulus=R_BW6)
    xv = cs.alloc_input(x)
    out = cs.alloc_input((x * y + 3) % R_BW6)
    yv = cs.alloc_witness(y)
    cs.enforce_equal(cs.mul(xv, yv) + 3, out)
    return cs


def phase_bw6_toy(dev):
    """The toy Fq circuit proved over BW6 on the card: verify accepts, the
    public input + 1 is rejected."""
    rng = random.Random(19)
    cs = _toy_fq_circuit(rng.randrange(R_BW6), rng.randrange(R_BW6))
    t0 = time.time()
    pk, vk = groth16_bw6.setup(cs, device=dev)
    t1 = time.time()
    proof = groth16_bw6.prove(pk, cs, rng=random.Random(3))
    t2 = time.time()
    pub = cs.public_inputs()
    bad = [pub[0], (pub[1] + 1) % R_BW6]
    if not groth16_bw6.verify(vk, pub, proof) or groth16_bw6.verify(vk, bad, proof):
        raise AssertionError("BW6 toy circuit: verify does not accept the proof or accepts x*y+4")
    say(f"BW6 toy circuit (3 public, 2 constraints): setup {t1 - t0:.2f} s, prove "
        f"{t2 - t1:.2f} s, verify accepts, the public input + 1 is rejected")


def bw6_key_spot_checks(pk, vk, sc):
    """8 lanes of each key batch and every gamma_abc point against the host's
    multiples of the generators by the setup's scalars."""
    g1, g2 = bw.g1_generator(), bw.g2_generator()
    G1, G2 = cg.bw6_g1(), cg.bw6_g2()
    for name, scal, G, gen, mul in (("a_query", sc.a, G1, g1, bw.g1_mul),
                                    ("b_g1_query", sc.b, G1, g1, bw.g1_mul),
                                    ("b_g2_query", sc.b, G2, g2, bw.g2_mul),
                                    ("h_query", sc.h, G1, g1, bw.g1_mul),
                                    ("l_query", sc.l, G1, g1, bw.g1_mul)):
        batch = getattr(pk, name)
        if batch[0].shape[0] != len(scal):
            raise AssertionError(f"BW6 {name}: {batch[0].shape[0]} lanes for {len(scal)} scalars")
        lanes = sorted({0, 1, len(scal) - 1, *np.linspace(0, len(scal) - 1, 5).astype(int)})
        idx = torch.as_tensor(lanes, device=batch[0].device)
        got = G.to_affine_host(tuple(c.index_select(0, idx) for c in batch))
        if got != [mul(gen, scal[i]) for i in lanes]:
            raise AssertionError(f"BW6 {name}: key lanes differ from the host's multiples")
    if vk.gamma_abc_g1 != [bw.g1_mul(g1, s) for s in sc.gamma_abc]:
        raise AssertionError("BW6 gamma_abc differs from the host's multiples")


def phase_bw6_wrap(dev, nv: int):
    """The fork's wrap at full width (tests/test_groth16_bw6.py:50-70 at nv):
    a sqrt-PST commit and open of a random 2^nv table on the card with the Fq
    transcript, the port's verifier accepts; build_comm_verifier, satisfied,
    its shape printed and held to BW6_SHAPES; groth16_bw6 setup (the keys
    spot-checked against the host), prove, verify; -C and another A are
    rejected.  Timed by Timer labels; the launches of the setup and of the
    prove are counted (paths bw6_setup, bw6_prove)."""
    pf = cprof.bls12_377(dev)
    rng = random.Random(57 + nv)
    t0 = time.time()
    ck, vk_pst = pst.setup(nv // 2 + nv % 2, profile=pf)
    Z = [rng.randrange(R) for _ in range(1 << nv)]
    point = [rng.randrange(R) for _ in range(nv)]
    pl = sqrt_pst.Polynomial.from_evaluations(dense.encode_table(Z, device=dev), pf)
    v = pl.eval(point)
    comm, T = pl.commit(ck)
    U, pst_proof, mipp_proof = pl.open(PoseidonTranscript(fq_params()), comm, ck, point, T)
    if not sqrt_pst.verify(PoseidonTranscript(fq_params()), vk_pst, U, point, v, pst_proof,
                           mipp_proof, T):
        raise AssertionError(f"BW6 wrap nv={nv}: the sqrt-PST opening does not verify")
    t_open = time.time() - t0
    t0 = time.time()
    cs = circuit_verifier.build_comm_verifier(vk_pst, U, point, v, pst_proof, mipp_proof, T)
    t_build = time.time() - t0
    t0 = time.time()
    if not cs.is_satisfied():
        raise AssertionError(f"BW6 wrap nv={nv}: the comm-verifier system is not satisfied")
    t_sat = time.time() - t0
    m = groth16_bw6._domain_size(cs)
    shape = (len(cs.constraints), len(cs.values), m.bit_length() - 1)
    say(f"BW6 wrap nv={nv}: sqrt-PST commit + open + verify on the card {t_open:.1f} s; "
        f"TestudoCommVerifier {shape[0]} constraints, {shape[1]} variables, "
        f"{len(cs.public_inputs())} public inputs, domain 2^{shape[2]}; build {t_build:.1f} s, "
        f"is_satisfied {t_sat:.1f} s")
    if shape != BW6_SHAPES[nv] or cs.public_inputs():
        raise AssertionError(f"BW6 wrap nv={nv}: shape {shape}, expected {BW6_SHAPES[nv]}")
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.time()
    with timer.record() as rec:
        tl = timer.Timer("groth16_bw6::lagrange")  # setup's own label, its scalars kept
        sc = groth16_bw6.setup_scalars(cs)
        tl.stop()
        pk, vk = groth16_bw6.setup(cs, device=dev, scalars=sc)
    torch.cuda.synchronize()
    t_setup = time.time() - t0
    counts_setup = dict(build.LAUNCHES)
    setup_split = _split(rec)
    bw6_key_spot_checks(pk, vk, sc)
    del sc
    build.reset_launches()
    t0 = time.time()
    with timer.record() as rec:
        proof = groth16_bw6.prove(pk, cs, rng=random.Random(nv))
    torch.cuda.synchronize()
    t_prove = time.time() - t0
    counts_prove = dict(build.LAUNCHES)
    prove_split = _split(rec)
    t0 = time.time()
    ok = groth16_bw6.verify(vk, [], proof)
    t_verify = time.time() - t0
    neg_c = groth16_bw6.Proof(proof.a, proof.b, bw.g1_neg(proof.c))
    other_a = groth16_bw6.Proof(bw.g1_add(proof.a, bw.g1_generator()), proof.b, proof.c)
    if not ok or groth16_bw6.verify(vk, [], neg_c) or groth16_bw6.verify(vk, [], other_a):
        raise AssertionError(f"BW6 wrap nv={nv}: verify does not accept, or accepts -C / another A")
    res = {"nv": nv, "constraints": shape[0], "variables": shape[1], "public_inputs": 0,
           "domain_log": shape[2], "open_s": t_open, "circuit_build_s": t_build,
           "is_satisfied_s": t_sat, "setup_s": t_setup, "setup_split": setup_split,
           "prove_s": t_prove, "prove_split": prove_split, "verify_s": t_verify,
           "launches_setup": {k: n for k, n in counts_setup.items() if n},
           "launches_prove": {k: n for k, n in counts_prove.items() if n}}
    say(f"BW6 wrap nv={nv}: setup {t_setup:.1f} s {json.dumps(setup_split)}; key lanes = host "
        f"multiples; prove {t_prove:.1f} s {json.dumps(prove_split)}; verify {t_verify:.2f} s "
        f"accepts, -C and another A rejected")
    say(f"  launches: setup {json.dumps(res['launches_setup'])}, prove "
        f"{json.dumps(res['launches_prove'])}")
    say("BW6 wrap " + json.dumps(res))
    del pk, vk, cs
    torch.cuda.empty_cache()
    return {"bw6_setup": counts_setup, "bw6_prove": counts_prove}


def kernels_bw6(dev, rep: Report, quick: bool):
    """The 761-bit row-major product against its plain version at the
    path's shapes: a complete add's six stacked products over 2^20 lanes
    (the MSM's bucket slices; the setup's are the key width), the b3 pair
    with one shared operand, the weighted sum's 384 lanes, and a ragged
    2^16 + ODD with 0, 1, q - 1, R mod q and r mixed in.  Its time at 2^20
    elements (torch.profiler, L2 flushed, and warm) beside bound_ms and the
    latency of one dependent product at one warp (the 48-limb chain)."""
    S = cg.FQ761
    q = S.modulus
    lanes = (1 << 12) if quick else (1 << 20)
    rng = np.random.default_rng(77)

    def rows(shape):
        v = rng.integers(0, 1 << 16, size=shape + (S.nlimbs,), dtype=np.int64)
        v[..., -1] &= 0x00FF  # below q
        return torch.as_tensor(v.astype(np.int32), device=dev)

    edges = torch.as_tensor(S.to_limbs([0, 1, q - 1, S.r_mod_p, R_BW6]), device=dev)
    cases = []
    for shape, shared in (((6, lanes), False), ((2, lanes), True), ((6, 384), False),
                          (((1 << 16) + ODD,), False)):
        a, b = rows(shape), rows(shape)
        flat_a, flat_b = a.view(-1, S.nlimbs), b.view(-1, S.nlimbs)
        flat_a[:5], flat_b[:5] = edges, edges.flip(0)
        if shared:
            b = b.reshape(-1, S.nlimbs)[3].clone()
        cases.append((shape, shared, a, b))
    got, want = [], []
    for shape, shared, a, b in cases:
        got.append(tf.mont_mul(S, a, b))
        want.append(tf.mont_mul_plain(S, a, b))
    n = 1 << 16 if quick else 1 << 20
    a, b = rows((n,)), rows((n,))
    flush = exp_mont_rm.l2_flusher(dev)
    out = torch.empty_like(a)
    raw = lambda: build.launch("mont_mul_rm", a.data_ptr(), b.data_ptr(), out.data_ptr(),
                               packed_field.field_id(S), n, 0, counted_as="mont_mul_rm_bw6fq")
    raw()
    if not torch.equal(out, tf.mont_mul_plain(S, a, b)):
        raise AssertionError("mont_mul_rm_bw6fq: the raw launch differs from the plain version")
    ms = exp_mont_rm.profiled_ms(raw, exp_mont_rm.KERNEL, flush=flush)
    if ms is None:
        raise AssertionError("torch.profiler saw no device time of the 761-bit product")
    l2_ms = exp_mont_rm.profiled_ms(raw, exp_mont_rm.KERNEL)
    raw_ms = exp_mont_rm.events_ms(raw)
    plain_ms = time_ms(lambda: tf.mont_mul_plain(S, a, b), 1)
    lat = exp_montmul.measure_latency(S, dev)["inline"]["us_per_product"]
    madd = exp_montmul.madds_per_product(S)
    label = (f"({n}, 48) bw6fq, two full operands; compared at "
             + ", ".join(f"{tuple(s) + (48,)}{' shared b' if sh else ''}" for s, sh, _, _ in cases))
    rep.add("mont_mul_rm_bw6fq", got, want, ms, plain_ms, 3 * S.nlimbs * 4 * n, madd * n, label)
    ptx = [ln for ln in build.build_report()["ptxas"] if "Fq761" in ln]
    rep.rows["mont_mul_rm_bw6fq"].update({
        "kernel_l2_ms": l2_ms, "raw_ms": raw_ms, "latency_bound_ms": lat / 1e3,
        "library_ms": None, "ptxas": ptx})
    say(f"  761-bit product at 2^{n.bit_length() - 1}: L2-warm {l2_ms:.4f} ms, raw launches "
        f"{raw_ms:.4f} ms; one dependent product at one warp {lat:.3f} us; "
        + "; ".join(ptx))


def _proof_key_381(pf, proof) -> tuple:
    """An R1CS proof over BLS12-381 as plain values (the GT elements through
    `ser_gt`), to hold two proofs equal."""
    m = proof.mipp_proof
    polys = lambda sc: [(p.coeffs, p.modulus) for p in sc.polys]
    return (proof.comm_U, polys(proof.sc_proof_phase1), proof.claims_phase2,
            polys(proof.sc_proof_phase2), proof.eval_vars_at_ry, proof.proof_eval_vars_at_ry,
            proof.rx, proof.ry, proof.transcript_sat_state, proof.initial_state,
            pf.ser_gt(proof.t), [tuple(pf.ser_gt(x) for x in pair) for pair in m.comms_t],
            m.comms_u, m.final_a, m.final_h, m.pst_proof_h)


def phase_bls381(dev, log2n: int, profiled: bool = True) -> dict:
    """The R1CS proof over BLS12-381 (Testudo's check_r1cs_proof_bls12_381,
    r1csproof.rs:754-801, at produce_synthetic_r1cs(2^log2n, 2^log2n, 10))
    through `curves.profile.bls12_381(dev)`: the Fr tables on the card, the
    groups, pairings and Poseidon on the host, the looped sumcheck.
    `R1CSGens.setup`, `prove`, then the verifier's `inst.evaluate` and
    `verify_native`, which accepts; eval_vars_at_ry + 1 and a wrong input
    are rejected; eval_vars_at_ry, the phase-2 claims and (A~, B~, C~)(rx,
    ry) equal Python ints mod r381.  A PST commit -> open -> check round trip
    on the setup's key, a wrong value rejected.  Setup and prove split by
    their Timer labels; with `profiled` one more prove under torch.profiler
    (the device's busy time in it), equal to the first.  Every path launches
    the row-major product at fr381 and nothing else; their launches are
    returned by path."""
    import random

    pf = cprof.bls12_381(dev)
    Rm = pf.R
    n = 1 << log2n
    what = f"BLS12-381 2^{log2n}"
    t0 = time.perf_counter()
    inst, vars_, inputs = r1cs.R1CSInstance.produce_synthetic_r1cs(
        n, n, BLS381_INPUTS, seed=log2n, spec=pf.fr_spec)
    build_s = time.perf_counter() - t0
    counts = {}

    build.reset_launches()
    with timer.record() as rec:
        gens, setup_ms = timed_once(lambda: r1csproof.R1CSGens.setup(n, profile=pf))
    counts["bls381_setup"] = dict(build.LAUNCHES)
    setup_split = _split(rec)
    setup_split["rest"] = round(setup_ms / 1e3 - sum(setup_split.values()), 4)

    def prove():
        return r1csproof.prove(inst, vars_, inputs, gens, PoseidonTranscript(fr_params_381()))

    build.reset_launches()
    with timer.record() as rec:
        (proof, rx, ry), prove_ms = timed_once(prove)
    counts["bls381_prove"] = dict(build.LAUNCHES)
    prove_split = _nizk_split(rec)

    evals_box = {}

    def verify(p, ins=inputs):
        evals_box["evals"], evals_box["ms"] = timed_once(lambda: inst.evaluate(rx, ry, dev))
        return r1csproof.verify_native(p, evals_box["evals"], n, n, ins, gens,
                                       PoseidonTranscript(fr_params_381()))

    build.reset_launches()
    ok, verify_ms = timed_once(lambda: verify(proof))
    counts["bls381_verify"] = dict(build.LAUNCHES)
    if ok is not True:
        raise AssertionError(f"{what}: the verifier rejected the proof")
    eval_ms = evals_box["ms"]
    bad = dataclasses.replace(proof, eval_vars_at_ry=(proof.eval_vars_at_ry + 1) % Rm)
    if verify(bad) is not False:
        raise AssertionError(f"{what}: the verifier accepted eval_vars_at_ry + 1")
    if verify(proof, [(inputs[0] + 1) % Rm] + inputs[1:]) is not False:
        raise AssertionError(f"{what}: the verifier accepted a wrong input")

    # exact checks in Python ints mod r381, independent of the verifier
    if proof.eval_vars_at_ry != host_evaluate(list(vars_), ry[1:], Rm):
        raise AssertionError(f"{what}: eval_vars_at_ry differs from the witness at ry[1:]")
    z = inst.z_vector(vars_, inputs)
    mats = (inst.A, inst.B, inst.C)
    claims = [host_evaluate(host_mat_vec(m, z, n, Rm), rx, Rm) for m in mats]
    c2 = proof.claims_phase2
    if list(c2[:3]) != claims or c2[3] != claims[0] * claims[1] % Rm:
        raise AssertionError(f"{what}: the phase-2 claims differ from A z, B z, C z at rx")
    eq_x, eq_y = host_eq(rx, Rm), host_eq(ry, Rm)
    want = tuple(sum(v * eq_x[r_] * eq_y[c_] for r_, c_, v in
                     zip(m.rows.tolist(), m.cols.tolist(), m.vals)) % Rm for m in mats)
    if evals_box["evals"] != want:
        raise AssertionError(f"{what}: inst.evaluate(rx, ry) on the card differs from the host sum")

    prof_line = "no profiled prove"
    if profiled:
        box = {}
        pp = exp_mont_rm.prove_profile(lambda: box.setdefault("out", prove()))
        if _proof_key_381(pf, box["out"][0]) != _proof_key_381(pf, proof):
            raise AssertionError(f"{what}: the profiled prove gave another proof")
        if pp["kernels"]:
            classes = "; ".join(f"{k} {c['launches']}" for k, c in pp["by_class"].items())
            prof_line = (
                f"profiled prove {pp['wall_ms_profiled'] / 1e3:.3f} s: device busy "
                f"{pp['device_ms']:.3f} ms ({pp['device_ms'] / pp['wall_ms_profiled']:.3%} of "
                f"it) over {pp['kernels']} CUDA events, mont_mul_rm {pp['mont_mul_rm_ms']:.3f} ms "
                f"over {pp['mont_mul_rm_launches']} launches (by size class: {classes}); largest: "
                + "; ".join(f"{nm[:50]} {ms:.3f} ms x {cnt}" for nm, ms, cnt in pp["largest"]))
        else:
            prof_line = "device busy time in a prove: not measured (torch.profiler saw no device events)"

    # PST commit -> open -> check on the setup's key (its nv variables)
    prng = random.Random(log2n)
    nv = gens.ck.nv
    vals = [prng.randrange(Rm) for _ in range(1 << nv)]
    point = [prng.randrange(Rm) for _ in range(nv)]
    build.reset_launches()

    def pst_round():
        table = dense.encode_table(vals, pf.fr_spec, dev)
        C = pst.commit(gens.ck, table)
        pis = pst.open_(gens.ck, table, point)
        return table, C, pis

    (table, C, pis), pst_ms = timed_once(pst_round)
    v = host_evaluate(vals, point, Rm)
    if dense.evaluate(table, point, pf.fr_spec) != v:
        raise AssertionError(f"{what}: the PST table's evaluation differs from the host's")
    if not pst.check(gens.vk, C, point, v, pis):
        raise AssertionError(f"{what}: PST check rejected an honest opening")
    if pst.check(gens.vk, C, point, (v + 1) % Rm, pis):
        raise AssertionError(f"{what}: PST check accepted the value + 1")
    counts["bls381_pst"] = dict(build.LAUNCHES)

    for path, snap in counts.items():
        others = {k: c for k, c in snap.items() if c and k != "mont_mul_rm_fr381"}
        if others or not snap["mont_mul_rm_fr381"]:
            raise AssertionError(f"{what}: path {path} launched {others or 'no fr381 product'}")
    say(f"{what} ({n} constraints, {n} variables, {BLS381_INPUTS} inputs, seed {log2n}; instance "
        f"built in {build_s:.2f} s): proved with the Fr tables on the card and the groups on the "
        f"host, verified; eval_vars_at_ry + 1 and a wrong input rejected; eval_vars_at_ry, the "
        f"phase-2 claims and (A~, B~, C~)(rx, ry) equal Python ints mod r381; PST (nv = {nv}) "
        f"commit + open {pst_ms / 1e3:.3f} s, checked, value + 1 rejected")
    say(f"  {what} times (s): setup {setup_ms / 1e3:.3f} {json.dumps(setup_split)}; prove "
        f"{prove_ms / 1e3:.3f} {json.dumps(prove_split)}; verify {verify_ms / 1e3:.3f} "
        f"(A~, B~, C~(rx, ry) on the card {eval_ms / 1e3:.4f}, the rest native checks on the host)")
    say(f"  {what} {prof_line}")
    say(f"  {what} launches: " + "; ".join(
        f"{path} {snap['mont_mul_rm_fr381']}" for path, snap in counts.items())
        + " (mont_mul_rm_fr381; no other kernel)")
    return counts


def kernels_fr381(dev, rep: Report, quick: bool):
    """The row-major product at BLS12-381's Fr against its plain version
    (exact): 2^20 + ODD elements (2^12 + ODD with `quick`) with two full
    operands (the narrow form) and times one shared element (the tiled form
    past 8,192), 8,192 + ODD times a shared element (narrow), and the proof's
    2^10 and 2^11 tables; among the first operands R - 1 (below R, above r:
    what `_fold_wide` hands the product), r - 1, 0, 1 and R mod r, the
    second operands canonical.  A stride of the products against Python
    ints; K1 (`mont_mul_rows`) at fr381 on 2^16 + ODD lanes.  Timed (device
    time, L2 flushed before each launch) at 2^20 with two full operands
    beside bound_ms, the plain version and the latency of one dependent
    product at one warp; the shared b and the proof's 2^10 and 2^11 tables
    beside it."""
    S = FR381
    r = S.modulus
    big = 1 << 12 if quick else 1 << 20
    rng = np.random.default_rng(381)

    def rows(count):
        v = rng.integers(0, 1 << 16, size=(count, S.nlimbs), dtype=np.int64)
        v[:, -1] &= 0x3FFF  # below r: its top limb is 0x73ed
        return v

    edges_a = np.concatenate([np.full((1, S.nlimbs), 0xFFFF, dtype=np.int64),
                              S.to_limbs([r - 1, 0, 1, S.r_mod_p]).astype(np.int64)])
    edges_b = S.to_limbs([S.r_mod_p, r - 1, 1, 0, r - 1]).astype(np.int64)
    cases = []
    for count, shared in ((big + ODD, False), (big + ODD, True), ((1 << 13) + ODD, True),
                          (1 << 10, False), (1 << 11, False)):
        a, b = rows(count), rows(count)
        a[:5], b[:5] = edges_a, edges_b
        at = torch.as_tensor(a.astype(np.int32), device=dev)
        bt = torch.as_tensor(b.astype(np.int32), device=dev)
        cases.append((count, shared, at, bt[1].clone() if shared else bt))
    got = [tf.mont_mul(S, a, b) for _, _, a, b in cases]
    want = [tf.mont_mul_plain(S, a, b) for _, _, a, b in cases]
    rinv = pow(S.mont_r, -1, r)
    for (count, shared, a, b), g in zip(cases, got):
        idx = list(range(8)) + list(range(8, count, max(1, count // 64)))
        xs, ys = S.from_limbs(a[idx]), S.from_limbs(b if shared else b[idx])
        ys = ys * len(idx) if shared else ys
        if S.from_limbs(g[idx]) != [x * y * rinv % r for x, y in zip(xs, ys)]:
            raise AssertionError(f"mont_mul_rm_fr381 at {count}: products differ from Python ints")
    m1 = (1 << 12 if quick else 1 << 16) + ODD
    a1, b1 = cases[0][2][:m1].T.contiguous(), cases[0][3][:m1].T.contiguous()
    if max_abs_err(packed_field.mont_mul_rows(S, a1, b1),
                   packed_field.mont_mul_rows_plain(S, a1, b1)) != 0:
        raise AssertionError("K1 (mont_mul_rows) at fr381 differs from its plain version")

    flush = exp_mont_rm.l2_flusher(dev)
    label = f"({big}, 16) fr381, two full operands"
    m = exp_mont_rm.measure_shape(label, S, big, False, dev, flush=flush)
    if m["kernel_ms"] is None:
        raise AssertionError("torch.profiler saw no device time of the fr381 product")
    a0, b0 = exp_mont_rm.operands(S, big, False, seed=5, device=dev)
    plain_ms = time_ms(lambda: tf.mont_mul_plain(S, a0, b0), 1)
    madd = exp_montmul.madds_per_product(S)
    lat = exp_montmul.measure_latency(S, dev)["inline"]["us_per_product"]
    compared = ", ".join(f"({c}, 16){' shared b' if sh else ''}" for c, sh, _, _ in cases)
    rep.add("mont_mul_rm_fr381", got, want, m["kernel_ms"], plain_ms, 3 * S.nlimbs * 4 * big,
            madd * big, label + f"; compared at {compared}")
    shapes = [{k: v for k, v in exp_mont_rm.measure_shape(lbl, S, cnt, sh, dev, flush).items()
               if k in ("shape", "kernel_ms", "kernel_l2_ms", "raw_ms", "call_ms", "bound_ms")}
              for lbl, cnt, sh in ((f"({big}, 16) fr381, shared b", big, True),
                                   ("(2^11, 16) fr381", 1 << 11, False),
                                   ("(2^10, 16) fr381", 1 << 10, False),
                                   ("(2^10, 16) fr381, shared b", 1 << 10, True))]
    ptx = [ln for ln in build.build_report()["ptxas"] if "Fr381" in ln]
    rep.rows["mont_mul_rm_fr381"].update({
        "kernel_l2_ms": m["kernel_l2_ms"], "raw_ms": m["raw_ms"], "call_ms": m["call_ms"],
        "latency_bound_ms": lat / 1e3, "library_ms": None, "shapes": shapes, "ptxas": ptx})
    say(f"  fr381 product at {big}: L2-warm {m['kernel_l2_ms']:.5f} ms, raw launches "
        f"{m['raw_ms']:.5f} ms, through field.mont_mul {m['call_ms']:.5f} ms; one dependent "
        f"product at one warp {lat:.4f} us; K1 at fr381 equal to its plain version on {m1} lanes")
    for row in shapes:
        say(f"  {row['shape']}: kernel {row['kernel_ms']:.5f} ms, L2-warm {row['kernel_l2_ms']:.5f}, "
            f"raw {row['raw_ms']:.5f}, call {row['call_ms']:.5f}, bound {row['bound_ms']:.6f}")
    for ln in ptx:
        say("  " + ln)


# ---------------------------------------------------------------------------
# The mesh: the sharded paths on shards of the card (parallel/mesh.py)
# ---------------------------------------------------------------------------


def make_shards(dev, D: int):
    """D shards: the card listed D times on a one-card machine, else the
    first D cards (`shard_mesh`)."""
    mesh = pmesh.shard_mesh(D, dev)
    say(f"mesh: {mesh.size} shards on {[str(d) for d in mesh.devices]}")
    return mesh


def turns(fn, reps: int = 3):
    """Walls (s) of `reps` turns of fn(False) and fn(True) (unsharded, then
    sharded), each synchronised on both sides, and the launches of the last
    sharded call; every call's result must equal the first's."""
    walls = {False: [], True: []}
    first, counts = None, None
    for i in range(reps):
        for sharded in (False, True):
            if sharded and i == reps - 1:
                build.reset_launches()
            out, ms = timed_once(lambda: fn(sharded))
            if sharded and i == reps - 1:
                counts = dict(build.LAUNCHES)
            if first is None:
                first = out
            elif out != first:
                raise AssertionError("a warm call changed its answer")
            walls[sharded].append(ms / 1e3)
    return walls, counts


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _walls(w) -> str:
    return f"{[round(x, 4) for x in w]} s, median {statistics.median(w):.4f} s"


def mesh_msm(dev, mesh, grp, affine_pts, ks) -> dict:
    """msm(affine=True) at 2^20 sharded over the mesh: equal to the unsharded
    result and to the host value; warm walls of both in turns; the launches
    of one warm sharded call."""
    N = 1 << 20
    pts = tile(affine_pts, N // N_UNIQUE)
    scal_np = random_scalars(N, 7)
    scal = torch.as_tensor(scal_np, device=dev)
    want = expected_msm(grp, scal_np, ks)

    def call(sharded):
        with pmesh.use_mesh(mesh if sharded else None):
            return grp.msm(pts, scal, affine=True, device=dev)

    one, _ = timed_once(lambda: call(False))
    got, cold = timed_once(lambda: call(True))
    if got != one or got != want:
        raise AssertionError(f"msm_{grp.name} at 2^20 on {mesh.size} shards differs from the "
                             f"unsharded result or the host value")
    walls, counts = turns(call)
    say(f"mesh msm_{grp.name} N=2^20 on {mesh.size} shards: equal to the unsharded result and the "
        f"host value; sharded cold {cold / 1e3:.4f} s, warm {_walls(walls[True])}; unsharded "
        f"warm {_walls(walls[False])}")
    say(f"  launches, one warm sharded msm_{grp.name}: {json.dumps(_nonzero(counts))}")
    return counts


def mesh_commit(dev, mesh) -> dict:
    """The sqrt-PST commit at nv = 20 sharded over the mesh (its 1,024
    columns in blocks): the column commitments limb-equal and, in affine,
    equal to the unsharded ones, T byte-equal; warm walls of both in turns;
    the launches of one warm sharded commit."""
    nv = 20
    pf = cprof.bls12_377(dev)
    ck, _ = pst.setup(nv - nv // 2, profile=pf)
    table = dense._to_mont_dev(torch.as_tensor(random_scalars(1 << nv, 7), device=dev))
    pl = sqrt_pst.Polynomial.from_evaluations(table, pf)

    def commit(sharded):
        with pmesh.use_mesh(mesh if sharded else None):
            comm, T = pl.commit(ck)
        return pf.g1b.to_affine(comm), pf.ser_gt(T), comm

    (aff1, t1, c1), _ = timed_once(lambda: commit(False))
    (aff2, t2, c2), cold = timed_once(lambda: commit(True))
    if aff2 != aff1 or t2 != t1 or not all(torch.equal(a, b) for a, b in zip(c1, c2)):
        raise AssertionError(f"the sqrt-PST commit at nv = {nv} on {mesh.size} shards differs "
                             f"from the unsharded one")
    walls, counts = turns(lambda sharded: commit(sharded)[:2])
    say(f"mesh sqrt-PST commit nv={nv} ({len(aff1)} columns) on {mesh.size} shards: column "
        f"commitments limb-equal, T byte-equal ({len(t1)} B) to the unsharded commit; sharded "
        f"cold {cold / 1e3:.4f} s, warm {_walls(walls[True])}; unsharded warm {_walls(walls[False])}")
    say(f"  launches, one warm sharded commit: {json.dumps(_nonzero(counts))}")
    return counts


def mesh_nizk(dev, log2n: int, runs) -> dict:
    """TestudoNIZK on produce_synthetic_r1cs(2^log2n, 2^log2n, 10) proved
    unsharded and under each (mesh, fused, path) of `runs`: byte-equal sat
    proofs and final sponge states, the sharded proof verified and its
    eval_vars_at_ry + 1 rejected, the fused sumcheck's kernels launched by
    the fused prove only; walls of warm proves of both in turns; the
    launches of one warm sharded prove, by path (None: not counted)."""
    n = 1 << log2n
    what = f"mesh NIZK 2^{log2n}"
    t0 = time.perf_counter()
    inst, vars_, inputs = r1cs.Instance.produce_synthetic_r1cs(n, n, NIZK_INPUTS)
    inst_s = time.perf_counter() - t0
    gens = snark.TestudoNizkGens.setup(n, n, NIZK_INPUTS, profile=cprof.bls12_377(dev))
    say(f"{what}: instance built in {inst_s:.1f} s")

    def verify(proof):
        return snark.nizk_verify(proof, gens, inst, inputs, PoseidonTranscript(fr_params()))

    ref, by_path = {}, {}
    for mesh, fused, path in runs:
        which = "fused" if fused else "looped"

        def prove(sharded):
            tp = PoseidonTranscript(fr_params())
            with pmesh.use_mesh(mesh if sharded else None):
                proof = snark.nizk_prove(inst, vars_, inputs, gens, tp, fused=fused)
            return proofs.ser_r1cs_proof(proof.r1cs_sat_proof), list(tp.sponge.state), proof

        if fused not in ref:
            ref[fused] = prove(False)
        blob, state, _ = ref[fused]
        (blob2, state2, proof2), cold = timed_once(lambda: prove(True))
        if blob2 != blob or state2 != state:
            raise AssertionError(f"{what} ({which}) on {mesh.size} shards: other bytes or another "
                                 f"sponge state than the unsharded prove")
        if verify(proof2) is not True:
            raise AssertionError(f"{what} ({which}) on {mesh.size} shards did not verify")
        bad = proofs.parse_r1cs_proof(blob2)
        bad.eval_vars_at_ry = (bad.eval_vars_at_ry + 1) % R
        if verify(snark.TestudoNizk(bad, proof2.r)) is not False:
            raise AssertionError(f"{what} ({which}): the verifier accepted eval_vars_at_ry + 1")
        walls, counts = turns(lambda sharded: prove(sharded)[:2], reps=2)
        if any(counts[k] for k in FUSED_KERNELS) != fused:
            raise AssertionError(f"{what} ({which}) on {mesh.size} shards launched "
                                 f"{ {k: counts[k] for k in FUSED_KERNELS} } fused sumcheck kernels")
        say(f"{what} ({n} constraints, {NIZK_INPUTS} inputs), {which} sumcheck, {mesh.size} "
            f"shards: sat proof {len(blob)} B and final sponge state equal to the unsharded "
            f"prove's; verified, eval_vars_at_ry + 1 rejected; sharded cold {cold / 1e3:.4f} s, "
            f"warm {_walls(walls[True])}; unsharded warm {_walls(walls[False])}")
        if path is not None:
            by_path[path] = counts
            say(f"  {what} launches, one warm sharded {which} prove: "
                f"{json.dumps(_nonzero(counts))}")
    return by_path


def phase_mesh(dev, affine, ks) -> dict:
    """The sharded paths (parallel/mesh.py) on MESH_SHARDS shards: the two
    MSMs at 2^20, the sqrt-PST commit at nv = 20, TestudoNIZK at 2^16 with
    both sumchecks and the golden instance, each against its unsharded run;
    then on MESH_SHARDS_WIDE shards the fused 2^16 prove, whose remnant is
    three rounds.  Returns the launches by path."""
    mesh = make_shards(dev, MESH_SHARDS)
    counts = {"mesh_msm": {name: 0 for name in build.LAUNCHES}}
    for grp in (GROUPS["g1"], GROUPS["g2"]):
        for name, n in mesh_msm(dev, mesh, grp, affine[grp.name], ks[grp.name]).items():
            counts["mesh_msm"][name] += n
    counts["mesh_commit"] = mesh_commit(dev, mesh)
    phase_nizk_golden(dev, mesh)
    wide = make_shards(dev, MESH_SHARDS_WIDE)
    counts.update(mesh_nizk(dev, 16, [(mesh, True, "mesh_nizk"), (mesh, False, "mesh_nizk_looped"),
                                      (wide, True, None)]))
    return counts


class _Late(Exception):
    """The instance build outran its budget."""


def mesh_big(dev, log2n: int, budget_s: int):
    """Whether TestudoNIZK at 2^log2n fits on the card under the
    MESH_SHARDS mesh: the instance's host build (stopped after `budget_s`
    seconds), the setup, one fused prove (its peak device memory, or the
    allocation that failed) and the verify."""
    import signal

    n = 1 << log2n
    what = f"mesh NIZK 2^{log2n}"

    def late(signum, frame):
        raise _Late

    old = signal.signal(signal.SIGALRM, late)
    signal.alarm(budget_s)
    t0 = time.perf_counter()
    try:
        inst, vars_, inputs = r1cs.Instance.produce_synthetic_r1cs(n, n, NIZK_INPUTS)
    except _Late:
        say(f"{what}: the instance's host build passed {budget_s} s "
            f"({time.perf_counter() - t0:.1f} s) and was stopped; no prove")
        return
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    say(f"{what}: instance built in {time.perf_counter() - t0:.1f} s of host time")
    mesh = make_shards(dev, MESH_SHARDS)
    gens, setup_ms = timed_once(
        lambda: snark.TestudoNizkGens.setup(n, n, NIZK_INPUTS, profile=cprof.bls12_377(dev)))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        tp = PoseidonTranscript(fr_params())
        with pmesh.use_mesh(mesh):
            proof = snark.nizk_prove(inst, vars_, inputs, gens, tp)
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as err:
        say(f"{what}: the prove ran out of device memory after {time.perf_counter() - t0:.1f} s "
            f"(peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated): "
            f"{str(err).splitlines()[0]}")
        return
    prove_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    size = len(proofs.ser_r1cs_proof(proof.r1cs_sat_proof))
    ok, verify_ms = timed_once(
        lambda: snark.nizk_verify(proof, gens, inst, inputs, PoseidonTranscript(fr_params())))
    if ok is not True:
        raise AssertionError(f"{what}: the verifier rejected the sharded proof")
    say(f"{what} on {mesh.size} shards fits: setup {setup_ms / 1e3:.1f} s, fused prove "
        f"{prove_s:.1f} s (peak {peak:.2f} GiB allocated), sat proof {size} B, verified in "
        f"{verify_ms / 1e3:.1f} s")


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
    (`fixed_base_one`) at the fixed-base phase's 2^16 and, as the row
    `fixed_base_one_key`, at the Groth16 keys' widths (KEY_LANES: the 2^16
    circuit's h query in G1, its b_g2 query in G2).  Each is compared with
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
    forms = [("fixed_base", "fixed_base", "k_fixed_base_team", "fixed_base_one",
              63 if quick else 2047),
             ("fixed_base_one", "fixed_base_one", "k_fixed_base_one", "fixed_base",
              256 if quick else 1 << 16)]
    if not quick:
        forms.append(("fixed_base_one_key", "fixed_base_one", "k_fixed_base_one", "fixed_base",
                      KEY_LANES[grp.name]))
    for row, kernel, entry, other, N in forms:
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
        rep.add(nm(row), got[:, pick].contiguous(), want, ms, plain,
                table.numel() * 4 + N * FR.nlimbs * 4 + N * rows * 4, sum(pop) * m_add,
                f"({rows}, 256) table x ({N}, 16) scalars -> ({rows}, {N}), {sum(pop)} set bits; "
                f"compared at {N + ODD} lanes" + (f" on {len(pick)} of them" if len(pick) < N + ODD
                                                   else "") + ", plain_ms from there")
        rep.rows[nm(row)].update({
            "replaces_also": ["testudo_tpu/tpu/curve.py:429"],
            "latency_bound_ms": lat(max(pop)), "latency_bound_all_steps_ms": lat(16 * FR.nlimbs),
            "latency_us_per_product": lat_us, "launch_sequence_ms": seq_ms,
            f"{other}_ms": other_ms, "ptxas": ptxas_of(entry, Gp.ncomp)})
        say(f"  {nm(row)}: {ms:.4f} ms at {N} lanes ({other} {other_ms:.4f} ms; the 256 add_mask "
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
    for _ in range(8):  # the profiler returns a window without device events now and then
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        calls = sum(once in e.name for e in evs)
        if calls:
            return sum(e.time_range.elapsed_us() for e in evs) / calls / 1e3
    return None


def kernel_device_ms(fn, name: str, flush=None) -> float:
    """Device milliseconds a call of the kernel `name` (torch.profiler,
    `exp_mont_rm.profiled_ms`, after `flush()` each call if given); where
    the profiler saw none of its events in any window, CUDA events around
    back-to-back calls instead (the flushes' own time taken off), said so."""
    ms = exp_mont_rm.profiled_ms(fn, name, reps=20, flush=flush)
    if ms is not None:
        return ms
    say(f"  torch.profiler saw no {name} event in its windows: CUDA events instead")
    if flush is None:
        return time_ms(fn, 20)
    return max(time_ms(lambda: (flush(), fn()), 20) - time_ms(flush, 20), 0.0)


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

    # -- Poseidon
    pos = {}
    for spec, lat in ((FR, lat_fr), (FQ, lat_fq)):
        st = _random_elements(spec, (ODD, 3), rng, dev)
        got, want = dsponge.permute(spec, st), dsponge.permute_plain(spec, st)
        one = st[5].contiguous()
        ms = kernel_device_ms(lambda: dsponge.permute(spec, one), "k_poseidon_permute")
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
        # and Spark's widest stack: the ops tree's layer 0 at 2^16, 12 product
        # circuits' halves, the eq table and 6 dot-product halves' 3 tables
        big += [("cubic_tau", 1, 0, 1 << 20), ("quad", 1, 0, 1 << 21), ("cubic", 12, 6, 1 << 15)]
    small = [(kind, kp, ks, n) for kind, kp, ks in (("quad", 1, 0), ("cubic_tau", 1, 0),
                                                     ("cubic", 1, 0), ("cubic", 2, 1),
                                                     ("cubic", 12, 6))
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
                cold = kernel_device_ms(run, "k_sumcheck_round", flush)
                warm = kernel_device_ms(run, "k_sumcheck_round")
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
    ms = kernel_device_ms(run, "k_sumcheck_tail")
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
    ap.add_argument("--snark-only", action="store_true",
                    help="build, check and time TestudoSNARK at 2^12, 2^16 and 2^20, stop")
    ap.add_argument("--bw6-only", action="store_true",
                    help="build, check and time the 761-bit product, msm_fp and the BW6 wrap "
                         "at nv = 16 and 10, stop")
    ap.add_argument("--bls381-only", action="store_true",
                    help="build, check and time the fr381 product and the R1CS proof over "
                         "BLS12-381 at 2^10, 2^12 and 2^14, stop")
    ap.add_argument("--mesh-only", action="store_true",
                    help="build, check and time the sharded paths on shards of the card, the "
                         "NIZK at 2^20 under the mesh, try 2^24 under it, stop")
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
    if args.snark_only:
        phase_snark_small(dev)
        phase_snark(dev, 12, profiled=False, groth16_part=False, warm=0)
        phase_cubic(dev)
        for log2n in (12, 16, 20):
            phase_snark(dev, log2n)
            say(f"SNARK 2^{log2n} done ({time.time() - t_start:.1f} s)")
        say("snark-only pass done; run without arguments for the full check")
        return 0
    g1, g2 = GROUPS["g1"], GROUPS["g2"]
    rep = Report()
    if args.bw6_only:
        kernels_bw6(dev, rep, quick=False)
        phase_bw6_msm(dev)
        phase_bw6_toy(dev)
        for nv in (16, 10):
            phase_bw6_wrap(dev, nv)
            say(f"BW6 wrap nv={nv} done ({time.time() - t_start:.1f} s)")
        say(json.dumps({"kernels": list(rep.rows.values())}))
        say("bw6-only pass done; run without arguments for the full check")
        return 0
    if args.bls381_only:
        kernels_fr381(dev, rep, quick=False)
        row = rep.rows["mont_mul_rm_fr381"]
        for log2n in (10, 12, 14):
            counts = phase_bls381(dev, log2n, profiled=log2n < 14)
            if log2n == 10:
                row["launches_by_path"] = {p: c["mont_mul_rm_fr381"] for p, c in counts.items()}
                row["launches"] = sum(row["launches_by_path"].values())
            say(f"BLS12-381 2^{log2n} done ({time.time() - t_start:.1f} s)")
        say(json.dumps({"kernels": list(rep.rows.values())}))
        say("bls381-only pass done; run without arguments for the full check")
        return 0

    proj, affine, ks = {}, {}, {}
    for grp in (g1, g2):
        proj[grp.name], affine[grp.name], ks[grp.name] = make_points(dev, grp, t_start)
    if args.mesh_only:
        phase_mesh(dev, affine, ks)
        say(f"mesh phase done ({time.time() - t_start:.1f} s)")
        mesh_nizk(dev, 20, [(make_shards(dev, MESH_SHARDS), fused, None) for fused in (True, False)])
        say(f"mesh NIZK 2^20 done ({time.time() - t_start:.1f} s)")
        mesh_big(dev, 24, budget_s=600)
        say(f"mesh-only pass done ({time.time() - t_start:.1f} s); run without arguments for the "
            f"full check")
        return 0

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
        kernels_bw6(dev, rep, quick=True)
        kernels_fr381(dev, rep, quick=True)
        phase_bls381(dev, 4, profiled=False)
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
    say(f"group layer done ({time.time() - t_start:.1f} s)")

    # the protocol path: sqrt-PST at a small size, then at full width
    phase_sqrt_pst(dev, 10, full=False)
    pst_counts, canon, basis = phase_sqrt_pst(dev, 20, full=True)
    for path, snap in pst_counts.items():
        note(path, snap)
    say(f"sqrt-PST done ({time.time() - t_start:.1f} s)")

    # the protocol on top: TestudoNIZK, the golden proof, then config #3 at 2^16
    phase_nizk_golden(dev)
    # one warm prove of each kind and no profiled proves (three, profiled, with
    # --nizk-only): the default run's time limit holds the BW6 wrap too
    for path, snap in phase_nizk(dev, 16, warm=1, profiled=False).items():
        note(path, snap)
    say(f"NIZK done ({time.time() - t_start:.1f} s)")

    # the sharded paths: MESH_SHARDS shards of the card (parallel/mesh.py)
    t_mesh = time.time()
    for path, snap in phase_mesh(dev, affine, ks).items():
        note(path, snap)
    say(f"mesh done in {time.time() - t_mesh:.1f} s ({time.time() - t_start:.1f} s)")

    # TestudoSNARK: without Groth16 the small instance against the CPU; the
    # cubic twin; with Groth16 config #4 at 2^16 (the paths counted there), one
    # warm prove, not profiled (`--snark-only` adds 2^12 with and without
    # Groth16, 2^20, three warm proves and the profiles: the default run's time
    # limit holds the BW6 wrap too)
    t_snark = time.time()
    phase_snark_small(dev)
    phase_cubic(dev)
    for path, snap in phase_snark(dev, 16, profiled=False, warm=1).items():
        note(path, snap)
    say(f"SNARK done in {time.time() - t_snark:.1f} s ({time.time() - t_start:.1f} s)")

    # BW6-761: msm_fp at a key's width and the small path, the toy Fq
    # circuit, then the one-level wrap of a 2^16 table's opening (paths
    # bw6_setup and bw6_prove)
    t_bw6 = time.time()
    phase_bw6_msm(dev)
    phase_bw6_toy(dev)
    for path, snap in phase_bw6_wrap(dev, 16).items():
        note(path, snap)
    say(f"BW6 done in {time.time() - t_bw6:.1f} s ({time.time() - t_start:.1f} s)")

    # BLS12-381: the R1CS proof at Testudo's own size for this curve, 1024
    # constraints (paths bls381_setup, bls381_prove, bls381_verify, bls381_pst)
    t_381 = time.time()
    for path, snap in phase_bls381(dev, 10).items():
        note(path, snap)
    say(f"BLS12-381 done in {time.time() - t_381:.1f} s ({time.time() - t_start:.1f} s)")

    # the measuring harness: the chain kernels' own path
    note("harness", phase_harness(dev))
    say(f"harness done ({time.time() - t_start:.1f} s)")

    # every kernel against its plain version.  G1 buckets: compared and timed
    # at the 2^20 plan.  G2 buckets: compared at the 2^16 plan (the plain
    # version would walk 80,000 lanes through 512 G2 adds at 2^20), timed at
    # the 2^20 plan.
    def lap(what):
        say(f"{what} done ({time.time() - t_start:.1f} s)")

    kernels_montgomery(dev, rep, quick=False)
    kernels_rowmajor(dev, rep, quick=False)
    kernels_chain(dev, rep, quick=False)
    lap("kernels: Montgomery, row-major, chain")
    kernels_sumcheck(dev, rep, lat_us, lat_fr, quick=False)
    lap("kernels: sumcheck")
    kernels_bw6(dev, rep, quick=False)
    lap("kernels: 761-bit product")
    kernels_fr381(dev, rep, quick=False)
    lap("kernels: fr381 product")
    kernels_group(dev, g1, rep, proj["g1"], *batches["g1", 20], *batches["g1", 20], lat_us,
                  quick=False)
    lap("kernels: G1")
    kernels_commit_bucket(dev, rep, canon, basis)
    del canon, basis
    kernels_group(dev, g2, rep, proj["g2"], *batches["g2", 16], *batches["g2", 20], lat_us,
                  quick=False)
    lap("kernels: commit bucket, G2")

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
