"""Row-wise Pedersen commitment for dense multilinear polynomials.

Counterpart of testudo_tpu/core/polycommit.py (itself of the legacy
PolyCommitment / PolyEvalProof of Testudo's src/dense_mlpoly.rs:175-575),
used only inside Spark's sparse-matrix commitment (comb_ops, comb_mem,
derefs), not for the witness (which uses sqrt-PST).

Commitment: the 2^n table viewed as 2^(n/2) rows x 2^(n - n/2) columns, each
row committed with shared Pedersen generators: one shared-basis multi-MSM
over the rows (`sqrt_pst._multi_msm_g1`: on the card the shared-table
multi-MSM of device/msm.py, the table of Montgomery limbs never leaving the
device; host groups loop).  Evaluation proof: the L/R factored evaluation
and a DotProductProofLog over the R side.  The verifier's MSM over the row
commitments is one host MSM (the native library on BLS12-377).  Blinds are
zero, as every Spark commitment and opening has them (the reference's
`random_blinds` option has no caller and is not ported).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from ..poly import dense
from . import commitments as com
from . import nizk
from .sqrt_pst import _multi_msm_g1


@dataclass
class PolyCommitmentGens:
    """dense_mlpoly.rs:176-199 (the Pedersen part; the PST part of the
    reference's PolyCommitmentGens is core/pst.py)."""

    num_vars: int
    gens: nizk.DotProductProofGens

    @property
    def profile(self):
        return self.gens.gens_n.profile

    @staticmethod
    def setup(num_vars: int, label: bytes, profile=None, memo=None) -> "PolyCommitmentGens":
        """`memo`: a dict shared by the setups of one key, so that two
        commitments with generators of one size and label draw them once."""
        _, right = dense.factored_lens(num_vars)
        key = (1 << right, bytes(label))
        if memo is not None and key in memo:
            return PolyCommitmentGens(num_vars, memo[key])
        gens = nizk.DotProductProofGens.new(1 << right, label, profile)
        if memo is not None:
            memo[key] = gens
        return PolyCommitmentGens(num_vars, gens)


@dataclass
class PolyCommitment:
    C: List  # host affine G1, one commitment per row

    def write_to_transcript(self, transcript) -> None:
        for c in self.C:
            transcript.append_g1_point(c)


def commit(table: torch.Tensor, gens: PolyCommitmentGens) -> "PolyCommitment":
    """dense_mlpoly.rs:349-377 with zero blinds (Spark's only use): the row
    commitments as ONE shared-basis multi-MSM."""
    pf = gens.profile
    n = table.shape[0]
    left, right = dense.factored_lens(n.bit_length() - 1)
    gens_n = gens.gens.gens_n
    if gens_n.n != 1 << right:
        raise ValueError(f"a table of {n} rows needs gens of {1 << right} points, got {gens_n.n}")
    rows = table.reshape(1 << left, 1 << right, pf.fr_spec.nlimbs)
    return PolyCommitment(pf.g1b.to_affine(_multi_msm_g1(pf, gens_n.batch(), rows)))


@dataclass
class PolyEvalProof:
    proof: nizk.DotProductProofLog


def prove(table: torch.Tensor, r: List[int], Zr: int, gens: PolyCommitmentGens, transcript,
          rng=None) -> PolyEvalProof:
    """dense_mlpoly.rs:482-534 for a commitment with zero blinds and a
    zero-blind Zr (Spark's only use)."""
    spec = gens.profile.fr_spec
    left, _ = dense.factored_lens(len(r))
    dev = table.device
    L_table = dense.eq_evals(r[:left], spec, dev)
    R_table = dense.eq_evals(r[left:], spec, dev)
    LZ = dense.bound_L(table, L_table, spec)  # (R_size, nlimbs)
    # LZ and R as host ints, in one copy
    flat = spec.decode(torch.cat([LZ, R_table]))
    nR = R_table.shape[0]
    proof, _C_LR, _C_Zr = nizk.dotproduct_prove(
        gens.gens, transcript, flat[:nR], 0, flat[nR:], Zr, 0, rng)
    return PolyEvalProof(proof)


def _eq_ints(point: List[int], m: int) -> List[int]:
    """The MSB-first eq table of `point` in host ints."""
    evals = [1]
    for x in point:
        nxt = []
        for e in evals:
            hi = e * x % m
            nxt += [(e - hi) % m, hi]
        evals = nxt
    return evals


def verify_plain(proof: PolyEvalProof, gens: PolyCommitmentGens, transcript, r: List[int],
                 Zr: int, comm: PolyCommitment) -> bool:
    """dense_mlpoly.rs:536-574 (with a zero-blind commitment to Zr), on the
    host but for the dot-product verifier's MSM over the generators."""
    pf = gens.profile
    C_Zr = com.commit_scalar(Zr, 0, gens.gens.gens_1)
    left, right = dense.factored_lens(len(r))
    L_ints = _eq_ints(r[:left], pf.R)
    R_ints = _eq_ints(r[left:], pf.R)
    if len(comm.C) != len(L_ints):
        return False
    C_LZ = com.lincomb(pf, comm.C, L_ints)
    return nizk.dotproduct_verify(proof.proof, 1 << right, gens.gens, transcript, R_ints,
                                  C_LZ, C_Zr)
