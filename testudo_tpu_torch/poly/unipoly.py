"""Univariate round polynomials (host ints over a scalar field).

Counterpart of testudo_tpu/poly/unipoly.py (itself of Testudo's
src/unipoly.rs): degree-2/3 polynomials recovered from evaluations at
0, 1, 2(, 3) via the hardcoded inverse Vandermonde (two_inv / six_inv,
unipoly.rs:26-49); coefficients stored low-to-high.  Proofs carry FULL
coefficient vectors (CompressedUniPoly is dead code in Testudo,
unipoly.rs:84-99).

Generic over the scalar modulus (default BLS12-377 Fr).
"""
from __future__ import annotations

from typing import List

from ..fields.bls12_377 import R


class UniPoly:
    __slots__ = ("coeffs", "modulus")

    def __init__(self, coeffs: List[int], modulus: int = R):
        self.modulus = modulus
        self.coeffs = [c % modulus for c in coeffs]

    @staticmethod
    def from_evals(evals: List[int], modulus: int = R) -> "UniPoly":
        if len(evals) not in (3, 4):
            raise ValueError(f"a round polynomial comes from 3 or 4 evaluations, got {len(evals)}")
        m = modulus
        two_inv = pow(2, -1, m)
        if len(evals) == 3:
            c = evals[0]
            a = two_inv * (evals[2] - evals[1] - evals[1] + c) % m
            b = (evals[1] - c - a) % m
            return UniPoly([c, b, a], m)
        six_inv = pow(6, -1, m)
        d = evals[0]
        a = six_inv * (
            evals[3] - 3 * evals[2] + 3 * evals[1] - evals[0]
        ) % m
        b = two_inv * (
            2 * evals[0] - 5 * evals[1] + 4 * evals[2] - evals[3]
        ) % m
        c = (evals[1] - d - a - b) % m
        return UniPoly([d, c, b, a], m)

    def degree(self) -> int:
        return len(self.coeffs) - 1

    def eval_at_zero(self) -> int:
        return self.coeffs[0]

    def eval_at_one(self) -> int:
        return sum(self.coeffs) % self.modulus

    def evaluate(self, r: int) -> int:
        m = self.modulus
        acc, power = self.coeffs[0], r
        for c in self.coeffs[1:]:
            acc = (acc + power * c) % m
            power = power * r % m
        return acc

    def write_to_transcript(self, transcript) -> None:
        """Absorb all coefficients (sumcheck.rs:127-129, unipoly.rs:101-109)."""
        for c in self.coeffs:
            transcript.append_scalar(c, self.modulus)
