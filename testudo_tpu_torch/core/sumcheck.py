"""Sumcheck protocol: looped provers over device tables + host verifier.

Counterpart of testudo_tpu/core/sumcheck.py (itself of Testudo's
src/sumcheck.rs), in its looped form with the host transcript.  Each round
computes the round polynomial's evaluations at X = 0, 2(, 3) over the
half-tables on the device, pulls those two or three scalars to the host in
one copy, absorbs the coefficients, squeezes one challenge, uploads it once
and folds every table with `poly.dense.bound_top` (binding the most
significant index bit, as the reference's bound_poly_var_top does).

Tables are `(n, nlimbs)` int32 Montgomery limb tensors.  Every product goes
through `device.field.mont_mul`: on a CUDA tensor that is a launch of the
row-major Montgomery kernel (csrc/mont_mul_rm.cu), on a CPU tensor its
plain version.  Additions and subtractions are plain tensor code.

Transcript behaviour matches the reference: every round polynomial
coefficient is absorbed with append_scalar (sumcheck.rs:127-129, 423-425)
and one challenge is squeezed per round; `prove_cubic_with_additive_term`
and `prove_quad` work with an Fr- or an Fq-sponge transcript.

`prove_cubic` and `prove_cubic_batched` are Spark's provers (product
trees); no path of the port drives them yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from ..device import field as tf
from ..device.field import FR
from ..poly import dense
from ..poly.unipoly import UniPoly


class SumcheckError(ValueError):
    """A sumcheck proof failed a round check or the degree bound."""


@dataclass
class SumcheckInstanceProof:
    polys: List[UniPoly]

    def verify(self, claim: int, num_rounds: int, degree_bound: int, transcript):
        """Host verifier (sumcheck.rs:29-63).  Returns (final_eval, r);
        raises SumcheckError on a wrong number of rounds, a round polynomial
        of another degree, or a failed round check."""
        m = self.polys[0].modulus if self.polys else FR.modulus
        e = claim % m
        r: List[int] = []
        if len(self.polys) != num_rounds:
            raise SumcheckError(f"{len(self.polys)} round polynomials, expected {num_rounds}")
        for poly in self.polys:
            if poly.degree() != degree_bound:
                raise SumcheckError(f"round polynomial of degree {poly.degree()}, "
                                    f"expected {degree_bound}")
            if (poly.eval_at_zero() + poly.eval_at_one()) % m != e:
                raise SumcheckError("sumcheck round check failed")
            poly.write_to_transcript(transcript)
            r_i = transcript.challenge_scalar(m)
            r.append(r_i)
            e = poly.evaluate(r_i)
        return e, r


# -- round evaluations ------------------------------------------------------


def _halves(tables: Sequence[torch.Tensor]):
    n = tables[0].shape[0] // 2
    return [x[:n] for x in tables], [x[n:] for x in tables]


def _at_two_three(spec, los, his, three: bool):
    """The tables' lines through (lo, hi) at X = 2 (2 hi - lo) and X = 3
    (the X = 2 value plus hi - lo)."""
    p2 = [tf.sub(spec, tf.add(spec, h, h), l) for l, h in zip(los, his)]
    if not three:
        return p2, None
    p3 = [tf.add(spec, x2, tf.sub(spec, h, l)) for x2, l, h in zip(p2, los, his)]
    return p2, p3


def _round_evals_cubic_tau_s(spec, tau, A, B, C) -> torch.Tensor:
    """Evals at {0, 2, 3} of sum_i tau(X, i) (A(X, i) B(X, i) - C(X, i)),
    stacked (3, nlimbs)."""

    def comb(t, a, b, c):
        return tf.mont_mul(spec, t, tf.sub(spec, tf.mont_mul(spec, a, b), c))

    los, his = _halves((tau, A, B, C))
    p2, p3 = _at_two_three(spec, los, his, True)
    return torch.stack([tf.reduce_sum(spec, comb(*x)) for x in (los, p2, p3)])


def _round_evals_cubic_prod_s(spec, A, B, C) -> torch.Tensor:
    """Evals at {0, 2, 3} of sum_i A B C (Spark's product layers)."""

    def comb(a, b, c):
        return tf.mont_mul(spec, tf.mont_mul(spec, a, b), c)

    los, his = _halves((A, B, C))
    p2, p3 = _at_two_three(spec, los, his, True)
    return torch.stack([tf.reduce_sum(spec, comb(*x)) for x in (los, p2, p3)])


def _round_evals_quad_s(spec, A, B) -> torch.Tensor:
    """Evals at {0, 2} of sum_i A B."""
    los, his = _halves((A, B))
    p2, _ = _at_two_three(spec, los, his, False)
    return torch.stack([tf.reduce_sum(spec, tf.mont_mul(spec, *x)) for x in (los, p2)])


def _pull(evals_dev: torch.Tensor, spec=FR) -> List[int]:
    """The round's evaluations as host ints: one device-to-host copy."""
    return spec.decode(evals_dev)


def _finals(tables: Sequence[torch.Tensor], spec=FR) -> List[int]:
    """Row 0 of every folded table, as host ints, in one copy."""
    return spec.decode(torch.stack([x[0] for x in tables]))


def _round(e: int, evals: List[int], transcript, m: int):
    """The round polynomial from its evaluations (e1 from the claim),
    absorbed coefficient by coefficient; returns (poly, r_j)."""
    poly = UniPoly.from_evals([evals[0], (e - evals[0]) % m] + evals[1:], m)
    poly.write_to_transcript(transcript)
    return poly, transcript.challenge_scalar(m)


def _prove_looped(round_evals, claim: int, num_rounds: int, tables, transcript, spec):
    m = spec.modulus
    e = claim % m
    tables = list(tables)
    rs: List[int] = []
    polys: List[UniPoly] = []
    for _ in range(num_rounds):
        poly, r_j = _round(e, _pull(round_evals(spec, *tables), spec), transcript, m)
        rs.append(r_j)
        rdev = dense.encode_scalar(r_j, spec, tables[0].device)
        tables = [dense.bound_top(x, rdev, spec) for x in tables]
        e = poly.evaluate(r_j)
        polys.append(poly)
    return SumcheckInstanceProof(polys), rs, _finals(tables, spec)


# -- provers ----------------------------------------------------------------


def prove_cubic_with_additive_term(
    claim: int,
    num_rounds: int,
    tau: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    transcript,
    spec=FR,
) -> Tuple[SumcheckInstanceProof, List[int], List[int]]:
    """Phase-1 Spartan sumcheck over tau * (A*B - C) (sumcheck.rs:67-148).
    Returns (proof, r, [tau, A, B, C] bound at r)."""
    return _prove_looped(_round_evals_cubic_tau_s, claim, num_rounds, (tau, A, B, C),
                         transcript, spec)


def prove_quad(
    claim: int,
    num_rounds: int,
    A: torch.Tensor,
    B: torch.Tensor,
    transcript,
    spec=FR,
) -> Tuple[SumcheckInstanceProof, List[int], List[int]]:
    """Phase-2 Spartan sumcheck over A*B (sumcheck.rs:387-443)."""
    return _prove_looped(_round_evals_quad_s, claim, num_rounds, (A, B), transcript, spec)


def prove_cubic(
    claim: int,
    num_rounds: int,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    transcript,
) -> Tuple[SumcheckInstanceProof, List[int], List[int]]:
    """Product sumcheck over A*B*C (sumcheck.rs:149-218), over Fr."""
    return _prove_looped(_round_evals_cubic_prod_s, claim, num_rounds, (A, B, C),
                         transcript, FR)


def prove_cubic_batched(
    claim: int,
    num_rounds: int,
    poly_vec_par,  # (list[A], list[B], shared C) device tables
    poly_vec_seq,  # (list[A], list[B], list[C]) device tables
    coeffs: List[int],
    transcript,
):
    """Batched product sumcheck (sumcheck.rs:220-385): `par` instances share
    poly_C (the eq polynomial); `seq` instances carry their own weights.
    Instances are random-linear-combined by `coeffs`.

    Returns (proof, r, claims_prod, claims_dotp) with
    claims_prod = (A_finals, B_finals, C_final) and claims_dotp the seq
    finals.
    """
    m = FR.modulus
    A_par, B_par, C_par = poly_vec_par
    A_seq, B_seq, C_seq = poly_vec_seq
    A_par, B_par = list(A_par), list(B_par)
    A_seq, B_seq, C_seq = list(A_seq), list(B_seq), list(C_seq)
    n_par = len(A_par)
    dev = C_par.device

    e = claim % m
    rs: List[int] = []
    polys: List[UniPoly] = []
    for _ in range(num_rounds):
        triples = [(a, b, C_par) for a, b in zip(A_par, B_par)] + list(zip(A_seq, B_seq, C_seq))
        # every instance's three evaluations in one copy
        flat = _pull(torch.cat([_round_evals_cubic_prod_s(FR, *t) for t in triples]))
        evals = [flat[3 * i: 3 * i + 3] for i in range(len(triples))]
        comb = [sum(ev[k] * cf for ev, cf in zip(evals, coeffs)) % m for k in range(3)]
        poly, r_j = _round(e, comb, transcript, m)
        rs.append(r_j)
        rdev = dense.encode_scalar(r_j, FR, dev)
        A_par = [dense.bound_top(x, rdev) for x in A_par]
        B_par = [dense.bound_top(x, rdev) for x in B_par]
        C_par = dense.bound_top(C_par, rdev)
        A_seq = [dense.bound_top(x, rdev) for x in A_seq]
        B_seq = [dense.bound_top(x, rdev) for x in B_seq]
        C_seq = [dense.bound_top(x, rdev) for x in C_seq]
        e = poly.evaluate(r_j)
        polys.append(poly)

    finals = _finals(A_par + B_par + [C_par] + A_seq + B_seq + C_seq)
    n_seq = len(A_seq)
    claims_prod = (finals[:n_par], finals[n_par: 2 * n_par], finals[2 * n_par])
    s = 2 * n_par + 1
    claims_dotp = (finals[s: s + n_seq], finals[s + n_seq: s + 2 * n_seq],
                   finals[s + 2 * n_seq: s + 3 * n_seq])
    return SumcheckInstanceProof(polys), rs, claims_prod, claims_dotp
