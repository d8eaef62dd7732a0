"""Layered product circuits (GKR-style) for offline memory checking.

Counterpart of testudo_tpu/core/product_tree.py (itself of Testudo's
src/product_tree.rs): a ProductCircuit stores the left and right halves of
each layer; its evaluation proof runs one batched cubic sumcheck a layer
with an eq-weight table, folding the claims by a layer challenge,
claim <- L + r (R - L); the batched proof joins DotProductCircuits at the
last layer (product_tree.rs:254-377).

Layer tables are `(n, 16)` Montgomery limb tensors on one device, each
layer's products one `field.mont_mul` (the row-major kernel on the card);
claims and challenges are host ints.  The layer sumchecks are the port's
`sumcheck.prove_cubic_batched`: fused (the default; on the card one
`sumcheck_round` launch of the `cubic` kind, one `sumcheck_tail` and, where
the absorb starts with one, a `poseidon_permute` a round) or looped
(`fused=False`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch

from ..device import field as tf
from ..device.field import FR
from ..poly import dense
from . import sumcheck
from .errors import require

_M = FR.modulus


class ProductCircuit:
    def __init__(self, poly: torch.Tensor):
        """poly: a (2^k, 16) table; builds its k layers of halves."""
        self.left_vec: List[torch.Tensor] = []
        self.right_vec: List[torch.Tensor] = []
        n = poly.shape[0]
        if n < 2 or n & (n - 1):
            raise ValueError(f"a product circuit needs a power of two from 2 rows, got {n}")
        num_layers = n.bit_length() - 1
        half = n // 2
        self.left_vec.append(poly[:half])
        self.right_vec.append(poly[half:])
        for i in range(num_layers - 1):
            prod = tf.mont_mul(FR, self.left_vec[i], self.right_vec[i])
            h = prod.shape[0] // 2
            self.left_vec.append(prod[:h])
            self.right_vec.append(prod[h:])

    def evaluate(self) -> int:
        return evaluate_all([self])[0]


def evaluate_all(circuits: List[ProductCircuit]) -> List[int]:
    """Each circuit's product, in one copy to the host."""
    top = torch.stack([t for c in circuits for t in (c.left_vec[-1][0], c.right_vec[-1][0])])
    v = FR.decode(top)
    return [v[2 * i] * v[2 * i + 1] % _M for i in range(len(circuits))]


class DotProductCircuit:
    def __init__(self, left: torch.Tensor, right: torch.Tensor, weight: torch.Tensor):
        self.left, self.right, self.weight = left, right, weight

    def evaluate_dev(self) -> torch.Tensor:
        """sum_i left_i right_i weight_i as one device element."""
        prods = tf.mont_mul(FR, tf.mont_mul(FR, self.left, self.right), self.weight)
        return tf.reduce_sum(FR, prods)

    def evaluate(self) -> int:
        return dense.decode_scalar(self.evaluate_dev())

    def split(self) -> Tuple["DotProductCircuit", "DotProductCircuit"]:
        idx = self.left.shape[0] // 2
        return (
            DotProductCircuit(self.left[:idx], self.right[:idx], self.weight[:idx]),
            DotProductCircuit(self.left[idx:], self.right[idx:], self.weight[idx:]),
        )


@dataclass
class LayerProofBatched:
    proof: sumcheck.SumcheckInstanceProof
    claims_prod_left: List[int]
    claims_prod_right: List[int]


@dataclass
class ProductCircuitEvalProofBatched:
    proof: List[LayerProofBatched]
    claims_dotp: Tuple[List[int], List[int], List[int]]

    @staticmethod
    def prove(prod_circuits: List[ProductCircuit], dotp_circuits: List[DotProductCircuit],
              transcript, fused: bool = True):
        """product_tree.rs:255-377.  Returns (proof, rand)."""
        if not prod_circuits:
            raise ValueError("a batched product proof needs a product circuit")
        dev = prod_circuits[0].left_vec[0].device
        claims_dotp_final = ([], [], [])
        proof_layers: List[LayerProofBatched] = []
        num_layers = len(prod_circuits[0].left_vec)
        claims_to_verify = evaluate_all(prod_circuits)
        rand: List[int] = []
        for layer_id in range(num_layers - 1, -1, -1):
            poly_C_par = dense.eq_evals(rand, FR, dev)
            num_rounds_prod = poly_C_par.shape[0].bit_length() - 1

            A_par = [c.left_vec[layer_id] for c in prod_circuits]
            B_par = [c.right_vec[layer_id] for c in prod_circuits]

            A_seq, B_seq, C_seq = [], [], []
            if layer_id == 0 and dotp_circuits:
                evals = FR.decode(torch.stack([d.evaluate_dev() for d in dotp_circuits]))
                claims_to_verify = claims_to_verify + evals
                for d in dotp_circuits:
                    A_seq.append(d.left)
                    B_seq.append(d.right)
                    C_seq.append(d.weight)

            coeffs = transcript.challenge_scalar_vec(_M, len(claims_to_verify))
            claim = sum(c * f for c, f in zip(claims_to_verify, coeffs)) % _M

            proof, rand_prod, claims_prod, claims_dotp = sumcheck.prove_cubic_batched(
                claim, num_rounds_prod, (A_par, B_par, poly_C_par), (A_seq, B_seq, C_seq),
                coeffs, transcript, fused=fused)
            claims_prod_left, claims_prod_right, _claims_eq = claims_prod
            for l, r_ in zip(claims_prod_left, claims_prod_right):
                transcript.append_scalar(l, _M)
                transcript.append_scalar(r_, _M)

            if layer_id == 0 and dotp_circuits:
                dl, dr, dw = claims_dotp
                for l, r_, w in zip(dl, dr, dw):
                    transcript.append_scalar(l, _M)
                    transcript.append_scalar(r_, _M)
                    transcript.append_scalar(w, _M)
                claims_dotp_final = (list(dl), list(dr), list(dw))

            r_layer = transcript.challenge_scalar(_M)
            claims_to_verify = [(l + r_layer * (r_ - l)) % _M
                                for l, r_ in zip(claims_prod_left, claims_prod_right)]
            rand = [r_layer] + rand_prod
            proof_layers.append(
                LayerProofBatched(proof, list(claims_prod_left), list(claims_prod_right)))
        return ProductCircuitEvalProofBatched(proof_layers, claims_dotp_final), rand

    def verify(self, claims_prod_vec: List[int], claims_dotp_vec: List[int], length: int,
               transcript):
        """product_tree.rs:379-476.  Returns (claims, claims_dotp, rand);
        raises ProofVerifyError or sumcheck.SumcheckError on a failed check."""
        num_layers = length.bit_length() - 1
        rand: List[int] = []
        require(len(self.proof) == num_layers, "number of product layers")
        claims_to_verify = list(claims_prod_vec)
        claims_to_verify_dotp: List[int] = []
        for i in range(num_layers):
            num_rounds = i
            if i == num_layers - 1:
                claims_to_verify = claims_to_verify + list(claims_dotp_vec)
            coeffs = transcript.challenge_scalar_vec(_M, len(claims_to_verify))
            claim = sum(c * f for c, f in zip(claims_to_verify, coeffs)) % _M
            claim_last, rand_prod = self.proof[i].proof.verify(claim, num_rounds, 3, transcript)
            claims_prod_left = self.proof[i].claims_prod_left
            claims_prod_right = self.proof[i].claims_prod_right
            require(len(claims_prod_left) == len(claims_prod_right) == len(claims_prod_vec),
                    "product claims")
            for l, r_ in zip(claims_prod_left, claims_prod_right):
                transcript.append_scalar(l, _M)
                transcript.append_scalar(r_, _M)
            require(len(rand) == len(rand_prod), "layer randomness")
            eq = dense.eq_evaluate(rand, rand_prod, _M)
            claim_expected = sum(cf * (l * r_ % _M * eq) for cf, l, r_ in
                                 zip(coeffs, claims_prod_left, claims_prod_right)) % _M
            if i == num_layers - 1:
                npi = len(claims_prod_vec)
                dl, dr, dw = self.claims_dotp
                require(len(dl) == len(dr) == len(dw) == len(claims_dotp_vec), "dot-product claims")
                for k in range(len(dl)):
                    transcript.append_scalar(dl[k], _M)
                    transcript.append_scalar(dr[k], _M)
                    transcript.append_scalar(dw[k], _M)
                    claim_expected = (claim_expected
                                      + coeffs[k + npi] * dl[k] * dr[k] * dw[k]) % _M
            require(claim_expected == claim_last % _M, "product layer check")
            r_layer = transcript.challenge_scalar(_M)
            claims_to_verify = [(l + r_layer * (r_ - l)) % _M
                                for l, r_ in zip(claims_prod_left, claims_prod_right)]
            if i == num_layers - 1:
                dl, dr, dw = self.claims_dotp
                for k in range(len(claims_dotp_vec) // 2):
                    cl = (dl[2 * k] + r_layer * (dl[2 * k + 1] - dl[2 * k])) % _M
                    cr = (dr[2 * k] + r_layer * (dr[2 * k + 1] - dr[2 * k])) % _M
                    cw = (dw[2 * k] + r_layer * (dw[2 * k + 1] - dw[2 * k])) % _M
                    claims_to_verify_dotp.extend([cl, cr, cw])
            rand = [r_layer] + rand_prod
        return claims_to_verify, claims_to_verify_dotp, rand
