"""Log-size dot-product argument (Bullet reduction and a sigma protocol).

Counterpart of testudo_tpu/core/nizk.py (itself of Testudo's src/nizk/mod.rs
and nizk/bullet.rs, the bulletproofs-style inner-product argument Spark's
polynomial commitment opens with).  Transcript: the Fr sponge; points are
absorbed compressed (append_point).

Group work goes through the generators' curve profile: the row MSMs of every
round and the generator fold on its G1 backend (on the card `msm_g1` and one
batch scalar multiplication a round), single points and few-term sums on the
host (`commitments.lincomb`).  The fold keeps G' = G / s with s the product
of the challenges' inverses so far: G_L u^-1 + G_R u = u^-1 (G_L + u^2 G_R),
so one backend `fold` by u^2 a round gives G', the round's MSMs take G' with
their scalars times s, and g_hat = s G'[0].  The affine points, and so the
proof, are the reference's.

Randomness: the prover's blinds come from `rng.randrange(r)` in the
reference's order (d, r_delta, r_beta, then 2 log2(n) pairs of which the
reduction uses the first log2(n)); `rng` defaults to `secrets.SystemRandom()`.
"""
from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import List, Sequence, Tuple

from . import commitments as com


@dataclass
class BulletReductionProof:
    L_vec: List  # host affine points
    R_vec: List


def _ip(a: Sequence[int], b: Sequence[int], m: int) -> int:
    return sum(x * y for x, y in zip(a, b)) % m


def bullet_prove(transcript, Q, gens_n: com.MultiCommitGens, H, a_vec: List[int],
                 b_vec: List[int], blind: int, blinds_vec: List[Tuple[int, int]]):
    """bullet.rs:36-152 over the generators `gens_n.G` (on the profile's G1
    backend).  Returns (proof, a_hat, b_hat, g_hat, blind_fin)."""
    pf = gens_n.profile
    m = pf.R
    n = gens_n.n
    if n & (n - 1) or len(a_vec) != n or len(b_vec) != n:
        raise ValueError(f"bullet_prove: {len(a_vec)}, {len(b_vec)} scalars for {n} generators "
                         f"(a power of two)")
    g1b = pf.g1b
    a, b = list(a_vec), list(b_vec)
    G = gens_n.batch()
    s = 1  # the true generators are s G
    L_vec, R_vec = [], []
    blind_fin = blind % m
    blinds = iter(blinds_vec)
    while n != 1:
        n //= 2
        a_L, a_R = a[:n], a[n:]
        b_L, b_R = b[:n], b[n:]
        c_L, c_R = _ip(a_L, b_R, m), _ip(a_R, b_L, m)
        blind_L, blind_R = next(blinds)
        G_L, G_R = g1b.slice(G, 0, n), g1b.slice(G, n, 2 * n)
        # L = <a_L, G_R> + c_L Q + blind_L H, R = <a_R, G_L> + c_R Q + blind_R H
        L_base = g1b.msm(G_R, [x * s % m for x in a_L])
        R_base = g1b.msm(G_L, [x * s % m for x in a_R])
        L = com.lincomb(pf, [L_base, Q, H], [1, c_L, blind_L])
        Rp = com.lincomb(pf, [R_base, Q, H], [1, c_R, blind_R])
        transcript.append_g1_point(L)
        transcript.append_g1_point(Rp)
        u = transcript.challenge_scalar(m)
        u_inv = pow(u, -1, m)
        a = [(x * u + u_inv * y) % m for x, y in zip(a_L, a_R)]
        b = [(x * u_inv + u * y) % m for x, y in zip(b_L, b_R)]
        G = g1b.fold(G_L, G_R, u * u % m)
        s = s * u_inv % m
        blind_fin = (blind_fin + u * u * blind_L + u_inv * u_inv * blind_R) % m
        L_vec.append(L)
        R_vec.append(Rp)
    g_hat = com.lincomb(pf, g1b.to_affine(G), [s])
    return BulletReductionProof(L_vec, R_vec), a[0], b[0], g_hat, blind_fin


def bullet_verification_scalars(proof: BulletReductionProof, n: int, transcript, m: int):
    """bullet.rs:157-218: (u^2, u^-2, s)."""
    lg_n = len(proof.L_vec)
    if n != 1 << lg_n or len(proof.R_vec) != lg_n:
        raise ValueError(f"a reduction of {lg_n} rounds for {n} generators")
    challenges = []
    for L, Rp in zip(proof.L_vec, proof.R_vec):
        transcript.append_g1_point(L)
        transcript.append_g1_point(Rp)
        challenges.append(transcript.challenge_scalar(m))
    challenges_inv = [pow(c, -1, m) for c in challenges]
    allinv = 1
    for c in challenges_inv:
        allinv = allinv * c % m
    challenges_sq = [c * c % m for c in challenges]
    challenges_inv_sq = [c * c % m for c in challenges_inv]
    s = [allinv]
    for i in range(1, n):
        lg_i = i.bit_length() - 1
        k = 1 << lg_i
        s.append(s[i - k] * challenges_sq[(lg_n - 1) - lg_i] % m)
    return challenges_sq, challenges_inv_sq, s


def bullet_verify(proof: BulletReductionProof, n: int, a: List[int], transcript, Gamma,
                  gens_n: com.MultiCommitGens):
    """bullet.rs:224-260.  Returns (g_hat, Gamma_hat, a_hat): g_hat one MSM
    on the profile's G1 backend, Gamma_hat one host MSM."""
    pf = gens_n.profile
    u_sq, u_inv_sq, s = bullet_verification_scalars(proof, n, transcript, pf.R)
    g_hat = pf.g1b.msm(gens_n.batch(), s)
    a_hat = _ip(a, s, pf.R)
    Gamma_hat = com.lincomb(pf, proof.L_vec + proof.R_vec + [Gamma], u_sq + u_inv_sq + [1])
    return g_hat, Gamma_hat, a_hat


@dataclass
class DotProductProofGens:
    n: int
    gens_n: com.MultiCommitGens
    gens_1: com.MultiCommitGens

    @staticmethod
    def new(n: int, label: bytes, profile=None) -> "DotProductProofGens":
        gens_n, gens_1 = com.MultiCommitGens.new(n + 1, label, profile).split_at(n)
        return DotProductProofGens(n, gens_n, gens_1)


@dataclass
class DotProductProofLog:
    bullet_reduction_proof: BulletReductionProof
    delta: object
    beta: object
    z1: int
    z2: int


def dotproduct_prove(gens: DotProductProofGens, transcript, x_vec: List[int], blind_x: int,
                     a_vec: List[int], y: int, blind_y: int, rng=None):
    """nizk/mod.rs:45-125.  Returns (proof, Cx, Cy)."""
    n = len(x_vec)
    if len(a_vec) != n or gens.n != n:
        raise ValueError(f"dotproduct_prove: {n} and {len(a_vec)} scalars for gens of {gens.n}")
    pf = gens.gens_n.profile
    m = pf.R
    rng = rng or secrets.SystemRandom()
    d = rng.randrange(m)
    r_delta = rng.randrange(m)
    r_beta = rng.randrange(m)
    lg_n = n.bit_length() - 1
    blinds_vec = [(rng.randrange(m), rng.randrange(m)) for _ in range(2 * lg_n)]

    Cx = com.commit_slice_dev(x_vec, blind_x, gens.gens_n)
    transcript.append_g1_point(Cx)
    Cy = com.commit_scalar(y, blind_y, gens.gens_1)
    transcript.append_g1_point(Cy)
    transcript.append_scalar_vector(a_vec, m)

    blind_Gamma = (blind_x + blind_y) % m
    proof, x_hat, a_hat, g_hat, rhat_Gamma = bullet_prove(
        transcript, gens.gens_1.G[0], gens.gens_n, gens.gens_n.h, x_vec, a_vec, blind_Gamma,
        blinds_vec)
    y_hat = x_hat * a_hat % m

    gens_hat = com.MultiCommitGens(1, [g_hat], gens.gens_1.h, pf)
    delta = com.commit_scalar(d, r_delta, gens_hat)
    transcript.append_g1_point(delta)
    beta = com.commit_scalar(d, r_beta, gens.gens_1)
    transcript.append_g1_point(beta)
    c = transcript.challenge_scalar(m)

    z1 = (d + c * y_hat) % m
    z2 = (a_hat * (c * rhat_Gamma + r_beta) + r_delta) % m
    return DotProductProofLog(proof, delta, beta, z1, z2), Cx, Cy


def dotproduct_verify(proof: DotProductProofLog, n: int, gens: DotProductProofGens, transcript,
                      a: List[int], Cx, Cy) -> bool:
    """nizk/mod.rs:127-179."""
    if gens.n != n or len(a) != n:
        raise ValueError(f"dotproduct_verify: {len(a)} scalars, n {n}, gens of {gens.n}")
    pf = gens.gens_n.profile
    m = pf.R
    transcript.append_g1_point(Cx)
    transcript.append_g1_point(Cy)
    transcript.append_scalar_vector(a, m)
    Gamma = com.lincomb(pf, [Cx, Cy], [1, 1])
    g_hat, Gamma_hat, a_hat = bullet_verify(proof.bullet_reduction_proof, n, a, transcript,
                                            Gamma, gens.gens_n)
    transcript.append_g1_point(proof.delta)
    transcript.append_g1_point(proof.beta)
    c = transcript.challenge_scalar(m)
    # (Gamma_hat c + beta) a_hat + delta == (g_hat + a_hat G) z1 + z2 h
    lhs = com.lincomb(pf, [Gamma_hat, proof.beta, proof.delta], [c * a_hat, a_hat, 1])
    rhs = com.lincomb(pf, [g_hat, gens.gens_1.G[0], gens.gens_1.h],
                      [proof.z1, a_hat * proof.z1, proof.z2])
    return lhs == rhs
