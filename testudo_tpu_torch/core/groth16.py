"""Groth16 over BLS12-377: setup, prove, verify.

Counterpart of testudo_tpu/core/groth16.py (itself of the reference's
ark-groth16 dependency, r1csproof.rs:27, 149, 421, 467): proves the Spartan
verifier circuit (core/circuit.py).  Every group batch goes through the
curve profile: on the device backends the keys are fixed-base batches (one
launch each: the team kernel up to 8,192 lanes, above it the 8-bit window
kernel over a table of g1's or g2's multiples built once on the card and
shared by the batches), the prover's A / B / C / H / L sums are `msm_g1` /
`msm_g2` over the projective keys (the general bucket path), and the QAP
division runs seven NTTs on the device (core/ntt.py).  The host does the QAP
evaluations at tau, the witness's row sums and the pairing check.

QAP layout (standard, as arkworks' LibsnarkReduction):
  - evaluation domain size m = next_pow2(num_constraints + num_public);
  - A_i picks up input-consistency rows: A_{pub i}(domain[nc + i]) = 1;
  - h(x) = (A(x) B(x) - C(x)) / Z(x) computed on a multiplicative coset.

The setup is seeded exactly as the JAX package's, so the keys equal its
keys point for point.  `prove` draws r then s from `rng` (default
`secrets.SystemRandom()`), as the reference draws them from `secrets`.
Timer labels: `groth16::lagrange`, `groth16::keys` (`groth16::keys G1`,
`groth16::keys G2`) in a setup; `groth16::row evals` (the host row sums),
`groth16::witness_h` (the NTTs and the quotient) and `groth16::msm a`,
`b_g1`, `b_g2`, `h`, `l` in a prove.
"""
from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..curves import profile as cprof
from ..device import field as tf
from ..device.field import FR
from ..fields.bls12_377 import R
from ..poly import dense
from ..utils.timer import Timer
from . import ntt
from .circuit import ConstraintSystem

_COSET_GEN = 5  # any non-subgroup element works; fixed for determinism


@dataclass
class VerifyingKey:
    alpha_g1: object
    beta_g2: object
    gamma_g2: object
    delta_g2: object
    gamma_abc_g1: List  # host affine, one per public var (incl. ONE)
    profile: object = None


@dataclass
class ProvingKey:
    num_pub: int
    num_vars: int
    domain_log: int
    alpha_g1: object
    beta_g1: object
    beta_g2: object
    delta_g1: object
    delta_g2: object
    a_query: object  # G1 batch of the profile's backend, one per variable
    b_g1_query: object
    b_g2_query: object  # G2 batch
    h_query: object  # G1 batch (m - 1)
    l_query: object  # G1 batch (witness vars), None without witnesses
    vk: VerifyingKey
    profile: object = None


@dataclass
class Proof:
    a: object  # host affine G1
    b: object  # host affine G2
    c: object  # host affine G1


def _domain_size(cs: ConstraintSystem) -> int:
    return 1 << max(1, (len(cs.constraints) + cs.num_pub - 1).bit_length())


def _batch_inv(vals: List[int], modulus: int = R) -> List[int]:
    pref = [1] * (len(vals) + 1)
    for i, v in enumerate(vals):
        pref[i + 1] = pref[i] * v % modulus
    total_inv = pow(pref[-1], -1, modulus)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = pref[i] * total_inv % modulus
        total_inv = total_inv * vals[i] % modulus
    return out


def _lagrange_at(tau: int, m: int, modulus: int = R) -> List[int]:
    """L_j(tau) for the size-m domain: (tau^m - 1) / (m (tau - w^j)) * w^j."""
    w = ntt.root_of_unity(m.bit_length() - 1, modulus)
    zt_minv = (pow(tau, m, modulus) - 1) * pow(m, -1, modulus) % modulus
    wj = ntt._powers(w, m, modulus)
    inv = _batch_inv([(tau - x) % modulus for x in wj], modulus)
    return [zt_minv * i % modulus * x % modulus for i, x in zip(inv, wj)]


def _sync(device: torch.device) -> None:
    """Wait for `device`: a Timer around device work reads device time only
    after it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class SetupScalars:
    """The toxic waste and every key batch's scalars of one setup."""

    alpha: int
    beta: int
    gamma: int
    delta: int
    tau: int
    a: List[int]  # A_i(tau), one per variable
    b: List[int]  # B_i(tau)
    h: List[int]  # tau^i Z(tau) / delta, i < m - 1
    l: List[int]  # (beta A_i + alpha B_i + C_i)(tau) / delta, witness variables
    gamma_abc: List[int]  # the same / gamma, public variables


def setup_scalars(cs: ConstraintSystem, seed: bytes = b"testudo-tpu-groth16",
                  nbytes: int = 40) -> SetupScalars:
    """The setup's scalars, seeded as the JAX package seeds them: numpy's
    default_rng on the first 8 bytes of sha256(seed), `nbytes` bytes mod the
    circuit's field each for alpha, beta, gamma, delta and tau (40 over Fr,
    groth16.py:113-122 there; core/groth16_bw6.py draws 56 over Fq)."""
    mod = cs.modulus
    rng = np.random.default_rng(int.from_bytes(hashlib.sha256(seed).digest()[:8], "little"))

    def rand_fr() -> int:
        return int.from_bytes(rng.bytes(nbytes), "little") % mod

    alpha, beta, gamma, delta, tau = (rand_fr() for _ in range(5))
    nc, npub, m = len(cs.constraints), cs.num_pub, _domain_size(cs)
    nvars = len(cs.values)

    L = _lagrange_at(tau, m, mod)
    # per-variable A_i(tau), B_i(tau), C_i(tau)
    a_t = [0] * nvars
    b_t = [0] * nvars
    c_t = [0] * nvars
    for lj, (A, B, C) in zip(L, cs.constraints):
        for i, co in A.items():
            a_t[i] = (a_t[i] + co * lj) % mod
        for i, co in B.items():
            b_t[i] = (b_t[i] + co * lj) % mod
        for i, co in C.items():
            c_t[i] = (c_t[i] + co * lj) % mod
    # input consistency rows (LibsnarkReduction): A_i(domain[nc + i]) = 1
    for i in range(npub):
        a_t[i] = (a_t[i] + L[nc + i]) % mod
    zt = (pow(tau, m, mod) - 1) % mod
    dinv = pow(delta, -1, mod)
    ginv = pow(gamma, -1, mod)
    return SetupScalars(
        alpha, beta, gamma, delta, tau, a_t, b_t,
        h=[tp * zt % mod * dinv % mod for tp in ntt._powers(tau, m - 1, mod)],
        l=[(beta * a_t[i] + alpha * b_t[i] + c_t[i]) % mod * dinv % mod
           for i in range(npub, nvars)],
        gamma_abc=[(beta * a_t[i] + alpha * b_t[i] + c_t[i]) % mod * ginv % mod
                   for i in range(npub)],
    )


def setup(cs: ConstraintSystem, seed: bytes = b"testudo-tpu-groth16", profile=None):
    """Circuit-specific setup (CircuitGens::setup, r1csproof.rs:80-151) on
    `profile` (default: BLS12-377 on the CUDA device): (pk, vk)."""
    pf = profile or cprof.bls12_377()
    tl = Timer("groth16::lagrange")
    sc = setup_scalars(cs, seed)
    tl.stop()
    npub, nvars, m = cs.num_pub, len(cs.values), _domain_size(cs)

    g1 = pf.g1_generator()
    g2 = pf.g2_generator()
    tk = Timer("groth16::keys")
    tg1 = Timer("groth16::keys G1")
    a_query = pf.g1b.fixed_base_mul(g1, sc.a)
    b_g1_query = pf.g1b.fixed_base_mul(g1, sc.b)
    h_query = pf.g1b.fixed_base_mul(g1, sc.h)
    l_query = pf.g1b.fixed_base_mul(g1, sc.l) if sc.l else None
    gamma_abc_g1 = pf.g1b.to_affine(pf.g1b.fixed_base_mul(g1, sc.gamma_abc))
    _sync(pf.device)
    tg1.stop()
    tg2 = Timer("groth16::keys G2")
    b_g2_query = pf.g2b.fixed_base_mul(g2, sc.b)
    _sync(pf.device)
    tg2.stop()
    vk = VerifyingKey(
        alpha_g1=pf.g1_mul(g1, sc.alpha),
        beta_g2=pf.g2_mul(g2, sc.beta),
        gamma_g2=pf.g2_mul(g2, sc.gamma),
        delta_g2=pf.g2_mul(g2, sc.delta),
        gamma_abc_g1=gamma_abc_g1,
        profile=pf,
    )
    pk = ProvingKey(
        num_pub=npub,
        num_vars=nvars,
        domain_log=m.bit_length() - 1,
        alpha_g1=vk.alpha_g1,
        beta_g1=pf.g1_mul(g1, sc.beta),
        beta_g2=vk.beta_g2,
        delta_g1=pf.g1_mul(g1, sc.delta),
        delta_g2=vk.delta_g2,
        a_query=a_query,
        b_g1_query=b_g1_query,
        b_g2_query=b_g2_query,
        h_query=h_query,
        l_query=l_query,
        vk=vk,
        profile=pf,
    )
    tk.stop()
    return pk, vk


def _row_evals(cs: ConstraintSystem, m: int):
    """(A z, B z, C z) over the domain: one value per constraint, then the
    input consistency rows of A, then zeros."""
    z = cs.values
    nc = len(cs.constraints)
    mod = cs.modulus
    rows = [[0] * m for _ in range(3)]
    for j, cons in enumerate(cs.constraints):
        for out, lc in zip(rows, cons):
            out[j] = sum(co * z[i] for i, co in lc.items()) % mod
    rows[0][nc: nc + cs.num_pub] = z[: cs.num_pub]
    return rows


def _witness_h(cs: ConstraintSystem, m: int, device=torch.device("cuda")) -> torch.Tensor:
    """h's coefficients by coset NTTs: h = (a~ b~ - c~) / Z, an (m, 16)
    Montgomery table on `device`; its top coefficient is zero."""
    trow = Timer("groth16::row evals")
    az, bz, cz = (dense.encode_table(v, FR, device) for v in _row_evals(cs, m))
    trow.stop()
    th = Timer("groth16::witness_h")
    g = _COSET_GEN
    # to coefficients, then to the coset
    a_e, b_e, c_e = (ntt.ntt(ntt.coset_scale(ntt.ntt(t, inverse=True), g)) for t in (az, bz, cz))
    num = tf.sub(FR, tf.mont_mul(FR, a_e, b_e), c_e)
    # Z on the coset is the constant g^m - 1
    zinv = dense.encode_scalar(pow(pow(g, m, R) - 1, -1, R), FR, device)
    h_c = ntt.coset_scale(ntt.ntt(tf.mont_mul(FR, num, zinv), inverse=True), g, inverse=True)
    _sync(h_c.device)
    th.stop()
    return h_c


def prove(pk: ProvingKey, cs: ConstraintSystem, rng=None) -> Proof:
    """Groth16 prover: five MSMs and the QAP division on the keys' profile;
    r and s are drawn from `rng` in that order."""
    if cs.num_pub != pk.num_pub or len(cs.values) != pk.num_vars:
        raise ValueError(f"a circuit of {cs.num_pub} public / {len(cs.values)} variables for a "
                         f"key of {pk.num_pub} / {pk.num_vars}")
    pf = pk.profile
    rng = rng or secrets.SystemRandom()
    r = rng.randrange(R)
    s = rng.randrange(R)
    z = cs.values
    m = 1 << pk.domain_log

    z_canon = torch.as_tensor(FR.to_limbs(z), device=pf.device)

    def msm(label, backend, bases, scalars):
        t = Timer("groth16::msm " + label)
        out = backend.msm(bases, scalars)
        t.stop()
        return out

    a_acc = msm("a", pf.g1b, pk.a_query, z_canon)
    b_acc_g2 = msm("b_g2", pf.g2b, pk.b_g2_query, z_canon)
    b_acc_g1 = msm("b_g1", pf.g1b, pk.b_g1_query, z_canon)
    h_c = _witness_h(cs, m, pf.device)
    one = torch.as_tensor(tf._int_to_limbs(1, FR.nlimbs), device=pf.device)
    h_canon = tf.mont_mul(FR, h_c, one)[: m - 1]  # out of Montgomery form
    h_acc = msm("h", pf.g1b, pk.h_query, h_canon)
    l_acc = None
    if pk.l_query is not None:
        l_acc = msm("l", pf.g1b, pk.l_query, z_canon[pk.num_pub:])

    A = pf.g1_add(pf.g1_add(pk.alpha_g1, a_acc), pf.g1_mul(pk.delta_g1, r))
    B = pf.g2_add(pf.g2_add(pk.beta_g2, b_acc_g2), pf.g2_mul(pk.delta_g2, s))
    B_g1 = pf.g1_add(pf.g1_add(pk.beta_g1, b_acc_g1), pf.g1_mul(pk.delta_g1, s))
    # C = L + H + s A + r B_g1 - r s delta
    C = pf.g1_add(l_acc, h_acc)
    C = pf.g1_add(C, pf.g1_mul(A, s))
    C = pf.g1_add(C, pf.g1_mul(B_g1, r))
    C = pf.g1_add(C, pf.g1_neg(pf.g1_mul(pk.delta_g1, r * s % R)))
    return Proof(A, B, C)


def verify(vk: VerifyingKey, public_inputs: List[int], proof: Proof) -> bool:
    """e(A, B) == e(alpha, beta) e(acc, gamma) e(C, delta), the public
    inputs' accumulator on the host.  False for a proof that fails, or for
    a number of public inputs that does not fit the key."""
    pf = vk.profile
    if len(public_inputs) != len(vk.gamma_abc_g1) - 1:
        return False
    acc = vk.gamma_abc_g1[0]
    for v, pt in zip(public_inputs, vk.gamma_abc_g1[1:]):
        acc = pf.g1_add(acc, pf.g1_mul(pt, v % R))
    lhs = pf.multi_pairing(
        [proof.a, pf.g1_neg(vk.alpha_g1), pf.g1_neg(acc), pf.g1_neg(proof.c)],
        [proof.b, vk.beta_g2, vk.gamma_g2, vk.delta_g2],
    )
    return lhs == pf.fq12_one()
