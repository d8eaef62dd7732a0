"""Groth16 over BW6-761: the one-level recursion wrap.

Counterpart of testudo_tpu/core/groth16_bw6.py.  Proves an Fq-native
constraint system, such as the TestudoCommVerifier circuit of
core/circuit_verifier.py, over the outer curve BW6-761, whose scalar field
IS BLS12-377's Fq (fields/bw6_761.py).  This is the composition the Testudo
fork left commented out (circuit_verifier.rs:653-658).

The algorithm is core/groth16.py's (LibsnarkReduction QAP layout, the coset
NTT division, five proving MSMs), and so are its setup scalars, row sums and
helpers, with the BW6 bindings: scalars mod q377 in
the 24-limb `FQ` spec (the seven NTTs of core/ntt.py run with modulus q377),
G1 and G2 both on the 761-bit curve through the generic device group
(device/curve_generic.py: six key batches by `fixed_base_mul`, five
`msm_fp`), verification through the host Tate pairing (curves/bw6_761.py).
On the card every group operation of a setup or a prove is batched complete
formulas over the 761-bit Montgomery kernel.

The setup is seeded exactly as the JAX package's (numpy's default_rng on the
first 8 bytes of sha256(seed), 56 bytes mod q377 each for alpha, beta,
gamma, delta and tau), so the keys are its keys point for point.  `prove`
draws r then s from `rng` (default: `secrets.randbelow`, as the JAX package).
Timer labels: `groth16_bw6::lagrange` (the scalars: Lagrange values, the
A / B / C sums at tau), `groth16_bw6::keys G1`, `groth16_bw6::keys G2`;
`groth16_bw6::row evals`, `groth16_bw6::witness_h`, `groth16_bw6::msm a`,
`b_g1`, `b_g2`, `h`, `l`; `groth16_bw6::verify`.
"""
from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import List, Optional

import torch

from ..curves import bw6_761 as bw
from ..device import curve_generic as cg
from ..device import field as tf
from ..device import msm
from ..device.field import FQ  # the 24-limb spec of the scalar field
from ..fields.bls12_377 import P as R  # BW6 scalar field = BLS12-377 Fq
from ..poly import dense
from ..utils.timer import Timer
from . import groth16, ntt
from .circuit import ConstraintSystem
from .groth16 import SetupScalars, _domain_size, _row_evals, _sync

SEED = b"testudo-tpu-groth16-bw6"
_COSET_GEN = 7  # fixed non-subgroup coset shift


@dataclass
class VerifyingKey:
    alpha_g1: object
    beta_g2: object
    gamma_g2: object
    delta_g2: object
    gamma_abc_g1: List  # host affine, one per public variable (incl. ONE)


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
    a_query: object  # projective BW6 G1 batch on the device, one per variable
    b_g1_query: object
    b_g2_query: object  # BW6 G2 batch
    h_query: object  # G1 batch (m - 1)
    l_query: object  # G1 batch (witness variables), None without witnesses
    vk: VerifyingKey


@dataclass
class Proof:
    a: object  # host affine BW6 G1
    b: object  # host affine BW6 G2
    c: object  # host affine BW6 G1


def setup_scalars(cs: ConstraintSystem, seed: bytes = SEED) -> SetupScalars:
    """The setup's scalars, drawn as the JAX package draws them
    (groth16_bw6.py:106-113 there: 56 bytes mod q377 each)."""
    if cs.modulus != R:
        raise ValueError("BW6 Groth16 proves circuits over BLS12-377's Fq")
    return groth16.setup_scalars(cs, seed, nbytes=56)


def setup(cs: ConstraintSystem, seed: bytes = SEED, device=torch.device("cuda"),
          scalars: Optional[SetupScalars] = None):
    """Circuit-specific setup over BW6-761, the key batches on `device`:
    (pk, vk).  The circuit must be over Fq (cs.modulus == q377).  `scalars`,
    when given, are `setup_scalars(cs, seed)` computed before (a caller that
    checks the keys against them)."""
    device = torch.device(device)
    sc = scalars
    if sc is None:
        tl = Timer("groth16_bw6::lagrange")
        sc = setup_scalars(cs, seed)
        tl.stop()
    g1, g2 = bw.g1_generator(), bw.g2_generator()
    G1, G2 = cg.bw6_g1(), cg.bw6_g2()

    def batch(G, base, add, values):
        return cg.fixed_base_mul(G, torch.as_tensor(FQ.to_limbs(values), device=device),
                                 base, add)

    tg1 = Timer("groth16_bw6::keys G1")
    a_query = batch(G1, g1, bw.g1_add, sc.a)
    b_g1_query = batch(G1, g1, bw.g1_add, sc.b)
    h_query = batch(G1, g1, bw.g1_add, sc.h)
    l_query = batch(G1, g1, bw.g1_add, sc.l) if sc.l else None
    gamma_abc_g1 = G1.to_affine_host(batch(G1, g1, bw.g1_add, sc.gamma_abc))
    _sync(device)
    tg1.stop()
    tg2 = Timer("groth16_bw6::keys G2")
    b_g2_query = batch(G2, g2, bw.g2_add, sc.b)
    _sync(device)
    tg2.stop()
    vk = VerifyingKey(
        alpha_g1=bw.g1_mul(g1, sc.alpha),
        beta_g2=bw.g2_mul(g2, sc.beta),
        gamma_g2=bw.g2_mul(g2, sc.gamma),
        delta_g2=bw.g2_mul(g2, sc.delta),
        gamma_abc_g1=gamma_abc_g1,
    )
    pk = ProvingKey(
        num_pub=cs.num_pub,
        num_vars=len(cs.values),
        domain_log=_domain_size(cs).bit_length() - 1,
        alpha_g1=vk.alpha_g1,
        beta_g1=bw.g1_mul(g1, sc.beta),
        beta_g2=vk.beta_g2,
        delta_g1=bw.g1_mul(g1, sc.delta),
        delta_g2=vk.delta_g2,
        a_query=a_query,
        b_g1_query=b_g1_query,
        b_g2_query=b_g2_query,
        h_query=h_query,
        l_query=l_query,
        vk=vk,
    )
    return pk, vk


def _witness_h(cs: ConstraintSystem, m: int, device=torch.device("cuda")) -> torch.Tensor:
    """h's coefficients by coset NTTs over q377: h = (a~ b~ - c~) / Z, an
    (m, 24) Montgomery table on `device`; its top coefficient is zero."""
    trow = Timer("groth16_bw6::row evals")
    az, bz, cz = (dense.encode_table(v, FQ, device) for v in _row_evals(cs, m))
    trow.stop()
    th = Timer("groth16_bw6::witness_h")
    g = _COSET_GEN
    a_e, b_e, c_e = (
        ntt.ntt(ntt.coset_scale(ntt.ntt(t, inverse=True, modulus=R), g, modulus=R), modulus=R)
        for t in (az, bz, cz))
    num = tf.sub(FQ, tf.mont_mul(FQ, a_e, b_e), c_e)
    zinv = dense.encode_scalar(pow(pow(g, m, R) - 1, -1, R), FQ, device)
    h_c = ntt.coset_scale(ntt.ntt(tf.mont_mul(FQ, num, zinv), inverse=True, modulus=R), g,
                          inverse=True, modulus=R)
    _sync(h_c.device)
    th.stop()
    return h_c


def prove(pk: ProvingKey, cs: ConstraintSystem, rng=None) -> Proof:
    """Groth16 prover over BW6-761: five `msm_fp` and the QAP division on the
    keys' device; r and s are drawn from `rng` in that order."""
    if cs.num_pub != pk.num_pub or len(cs.values) != pk.num_vars:
        raise ValueError(f"a circuit of {cs.num_pub} public / {len(cs.values)} variables for a "
                         f"key of {pk.num_pub} / {pk.num_vars}")
    draw = rng.randrange if rng is not None else secrets.randbelow
    r = draw(R)
    s = draw(R)
    device = pk.a_query[0].device
    z = cs.values
    m = 1 << pk.domain_log
    G1, G2 = cg.bw6_g1(), cg.bw6_g2()
    z_canon = torch.as_tensor(FQ.to_limbs(z), device=device)

    def run(label, G, add, bases, scalars):
        t = Timer("groth16_bw6::msm " + label)
        out = msm.msm_fp(G, add, bases, scalars)
        t.stop()
        return out

    a_acc = run("a", G1, bw.g1_add, pk.a_query, z_canon)
    b_acc_g2 = run("b_g2", G2, bw.g2_add, pk.b_g2_query, z_canon)
    b_acc_g1 = run("b_g1", G1, bw.g1_add, pk.b_g1_query, z_canon)
    h_c = _witness_h(cs, m, device)
    one = torch.as_tensor(tf._int_to_limbs(1, FQ.nlimbs), device=device)
    h_canon = tf.mont_mul(FQ, h_c, one)[: m - 1]  # out of Montgomery form
    h_acc = run("h", G1, bw.g1_add, pk.h_query, h_canon)
    l_acc = None
    if pk.l_query is not None:
        l_acc = run("l", G1, bw.g1_add, pk.l_query, z_canon[pk.num_pub:])

    A = bw.g1_add(bw.g1_add(pk.alpha_g1, a_acc), bw.g1_mul(pk.delta_g1, r))
    B = bw.g2_add(bw.g2_add(pk.beta_g2, b_acc_g2), bw.g2_mul(pk.delta_g2, s))
    B_g1 = bw.g1_add(bw.g1_add(pk.beta_g1, b_acc_g1), bw.g1_mul(pk.delta_g1, s))
    # C = L + H + s A + r B_g1 - r s delta
    C = bw.g1_add(l_acc, h_acc)
    C = bw.g1_add(C, bw.g1_mul(A, s))
    C = bw.g1_add(C, bw.g1_mul(B_g1, r))
    C = bw.g1_add(C, bw.g1_neg(bw.g1_mul(pk.delta_g1, r * s % R)))
    return Proof(A, B, C)


def verify(vk: VerifyingKey, public_inputs: List[int], proof: Proof) -> bool:
    """e(A, B) == e(alpha, beta) e(acc, gamma) e(C, delta) over BW6-761, the
    public inputs' accumulator on the host.  False for a proof that fails,
    or for a number of public inputs that does not fit the key."""
    if len(public_inputs) != len(vk.gamma_abc_g1) - 1:
        return False
    t = Timer("groth16_bw6::verify")
    acc = vk.gamma_abc_g1[0]
    for v, pt in zip(public_inputs, vk.gamma_abc_g1[1:]):
        acc = bw.g1_add(acc, bw.g1_mul(pt, v % R))
    lhs = bw.multi_pairing(
        [proof.a, bw.g1_neg(vk.alpha_g1), bw.g1_neg(acc), bw.g1_neg(proof.c)],
        [proof.b, vk.beta_g2, vk.gamma_g2, vk.delta_g2],
    )
    t.stop()
    return lhs == bw.Fq6.one()
