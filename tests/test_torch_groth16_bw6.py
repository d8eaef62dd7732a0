"""Groth16 over BW6-761 (core/groth16_bw6.py) on the CPU, on the toy Fq
circuit of tests/test_groth16_bw6.py:16-25 (public x and x * y + 3, witness
y): the setup draws the JAX package's scalars and its key batches are the
host's multiples of them; prove, verify, and the verifier rejects a public
input + 1, -C and another A; keys and proofs carry across to the JAX
package's classes and back.  Slow-marked: the keys against the JAX
package's own `setup`, and (A, B, C) against its `prove` under the same r
and s (both compile the JAX package's 48-limb graphs for minutes)."""
import hashlib
import random

import numpy as np
import pytest
import torch

from testudo_tpu.core import groth16_bw6 as jg16
from testudo_tpu_torch import convert
from testudo_tpu_torch.core import groth16_bw6 as g16
from testudo_tpu_torch.core.circuit import ConstraintSystem
from testudo_tpu_torch.curves import bw6_761 as bw
from testudo_tpu_torch.device import curve_generic as cg
from testudo_tpu_torch.fields.bls12_377 import P

torch.set_num_threads(1)

CPU = torch.device("cpu")
RS = (0x1234567 << 300 | 89, 0xABCDEF << 250 | 7)  # the r and s of the compared proofs


def _toy_fq_circuit(x: int, y: int) -> ConstraintSystem:
    """public: x, x*y + 3; witness: y  (over Fq = BW6's scalar field)."""
    cs = ConstraintSystem(modulus=P)
    xv = cs.alloc_input(x)
    out = cs.alloc_input((x * y + 3) % P)
    yv = cs.alloc_witness(y)
    prod = cs.mul(xv, yv)
    cs.enforce_equal(prod + 3, out)
    assert cs.is_satisfied()
    return cs


class _Fixed:
    """An rng whose draws are r, then s."""

    def __init__(self, values):
        self.values = list(values)

    def randrange(self, n):
        return self.values.pop(0) % n


@pytest.fixture(scope="module")
def toy():
    rng = random.Random(19)
    cs = _toy_fq_circuit(rng.randrange(P), rng.randrange(P))
    pk, vk = g16.setup(cs, device=CPU)
    proof = g16.prove(pk, cs, rng=_Fixed(RS))
    return cs, pk, vk, proof


def test_setup_draws_the_jax_packages_scalars_and_keys_are_their_multiples(toy):
    cs, pk, vk, _ = toy
    sc = g16.setup_scalars(cs)
    # the JAX package's draw (groth16_bw6.py:106-113)
    rng = np.random.default_rng(
        int.from_bytes(hashlib.sha256(b"testudo-tpu-groth16-bw6").digest()[:8], "little"))
    assert [sc.alpha, sc.beta, sc.gamma, sc.delta, sc.tau] == [
        int.from_bytes(rng.bytes(56), "little") % P for _ in range(5)]
    assert (pk.num_pub, pk.num_vars, pk.domain_log) == (3, 5, 3)  # 2 constraints + 3 inputs
    g1, g2 = bw.g1_generator(), bw.g2_generator()
    G1, G2 = cg.bw6_g1(), cg.bw6_g2()
    for batch, scalars in ((pk.a_query, sc.a), (pk.b_g1_query, sc.b), (pk.h_query, sc.h),
                           (pk.l_query, sc.l)):
        assert G1.to_affine_host(batch) == [bw.g1_mul(g1, s) for s in scalars]
    assert G2.to_affine_host(pk.b_g2_query) == [bw.g2_mul(g2, s) for s in sc.b]
    assert vk.gamma_abc_g1 == [bw.g1_mul(g1, s) for s in sc.gamma_abc]
    assert (vk.alpha_g1, vk.beta_g2, vk.gamma_g2, vk.delta_g2) == (
        bw.g1_mul(g1, sc.alpha), bw.g2_mul(g2, sc.beta), bw.g2_mul(g2, sc.gamma),
        bw.g2_mul(g2, sc.delta))
    assert (pk.beta_g1, pk.delta_g1) == (bw.g1_mul(g1, sc.beta), bw.g1_mul(g1, sc.delta))
    assert len(sc.h) == (1 << pk.domain_log) - 1 and len(sc.l) == pk.num_vars - pk.num_pub


def test_prove_verify_and_reject(toy):
    cs, pk, vk, proof = toy
    pub = cs.public_inputs()
    assert g16.verify(vk, pub, proof)
    bad = list(pub)
    bad[1] = (bad[1] + 1) % P
    assert not g16.verify(vk, bad, proof)
    assert not g16.verify(vk, pub, g16.Proof(proof.a, proof.b, bw.g1_neg(proof.c)))
    other = bw.g1_add(proof.a, bw.g1_generator())
    assert not g16.verify(vk, pub, g16.Proof(other, proof.b, proof.c))
    assert not g16.verify(vk, pub[:1], proof)  # a count that does not fit the key
    with pytest.raises(ValueError):
        g16.prove(pk, ConstraintSystem(modulus=P))  # another circuit's shape


def test_keys_and_proof_carry_across_and_back(toy):
    _, pk, vk, proof = toy
    rpk, rvk = convert.bw6_groth16_keys_to_reference(pk, vk, jg16)
    assert isinstance(rpk, jg16.ProvingKey) and isinstance(rvk, jg16.VerifyingKey)
    assert rpk.a_query[0].dtype == np.uint32 and rpk.a_query[0].shape == (5, 48)
    back_pk, back_vk = convert.bw6_groth16_keys_from_reference(rpk, rvk, device=CPU)
    assert back_vk == vk
    for name in ("a_query", "b_g1_query", "b_g2_query", "h_query", "l_query"):
        for mine, theirs in zip(getattr(back_pk, name), getattr(pk, name)):
            assert torch.equal(mine, theirs), name
    assert (back_pk.alpha_g1, back_pk.delta_g2, back_pk.domain_log) == (
        pk.alpha_g1, pk.delta_g2, pk.domain_log)
    rproof = convert.bw6_groth16_proof_to_reference(proof, jg16.Proof)
    assert isinstance(rproof, jg16.Proof)
    assert convert.bw6_groth16_proof_from_reference(rproof) == proof


@pytest.fixture(scope="module")
def jax_keys(toy):
    """The JAX package's own setup of the toy circuit."""
    return jg16.setup(toy[0])


@pytest.mark.slow
def test_keys_equal_the_jax_packages_setup(toy, jax_keys):
    """The JAX package's setup on the same circuit: equal keys (affine)."""
    from testudo_tpu.tpu import curve_generic as jcg

    _, pk, vk, _ = toy
    jpk, jvk = jax_keys
    assert jvk.gamma_abc_g1 == vk.gamma_abc_g1
    assert (jvk.alpha_g1, jvk.beta_g2, jvk.gamma_g2, jvk.delta_g2) == (
        vk.alpha_g1, vk.beta_g2, vk.gamma_g2, vk.delta_g2)
    assert (jpk.beta_g1, jpk.delta_g1) == (pk.beta_g1, pk.delta_g1)
    for name, G, jG in (("a_query", cg.bw6_g1(), jcg.bw6_g1()),
                        ("b_g1_query", cg.bw6_g1(), jcg.bw6_g1()),
                        ("b_g2_query", cg.bw6_g2(), jcg.bw6_g2()),
                        ("h_query", cg.bw6_g1(), jcg.bw6_g1()),
                        ("l_query", cg.bw6_g1(), jcg.bw6_g1())):
        assert jG.to_affine_host(getattr(jpk, name)) == G.to_affine_host(getattr(pk, name)), name


@pytest.mark.slow
def test_proof_equals_the_jax_packages_under_the_same_r_and_s(toy, jax_keys, monkeypatch):
    """The JAX package's prove under the same r and s: equal (A, B, C), and
    equal again from the port on the JAX package's keys carried across."""
    cs, _, _, proof = toy
    jpk, jvk = jax_keys
    draws = list(RS)
    monkeypatch.setattr(jg16.secrets, "randbelow", lambda n: draws.pop(0) % n)
    jproof = jg16.prove(jpk, cs)
    assert (jproof.a, jproof.b, jproof.c) == (proof.a, proof.b, proof.c)
    assert jg16.verify(jvk, cs.public_inputs(), jproof)
    carried, _ = convert.bw6_groth16_keys_from_reference(jpk, jvk, device=CPU)
    again = g16.prove(carried, cs, rng=_Fixed(RS))
    assert (again.a, again.b, again.c) == (proof.a, proof.b, proof.c)
