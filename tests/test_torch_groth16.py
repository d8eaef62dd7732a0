"""The port's Groth16 (testudo_tpu_torch/core/groth16.py) against the JAX
package's (testudo_tpu/core/groth16.py) on the CPU, on the circuit of
tests/test_snark.py's `test_groth16_tiny` (x^3 + x + 5 = 35 at x = 3):

  - public input 35 is accepted and 36 rejected, on the host group backends
    and on the device backends' plain versions (`bls12_377("cpu")`);
  - the keys equal the JAX package's point for point (the seeded setup):
    affine on the host backends, projective limb for limb on the device
    backends (the fixed-base batches run the same adds and selects); they
    carry across by `convert` and back unchanged, and the JAX package's
    verifier accepts the port's proof with them (and rejects 36);
  - slow-marked: under one seeded stream for r and s (the port's `rng`; the
    JAX package's `secrets` patched with the same stream) the proof's A, B, C
    equal the JAX package's, on both backends, and the port's verifier
    accepts the JAX package's proof with its keys carried across (the JAX
    package's prover compiles its small-MSM graphs for minutes on the CPU);
  - `_witness_h` equals the JAX package's on a circuit of 100 constraints
    (domain 2^7), limb for limb.
Exact: points, limbs and field elements."""
import random
import types

import numpy as np
import pytest
import torch

from testudo_tpu.core import groth16 as jg
from testudo_tpu.core.circuit import ConstraintSystem as JConstraintSystem
from testudo_tpu.fields import host as jhf
from testudo_tpu_torch import convert
from testudo_tpu_torch.core import groth16
from testudo_tpu_torch.core.circuit import ConstraintSystem
from testudo_tpu_torch.curves import profile as cprof
from testudo_tpu_torch.device import curve as tc

torch.set_num_threads(1)

SEED = 21


def _tiny(cs_cls):
    cs = cs_cls()
    out = cs.alloc_input(35)
    x = cs.alloc_witness(3)
    x2 = cs.mul(x, x)
    x3 = cs.mul(x2, x)
    cs.enforce_equal(x3 + x + 5, out)
    assert cs.is_satisfied()
    return cs


def _chain(cs_cls, n: int):
    """n constraints: a running product and sum of a seeded witness, one
    public input at the end."""
    rng = random.Random(n)
    cs = cs_cls()
    vals = [rng.randrange(1, 1 << 60) for _ in range(n)]
    total = cs.alloc_input(0)
    acc = cs.alloc_witness(vals[0])
    for v in vals[1:]:
        acc = cs.mul(acc, cs.alloc_witness(v)) + v
    cs.values[1] = acc.value  # the public input is the chain's end
    total.value = acc.value
    cs.enforce_equal(acc, total)
    assert cs.is_satisfied()
    return cs


_PROFILES = {"host": lambda: cprof.bls12_377("cpu", host_groups=True),
             "device": lambda: cprof.bls12_377("cpu")}


@pytest.fixture(scope="module")
def reference():
    """The JAX package's keys (its setup is seeded)."""
    cs = _tiny(JConstraintSystem)
    pk, vk = jg.setup(cs)
    return dict(cs=cs, pk=pk, vk=vk)


@pytest.fixture(scope="module")
def reference_proof(reference):
    """The JAX package's proof, r and s from the seeded stream."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jg, "secrets", types.SimpleNamespace(randbelow=random.Random(SEED).randrange))
    try:
        proof = jg.prove(reference["pk"], reference["cs"])
    finally:
        mp.undo()
    assert jg.verify(reference["vk"], [35], proof)
    return proof


@pytest.fixture(scope="module", params=list(_PROFILES))
def ours(request):
    cs = _tiny(ConstraintSystem)
    pk, vk = groth16.setup(cs, profile=_PROFILES[request.param]())
    proof = groth16.prove(pk, cs, random.Random(SEED))
    return dict(kind=request.param, cs=cs, pk=pk, vk=vk, proof=proof)


def test_tiny_accepts_35_and_rejects_36(ours):
    vk, proof = ours["vk"], ours["proof"]
    assert groth16.verify(vk, [35], proof) is True
    assert groth16.verify(vk, [36], proof) is False
    assert groth16.verify(vk, [35, 1], proof) is False  # a wrong number of inputs
    g1 = vk.profile.g1_generator()
    moved = groth16.Proof(vk.profile.g1_add(proof.a, g1), proof.b, proof.c)
    assert groth16.verify(vk, [35], moved) is False
    assert groth16.verify(vk, [35], groth16.Proof(proof.a, proof.b,
                                                  vk.profile.g1_neg(proof.c))) is False


def _ref_affine(batch):
    if batch is None:
        return None
    g2 = isinstance(batch[0], tuple)
    pts = convert.points_from_reference(batch, device=torch.device("cpu"))
    return (tc.g2_to_affine_host if g2 else tc.g1_to_affine_host)(pts)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


_BATCHES = ("a_query", "b_g1_query", "b_g2_query", "h_query", "l_query")
_POINTS = ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2")


def test_keys_equal_the_reference(ours, reference):
    pk, vk, rpk, rvk = ours["pk"], ours["vk"], reference["pk"], reference["vk"]
    assert (pk.num_pub, pk.num_vars, pk.domain_log) == (rpk.num_pub, rpk.num_vars,
                                                        rpk.domain_log)
    for name in _POINTS:
        assert getattr(pk, name) == convert.host_point_from_reference(getattr(rpk, name)), name
    for name in ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2"):
        assert getattr(vk, name) == convert.host_point_from_reference(getattr(rvk, name)), name
    assert vk.gamma_abc_g1 == [convert.host_point_from_reference(p) for p in rvk.gamma_abc_g1]
    for name in _BATCHES:
        g2 = name == "b_g2_query"
        backend = pk.profile.g2b if g2 else pk.profile.g1b
        assert backend.to_affine(getattr(pk, name)) == _ref_affine(getattr(rpk, name)), name
        if ours["kind"] == "device":  # projective limbs too
            got = convert.points_to_reference(getattr(pk, name))
            want = getattr(rpk, name)
            for g, w in zip(_leaves(got), _leaves(want)):
                assert np.array_equal(g, np.asarray(w)), name


@pytest.mark.slow  # the JAX package's prover compiles for minutes on the CPU
def test_proof_equals_the_reference(ours, reference, reference_proof):
    assert ours["proof"] == convert.groth16_proof_from_reference(reference_proof)
    # the port's verifier on the JAX package's proof and keys
    _, vk = convert.groth16_keys_from_reference(reference["pk"], reference["vk"],
                                                ours["pk"].profile)
    assert groth16.verify(vk, [35], convert.groth16_proof_from_reference(reference_proof)) is True


def test_keys_carry_across_and_the_reference_verifies_the_port(ours):
    proof = ours["proof"]
    # the JAX package's verifier on the port's proof and keys
    rpk, rvk = convert.groth16_keys_to_reference(ours["pk"], ours["vk"], jhf, jg)
    rp = convert.groth16_proof_to_reference(proof, jhf, jg.Proof)
    assert jg.verify(rvk, [35], rp) is True
    assert jg.verify(rvk, [36], rp) is False
    # the keys carried back are the port's
    pk2, vk2 = convert.groth16_keys_from_reference(rpk, rvk, ours["pk"].profile)
    assert vk2 == ours["vk"]
    for name in _BATCHES:
        backend = pk2.profile.g2b if name == "b_g2_query" else pk2.profile.g1b
        assert backend.to_affine(getattr(pk2, name)) == \
            backend.to_affine(getattr(ours["pk"], name)), name


def test_witness_h_equals_the_reference():
    cs, jcs = _chain(ConstraintSystem, 100), _chain(JConstraintSystem, 100)
    assert cs.values == jcs.values and cs.constraints == jcs.constraints
    m = groth16._domain_size(cs)
    assert m == 128
    h = groth16._witness_h(cs, m, torch.device("cpu"))
    want = np.asarray(jg._witness_h(jcs, m))
    assert np.array_equal(h.numpy().astype(np.int64), want.astype(np.int64))
    # h Z = a b - c on the domain's coset: the top coefficient is zero
    assert not h[-1].any()


def test_lagrange_at_equals_the_reference():
    for m in (2, 8, 64):
        tau = random.Random(m).randrange(groth16.R)
        assert groth16._lagrange_at(tau, m) == jg._lagrange_at(tau, m)
