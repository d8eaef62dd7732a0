"""The port's verifier circuit (testudo_tpu_torch/core/circuit.py) against the
JAX package's (testudo_tpu/core/circuit.py, host Python) on the CPU.

  - `build_verifier_circuit` gives the reference's circuit constraint for
    constraint (the same order, the same linear-combination dicts), with
    equal values and `num_pub`: for `CircuitGens`' all-ones config at the
    cubic's 4 x 4 x 1 and at 16 x 16 x 3, and for the config
    `prove_verifier` builds from a real 16 x 16 x 3 proof (the port's NIZK
    on the host group backends), which satisfies it.
  - The circuits' sizes at the cubic, 2^12, 2^16 and 2^20 shapes (10 inputs,
    as benches/testudo.py builds config #4).
  - The transcript gadget's challenges equal the port's host Fr transcript's
    on the same absorbs (seeded values).
Exact: integers."""
import random

import pytest
import torch

from testudo_tpu.core import circuit as jcircuit
from testudo_tpu_torch.core import circuit, groth16, r1cs, r1csproof, snark
from testudo_tpu_torch.curves import profile as cprof
from testudo_tpu_torch.fields.bls12_377 import R
from testudo_tpu_torch.poseidon.transcript import PoseidonTranscript, fr_params

torch.set_num_threads(1)


def _ref_config(config):
    return jcircuit.VerifierConfig(**vars(config))


def _assert_same_circuit(ours, ref):
    assert ours.num_pub == ref.num_pub
    assert ours.values == ref.values
    assert len(ours.constraints) == len(ref.constraints)
    for k, (a, b) in enumerate(zip(ours.constraints, ref.constraints)):
        assert a == b, f"constraint {k}"
        # the dicts' order too: the QAP walks them in it
        assert [list(x) for x in a] == [list(x) for x in b], f"constraint {k}"


@pytest.mark.parametrize("shape", [(4, 4, 1), (16, 16, 3)], ids=["cubic", "16x16x3"])
def test_dummy_circuit_equals_the_reference(shape):
    nc, nv = r1cs.pad_params(*shape)
    config = r1csproof.dummy_verifier_config(nc, nv, shape[2])
    ours = circuit.build_verifier_circuit(config)
    _assert_same_circuit(ours, jcircuit.build_verifier_circuit(_ref_config(config)))
    assert ours.is_satisfied() is False  # all ones are no proof


@pytest.mark.parametrize("log2n, constraints, variables, log_m", [
    (None, 4735, 4756, 13), (12, 24292, 24372, 15), (16, 31554, 31654, 15),
    (20, 38816, 38936, 16)])
def test_circuit_sizes(log2n, constraints, variables, log_m):
    shape = (4, 4, 1) if log2n is None else (1 << log2n, 1 << log2n, 10)
    nc, nv = r1cs.pad_params(*shape)
    cs = circuit.build_verifier_circuit(r1csproof.dummy_verifier_config(nc, nv, shape[2]))
    assert (len(cs.constraints), len(cs.values)) == (constraints, variables)
    assert groth16._domain_size(cs) == 1 << log_m


@pytest.fixture(scope="module")
def real_proof():
    pf = cprof.bls12_377("cpu", host_groups=True)
    inst, vars_, inputs = r1cs.Instance.produce_synthetic_r1cs(16, 16, 3)
    gens = snark.TestudoNizkGens.setup(16, 16, 3, profile=pf)
    proof = snark.nizk_prove(inst, vars_, inputs, gens, PoseidonTranscript(fr_params()))
    rx, ry = proof.r
    evals = inst.inst.evaluate(rx, ry, "cpu")
    return inst, inputs, proof.r1cs_sat_proof, evals


def test_real_circuit_equals_the_reference_and_is_satisfied(real_proof):
    inst, inputs, sat, evals = real_proof
    config = r1csproof.verifier_config(sat, inst.inst.num_vars, inst.inst.num_cons,
                                       inputs.assignment, evals)
    ours = circuit.build_verifier_circuit(config)
    _assert_same_circuit(ours, jcircuit.build_verifier_circuit(_ref_config(config)))
    assert ours.is_satisfied() is True
    # the public inputs in the verifier's order (r1csproof.rs:453-463)
    assert ours.public_inputs() == [sat.initial_state, *inputs.assignment, *sat.rx, *sat.ry,
                                    sat.eval_vars_at_ry, *evals, sat.transcript_sat_state]
    # the same structure as the dummy circuit CircuitGens keys
    dummy = circuit.build_verifier_circuit(r1csproof.dummy_verifier_config(
        inst.inst.num_cons, inst.inst.num_vars, len(inputs.assignment)))
    assert [[sorted(x) for x in c] for c in ours.constraints] == \
        [[sorted(x) for x in c] for c in dummy.constraints]
    # a wrong evaluation breaks it
    bad = r1csproof.verifier_config(sat, inst.inst.num_vars, inst.inst.num_cons,
                                    inputs.assignment, (evals[0], evals[1], (evals[2] + 1) % R))
    assert circuit.build_verifier_circuit(bad).is_satisfied() is False


@pytest.mark.parametrize("seed", [1, 2])
def test_transcript_gadget_equals_the_host_transcript(seed):
    rng = random.Random(seed)
    c = rng.randrange(R)
    absorbs = [[rng.randrange(R) for _ in range(k)] for k in (3, 0, 1, 4, 2)]
    cs = circuit.ConstraintSystem()
    gadget = circuit.TranscriptGadget(cs, cs.alloc_witness(c))
    host = PoseidonTranscript(fr_params())
    host.new_from_state(c)
    for vals in absorbs:
        gadget.append_vector([cs.alloc_witness(v) for v in vals])
        host.append_scalar_vector(vals, R)
        assert gadget.challenge().value == host.challenge_scalar(R)
    assert [v.value for v in gadget.challenge_vec(3)] == host.challenge_scalar_vec(R, 3)
    assert cs.is_satisfied()


def test_constraint_system_basics():
    cs = circuit.ConstraintSystem()
    out = cs.alloc_input(35)
    x = cs.alloc_witness(3)
    with pytest.raises(ValueError):
        cs.alloc_input(1)  # inputs precede witnesses
    x3 = x * x * x
    cs.enforce_equal(x3 + x + 5, out)
    assert cs.is_satisfied() and cs.public_inputs() == [35]
    assert (cs.num_pub, len(cs.values), len(cs.constraints)) == (2, 5, 3)
    lc = cs.lincomb([(2, x), (3, out)], const=7)
    assert lc.value == (2 * 3 + 3 * 35 + 7) % R and lc.lc == {0: 7, 2: 2, 1: 3}
