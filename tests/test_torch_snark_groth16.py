"""The whole slice on the CPU: TestudoSNARK with its Groth16-compressed
verifier (testudo_tpu_torch/core/snark.py with `with_groth16=True`, the
default; core/groth16.py, core/circuit.py, core/ntt.py, r1csproof.py's
`CircuitGens`, `prove_verifier`, `verifier_proof_verify`) on the host group
backends (`cprof.bls12_377("cpu", host_groups=True)`), at 16 x 16 x 3 with 16
nonzero entries a matrix (a verifier circuit of 8,666 variables, domain
2^14).

  - The proof is 192 B longer than without Groth16 (16,497 B there): the
    Option's tag is 1 and the Groth16 proof follows; the codec round-trips,
    refuses trailing bytes and a bad tag.
  - The verifier accepts, and rejects inst_evals[0] + 1, a Groth16 proof
    with C replaced by -C or A by A + G, a flipped byte of the eval proof
    and a wrong input; a proof without its Groth16 part takes the native
    branch and verifies.
  - `prove_verifier` raises when its transcript re-derives another initial
    state than the proof's (a transcript not re-keyed at the SNARK's
    challenge), and proves under the honest one.
  - The setup, prove and verify record their Timer labels.
  - Slow-marked: the proof's bytes equal the JAX package's `snark_prove`
    (with Groth16; its groups on the host, its sumchecks looped, its
    Groth16 keys the port's carried across) under one seeded stream (the
    port's `rng`; the JAX package's `secrets` in its nizk and groth16
    modules patched with the same stream), and each package's verifier
    accepts the other's proof, carried across by `convert`.
Exact: bytes and field elements."""
import random
import types

import pytest
import torch

from testudo_tpu import proofs as jproofs
from testudo_tpu.core import commitments as jcom
from testudo_tpu.core import groth16 as jg
from testudo_tpu.core import mipp as jmipp
from testudo_tpu.core import nizk as jnizk
from testudo_tpu.core import polycommit as jpc
from testudo_tpu.core import product_tree as jptree
from testudo_tpu.core import pst as jpst
from testudo_tpu.core import r1cs as jr1cs
from testudo_tpu.core import r1csproof as jrp
from testudo_tpu.core import snark as jsnark
from testudo_tpu.core import spark as jspark
from testudo_tpu.core import sumcheck as jsc
from testudo_tpu.curves import profile as jprof
from testudo_tpu.fields import host as jhf
from testudo_tpu.poly import unipoly as junipoly
from testudo_tpu.poseidon import transcript as jtr
from testudo_tpu_torch import convert, proofs
from testudo_tpu_torch import serialize as ser
from testudo_tpu_torch.core import groth16, r1cs, r1csproof, snark
from testudo_tpu_torch.curves import profile as cprof
from testudo_tpu_torch.fields.bls12_377 import R
from testudo_tpu_torch.poseidon.transcript import PoseidonTranscript, fr_params
from testudo_tpu_torch.utils import timer

torch.set_num_threads(1)

NC = NV = 16
NI = 3
NNZ = 16
BLIND_SEED = 13
SIZE_WITHOUT_GROTH16 = 16497  # tests/test_torch_snark.py at the same shape
JAX_MODULES = (jsnark, jspark, jpc, jnizk, jptree, jsc, jcom, jrp, jmipp, junipoly, jg)


def _profile():
    return cprof.bls12_377("cpu", host_groups=True)


@pytest.fixture(scope="module")
def setup():
    inst, vars_, inputs = r1cs.Instance.produce_synthetic_r1cs(NC, NV, NI)
    with timer.record() as rec:
        gens = snark.TestudoSnarkGens.setup(NC, NV, NI, NNZ, profile=_profile())
    comm, decomm = snark.snark_encode(inst, gens)
    return dict(inst=inst, vars=vars_, inputs=inputs, gens=gens, comm=comm, decomm=decomm,
                labels={label for label, _ in rec})


@pytest.fixture(scope="module")
def proved(setup):
    s = setup
    tp = PoseidonTranscript(fr_params())
    with timer.record() as rec:
        proof = snark.snark_prove(s["inst"], s["comm"], s["decomm"], s["vars"], s["inputs"],
                                  s["gens"], tp, rng=random.Random(BLIND_SEED))
    return dict(proof=proof, blob=proofs.ser_testudo_snark(proof), state=list(tp.sponge.state),
                labels={label for label, _ in rec})


def _verify(s, proof, inputs=None, labels=None):
    with timer.record() as rec:
        ok = snark.snark_verify(proof, s["gens"], s["comm"], inputs or s["inputs"],
                                PoseidonTranscript(fr_params()))
    if labels is not None:
        labels.update(label for label, _ in rec)
    return ok


def _with_circuit_proof(proof, **parts):
    vp = proof.r1cs_verifier_proof
    cp = groth16.Proof(**{**vars(vp.circuit_proof), **parts})
    return snark.TestudoSnark(proof.r1cs_sat_proof, proof.r1cs_eval_proof, proof.inst_evals,
                              proof.r, r1csproof.R1CSVerifierProof(**{**vars(vp),
                                                                      "circuit_proof": cp}))


def test_gens_hold_the_circuit_keys(setup):
    gc = setup["gens"].gens_gc
    assert isinstance(gc, r1csproof.CircuitGens)
    # 1 + 3 inputs + 4 + 5 coordinates of (rx, ry) + eval, Ar, Br, Cr + sat state
    assert (gc.pk.num_pub, gc.pk.num_vars, gc.pk.domain_log) == (19, 8666, 14)
    assert len(gc.vk.gamma_abc_g1) == 19


def test_sizes(proved):
    proof, blob = proved["proof"], proved["blob"]
    assert proof.r1cs_verifier_proof is not None
    g16 = proofs.ser_groth16_proof(proof.r1cs_verifier_proof.circuit_proof)
    assert len(g16) == 192
    assert len(blob) == SIZE_WITHOUT_GROTH16 + 192
    assert blob[-193] == 1 and blob[-192:] == g16
    without = snark.TestudoSnark(proof.r1cs_sat_proof, proof.r1cs_eval_proof, proof.inst_evals,
                                 proof.r)
    assert proofs.ser_testudo_snark(without) == blob[:-193] + b"\x00"


def test_verifier_accepts_and_rejects(setup, proved):
    s, proof = setup, proved["proof"]
    assert _verify(s, proof) is True
    e = proof.inst_evals
    bumped = snark.TestudoSnark(proof.r1cs_sat_proof, proof.r1cs_eval_proof,
                                ((e[0] + 1) % R, e[1], e[2]), proof.r, proof.r1cs_verifier_proof)
    assert _verify(s, bumped) is False
    pf = _profile()
    cp = proof.r1cs_verifier_proof.circuit_proof
    assert _verify(s, _with_circuit_proof(proof, c=pf.g1_neg(cp.c))) is False
    assert _verify(s, _with_circuit_proof(proof, a=pf.g1_add(cp.a, pf.g1_generator()))) is False
    # one flipped byte of the eval proof: the low byte of its last scalar
    sat = len(proofs.ser_r1cs_proof(proof.r1cs_sat_proof))
    ev = len(proofs.ser_spark_proof(proof.r1cs_eval_proof.proof))
    blob = bytearray(proved["blob"])
    blob[sat + ev - 32] ^= 1
    assert _verify(s, proofs.parse_testudo_snark(bytes(blob))) is False
    inputs = s["inputs"].assignment
    assert _verify(s, proof, inputs=r1cs.Assignment([(inputs[0] + 1) % R] + inputs[1:])) is False
    assert _verify(s, proof) is True


def test_without_the_groth16_part_the_native_branch_verifies(setup, proved):
    proof = proved["proof"]
    labels = set()
    native = snark.TestudoSnark(proof.r1cs_sat_proof, proof.r1cs_eval_proof, proof.inst_evals,
                                proof.r)
    assert _verify(setup, native, labels=labels) is True
    assert "snark_verify::sat proof" in labels and "snark_verify::groth16" not in labels


def test_codec_round_trip(setup, proved):
    blob = proved["blob"]
    back = proofs.parse_testudo_snark(blob)
    assert proofs.ser_testudo_snark(back) == blob
    vp, vp_back = proved["proof"].r1cs_verifier_proof, back.r1cs_verifier_proof
    assert vp_back.circuit_proof == vp.circuit_proof
    assert (vp_back.initial_state, vp_back.transcript_sat_state) == (vp.initial_state,
                                                                     vp.transcript_sat_state)
    assert _verify(setup, back) is True
    with pytest.raises(ser.DeserializeError):
        proofs.parse_testudo_snark(blob + b"\x00")
    with pytest.raises(ser.DeserializeError):
        proofs.parse_testudo_snark(blob[:-193] + b"\x02" + blob[-192:])
    with pytest.raises(ser.DeserializeError):
        proofs.parse_testudo_snark(blob[:-1])


def test_prove_verifier_checks_the_initial_state(setup, proved):
    s, proof = setup, proved["proof"]
    sat, (Ar, Br, Cr) = proof.r1cs_sat_proof, proof.inst_evals
    gc = s["gens"].gens_gc
    args = (sat, s["inst"].inst.num_vars, s["inst"].inst.num_cons, s["inputs"].assignment,
            (Ar, Br, Cr))
    with pytest.raises(ValueError, match="initial state"):
        r1csproof.prove_verifier(*args, PoseidonTranscript(fr_params()), gc,
                                 random.Random(1))
    # the SNARK's re-key at c: the re-derived state is the sat proof's, and
    # r1csproof.prove's absorb of T is append_gt's
    tp = PoseidonTranscript(fr_params())
    s["comm"].write_to_transcript(tp)
    c = tp.challenge_scalar(R)
    tp.new_from_state(c)
    tq = PoseidonTranscript(fr_params())
    tq.new_from_state(c)
    tq.append_gt(sat.t)
    assert tq.challenge_scalar(R) == sat.initial_state
    vp = r1csproof.prove_verifier(*args, tp, gc, random.Random(1))
    assert vp.initial_state == sat.initial_state
    assert r1csproof.verifier_proof_verify(vp, proof.r, s["inputs"].assignment, (Ar, Br, Cr),
                                           PoseidonTranscript(fr_params()), gc,
                                           s["gens"].gens_r1cs_sat) is True


def test_timer_labels(setup, proved):
    assert {"groth16::circuit build", "groth16::lagrange", "groth16::keys", "groth16::keys G1",
            "groth16::keys G2"} <= setup["labels"]
    assert {"snark_prove::prove_verifier", "groth16::circuit build", "groth16::row evals",
            "groth16::witness_h", "groth16::msm a", "groth16::msm b_g1", "groth16::msm b_g2",
            "groth16::msm h", "groth16::msm l"} <= proved["labels"]
    labels = set()
    assert _verify(setup, proved["proof"], labels=labels) is True
    assert {"snark_verify::groth16", "snark_verify::sqrt-PST check",
            "snark_verify::spark"} <= labels


@pytest.fixture(scope="module")
def reference(setup):
    """The same instance proved by the JAX package under the same stream.
    Its verifier circuit's Groth16 keys are the port's, carried across by
    `convert`: the two setups are seeded alike and give equal keys
    (tests/test_torch_groth16.py), and the JAX package's fixed-base setup of
    this 8,666-variable circuit runs for over 40 minutes on the CPU."""
    mp = pytest.MonkeyPatch()
    mp.setenv("TESTUDO_HOST_CURVE", "1")  # read when the profile is first built
    mp.setenv("TESTUDO_FUSED_SUMCHECK", "0")
    mp.setenv("TESTUDO_FUSED_SPARK", "0")
    jprof.bls12_377.cache_clear()
    mp.setattr(jpst, "_SETUP_CACHE", {})
    stream = types.SimpleNamespace(randbelow=random.Random(BLIND_SEED).randrange)
    mp.setattr(jnizk, "secrets", stream)
    mp.setattr(jg, "secrets", stream)
    try:
        jinst, jvars, jinputs = jr1cs.Instance.produce_synthetic_r1cs(NC, NV, NI)
        jgens = jsnark.TestudoSnarkGens.setup(NC, NV, NI, NNZ, with_groth16=False)
        gc = setup["gens"].gens_gc
        jgens.gens_gc = jrp.CircuitGens(*convert.groth16_keys_to_reference(gc.pk, gc.vk, jhf, jg))
        jcomm, jdecomm = jsnark.snark_encode(jinst, jgens)
        tp = jtr.PoseidonTranscript(jtr.fr_params())
        jproof = jsnark.snark_prove(jinst, jcomm, jdecomm, jvars, jinputs, jgens, tp)
        yield dict(inputs=jinputs, gens=jgens, comm=jcomm, proof=jproof,
                   blob=jproofs.ser_testudo_snark(jproof), state=list(tp.sponge.state))
    finally:
        jprof.bls12_377.cache_clear()
        mp.undo()


@pytest.mark.slow  # the JAX package's Groth16 prover and Spark compile XLA for many minutes
def test_proof_bytes_equal_the_reference_and_cross_verify(setup, proved, reference):
    assert proved["blob"] == reference["blob"]
    assert proved["state"] == reference["state"]
    # the JAX package's proof in the port's verifier, against its commitment
    port_proof = convert.snark_proof_from_reference(reference["proof"])
    assert proofs.ser_testudo_snark(port_proof) == reference["blob"]
    comm = convert.computation_commitment_from_reference(reference["comm"])
    assert snark.snark_verify(port_proof, setup["gens"], comm, setup["inputs"],
                              PoseidonTranscript(fr_params())) is True
    # the port's proof and commitment in the JAX package's verifier
    ref_proof = convert.snark_proof_to_reference(proved["proof"], jhf, *JAX_MODULES)
    assert jproofs.ser_testudo_snark(ref_proof) == proved["blob"]
    ref_comm = convert.computation_commitment_to_reference(setup["comm"], jhf, *JAX_MODULES)
    assert jsnark.snark_verify(ref_proof, reference["gens"], ref_comm, reference["inputs"],
                               jtr.PoseidonTranscript(jtr.fr_params())) is True
