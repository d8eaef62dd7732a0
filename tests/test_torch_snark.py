"""The slice as a whole: TestudoSNARK without Groth16 (testudo_tpu_torch/core/
snark.py: `snark_encode`, `snark_prove`, `snark_verify` over the NIZK stack
and Spark) on the CPU with the host group backends
(`cprof.bls12_377("cpu", host_groups=True)`), at 16 x 16 x 3 with 16 nonzero
entries a matrix.

  - The proof's sizes obey the identity total = sat + eval + 3 x 32 + rx + ry
    + 1 (the empty Option of the Groth16 proof); the sat proof is 5,192 B.
  - The verifier accepts, and rejects an inst_evals entry + 1, a flipped byte
    of the eval proof (read back through `parse_testudo_snark`) and a wrong
    input; the codec round-trips and refuses trailing bytes and a Groth16
    tag without its proof; `with_groth16=True` (the default) builds the
    Groth16 keys of the verifier circuit (tests/test_torch_snark_groth16.py
    proves with them).
  - The fused sumcheck provers (the default) and the looped ones give the
    same bytes.
  - Slow-marked: the proof's bytes equal the JAX package's `snark_prove`
    (`with_groth16=False`; its groups on the host, its sumchecks looped:
    TESTUDO_HOST_CURVE=1, TESTUDO_FUSED_SUMCHECK=0, TESTUDO_FUSED_SPARK=0)
    under one seeded blind stream (the port's `rng`; the JAX package's
    `secrets` attribute patched with the same stream from here), and each
    package's verifier accepts the other's proof and commitment, carried
    across by `convert`.  The JAX side compiles XLA on the CPU for many
    minutes.
Exact: bytes and field elements."""
import random
import types

import pytest
import torch

from testudo_tpu import proofs as jproofs
from testudo_tpu.core import commitments as jcom
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
from testudo_tpu_torch.core import r1cs, snark
from testudo_tpu_torch.curves import profile as cprof
from testudo_tpu_torch.fields.bls12_377 import R
from testudo_tpu_torch.poseidon.transcript import PoseidonTranscript, fr_params

torch.set_num_threads(1)

NC = NV = 16
NI = 3
NNZ = 16
BLIND_SEED = 13
JAX_MODULES = (jsnark, jspark, jpc, jnizk, jptree, jsc, jcom, jrp, jmipp, junipoly)


def _profile():
    return cprof.bls12_377("cpu", host_groups=True)


@pytest.fixture(scope="module")
def setup():
    inst, vars_, inputs = r1cs.Instance.produce_synthetic_r1cs(NC, NV, NI)
    assert inst.inst.A.nnz == NNZ
    gens = snark.TestudoSnarkGens.setup(NC, NV, NI, NNZ, with_groth16=False, profile=_profile())
    comm, decomm = snark.snark_encode(inst, gens)
    return dict(inst=inst, vars=vars_, inputs=inputs, gens=gens, comm=comm, decomm=decomm)


def _prove(s, fused=True):
    tp = PoseidonTranscript(fr_params())
    proof = snark.snark_prove(s["inst"], s["comm"], s["decomm"], s["vars"], s["inputs"], s["gens"],
                              tp, fused=fused, rng=random.Random(BLIND_SEED))
    return dict(proof=proof, blob=proofs.ser_testudo_snark(proof), state=list(tp.sponge.state))


@pytest.fixture(scope="module")
def proved(setup):
    return _prove(setup)


def _verify(s, proof, inputs=None, comm=None):
    return snark.snark_verify(proof, s["gens"], comm or s["comm"], inputs or s["inputs"],
                              PoseidonTranscript(fr_params()))


def _sizes(proof):
    sat = len(proofs.ser_r1cs_proof(proof.r1cs_sat_proof))
    ev = len(proofs.ser_spark_proof(proof.r1cs_eval_proof.proof))
    return sat, ev, len(proofs.ser_testudo_snark(proof))


def test_sizes_obey_the_identity(proved):
    proof = proved["proof"]
    sat, ev, total = _sizes(proof)
    rx, ry = proof.r
    assert (len(rx), len(ry)) == (4, 5)
    assert sat == 5192  # the NIZK's sat proof at 16 x 16 (tests/fixtures/golden_nizk.json)
    assert total == sat + ev + 3 * 32 + (8 + 32 * len(rx)) + (8 + 32 * len(ry)) + 1
    assert proved["blob"][-1] == 0


def test_verifier_accepts_and_rejects(setup, proved):
    proof = proved["proof"]
    assert _verify(setup, proof) is True
    e = proof.inst_evals
    bumped = snark.TestudoSnark(proof.r1cs_sat_proof, proof.r1cs_eval_proof,
                                (e[0], e[1], (e[2] + 1) % R), proof.r)
    assert _verify(setup, bumped) is False
    bumped = snark.TestudoSnark(proof.r1cs_sat_proof, proof.r1cs_eval_proof,
                                ((e[0] + 1) % R, e[1], e[2]), proof.r)
    assert _verify(setup, bumped) is False
    # one flipped byte of the eval proof: the low byte of its last scalar (z2
    # of the derefs' dot-product argument)
    sat, ev, _ = _sizes(proof)
    blob = bytearray(proved["blob"])
    blob[sat + ev - 32] ^= 1
    assert _verify(setup, proofs.parse_testudo_snark(bytes(blob))) is False
    inputs = setup["inputs"].assignment
    wrong = r1cs.Assignment([(inputs[0] + 1) % R] + inputs[1:])
    assert _verify(setup, proof, inputs=wrong) is False
    assert _verify(setup, proof) is True


def test_codec_round_trip(setup, proved):
    blob = proved["blob"]
    back = proofs.parse_testudo_snark(blob)
    assert proofs.ser_testudo_snark(back) == blob
    assert _verify(setup, back) is True
    with pytest.raises(ser.DeserializeError):
        proofs.parse_testudo_snark(blob + b"\x00")
    with pytest.raises(ser.DeserializeError):
        proofs.parse_testudo_snark(blob[:-1] + b"\x01")  # a Groth16 tag without its proof
    with pytest.raises(ser.DeserializeError):
        proofs.parse_testudo_snark(blob[:-1] + b"\x02")


def test_fused_and_looped_provers_give_the_same_bytes(setup, proved):
    looped = _prove(setup, fused=False)
    assert looped["blob"] == proved["blob"]
    assert looped["state"] == proved["state"]


def test_generators_and_groth16(setup):
    g = setup["gens"].gens_r1cs_eval.gens
    # the ops' and the derefs' rows are 16 wide here: one draw serves both
    assert g.gens_ops.gens is g.gens_derefs.gens
    assert (g.gens_ops.num_vars, g.gens_mem.num_vars, g.gens_derefs.num_vars) == (8, 6, 7)
    assert setup["gens"].gens_gc is None  # with_groth16=False
    # the reference's default, with_groth16=True, adds the verifier circuit's keys
    gens = snark.TestudoSnarkGens.setup(NC, NV, NI, NNZ, profile=_profile())
    # ONE, the initial state, the inputs, rx, ry, eval_vars_at_ry, Ar, Br, Cr, sat state
    assert gens.gens_gc.pk.num_pub == 2 + NI + 4 + 5 + 5
    assert gens.gens_r1cs_eval == setup["gens"].gens_r1cs_eval


def test_spark_generators_and_commitment_carry_across(setup):
    """Spark's generators: the port's, carried into the JAX package's classes,
    equal the JAX package's own setup, and come back unchanged; so does the
    computation commitment."""
    ours = setup["gens"].gens_r1cs_eval
    nc, nv = r1cs.pad_params(NC, NV, NI)
    ref = jsnark.R1CSCommitmentGens.setup(b"gens_r1cs_eval", nc, nv, NI, NNZ)
    carried = convert.spark_gens_to_reference(ours, jhf, *JAX_MODULES)
    assert isinstance(carried, jsnark.R1CSCommitmentGens)
    for name in ("gens_ops", "gens_mem", "gens_derefs"):
        a, b = getattr(carried.gens, name), getattr(ref.gens, name)
        assert a.num_vars == b.num_vars
        for part in ("gens_n", "gens_1"):
            pa, pb = getattr(a.gens, part), getattr(b.gens, part)
            assert (pa.n, list(pa.G), pa.h) == (pb.n, list(pb.G), pb.h)
    back = convert.spark_gens_from_reference(carried, _profile())
    assert back.gens.gens_ops.gens.gens_n.G == ours.gens.gens_ops.gens.gens_n.G
    assert back.gens.gens_derefs.gens.gens_1.h == ours.gens.gens_derefs.gens.gens_1.h
    comm = convert.computation_commitment_to_reference(setup["comm"], jhf, *JAX_MODULES)
    assert isinstance(comm, jsnark.ComputationCommitment)
    assert convert.computation_commitment_from_reference(comm) == setup["comm"]


@pytest.fixture(scope="module")
def reference(setup):
    """The same instance proved by the JAX package under the same blinds."""
    mp = pytest.MonkeyPatch()
    mp.setenv("TESTUDO_HOST_CURVE", "1")  # read when the profile is first built
    mp.setenv("TESTUDO_FUSED_SUMCHECK", "0")
    mp.setenv("TESTUDO_FUSED_SPARK", "0")
    jprof.bls12_377.cache_clear()
    mp.setattr(jpst, "_SETUP_CACHE", {})
    stream = random.Random(BLIND_SEED)
    mp.setattr(jnizk, "secrets", types.SimpleNamespace(randbelow=stream.randrange))
    try:
        jinst, jvars, jinputs = jr1cs.Instance.produce_synthetic_r1cs(NC, NV, NI)
        jgens = jsnark.TestudoSnarkGens.setup(NC, NV, NI, NNZ, with_groth16=False)
        jcomm, jdecomm = jsnark.snark_encode(jinst, jgens)
        tp = jtr.PoseidonTranscript(jtr.fr_params())
        jproof = jsnark.snark_prove(jinst, jcomm, jdecomm, jvars, jinputs, jgens, tp)
        yield dict(inst=jinst, inputs=jinputs, gens=jgens, comm=jcomm, proof=jproof,
                   blob=jproofs.ser_testudo_snark(jproof), state=list(tp.sponge.state))
    finally:
        jprof.bls12_377.cache_clear()
        mp.undo()


@pytest.mark.slow  # the JAX package's Spark compiles XLA on the CPU (many minutes)
def test_proof_bytes_equal_the_reference_and_cross_verify(setup, proved, reference):
    assert proved["blob"] == reference["blob"]
    assert proved["state"] == reference["state"]
    # the commitment and the generators carried across match each package's own
    comm = convert.computation_commitment_from_reference(reference["comm"])
    assert comm == setup["comm"]
    gens = convert.spark_gens_from_reference(reference["gens"].gens_r1cs_eval, _profile())
    ours = setup["gens"].gens_r1cs_eval.gens
    assert gens.gens.gens_ops.gens.gens_n.G == ours.gens_ops.gens.gens_n.G
    assert gens.gens.gens_mem.gens.gens_1.G == ours.gens_mem.gens.gens_1.G
    # the JAX package's proof in the port's verifier, against its commitment
    port_proof = convert.snark_proof_from_reference(reference["proof"])
    assert proofs.ser_testudo_snark(port_proof) == reference["blob"]
    assert _verify(setup, port_proof, comm=comm) is True
    # the port's proof and commitment in the JAX package's verifier
    ref_proof = convert.snark_proof_to_reference(proved["proof"], jhf, *JAX_MODULES)
    assert jproofs.ser_testudo_snark(ref_proof) == proved["blob"]
    ref_comm = convert.computation_commitment_to_reference(setup["comm"], jhf, *JAX_MODULES)
    tv = jtr.PoseidonTranscript(jtr.fr_params())
    assert jsnark.snark_verify(ref_proof, reference["gens"], ref_comm, reference["inputs"],
                               tv) is True
