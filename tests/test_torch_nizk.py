"""The slice as a whole: TestudoNIZK (testudo_tpu_torch/core/snark.py over the
R1CS proof, the sumcheck and sqrt-PST) on the CPU, with the host group
backends (`cprof.bls12_377("cpu", host_groups=True)`: the Fr tables, the
sumcheck and the R1CS products on CPU tensors, i.e. the kernels' plain
versions; every group operation on the host).

  - The golden instance (16 x 16 x 2, seed 7) proves to the bytes of
    tests/fixtures/golden_nizk.json, with both final sponge states equal,
    with the fused sumcheck (the default) and with the looped one.
  - A second instance (32 x 32 x 3, seed 11: an odd sqrt-PST matrix) proved
    by both packages gives byte-equal proofs and sponge states.  The JAX side
    runs with TESTUDO_HOST_CURVE=1, a cleared profile cache, an empty
    `pst._SETUP_CACHE` and the looped sumcheck (TESTUDO_FUSED_SUMCHECK=0): its
    fused jit compiles for minutes a shape on a CPU, so the JAX side stays
    pinned looped (the port's side runs its fused default;
    tests/test_torch_sumcheck_fused.py holds the fused provers against the
    looped ones, and, slow-marked, against the JAX fused jit).
  - Each package's verifier accepts the other's proof, carried across by
    `convert`; the codecs round-trip; the verifier rejects corrupted proofs.
Exact: bytes and field elements."""
import hashlib
import json
import os

import pytest
import torch

from testudo_tpu import proofs as jproofs
from testudo_tpu.core import mipp as jmipp
from testudo_tpu.core import pst as jpst
from testudo_tpu.core import r1cs as jr1cs
from testudo_tpu.core import r1csproof as jrp
from testudo_tpu.core import snark as jsnark
from testudo_tpu.core import sumcheck as jsc
from testudo_tpu.curves import profile as jprof
from testudo_tpu.fields import host as jhf
from testudo_tpu.poly.unipoly import UniPoly as JUniPoly
from testudo_tpu.poseidon import transcript as jtr
from testudo_tpu_torch import convert, proofs
from testudo_tpu_torch import serialize as ser
from testudo_tpu_torch.core import r1cs, snark
from testudo_tpu_torch.curves import profile as cprof
from testudo_tpu_torch.device import build
from testudo_tpu_torch.fields.bls12_377 import R
from testudo_tpu_torch.poseidon.transcript import PoseidonTranscript, fr_params

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

FIX_PATH = os.path.join(os.path.dirname(__file__), "fixtures", "golden_nizk.json")


def _profile():
    return cprof.bls12_377("cpu", host_groups=True)


def _prove(nc, nv, ni, seed, fused=True):
    inst, vars_, inputs = r1cs.Instance.produce_synthetic_r1cs(nc, nv, ni, seed=seed)
    gens = snark.TestudoNizkGens.setup(nc, nv, ni, profile=_profile())
    tp = PoseidonTranscript(fr_params())
    proof = snark.nizk_prove(inst, vars_, inputs, gens, tp, fused=fused)
    return dict(inst=inst, vars=vars_, inputs=inputs, gens=gens, proof=proof,
                blob=proofs.ser_r1cs_proof(proof.r1cs_sat_proof),
                prover_state=list(tp.sponge.state))


def _verify(run, proof=None, inputs=None, inst=None):
    tv = PoseidonTranscript(fr_params())
    ok = snark.nizk_verify(proof or run["proof"], run["gens"], inst or run["inst"],
                           inputs or run["inputs"], tv)
    return ok, list(tv.sponge.state)


@pytest.fixture(scope="module")
def fix():
    with open(FIX_PATH) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def golden(fix):
    p = fix["params"]
    build.reset_launches()
    run = _prove(p["num_cons"], p["num_vars"], p["num_inputs"], p["seed"])
    run["launches"] = sum(build.LAUNCHES.values())
    return run


@pytest.fixture(scope="module")
def both():
    """The 32 x 32 x 3 instance proved by the port and by the JAX package."""
    run = _prove(32, 32, 3, 11)
    mp = pytest.MonkeyPatch()
    mp.setenv("TESTUDO_HOST_CURVE", "1")  # read when the profile is first built
    mp.setenv("TESTUDO_FUSED_SUMCHECK", "0")
    jprof.bls12_377.cache_clear()
    mp.setattr(jpst, "_SETUP_CACHE", {})
    try:
        jinst, jvars, jinputs = jr1cs.Instance.produce_synthetic_r1cs(32, 32, 3, seed=11)
        jgens = jsnark.TestudoNizkGens.setup(32, 32, 3)
        jtp = jtr.PoseidonTranscript(jtr.fr_params())
        jproof = jsnark.nizk_prove(jinst, jvars, jinputs, jgens, jtp)
        run.update(jinst=jinst, jinputs=jinputs, jgens=jgens, jproof=jproof,
                   jblob=jproofs.ser_r1cs_proof(jproof.r1cs_sat_proof),
                   jprover_state=list(jtp.sponge.state))
        jtv = jtr.PoseidonTranscript(jtr.fr_params())
        run["jok"] = jsnark.nizk_verify(jproof, jgens, jinst, jinputs, jtv)
        run["jverifier_state"] = list(jtv.sponge.state)
        yield run
    finally:
        jprof.bls12_377.cache_clear()
        mp.undo()


def test_golden_proof_bytes_equal_the_fixture(golden, fix):
    blob = golden["blob"]
    assert len(blob) == 5192
    assert hashlib.sha256(blob).hexdigest() == fix["sat_proof_sha256"]
    assert blob.hex() == fix["sat_proof_hex"]
    assert [hex(v) for v in golden["prover_state"]] == fix["prover_final_sponge_state"]
    assert golden["launches"] == 0  # CPU tensors take the plain versions


def test_golden_proof_bytes_equal_the_fixture_looped(fix):
    p = fix["params"]
    run = _prove(p["num_cons"], p["num_vars"], p["num_inputs"], p["seed"], fused=False)
    assert run["blob"].hex() == fix["sat_proof_hex"]
    assert [hex(v) for v in run["prover_state"]] == fix["prover_final_sponge_state"]
    ok, state = _verify(run)
    assert ok is True and [hex(v) for v in state] == fix["verifier_final_sponge_state"]


def test_golden_proof_verifies_to_the_fixture_state(golden, fix):
    ok, state = _verify(golden)
    assert ok is True
    assert [hex(v) for v in state] == fix["verifier_final_sponge_state"]


def test_proof_bytes_equal_reference(both):
    assert both["blob"] == both["jblob"]
    assert both["proof"].r == tuple(both["jproof"].r)
    assert both["prover_state"] == both["jprover_state"]
    ok, state = _verify(both)
    assert ok is True and both["jok"] is True
    assert state == both["jverifier_state"]


def test_each_verifier_accepts_the_other_packages_proof(both):
    # the port's proof, carried across, in the JAX package's verifier
    sat = convert.r1cs_proof_to_reference(both["proof"].r1cs_sat_proof, jhf, jrp.R1CSProof,
                                          jsc.SumcheckInstanceProof, JUniPoly, jmipp.MippProof)
    assert jproofs.ser_r1cs_proof(sat) == both["blob"]
    jtv = jtr.PoseidonTranscript(jtr.fr_params())
    assert jsnark.nizk_verify(jsnark.TestudoNizk(sat, both["proof"].r), both["jgens"],
                              both["jinst"], both["jinputs"], jtv) is True
    # the JAX package's proof, and its instance, in the port's verifier
    jsat = both["jproof"].r1cs_sat_proof
    sat = convert.r1cs_proof_from_reference(jsat)
    assert proofs.ser_r1cs_proof(sat) == both["jblob"]
    inst = convert.r1cs_instance_from_reference(both["jinst"])
    assert inst.digest == both["inst"].digest
    ok, _ = _verify(both, proof=snark.TestudoNizk(sat, both["jproof"].r), inst=inst,
                    inputs=r1cs.Assignment(list(both["jinputs"].assignment)))
    assert ok is True


def test_codecs_round_trip(both):
    blob = both["blob"]
    back = proofs.parse_r1cs_proof(blob)
    assert proofs.ser_r1cs_proof(back) == blob
    ok, _ = _verify(both, proof=snark.TestudoNizk(back, (back.rx, back.ry)))
    assert ok is True
    assert proofs.ser_r1cs_proof(jproofs.parse_r1cs_proof(blob)) == blob
    with pytest.raises(ser.DeserializeError):
        proofs.parse_r1cs_proof(blob + b"\x00")
    with pytest.raises(ser.DeserializeError):
        proofs.parse_r1cs_proof(blob[:-1])
    poly = both["proof"].r1cs_sat_proof.sc_proof_phase1.polys[0]
    assert proofs.de_unipoly(ser.Reader(proofs.ser_unipoly(poly))).coeffs == poly.coeffs


def _corrupt(proof, **changes):
    sat = proofs.parse_r1cs_proof(proofs.ser_r1cs_proof(proof.r1cs_sat_proof))
    for k, v in changes.items():
        setattr(sat, k, v(getattr(sat, k)))
    return snark.TestudoNizk(sat, (sat.rx, sat.ry))


def test_verifier_rejects_corrupted_proofs(both):
    proof = both["proof"]
    sat = proof.r1cs_sat_proof
    assert _verify(both, proof=_corrupt(proof, eval_vars_at_ry=lambda v: (v + 1) % R))[0] is False
    bad_inputs = r1cs.Assignment([(both["inputs"].assignment[0] + 1) % R]
                                 + both["inputs"].assignment[1:])
    assert _verify(both, inputs=bad_inputs)[0] is False
    assert _verify(both, proof=_corrupt(
        proof, claims_phase2=lambda c: (c[0], c[1], (c[2] + 1) % R, c[3])))[0] is False

    def bump_coeff(sc):
        sc.polys[2].coeffs[1] = (sc.polys[2].coeffs[1] + 1) % R
        return sc

    assert _verify(both, proof=_corrupt(proof, sc_proof_phase2=bump_coeff))[0] is False
    assert _verify(both, proof=_corrupt(proof, initial_state=lambda s: (s + 1) % R))[0] is False
    # the honest proof still verifies after the corrupted copies
    assert _verify(both)[0] is True and sat.eval_vars_at_ry == both["proof"].r1cs_sat_proof.eval_vars_at_ry


def test_groth16_is_not_ported_yet():
    """Since the Groth16 half is ported, `with_groth16=True` builds the
    verifier circuit's keys (`gens_gc`), which the NIZK prover never uses,
    as in the reference; the sqrt-PST key is the one without them."""
    gens = snark.TestudoNizkGens.setup(16, 16, 2, with_groth16=True, profile=_profile())
    assert gens.gens_gc is not None and gens.gens_gc.pk.num_pub == 2 + 2 + 4 + 5 + 5
    plain = snark.TestudoNizkGens.setup(16, 16, 2, profile=_profile())
    assert plain.gens_gc is None and plain.gens_r1cs_sat == gens.gens_r1cs_sat
