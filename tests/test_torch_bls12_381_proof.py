"""The R1CS proof and the PST commitment over the port's BLS12-381 profile.

Mirrors of tests/test_bls12_381_proof.py:21 and :52 (Testudo's
check_r1cs_proof_bls12_381, r1csproof.rs:754-801) on the port:
`curves.profile.bls12_381(device="cpu")` (host groups, Fr tables as CPU
limb tensors, the looped sumcheck) proves a 16 x 16 x 3 synthetic instance
that `verify_native` accepts and a corrupted evaluation fails, and PST
commit -> open -> check passes and rejects a wrong value.  The slow-marked
test holds the port's proof equal, field by field, to the JAX package's
under the same seed (the JAX side compiles its device field graphs on the
CPU for minutes, as its own 381 tests' slow mark says)."""
import dataclasses
import random

import pytest
import torch

from testudo_tpu_torch.core import pst, r1cs, r1csproof
from testudo_tpu_torch.curves import profile as cprof
from testudo_tpu_torch.device.field import FR381
from testudo_tpu_torch.poly import dense
from testudo_tpu_torch.poseidon.transcript import PoseidonTranscript, fr_params_381

torch.set_num_threads(1)

CPU = torch.device("cpu")
SHAPE = (16, 16, 3)  # constraints, variables, inputs
SEED = 3


@pytest.fixture(scope="module")
def proved():
    prof = cprof.bls12_381(CPU)
    inst, vars_, inputs = r1cs.R1CSInstance.produce_synthetic_r1cs(*SHAPE, seed=SEED,
                                                                   spec=prof.fr_spec)
    gens = r1csproof.R1CSGens.setup(SHAPE[1], profile=prof)
    proof, rx, ry = r1csproof.prove(inst, vars_, inputs, gens,
                                    PoseidonTranscript(fr_params_381()))
    return prof, inst, vars_, inputs, gens, proof, rx, ry


def test_profile_is_the_381_one():
    prof = cprof.bls12_381(CPU)
    assert prof is cprof.bls12_381("cpu")  # one per device
    assert prof.name == "bls12_381" and prof.fr_spec == FR381 and prof.device == CPU
    assert prof.fr_params is prof.fq_params is fr_params_381
    assert not prof.fused_sumcheck and cprof.bls12_377(CPU).fused_sumcheck
    assert isinstance(prof.g1b, cprof.HostGroupBackend)
    assert isinstance(prof.g2b, cprof.HostGroupBackend)
    g1, g2 = prof.g1_generator(), prof.g2_generator()
    assert len(prof.ser_g1_uncompressed(g1)) == 96 and len(prof.ser_g2_uncompressed(g2)) == 192
    assert len(prof.ser_gt(prof.fq12_one())) == 576


def test_check_r1cs_proof_bls12_381(proved):
    prof, inst, vars_, inputs, gens, proof, rx, ry = proved
    assert inst.is_sat(vars_, inputs)
    assert all(p.modulus == prof.R for p in proof.sc_proof_phase1.polys)
    inst_evals = inst.evaluate(rx, ry, CPU)
    nc, nv, _ = SHAPE
    assert r1csproof.verify_native(proof, inst_evals, nc, nv, inputs, gens,
                                   PoseidonTranscript(fr_params_381()))
    bad = dataclasses.replace(proof, eval_vars_at_ry=(proof.eval_vars_at_ry + 1) % prof.R)
    assert not r1csproof.verify_native(bad, inst_evals, nc, nv, inputs, gens,
                                       PoseidonTranscript(fr_params_381()))
    wrong_inputs = [(inputs[0] + 1) % prof.R] + inputs[1:]
    assert not r1csproof.verify_native(proof, inst_evals, nc, nv, wrong_inputs, gens,
                                       PoseidonTranscript(fr_params_381()))


def test_eval_and_claims_equal_python_ints(proved):
    """eval_vars_at_ry is the witness's multilinear extension at ry[1:], and
    the phase-two claims are (A z, B z, C z) folded at rx, all mod r381."""
    prof, inst, vars_, inputs, gens, proof, rx, ry = proved
    R = prof.R

    def mle(vals, point):
        for r in point:
            half = len(vals) // 2
            vals = [(vals[i] + r * (vals[half + i] - vals[i])) % R for i in range(half)]
        return vals[0]

    assert proof.eval_vars_at_ry == mle(list(vars_), ry[1:])
    z = inst.z_vector(vars_, inputs)
    for mat, claim in zip((inst.A, inst.B, inst.C), proof.claims_phase2[:3]):
        mz = [0] * inst.num_cons
        for r_, c_, v in zip(mat.rows.tolist(), mat.cols.tolist(), mat.vals):
            mz[r_] = (mz[r_] + v * z[c_]) % R
        assert claim == mle(mz, rx)
    assert proof.claims_phase2[3] == proof.claims_phase2[0] * proof.claims_phase2[1] % R


def test_fused_sumcheck_is_refused_over_381():
    """The fused provers exist over BLS12-377's Fr only: asked to fuse over
    fr381 they raise (the profile's proof takes the looped ones)."""
    from testudo_tpu_torch.core import sumcheck

    t = dense.encode_table(list(range(4)), FR381, CPU)
    tp = PoseidonTranscript(fr_params_381())
    with pytest.raises(ValueError, match="fused"):
        sumcheck.prove_quad(0, 2, t, t, tp, FR381, fused=True)
    with pytest.raises(ValueError, match="fused"):
        sumcheck.prove_cubic_with_additive_term(0, 2, t, t, t, t, tp, FR381, fused=True)
    proof, rs, _ = sumcheck.prove_quad(14, 2, t, t, tp, FR381, fused=False)
    assert len(rs) == 2 and proof.polys[0].modulus == FR381.modulus


def test_pst_roundtrip_bls12_381():
    """PST commit -> open -> check over the 381 profile (small)."""
    rng = random.Random(19)
    prof = cprof.bls12_381(CPU)
    ck, vk = pst.setup(3, seed=b"381-pst", profile=prof)
    evals = [rng.randrange(prof.R) for _ in range(8)]
    table = dense.encode_table(evals, prof.fr_spec, CPU)
    C = pst.commit(ck, table)
    point = [rng.randrange(prof.R) for _ in range(3)]
    proofs = pst.open_(ck, table, point)
    cur = evals
    for p in point:
        half = len(cur) // 2
        cur = [(cur[i] + p * (cur[half + i] - cur[i])) % prof.R for i in range(half)]
    v = cur[0]
    assert dense.evaluate(table, point, prof.fr_spec) == v
    assert pst.check(vk, C, point, v, proofs)
    assert not pst.check(vk, C, point, (v + 1) % prof.R, proofs)


@pytest.mark.slow
def test_proof_equals_the_jax_package():
    """Both packages prove the same 16 x 16 x 3 instance over BLS12-381 with
    the same seeded setup: equal keys, and an equal proof field by field
    (group elements as affine points, the GT element through `ser_gt`); each
    package's verifier accepts the other's proof."""
    from testudo_tpu.core import r1cs as jr1cs
    from testudo_tpu.core import r1csproof as jr1csproof
    from testudo_tpu.curves import profile as jprof
    from testudo_tpu.poseidon.transcript import PoseidonTranscript as JTranscript
    from testudo_tpu.poseidon.transcript import fr_params_381 as jfr_params_381
    from testudo_tpu_torch import convert

    jp = jprof.bls12_381()
    prof = cprof.bls12_381(CPU)
    jinst, jvars, jinputs = jr1cs.R1CSInstance.produce_synthetic_r1cs(*SHAPE, seed=SEED,
                                                                      spec=jp.fr_spec)
    jgens = jr1csproof.R1CSGens.setup(SHAPE[1], profile=jp)
    jproof, jrx, jry = jr1csproof.prove(jinst, jvars, jinputs, jgens,
                                        JTranscript(jfr_params_381()))

    inst = convert.r1cs_instance_from_reference(jinst)
    assert inst.A.spec == FR381
    gens = r1csproof.R1CSGens.setup(SHAPE[1], profile=prof)
    ck = convert.committer_key_from_reference(jgens.ck, prof)
    assert ck.powers_of_g == gens.ck.powers_of_g and ck.powers_of_h == gens.ck.powers_of_h
    vk = convert.verifier_key_from_reference(jgens.vk, prof)
    assert (vk.g_mask, vk.h_mask) == (gens.vk.g_mask, gens.vk.h_mask)
    proof, rx, ry = r1csproof.prove(inst, list(jvars), list(jinputs), gens,
                                    PoseidonTranscript(fr_params_381()))
    theirs = convert.r1cs_proof_from_reference(jproof, prof)
    assert (rx, ry) == (jrx, jry)
    assert prof.ser_gt(proof.t) == prof.ser_gt(theirs.t) == jp.ser_gt(jproof.t)
    for name in ("comm_U", "claims_phase2", "eval_vars_at_ry", "proof_eval_vars_at_ry", "rx",
                 "ry", "transcript_sat_state", "initial_state"):
        assert getattr(proof, name) == getattr(theirs, name), name
    for phase in ("sc_proof_phase1", "sc_proof_phase2"):
        ours, ref = getattr(proof, phase).polys, getattr(theirs, phase).polys
        assert [(p.coeffs, p.modulus) for p in ours] == [(p.coeffs, p.modulus) for p in ref]
    m, mt = proof.mipp_proof, theirs.mipp_proof
    assert [tuple(prof.ser_gt(x) for x in pair) for pair in m.comms_t] == \
        [tuple(prof.ser_gt(x) for x in pair) for pair in mt.comms_t]
    assert (m.comms_u, m.final_a, m.final_h, m.pst_proof_h) == \
        (mt.comms_u, mt.final_a, mt.final_h, mt.pst_proof_h)
    evals = inst.evaluate(rx, ry, CPU)
    assert evals == tuple(jinst.evaluate(jrx, jry))
    nc, nv, _ = SHAPE
    assert r1csproof.verify_native(theirs, evals, nc, nv, list(jinputs), gens,
                                   PoseidonTranscript(fr_params_381()))
    assert jr1csproof.verify_native(jproof, evals, nc, nv, jinputs, jgens,
                                    JTranscript(jfr_params_381()))
