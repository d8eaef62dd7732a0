"""The in-circuit sqrt-PST opening verifier (core/circuit_verifier.py) against
the JAX package's: on the same inputs both build EQUAL constraint systems,
constraint for constraint (the same linear-combination dicts, in the same
order) and value for value.  The gadgets of tests/test_circuit_verifier.py:86-117
(nonnative Fr arithmetic, the residue-witness pairing check) run fast; the
whole TestudoCommVerifier on one opening, made on the port and carried across
to the JAX package's classes, is slow-marked."""
import random

import pytest

from testudo_tpu.core import circuit_verifier as jcv
from testudo_tpu.curves import host_curve as jhc
from testudo_tpu.curves import pairing as jpr
from testudo_tpu.fields import host as jhf
from testudo_tpu_torch import convert
from testudo_tpu_torch.core import circuit_verifier as cv
from testudo_tpu_torch.curves import host_curve as hc
from testudo_tpu_torch.curves import pairing as pr
from testudo_tpu_torch.fields.bls12_377 import P, R


def _assert_equal_systems(cs, jcs):
    assert cs.modulus == jcs.modulus == P
    assert cs.num_pub == jcs.num_pub
    assert len(cs.constraints) == len(jcs.constraints)
    for k, (mine, theirs) in enumerate(zip(cs.constraints, jcs.constraints)):
        assert tuple(mine) == tuple(theirs), k
    assert cs.values == jcs.values


def test_nonnative_fr_gadgets_equal_the_jax_package():
    rng = random.Random(41)
    a_val, b_val = rng.randrange(R), rng.randrange(R)
    systems = []
    for mod in (cv, jcv):
        cs = mod.ConstraintSystem(modulus=P)
        a, b = mod.fr_alloc(cs, a_val), mod.fr_alloc(cs, b_val)
        prod = mod.fr_mul(cs, a, b)
        inv = mod.fr_inverse(cs, a)
        lin = mod.fr_lincomb(cs, 7, [(3, a), (R - 1, b)])
        assert (prod.value, inv.value) == (a_val * b_val % R, pow(a_val, -1, R))
        assert lin.value == (7 + 3 * a_val - b_val) % R
        assert cs.is_satisfied()
        systems.append(cs)
    _assert_equal_systems(*systems)
    # a wrong product does not satisfy the port's system
    cs = cv.ConstraintSystem(modulus=P)
    a, b = cv.fr_alloc(cs, a_val), cv.fr_alloc(cs, b_val)
    prod = cv.fr_mul(cs, a, b)
    assert cs.is_satisfied()
    cs.values[next(iter(prod.bits[3].lc))] ^= 1  # one bit of the product flipped
    assert not cs.is_satisfied()


def test_residue_witness_pairing_check_equals_the_jax_package():
    rng = random.Random(42)
    k1, k2 = rng.randrange(1, R), rng.randrange(1, R)
    p1 = hc.g1_mul(hc.g1_generator(), k1)
    q1 = hc.g2_mul(hc.g2_generator(), k2)
    e = pr.pairing(p1, q1)
    assert convert.fq12_to_reference(e, jhf) == jpr.pairing(p1, convert.host_point_to_reference(
        q1, jhf))
    systems = []
    for mod, pt, qt, et in ((cv, p1, q1, e),
                            (jcv, p1, convert.host_point_to_reference(q1, jhf),
                             convert.fq12_to_reference(e, jhf))):
        cs = mod.ConstraintSystem(modulus=P)
        mod.enforce_pairing_product(
            cs, [(mod.G1Var.alloc(cs, pt), mod.G2Var.alloc(cs, qt))], rhs=mod.Fq12Var.alloc(cs, et))
        assert cs.is_satisfied()
        systems.append(cs)
    _assert_equal_systems(*systems)
    # the == 1 form: e(P, Q) e(-P, Q) == 1
    systems = []
    for mod, curve, qt in ((cv, hc, q1), (jcv, jhc, convert.host_point_to_reference(q1, jhf))):
        cs = mod.ConstraintSystem(modulus=P)
        mod.enforce_pairing_product(
            cs, [(mod.G1Var.alloc(cs, p1), mod.G2Var.alloc(cs, qt)),
                 (mod.G1Var.alloc(cs, curve.g1_neg(p1)), mod.G2Var.alloc(cs, qt))], rhs=None)
        assert cs.is_satisfied()
        systems.append(cs)
    _assert_equal_systems(*systems)


def test_transcript_gadget_challenges_equal_the_jax_package():
    """The in-circuit Fq transcript: absorb a G1 point and a GT element,
    squeeze an Fr challenge; equal systems, and the challenge equals the
    host transcript's."""
    from testudo_tpu_torch.poseidon.transcript import PoseidonTranscript, fq_params

    rng = random.Random(43)
    pt = hc.g1_mul(hc.g1_generator(), rng.randrange(1, R))
    gt = pr.pairing(pt, hc.g2_generator())
    systems, chals = [], []
    for mod, g, t in ((cv, pt, gt), (jcv, pt, convert.fq12_to_reference(gt, jhf))):
        cs = mod.ConstraintSystem(modulus=P)
        tr = mod.TranscriptFqGadget(cs)
        tr.append_g1_uncompressed(mod.G1Var.alloc(cs, g))
        tr.append_gt_uncompressed(mod.Fq12Var.alloc(cs, t))
        chals.append(tr.challenge_fr().value)
        assert cs.is_satisfied()
        systems.append(cs)
    _assert_equal_systems(*systems)
    host = PoseidonTranscript(fq_params())
    host.append_g1_uncompressed(pt)
    host.append_gt_uncompressed(gt)
    assert chals[0] == chals[1] == host.challenge_fr()


@pytest.mark.slow
def test_comm_verifier_on_one_opening_equals_the_jax_package():
    """A sqrt-PST opening at nv = 4 made on the port (host groups), carried
    across to the JAX package's classes: both TestudoCommVerifier systems are
    satisfied and equal; v + 1 is not satisfied."""
    from testudo_tpu.core import mipp as jmipp
    from testudo_tpu.core import pst as jpst
    from testudo_tpu_torch.core import pst, sqrt_pst
    from testudo_tpu_torch.curves import profile as cprof
    from testudo_tpu_torch.poly import dense
    from testudo_tpu_torch.poseidon.transcript import PoseidonTranscript, fq_params

    rng = random.Random(44)
    nv, dev = 4, "cpu"
    pf = cprof.bls12_377(dev, host_groups=True)
    ck, vk = pst.setup(nv // 2, profile=pf)
    Z = [rng.randrange(R) for _ in range(1 << nv)]
    point = [rng.randrange(R) for _ in range(nv)]
    pl = sqrt_pst.Polynomial.from_evaluations(dense.encode_table(Z, device=dev), pf)
    v = pl.eval(point)
    comm, T = pl.commit(ck)
    U, pst_proof, mipp_proof = pl.open(PoseidonTranscript(fq_params()), comm, ck, point, T)
    assert sqrt_pst.verify(PoseidonTranscript(fq_params()), vk, U, point, v, pst_proof,
                           mipp_proof, T)
    cs = cv.build_comm_verifier(vk, U, point, v, pst_proof, mipp_proof, T)
    assert cs.is_satisfied()

    ref = lambda p: convert.host_point_to_reference(p, jhf)
    jvk = jpst.VerifierKey(vk.nv, ref(vk.g), ref(vk.h), [ref(p) for p in vk.g_mask],
                           [ref(p) for p in vk.h_mask], profile=object())
    jproof = convert.mipp_proof_to_reference(mipp_proof, jhf, jmipp.MippProof)
    jcs = jcv.build_comm_verifier(jvk, ref(U), point, v, [ref(p) for p in pst_proof], jproof,
                                  convert.fq12_to_reference(T, jhf))
    assert jcs.is_satisfied()
    _assert_equal_systems(cs, jcs)
    assert not cv.build_comm_verifier(vk, U, point, (v + 1) % R, pst_proof, mipp_proof,
                                      T).is_satisfied()
