"""The port's Poseidon sponge and transcript (testudo_tpu_torch/poseidon/)
against the JAX package's host originals: equal challenges after identical
absorbs, unequal ones after different absorbs, equal sponge states."""
import numpy as np
import pytest

from testudo_tpu.curves import host_curve as jhc
from testudo_tpu.poseidon import constants_377 as jconst
from testudo_tpu.poseidon import transcript as jtr
from testudo_tpu_torch.curves import host_curve as hc
from testudo_tpu_torch.curves import pairing as pr
from testudo_tpu_torch.fields.bls12_377 import P, R
from testudo_tpu_torch.poseidon import constants_377 as tconst
from testudo_tpu_torch.poseidon import transcript as ttr

RNG = np.random.default_rng(91)


def test_constants_are_the_same():
    for name in ("ARK", "MDS", "FULL_ROUNDS", "PARTIAL_ROUNDS", "ALPHA", "RATE", "CAPACITY"):
        assert getattr(tconst, name) == getattr(jconst, name), name


def _state(tr):
    return list(tr.sponge.state)


@pytest.mark.parametrize("params", ["fq_params", "fr_params"])
def test_identical_absorbs_give_identical_challenges(params):
    t, j = ttr.PoseidonTranscript(getattr(ttr, params)()), jtr.PoseidonTranscript(getattr(jtr, params)())
    assert t.params.modulus == j.params.modulus == (P if params == "fq_params" else R)
    g1 = hc.g1_mul(hc.g1_generator(), 12345)
    g2 = hc.g2_mul(hc.g2_generator(), 678)
    jg2 = jhc.g2_mul(jhc.g2_generator(), 678)
    gt = pr.pairing(g1, g2)
    from testudo_tpu.curves import pairing as jpr

    jgt = jpr.pairing(g1, jg2)
    blob = RNG.bytes(133)
    for tr, p2, e in ((t, g2, gt), (j, jg2, jgt)):
        tr.append_scalar(5, R)
        tr.append_scalar(R - 1, P)
        tr.append_scalar_vector([1, 2, 3], R)
        tr.append_serialized_scalar(77, R)
        tr.append_g1_uncompressed(g1)
        tr.append_g1_point(g1)
        tr.append_g1_point(None)
        tr.append_g2_uncompressed(p2)
        tr.append_g2_point(p2)
        tr.append_gt(e)
        tr.append_gt_uncompressed(e)
        tr.append_bytes(blob)
        tr.append_u64(1 << 40)
    assert _state(t) == _state(j)
    assert t.challenge_scalar(R) == j.challenge_scalar(R)
    assert t.challenge_scalar(P) == j.challenge_scalar(P)
    assert t.challenge_fr_vec(3) == j.challenge_fr_vec(3)
    t.new_from_state(9)
    j.new_from_state(9)
    assert t.challenge_fr() == j.challenge_fr()
    t.new_from_state2_scalar(11, R)
    j.new_from_state2_scalar(11, R)
    assert t.challenge_fr() == j.challenge_fr() and _state(t) == _state(j)


def test_different_absorbs_give_different_challenges():
    a, b = ttr.PoseidonTranscript(ttr.fq_params()), ttr.PoseidonTranscript(ttr.fq_params())
    a.append_bytes(b"left")
    b.append_bytes(b"right")
    ca, cb = a.challenge_scalar(R), b.challenge_scalar(R)
    assert ca != cb and 0 <= ca < R and 0 <= cb < R
    c = ttr.PoseidonTranscript(ttr.fq_params())
    c.append_bytes(b"left")
    assert c.challenge_scalar(R) == ca
    assert c.challenge_scalar(R) != ca  # squeezing advances the sponge
