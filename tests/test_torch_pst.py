"""The port's PST commitment (testudo_tpu_torch/core/pst.py) against the JAX
package's core/pst.py: the same keys as affine points, the same commitments
and openings for the same table, accepting and rejecting checks, G1 and G2
sides.  The port runs with its device backends on the CPU (the kernels' plain
versions), the JAX package with its host group backends, so no JAX curve
graph is compiled.  Points are compared as affine host points: exact."""
import numpy as np
import pytest
import torch

from testudo_tpu.core import pst as jpst
from testudo_tpu.curves import profile as jprof
from testudo_tpu.fields import host as jhf
from testudo_tpu.poly import dense as jd
from testudo_tpu_torch import convert
from testudo_tpu_torch.core import pst
from testudo_tpu_torch.curves import profile as cprof
from testudo_tpu_torch.fields.bls12_377 import R
from testudo_tpu_torch.poly import dense

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

NV = 3
RNG = np.random.default_rng(121)
Z = [0, 1, R - 1] + [int.from_bytes(RNG.bytes(40), "little") % R for _ in range((1 << NV) - 3)]
POINT = [int.from_bytes(RNG.bytes(40), "little") % R for _ in range(NV)]


def _to_ref(pt):
    return convert.host_point_to_reference(pt, jhf)


@pytest.fixture(scope="module")
def world():
    """Keys, tables and the evaluation in both packages, made once."""
    mp = pytest.MonkeyPatch()
    mp.setenv("TESTUDO_HOST_CURVE", "1")  # read when the profile is first built
    jprof.bls12_377.cache_clear()
    jpf = jprof.bls12_377()
    mp.setattr(jpst, "_SETUP_CACHE", {})
    pf = cprof.bls12_377("cpu")
    try:
        ck, vk = pst.setup(NV, profile=pf)
        jck, jvk = jpst.setup(NV, profile=jpf)
        table, jtable = dense.encode_table(Z, device="cpu"), jd.encode_table(Z)
        value = dense.evaluate(table, POINT)
        assert value == jd.evaluate(jtable, POINT)
        yield dict(pf=pf, jpf=jpf, ck=ck, vk=vk, jck=jck, jvk=jvk, table=table, jtable=jtable,
                   value=value)
    finally:
        jprof.bls12_377.cache_clear()
        mp.undo()


def test_setup_keys_equal_reference_as_affine_points(world):
    ck, vk, jck, jvk, pf = (world[k] for k in ("ck", "vk", "jck", "jvk", "pf"))
    assert ck.nv == jck.nv == NV and len(ck.powers_of_g) == NV + 1
    assert ck.g == jck.g and _to_ref(ck.h) == jck.h
    for lvl in range(NV + 1):
        assert pf.g1b.size(ck.powers_of_g[lvl]) == 1 << (NV - lvl)
        assert pf.g1b.to_affine(ck.powers_of_g[lvl]) == jck.powers_of_g[lvl]
        assert [_to_ref(p) for p in pf.g2b.to_affine(ck.powers_of_h[lvl])] == jck.powers_of_h[lvl]
    assert vk.g_mask == jvk.g_mask and [_to_ref(p) for p in vk.h_mask] == jvk.h_mask
    assert pst.setup(NV, profile=pf)[0] is ck  # memoised


def test_ark_draws_and_seeded_setup_scalars_match_reference():
    g, h, ts = pst.ark_setup_draws(NV)
    jg, jh, jts = jpst.ark_setup_draws(NV)
    assert g == jg and _to_ref(h) == jh and ts == jts
    assert pst._seed_scalars(b"seed", 5, R) == jpst._seed_scalars(b"seed", 5, R)


def test_to_canon_scalars_matches_reference(world):
    got = pst._to_canon_scalars(world["table"])
    want = np.asarray(jpst._to_canon_scalars(world["jtable"])).astype(np.int32)
    assert np.array_equal(got.numpy(), want)
    assert pf_decode(got) == Z


def pf_decode(canon):
    from testudo_tpu_torch.device.field import FR

    return FR.from_limbs(canon)


def test_commit_open_check_g1(world):
    ck, vk, jck, jvk = (world[k] for k in ("ck", "vk", "jck", "jvk"))
    com = pst.commit(ck, world["table"])
    assert com == jpst.commit(jck, world["jtable"])
    proof = pst.open_(ck, world["table"], POINT)
    assert proof == jpst.open_(jck, world["jtable"], POINT) and len(proof) == NV
    v = world["value"]
    assert pst.check(vk, com, POINT, v, proof) is True
    assert pst.check(vk, com, POINT, (v + 1) % R, proof) is False
    assert pst.check(vk, com, POINT, v, proof[::-1]) is False
    assert pst.check(vk, com, POINT, v, proof[:-1]) is False
    # each package's verifier accepts the other's opening
    assert jpst.check(jvk, com, POINT, v, proof) is True
    # a key carried across commits to the same point
    ck2 = convert.committer_key_from_reference(jck, world["pf"])
    assert pst.commit(ck2, world["table"]) == com
    vk2 = convert.verifier_key_from_reference(jvk, world["pf"])
    assert pst.check(vk2, com, POINT, v, proof) is True


def test_commit_open_check_g2(world):
    ck, vk, jck, jvk = (world[k] for k in ("ck", "vk", "jck", "jvk"))
    com = pst.commit_g2(ck, world["table"])
    assert _to_ref(com) == jpst.commit_g2(jck, world["jtable"])
    proof = pst.open_g2(ck, world["table"], POINT)
    assert [_to_ref(p) for p in proof] == jpst.open_g2(jck, world["jtable"], POINT)
    v = world["value"]
    assert pst.check_g2(vk, com, POINT, v, proof) is True
    assert pst.check_g2(vk, com, POINT, (v + 1) % R, proof) is False
    assert pst.check_g2(vk, com, POINT, v, proof[:-1]) is False
    assert jpst.check_g2(jvk, _to_ref(com), POINT, v, [_to_ref(p) for p in proof]) is True


def test_trim_commits_a_shorter_table_with_the_suffix_levels(world):
    ck, vk = world["ck"], world["vk"]
    short = Z[:4]
    t = dense.encode_table(short, device="cpu")
    pt = POINT[:2]
    com = pst.commit(ck, t)  # level = ck.nv - 2
    ck2, vk2 = ck.trim(2), vk.trim(2)
    assert ck2.nv == 2 and len(ck2.powers_of_g) == 3 and vk2.g_mask == vk.g_mask[1:]
    assert pst.commit(ck2, t) == com
    proof = pst.open_(ck2, t, pt)
    assert pst.check(vk, com, pt, dense.evaluate(t, pt), proof) is True
    with pytest.raises(ValueError):
        ck.trim(NV + 1)
    with pytest.raises(ValueError):
        pst.open_(ck, t, POINT)
