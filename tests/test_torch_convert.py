"""State carried across (testudo_tpu_torch/convert.py): the JAX package's G1
and G2 pytrees, packed batches and scalar limbs go into the port and back
exactly, and both packages decode them to the same host points."""
import numpy as np
import pytest
import torch

from testudo_tpu.curves import host_curve as jhc
from testudo_tpu.fields import host as jhf
from testudo_tpu.tpu import curve as jc
from testudo_tpu.tpu import pallas_curve as pcu
from testudo_tpu.tpu.field import FR as JFR
from testudo_tpu_torch import convert
from testudo_tpu_torch.device import curve as tc
from testudo_tpu_torch.device import msm as tmsm
from testudo_tpu_torch.curves import host_curve as hc
from testudo_tpu_torch.device.packed_curve import G1P, G2P
from testudo_tpu_torch.fields.bls12_377 import R

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

RNG = np.random.default_rng(61)
G = jhc.g1_generator()
PTS = [jhc.g1_mul(G, int(k)) for k in RNG.integers(1, 1 << 62, size=5)] + [None]


def test_points_round_trip_and_decode_alike():
    ref = jc.g1_from_affine_host(PTS)
    ref_np = tuple(np.asarray(c) for c in ref)
    got = convert.points_from_reference(ref_np, device="cpu")
    assert all(c.dtype == torch.int32 and c.shape == (6, 24) for c in got)
    assert tc.g1_to_affine_host(got) == PTS == jc.g1_to_affine_host(ref)
    back = convert.points_to_reference(got)
    for b, r in zip(back, ref_np):
        assert b.dtype == np.uint32 and np.array_equal(b, r)
    # a point made by the port reads the same in the JAX package
    own = tc.g1_add(got, got)
    assert jc.g1_to_affine_host(convert.points_to_reference(own)) == [
        jhc.g1_add(p, p) for p in PTS]


def test_packed_round_trip():
    ref = np.asarray(pcu.G1P.pack(jc.g1_from_affine_host(PTS)))
    got = convert.packed_from_reference(ref, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (72, 6)
    assert tc.g1_to_affine_host(G1P.unpack(got)) == PTS
    back = convert.packed_to_reference(got)
    assert back.dtype == np.uint32 and np.array_equal(back, ref)


def test_scalars_round_trip_and_drive_an_msm():
    vals = [0, 1, R - 1, 12345678901234567890, 7, 3]
    ref = JFR.to_limbs(vals)  # canonical uint32 limbs, as the JAX MSM takes them
    got = convert.scalars_from_reference(ref, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (6, 16)
    assert np.array_equal(convert.scalars_to_reference(got), ref)
    pts = convert.points_from_reference(
        tuple(np.asarray(c) for c in jc.g1_from_affine_host(PTS)), device="cpu")
    assert tmsm.msm_g1(pts, got, device="cpu") == jhc.g1_msm(PTS, vals)


@pytest.mark.parametrize("fault", ["range", "width", "dtype", "triple"])
def test_conversions_reject_what_is_not_limbs(fault):
    good = np.zeros((4, 24), dtype=np.uint32)
    if fault == "range":
        bad = good.copy()
        bad[1, 3] = 1 << 16
        with pytest.raises(ValueError):
            convert.points_from_reference((bad, good, good), device="cpu")
    elif fault == "width":
        with pytest.raises(ValueError):
            convert.scalars_from_reference(good, device="cpu")
    elif fault == "dtype":
        with pytest.raises(TypeError):
            convert.packed_from_reference(np.zeros((72, 2), dtype=np.float32), device="cpu")
    else:
        with pytest.raises(ValueError):
            convert.points_from_reference((good, good), device="cpu")


# -- G2: every coordinate a (c0, c1) pair, packed batches of 144 rows -----------------

G2 = jhc.g2_generator()
PTS2 = [jhc.g2_mul(G2, int(k)) for k in RNG.integers(1, 1 << 62, size=4)] + [None]


def _pt(p):
    return None if p is None else ((p[0].c0, p[0].c1), (p[1].c0, p[1].c1))


def test_g2_points_round_trip_and_decode_alike():
    ref = jc.g2_from_affine_host(PTS2)
    ref_np = tuple(tuple(np.asarray(c) for c in coord) for coord in ref)
    got = convert.points_from_reference(ref_np, device="cpu")
    assert all(isinstance(coord, tuple) and len(coord) == 2 for coord in got)
    assert all(c.dtype == torch.int32 and c.shape == (5, 24) for coord in got for c in coord)
    assert [_pt(p) for p in tc.g2_to_affine_host(got)] == [_pt(p) for p in PTS2]
    back = convert.points_to_reference(got)
    for bcoord, rcoord in zip(back, ref_np):
        for b, r in zip(bcoord, rcoord):
            assert b.dtype == np.uint32 and np.array_equal(b, r)
    # a point made by the port reads the same in the JAX package
    own = tc.g2_add(got, got)
    assert [_pt(p) for p in jc.g2_to_affine_host(convert.points_to_reference(own))] == [
        _pt(jhc.g2_add(p, p)) for p in PTS2]


def test_g2_packed_round_trip_and_host_msm():
    ref = np.asarray(pcu.G2P.pack(jc.g2_from_affine_host(PTS2)))
    got = convert.packed_from_reference(ref, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (144, 5)
    assert [_pt(p) for p in tc.g2_to_affine_host(G2P.unpack(got))] == [_pt(p) for p in PTS2]
    back = convert.packed_to_reference(got)
    assert back.dtype == np.uint32 and np.array_equal(back, ref)
    vals = [3, 0, R - 1, 5, 9]
    want = jhc.g2_msm(PTS2, vals)
    port_pts = [None if p is None else (hc.Fq2(*_pt(p)[0]), hc.Fq2(*_pt(p)[1])) for p in PTS2]
    assert _pt(hc.g2_msm(port_pts, vals)) == _pt(want)
    assert isinstance(want[0], jhf.Fq2)


@pytest.mark.parametrize("fault", ["rows", "pair", "nested_width"])
def test_g2_conversions_reject_what_is_not_a_point_batch(fault):
    good = np.zeros((4, 24), dtype=np.uint32)
    with pytest.raises(ValueError):
        if fault == "rows":
            convert.packed_from_reference(np.zeros((100, 2), dtype=np.uint32), device="cpu")
        elif fault == "pair":
            convert.points_from_reference(((good, good, good), (good, good), (good, good)), device="cpu")
        else:
            convert.points_from_reference(((good, good[:, :16]),) * 3, device="cpu")


def test_fr_table_round_trip():
    from testudo_tpu.poly import dense as jd
    from testudo_tpu_torch.poly import dense as td

    vals = [0, 1, R - 1, 123456789]
    ref = np.asarray(jd.encode_table(vals))
    got = convert.fr_table_from_reference(ref, device="cpu")
    assert got.dtype == torch.int32 and torch.equal(got, td.encode_table(vals, device="cpu"))
    back = convert.fr_table_to_reference(got)
    assert back.dtype == np.uint32 and np.array_equal(back, ref)
    with pytest.raises(ValueError):
        convert.fr_table_from_reference(ref[:, :8], device="cpu")


def test_committer_key_from_limb_pytrees_and_host_points():
    """A key whose levels are the reference's device pytrees (as numpy) or
    host point lists converts to the same affine points."""
    from types import SimpleNamespace

    from testudo_tpu_torch.curves import profile as cprof

    pf = cprof.bls12_377("cpu")
    g2pts = [jhc.g2_mul(jhc.g2_generator(), k) for k in (3, 5)] + [None]
    g1pts = PTS[:3]
    tree1 = tuple(np.asarray(c) for c in jc.g1_from_affine_host(g1pts))
    tree2 = tuple(tuple(np.asarray(c) for c in coord) for coord in jc.g2_from_affine_host(g2pts))
    ref = SimpleNamespace(nv=1, powers_of_g=[tree1, list(g1pts[:1])],
                          powers_of_h=[tree2, list(g2pts[:1])], g=G, h=jhc.g2_generator())
    ck = convert.committer_key_from_reference(ref, pf)
    assert ck.nv == 1 and ck.profile is pf and ck.g == G
    assert pf.g1b.to_affine(ck.powers_of_g[0]) == g1pts
    assert pf.g1b.to_affine(ck.powers_of_g[1]) == g1pts[:1]
    want2 = [convert.host_point_from_reference(p) for p in g2pts]
    assert pf.g2b.to_affine(ck.powers_of_h[0]) == want2
    assert pf.g2b.to_affine(ck.powers_of_h[1]) == want2[:1]
    assert ck.h == hc.g2_generator() and type(ck.h[0]).__module__.startswith("testudo_tpu_torch")
    host_pf = cprof.bls12_377("cpu", host_groups=True)
    with pytest.raises(TypeError):  # a limb pytree needs the device backend
        convert.committer_key_from_reference(ref, host_pf)
    back = convert.host_point_to_reference(ck.h, jhf)
    assert back == jhc.g2_generator()
