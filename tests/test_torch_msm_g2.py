"""The G2 side of the port's MSM (testudo_tpu_torch/device/msm.py): `msm_g2`
on the CPU against the host oracle the JAX package's own MSM tests use, and
the stage functions that differ between the groups (`_with_neg_y_table`,
`_cat_points`, `_pad_to`) against testudo_tpu.tpu.msm.  One slow-marked test
runs the JAX packed G2 MSM itself (Pallas interpret mode: a long CPU compile)
and compares segment, bucket and window sums limb for limb.  Integers: exact
equality."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from testudo_tpu.curves import host_curve as jhc
from testudo_tpu.fields import host as jhf
from testudo_tpu.tpu import curve as jc
from testudo_tpu.tpu import msm as jmsm
from testudo_tpu.tpu import pallas_curve as pcu
from testudo_tpu_torch.curves import host_curve as hc
from testudo_tpu_torch.device import curve as tc
from testudo_tpu_torch.device import msm as tmsm
from testudo_tpu_torch.device.field import FR
from testudo_tpu_torch.device.packed_curve import G1P, G2P
from testudo_tpu_torch.fields.bls12_377 import R

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

RNG = np.random.default_rng(53)
_PRNG = __import__("random").Random(53)


def _rand_fr():
    return _PRNG.randrange(R)


def _rand_g2(n):
    G = hc.g2_generator()
    return [hc.g2_mul(G, int(k)) for k in RNG.integers(1, 1 << 62, size=n)]


def _to_ref(p):
    return None if p is None else (jhf.Fq2(p[0].c0, p[0].c1), jhf.Fq2(p[1].c0, p[1].c1))


def _pt(p):
    return None if p is None else ((p[0].c0, p[0].c1), (p[1].c0, p[1].c1))


def _oracle(pts_h, scalars):
    """The JAX package's host MSM, as a plain tuple; the port's own host MSM
    must agree with it."""
    want = _pt(jhc.g2_msm([_to_ref(p) for p in pts_h], scalars))
    assert _pt(hc.g2_msm(pts_h, scalars)) == want
    return want


def _scal_np(vals):
    return FR.to_limbs([v % R for v in vals])


def _same(t, j):
    return np.array_equal(t.cpu().numpy(), np.asarray(j).astype(np.int64))


# -- stages that differ between the groups ---------------------------------------------


def test_with_neg_y_table_ncomp2_matches_reference():
    pts = _rand_g2(5) + [None]  # the identity row has y = (mont(1), 0)
    ptcat = G2P.pack(tc.g2_from_affine_host(pts, device="cpu")).T.contiguous()
    ptcat[4, 48:72] = 0  # y.c0 = 0 stays 0 while y.c1 of the same point is negated
    ptcat[3, 72:96] = 0  # and the other way round
    before = ptcat.clone()
    got = tmsm._with_neg_y_table(ptcat, 2)
    ref = jmsm._with_neg_y_table(jnp.asarray(ptcat.numpy().astype(np.uint32)), 24, 2)
    assert got.shape == (12, 144) and _same(got, ref)
    assert torch.equal(ptcat, before) and torch.equal(got[:6], before)
    assert int(got[6 + 4, 48:72].abs().sum()) == 0 and int(got[6 + 3, 72:96].abs().sum()) == 0
    neg = tc.g2_to_affine_host(G2P.unpack(got[6:9].T.contiguous()))
    assert neg == [hc.g2_neg(p) for p in pts[:3]]
    assert tc.g2_to_affine_host(G2P.unpack(got[11:12].T.contiguous())) == [None]


def test_cat_points_and_pad_for_nested_coordinates():
    pts_h = _rand_g2(5)
    pts = tc.g2_from_affine_host(pts_h, device="cpu")
    ref = jmsm._cat_points("g2", jc.g2_from_affine_host([_to_ref(p) for p in pts_h]))
    cat = tmsm._cat_points(pts)
    assert cat.shape == (5, 144) and _same(cat, ref)
    assert torch.equal(cat, G2P.pack(pts).T)
    scal = torch.from_numpy(_scal_np([1, 2, 3, 4, 5]))
    p2, s2 = tmsm._pad_pow2(pts, scal)
    assert s2.shape == (8, 16)
    for coord in p2:
        assert isinstance(coord, tuple) and len(coord) == 2
        assert all(c.shape == (8, 24) and int(c[5:].abs().sum()) == 0 for c in coord)
    p3, s3 = tmsm._pad_to(pts, scal, 5)
    assert s3 is scal and p3 is pts
    sliced = tmsm._map_coords(lambda c: c[1:3], pts)
    assert tc.g2_to_affine_host(sliced) == pts_h[1:3]


def test_weighted_sum_and_horner_against_host():
    """sum_j (j+1) B_j per window, then sum_w 2^(c w) S_w, on small buckets
    with an identity among them."""
    W, c = 2, 2  # 4 buckets per window
    pts = _rand_g2(W * 4)
    pts[5] = None
    buckets = G2P.pack(tc.g2_from_affine_host(pts, device="cpu"))
    wins = tmsm._weighted_sum_packed(G2P, buckets, W, c, plus_one=True)
    want = []
    for w in range(W):
        acc = None
        for j in range(4):
            acc = hc.g2_add(acc, hc.g2_mul(pts[w * 4 + j], j + 1))
        want.append(acc)
    assert tc.g2_to_affine_host(G2P.unpack(wins)) == want
    out = tmsm._horner_ladder_packed(G2P, wins, 3)
    assert tc.g2_to_affine_host(G2P.unpack(out)) == [hc.g2_add(want[0], hc.g2_mul(want[1], 8))]


# -- the slice as a whole -----------------------------------------------------------------


def test_msm_g2_small_path_defaults_vs_host():
    """n <= 64: one ladder launch and a tree; every argument but the device
    at its default (signed windows of 13 bits play no part here)."""
    n = 5
    pts_h = _rand_g2(n)
    scalars = [0, R - 1] + [_rand_fr() for _ in range(n - 2)]
    got = tmsm.msm_g2(tc.g2_from_affine_host(pts_h, device="cpu"), scalars, device="cpu")
    assert _pt(got) == _oracle(pts_h, scalars)


def test_msm_g2_signed_affine_vs_host():
    n = 66  # > 64: the full signed Pippenger, padded to 128; mixed adds
    pts_h = _rand_g2(n)
    scalars = [0, 1, R - 1, 2] + [_rand_fr() for _ in range(n - 4)]
    dev = tc.g2_from_affine_host(pts_h, device="cpu")
    got = tmsm.msm_g2(dev, scalars, affine=True, signed_c=4, device="cpu")
    assert _pt(got) == _oracle(pts_h, scalars)


def test_msm_g2_signed_projective_with_identity_rows_vs_host():
    """affine=False: general adds; the bases are projective (Z != 1) with
    identity rows among them, as a fixed-base table with zero scalars is."""
    n = 65
    pts_h = _rand_g2(n)
    pts_h[3] = pts_h[40] = None
    dev = tc.g2_from_affine_host(pts_h, device="cpu")
    dev = tc.g2_add(dev, tc.g2_identity((n,), device="cpu"))  # same points, Z != mont(1)
    assert not torch.equal(dev[2][0][0], tc.g2_from_affine_host(pts_h[:1], device="cpu")[2][0][0])
    scalars = [_rand_fr() for _ in range(n)]
    got = tmsm.msm_g2(dev, scalars, signed_c=5, device="cpu")
    assert _pt(got) == _oracle(pts_h, scalars)


def test_msm_g2_unsigned_vs_host_and_limb_scalars():
    """An explicit unsigned c, scalars given as limbs, mixed adds."""
    n = 70
    pts_h = _rand_g2(n)
    scalars = [_rand_fr() for _ in range(n)]
    dev = tc.g2_from_affine_host(pts_h, device="cpu")
    limbs = torch.from_numpy(_scal_np(scalars))
    got = _pt(tmsm.msm_g2(dev, limbs, c=4, affine=True, device="cpu"))
    assert got == _oracle(pts_h, scalars)
    scalars[7] ^= 1  # the oracle tells one flipped scalar apart
    assert got != _oracle(pts_h, scalars)


def test_msm_g1_and_g2_share_one_body_and_check_arguments():
    assert tmsm.msm_g1.__code__.co_names.count("_msm_entry") == 1
    assert tmsm.msm_g2.__code__.co_names.count("_msm_entry") == 1
    dev = tc.g2_from_affine_host(_rand_g2(2), device="cpu")
    with pytest.raises(ValueError, match="msm_g2"):
        tmsm.msm_g2(dev, [1, 2, 3], device="cpu")
    G = hc.g1_generator()
    dev1 = tc.g1_from_affine_host([G, G], device="cpu")
    with pytest.raises(ValueError, match="msm_g1"):
        tmsm.msm_g1(dev1, [1], device="cpu")
    assert tmsm.msm_g1(dev1, [1, 2], device="cpu") == hc.g1_mul(G, 3)
    with pytest.raises(ValueError):
        tmsm._group("g3")
    assert tmsm._group("g1")[0] is G1P and tmsm._group("g2")[0] is G2P


# -- against the JAX packed G2 MSM itself (slow: Pallas interpret mode) ---------------------


@pytest.mark.slow
def test_msm_g2_packed_stages_equal_reference_packed_msm(monkeypatch):
    """Runs testudo_tpu's packed signed G2 MSM (c = 4, n = 66 padded to 128,
    affine) stage by stage through its Pallas kernels in interpret mode and
    holds the port's segment sums, bucket sums and window sums against it limb
    for limb, and the final affine result.  Slow: every EC kernel costs
    minutes of CPU compile in interpret mode, and at ncomp = 2 the compile
    needs tens of GiB of memory (48 GiB resident after 25 minutes on a
    64 GiB host): run it alone on a machine that has them."""
    monkeypatch.setenv("TESTUDO_PACKED", "1")
    monkeypatch.setenv("TESTUDO_MSM_C", "4")
    c, n = 4, 66
    pts_h = _rand_g2(n)
    scalars = [0, 1, R - 1, 2] + [_rand_fr() for _ in range(n - 4)]
    limbs = _scal_np(scalars)

    # port
    tp, ts = tmsm._pad_pow2(tc.g2_from_affine_host(pts_h, device="cpu"), torch.from_numpy(limbs))
    ptcat = tmsm._cat_points(tp)
    N = ptcat.shape[0]
    order, sgn, starts, counts = tmsm._digit_counts_signed(ts, c)
    table = tmsm._with_neg_y_table(ptcat, 2)
    order_flat = (order + sgn * N).reshape(-1).contiguous()
    W, B = counts.shape
    T_cap = tmsm._pick_t_cap(counts.numpy(), W, B)
    wnd, seg_start, seg_count, lane_off, nseg, L = tmsm._plan_segments(
        starts.numpy(), counts.numpy(), T_cap)
    S_cap = 1 << (max(1, int(nseg.max())) - 1).bit_length()
    seg = tmsm._msm_seg_buckets(G2P, table, order_flat, wnd, seg_start, seg_count, N, True)
    buckets = tmsm._seg_reduce(G2P, seg, lane_off, nseg, S_cap)
    wins = tmsm._weighted_sum_packed(G2P, tmsm._drop_mag0(buckets, 144, W, B), W, c - 1, True)

    # reference, same stages (msm.py:791-849)
    jp, js = jmsm._pad_pow2(jc.g2_from_affine_host([_to_ref(p) for p in pts_h]),
                            jnp.asarray(limbs.astype(np.uint32)))
    jptcat = jmsm._cat_points("g2", jp)
    jorder, jsgn, jstarts, jcounts = jmsm._digit_counts_signed(js, c)
    jtable = jmsm._with_neg_y_table(jptcat, 24, 2)
    jflat = (jorder + jsgn * N).reshape(-1)
    L_pad, lc = jmsm._plan_lanes(T_cap, 144, L, S_cap)
    pad = L_pad - L
    jseg = jmsm._msm_seg_buckets(
        "g2", jtable, jflat, jnp.asarray(np.pad(wnd, (0, pad))),
        jnp.asarray(np.pad(seg_start, (0, pad))), jnp.asarray(np.pad(seg_count, (0, pad))),
        T_cap, lc, N, True)
    assert _same(seg, np.asarray(jseg)[:, :L])
    jbuckets = jmsm._seg_reduce("g2", jseg, (jnp.asarray(lane_off), jnp.asarray(nseg)), S_cap)
    assert _same(buckets, jbuckets)
    jwins = jmsm._weighted_sum_packed_jit(
        "g2", jmsm._drop_mag0(jbuckets, 144, W, B), W, c - 1, True)
    assert _same(wins, jwins)
    jout = jc.g2_to_affine_host(pcu.G2P.unpack(jmsm._horner_ladder_packed("g2", jwins, c)))[0]
    got = tmsm.msm_g2(tc.g2_from_affine_host(pts_h, device="cpu"), scalars, affine=True,
                      signed_c=c, device="cpu")
    assert _pt(got) == _pt(jout) == _oracle(pts_h, scalars)
