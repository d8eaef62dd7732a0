"""The port's MSM (testudo_tpu_torch/device/msm.py) stage by stage against
testudo_tpu.tpu.msm, then the slice as a whole: `msm_g1` on the CPU against
the host oracle the JAX package's own MSM tests use.  One slow-marked test
runs the JAX packed MSM itself (Pallas interpret mode: minutes of CPU
compile) and compares window sums limb for limb.  Integers: exact equality."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from testudo_tpu.curves import host_curve as jhc
from testudo_tpu.tpu import curve as jc
from testudo_tpu.tpu import msm as jmsm
from testudo_tpu.tpu import pallas_curve as pcu
from testudo_tpu_torch.curves import host_curve as hc
from testudo_tpu_torch.device import curve as tc
from testudo_tpu_torch.device import msm as tmsm
from testudo_tpu_torch.device.field import FR
from testudo_tpu_torch.device.packed_curve import G1P
from testudo_tpu_torch.fields.bls12_377 import R

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

RNG = np.random.default_rng(51)
_PRNG = __import__("random").Random(51)


def _rand_fr():
    return _PRNG.randrange(R)


def _rand_g1(n):
    G = hc.g1_generator()
    return [hc.g1_mul(G, int(k)) for k in RNG.integers(1, 1 << 62, size=n)]


def _scal_np(vals):
    return FR.to_limbs([v % R for v in vals])


def _same(t, j):
    return np.array_equal(t.cpu().numpy(), np.asarray(j).astype(np.int64))


SCALARS = [0, 1, R - 1, 2, (1 << 252) - 1] + [_rand_fr() for _ in range(59)]


# -- stages ---------------------------------------------------------------------


@pytest.mark.parametrize("c", [4, 13])
def test_signed_digits_match_reference_and_reconstruct(c):
    limbs = _scal_np(SCALARS)
    got = tmsm._signed_digits(torch.from_numpy(limbs), c)
    ref = jmsm._signed_digits(jnp.asarray(limbs.astype(np.uint32)), c)
    assert _same(got, ref)
    digs = got.numpy()
    assert int(np.abs(digs).max()) <= 1 << (c - 1)
    for j, s in enumerate(SCALARS):
        assert sum(int(digs[w, j]) << (c * w) for w in range(digs.shape[0])) == s % R


@pytest.mark.parametrize("c", [4, 8])
def test_unsigned_digits_and_counts_match_reference(c):
    limbs = _scal_np(SCALARS)
    t, j = torch.from_numpy(limbs), jnp.asarray(limbs.astype(np.uint32))
    assert _same(tmsm._digits_from_scalars(t, c), jmsm._digits_from_scalars(j, c))
    for got, ref in zip(tmsm._digit_counts(t, c), jmsm._digit_counts(j, c)):
        assert _same(got, ref)


@pytest.mark.parametrize("c", [4, 13])
def test_digit_counts_signed_match_reference(c):
    """order needs a STABLE sort to agree; starts/counts need side='right'."""
    limbs = _scal_np(SCALARS)
    got = tmsm._digit_counts_signed(torch.from_numpy(limbs), c)
    ref = jmsm._digit_counts_signed(jnp.asarray(limbs.astype(np.uint32)), c)
    for name, g, r in zip(("order", "sign", "starts", "counts"), got, ref):
        assert _same(g, r), name
    assert int(got[3][:, 0].sum()) == 0  # magnitude 0 does no work


def test_with_neg_y_table_matches_reference():
    pts = _rand_g1(5) + [None]  # the identity row has y = mont(1), x = z = 0
    packed = G1P.pack(tc.g1_from_affine_host(pts, device="cpu"))
    ptcat = packed.T.contiguous()
    ptcat[4, 24:48] = 0  # a zero y must stay zero
    got = tmsm._with_neg_y_table(ptcat)
    ref = jmsm._with_neg_y_table(jnp.asarray(ptcat.numpy().astype(np.uint32)), 24, 1)
    assert got.shape == (12, 72) and _same(got, ref)
    neg = tc.g1_to_affine_host(G1P.unpack(got[6:10].T.contiguous()))
    assert neg == [hc.g1_neg(p) for p in pts[:4]]


def test_round_T_and_pick_t_cap_match_reference():
    for t in (0, 1, 15, 16, 17, 100, 511, 512, 513, 4241, 65536):
        assert tmsm._round_T(t) == jmsm._round_T(t)
    for seed in range(4):
        rng = np.random.default_rng(seed)
        counts = rng.poisson(20, size=(8, 33)).astype(np.int32)
        counts[:, 0] = 0
        counts[-1, 1:5] = 700  # a skewed top window
        assert tmsm._pick_t_cap(counts, 8, 33) == jmsm._pick_t_cap(counts, 8, 33)


def test_plan_segments_matches_reference():
    rng = np.random.default_rng(9)
    counts = rng.poisson(10, size=(5, 9)).astype(np.int32)
    counts[:, 0] = 0
    counts[4, 3] = 90
    counts[2, 5] = 0
    starts = (np.cumsum(counts, axis=1) - counts).astype(np.int32)
    for T_cap in (16, 32):
        got = tmsm._plan_segments(starts, counts, T_cap)
        ref = jmsm._plan_segments(starts, counts, T_cap)
        for g, r in zip(got, ref):
            assert np.array_equal(g, r)


def test_pad_pow2_and_pad_to():
    pts = tc.g1_from_affine_host(_rand_g1(5), device="cpu")
    scal = torch.from_numpy(_scal_np([1, 2, 3, 4, 5]))
    p2, s2 = tmsm._pad_pow2(pts, scal)
    assert s2.shape == (8, 16) and all(c.shape == (8, 24) for c in p2)
    assert int(s2[5:].abs().sum()) == 0 and all(int(c[5:].abs().sum()) == 0 for c in p2)
    p3, s3 = tmsm._pad_to(pts, scal, 5)
    assert s3 is scal and p3 is pts
    assert torch.equal(tmsm._prep_scalars([R + 1, 2], "cpu"), torch.from_numpy(_scal_np([1, 2])))


def test_weighted_sum_and_horner_against_host():
    """sum_j (j+1) B_j per window, then sum_w 2^(c w) S_w, on small buckets."""
    W, c = 3, 3  # 8 buckets per window
    pts = _rand_g1(W * 8)
    pts[5] = None
    buckets = G1P.pack(tc.g1_from_affine_host(pts, device="cpu"))
    wins = tmsm._weighted_sum_packed(G1P, buckets, W, c, plus_one=True)
    want = []
    for w in range(W):
        acc = None
        for j in range(8):
            acc = hc.g1_add(acc, hc.g1_mul(pts[w * 8 + j], j + 1))
        want.append(acc)
    assert tc.g1_to_affine_host(G1P.unpack(wins)) == want
    wins0 = tmsm._weighted_sum_packed(G1P, buckets, W, c)
    assert tc.g1_to_affine_host(G1P.unpack(wins0))[0] == hc.g1_msm(pts[:8], list(range(8)))
    out = tmsm._horner_ladder_packed(G1P, wins, 4)
    total = None
    for w in range(W):
        total = hc.g1_add(total, hc.g1_mul(want[w], 1 << (4 * w)))
    assert tc.g1_to_affine_host(G1P.unpack(out)) == [total]


# -- the slice as a whole ---------------------------------------------------------


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "projective"])
def test_msm_g1_signed_vs_host(affine):
    n = 68  # > 64: the full signed Pippenger, padded to 128
    pts_h = _rand_g1(n)
    scalars = [0, 1, R - 1, 2] + [_rand_fr() for _ in range(n - 4)]
    dev = tc.g1_from_affine_host(pts_h, device="cpu")
    got = tmsm.msm_g1(dev, scalars, affine=affine, signed_c=4, device="cpu")
    assert got == jhc.g1_msm(pts_h, scalars)


def test_msm_g1_small_vs_host():
    n = 5  # <= 64: ladder + tree
    pts_h = _rand_g1(n)
    scalars = [int(s) for s in RNG.integers(0, 1 << 60, size=n)]
    got = tmsm.msm_g1(tc.g1_from_affine_host(pts_h, device="cpu"), scalars, device="cpu")
    assert got == jhc.g1_msm(pts_h, scalars)


def test_msm_g1_unsigned_vs_host_and_limb_scalars():
    n = 96
    pts_h = _rand_g1(n)
    scalars = [_rand_fr() for _ in range(n)]
    dev = tc.g1_from_affine_host(pts_h, device="cpu")
    want = jhc.g1_msm(pts_h, scalars)
    assert tmsm.msm_g1(dev, scalars, c=4, device="cpu") == want
    # one flipped scalar must change the answer
    scalars[7] ^= 1
    limbs = torch.from_numpy(_scal_np(scalars))
    got = tmsm.msm_g1(dev, limbs, c=4, device="cpu")
    assert got != want and got == jhc.g1_msm(pts_h, scalars)


def test_msm_g1_argument_checks():
    dev = tc.g1_from_affine_host(_rand_g1(2), device="cpu")
    with pytest.raises(ValueError):
        tmsm.msm_g1(dev, [1, 2, 3], device="cpu")
    limbs = torch.from_numpy(_scal_np(SCALARS))
    with pytest.raises(ValueError):
        tmsm._signed_digits(limbs, 17)
    with pytest.raises(ValueError):
        tmsm._digits_from_scalars(limbs, 5)


# -- against the JAX packed MSM itself (slow: Pallas interpret mode) ---------------


@pytest.mark.slow
def test_msm_packed_stages_equal_reference_packed_msm(monkeypatch):
    """Runs testudo_tpu's packed signed MSM (c = 4, n = 68 padded to 128,
    affine) stage by stage through its Pallas kernels in interpret mode and
    holds the port's segment sums, bucket sums and window sums against it limb
    for limb, and the final affine result.  Slow: every EC kernel costs
    minutes of CPU compile in interpret mode."""
    monkeypatch.setenv("TESTUDO_PACKED", "1")
    monkeypatch.setenv("TESTUDO_MSM_C", "4")
    c, n = 4, 68
    pts_h = _rand_g1(n)
    scalars = [0, 1, R - 1, 2] + [_rand_fr() for _ in range(n - 4)]
    limbs = _scal_np(scalars)

    # port
    tp, ts = tmsm._pad_pow2(tc.g1_from_affine_host(pts_h, device="cpu"), torch.from_numpy(limbs))
    stages = {}
    ptcat = tmsm._cat_points(tp)
    N = ptcat.shape[0]
    order, sgn, starts, counts = tmsm._digit_counts_signed(ts, c)
    table = tmsm._with_neg_y_table(ptcat)
    order_flat = (order + sgn * N).reshape(-1).contiguous()
    W, B = counts.shape
    T_cap = tmsm._pick_t_cap(counts.numpy(), W, B)
    wnd, seg_start, seg_count, lane_off, nseg, L = tmsm._plan_segments(
        starts.numpy(), counts.numpy(), T_cap)
    S_cap = 1 << (max(1, int(nseg.max())) - 1).bit_length()
    seg = tmsm._msm_seg_buckets(G1P, table, order_flat, wnd, seg_start, seg_count, N, True)
    buckets = tmsm._seg_reduce(G1P, seg, lane_off, nseg, S_cap)
    wins = tmsm._weighted_sum_packed(G1P, tmsm._drop_mag0(buckets, 72, W, B), W, c - 1, True)

    # reference, same stages (msm.py:791-849)
    jp, js = jmsm._pad_pow2(jc.g1_from_affine_host(pts_h), jnp.asarray(limbs.astype(np.uint32)))
    jptcat = jmsm._cat_points("g1", jp)
    jorder, jsgn, jstarts, jcounts = jmsm._digit_counts_signed(js, c)
    jtable = jmsm._with_neg_y_table(jptcat, 24, 1)
    jflat = (jorder + jsgn * N).reshape(-1)
    L_pad, lc = jmsm._plan_lanes(T_cap, 72, L, S_cap)
    pad = L_pad - L
    jseg = jmsm._msm_seg_buckets(
        "g1", jtable, jflat, jnp.asarray(np.pad(wnd, (0, pad))),
        jnp.asarray(np.pad(seg_start, (0, pad))), jnp.asarray(np.pad(seg_count, (0, pad))),
        T_cap, lc, N, True)
    assert _same(seg, np.asarray(jseg)[:, :L])
    jbuckets = jmsm._seg_reduce("g1", jseg, (jnp.asarray(lane_off), jnp.asarray(nseg)), S_cap)
    assert _same(buckets, jbuckets)
    jwins = jmsm._weighted_sum_packed_jit(
        "g1", jmsm._drop_mag0(jbuckets, 72, W, B), W, c - 1, True)
    assert _same(wins, jwins)
    jout = jc.g1_to_affine_host(pcu.G1P.unpack(jmsm._horner_ladder_packed("g1", jwins, c)))[0]
    got = tmsm.msm_g1(tc.g1_from_affine_host(pts_h, device="cpu"), scalars, affine=True,
                      signed_c=c, device="cpu")
    assert got == jout == jhc.g1_msm(pts_h, scalars)
