"""The port's Fq2 and G2 layers below the packed kernels: host `Fq2`, `B2`, the
G2 generator and the host group law (testudo_tpu_torch/fields/host.py,
curves/host_curve.py) against testudo_tpu.fields.host / curves.host_curve,
and device Fq2 and G2 arithmetic (testudo_tpu_torch/device/curve.py) against
testudo_tpu.tpu.curve limb for limb and against the host curve as points.
Integers: exact equality."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from testudo_tpu.curves import host_curve as jhc
from testudo_tpu.fields import host as jhf
from testudo_tpu.tpu import curve as jc
from testudo_tpu_torch.curves import host_curve as hc
from testudo_tpu_torch.device import curve as tc
from testudo_tpu_torch.device.field import FQ, FR
from testudo_tpu_torch.fields import host as hf
from testudo_tpu_torch.fields.bls12_377 import P, R

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

RNG = np.random.default_rng(81)


def _rand_fq():
    return int.from_bytes(RNG.bytes(64), "little") % P


def _pair(x):
    """A port Fq2 or a reference Fq2 as a plain (c0, c1) pair."""
    return (x.c0, x.c1)


def _pt(p):
    return None if p is None else (_pair(p[0]), _pair(p[1]))


def _to_ref(p):
    return None if p is None else (jhf.Fq2(*_pair(p[0])), jhf.Fq2(*_pair(p[1])))


def _host_points(n):
    G = hc.g2_generator()
    return [hc.g2_mul(G, int(k)) for k in RNG.integers(1, 1 << 62, size=n)]


# lanes: P+Q, P+P, P+(-P), P+O, O+Q, O+O, and two more P+Q
A_H = _host_points(8)
B_H = _host_points(8)
B_H[1] = A_H[1]
B_H[2] = hc.g2_neg(A_H[2])
B_H[3] = None
A_H[4] = None
A_H[5] = None
B_H[5] = None


def _both(points):
    return (tc.g2_from_affine_host(points, device="cpu"),
            jc.g2_from_affine_host([_to_ref(p) for p in points]))


def _assert_same(tp, jp):
    for tcoord, jcoord in zip(tp, jp):
        for t, j in zip(tcoord, jcoord):
            assert t.dtype == torch.int32
            assert np.array_equal(t.numpy(), np.asarray(j).astype(np.int32))


# -- host ---------------------------------------------------------------------------


def test_host_fq2_matches_reference():
    vals = [(0, 0), (1, 0), (0, 1), (P - 1, P - 1)] + [(_rand_fq(), _rand_fq()) for _ in range(6)]
    for a0, a1 in vals:
        a, ja = hf.Fq2(a0, a1), jhf.Fq2(a0, a1)
        assert _pair(-a) == _pair(-ja) and _pair(a.square()) == _pair(ja.square())
        assert _pair(a.mul_scalar(7)) == _pair(ja.mul_scalar(7))
        assert a.is_zero() == ja.is_zero() and a == hf.Fq2(a0 + P, a1)
        if not a.is_zero():
            assert _pair(a.inv()) == _pair(ja.inv())
            assert a * a.inv() == hf.Fq2.one()
        for b0, b1 in vals[:5]:
            b, jb = hf.Fq2(b0, b1), jhf.Fq2(b0, b1)
            assert _pair(a + b) == _pair(ja + jb) and _pair(a - b) == _pair(ja - jb)
            assert _pair(a * b) == _pair(ja * jb)
    sq = hf.Fq2(3, 4).square()
    assert sq.sqrt().square() == sq and _pair(sq.sqrt()) == _pair(jhf.Fq2(*_pair(sq)).sqrt())
    assert hf.Fq2(0, 1).square() == hf.Fq2(-5, 0)  # u^2 = -5
    assert hf.Fq2(1, 2) != (1, 2) and hash(hf.Fq2(1, 2)) == hash(hf.Fq2(1 + P, 2))


def test_host_g2_constants_and_generator_match_reference():
    assert _pair(hc.B2) == _pair(jhc.B2) and hc.B2 * hf.Fq2(0, 1) == hf.Fq2.one()
    G = hc.g2_generator()
    assert _pt(G) == _pt(jhc.g2_generator())
    assert hc.g2_is_on_curve(G) and hc.g2_is_on_curve(None)
    assert not hc.g2_is_on_curve((hf.Fq2(1, 1), hf.Fq2(1, 1)))
    assert hc.g2_mul(G, R) is None
    assert tc._B3_K == jc._B3_K


def test_host_g2_group_law_matches_reference():
    G = hc.g2_generator()
    k = 0x1234567890ABCDEF1234567890ABCDEF
    assert _pt(hc.g2_mul(G, k)) == _pt(jhc.g2_mul(jhc.g2_generator(), k))
    assert hc.g2_mul(A_H[0], -5) == hc.g2_neg(hc.g2_mul(A_H[0], 5))
    for a, b in zip(A_H, B_H):
        assert _pt(hc.g2_add(a, b)) == _pt(jhc.g2_add(_to_ref(a), _to_ref(b)))
        assert _pt(hc.g2_double(a)) == _pt(jhc.g2_add(_to_ref(a), _to_ref(a)))
    pts = [p for p in A_H if p is not None]
    ss = [int(s) for s in RNG.integers(0, 1 << 62, size=len(pts))]
    ss[0] = 0
    assert _pt(hc.g2_msm(pts, ss)) == _pt(jhc.g2_msm([_to_ref(p) for p in pts], ss))


# -- device Fq2 -----------------------------------------------------------------------


def _fq2_batches():
    vals = [[_rand_fq() for _ in range(7)] for _ in range(4)]
    for col, edge in zip(vals, ([0, 1, P - 1], [0, 0, P - 1], [P - 1, 0, 1], [1, P - 1, P - 1])):
        col[:3] = edge
    enc = [FQ.encode(v) for v in vals]
    t = [torch.from_numpy(e) for e in enc]
    j = [jnp.asarray(e.astype(np.uint32)) for e in enc]
    return vals, ((t[0], t[1]), (t[2], t[3])), ((j[0], j[1]), (j[2], j[3]))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "neg", "select"])
def test_fq2_ops_match_reference_and_host(op):
    vals, (ta, tb), (ja, jb) = _fq2_batches()
    ha = [hf.Fq2(x, y) for x, y in zip(vals[0], vals[1])]
    hb = [hf.Fq2(x, y) for x, y in zip(vals[2], vals[3])]
    cond = np.arange(7) % 2 == 0
    got, ref, want = {
        "add": lambda: (tc.fq2_add(ta, tb), jc.fq2_add(ja, jb), [a + b for a, b in zip(ha, hb)]),
        "sub": lambda: (tc.fq2_sub(ta, tb), jc.fq2_sub(ja, jb), [a - b for a, b in zip(ha, hb)]),
        "mul": lambda: (tc.fq2_mul(ta, tb), jc.fq2_mul(ja, jb), [a * b for a, b in zip(ha, hb)]),
        "neg": lambda: (tc.fq2_neg(ta), jc.fq2_neg(ja), [-a for a in ha]),
        "select": lambda: (tc.fq2_select(torch.from_numpy(cond), ta, tb),
                           jc.fq2_select(jnp.asarray(cond), ja, jb),
                           [a if c else b for c, a, b in zip(cond, ha, hb)]),
    }[op]()
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r).astype(np.int32))
    assert list(zip(FQ.decode(got[0]), FQ.decode(got[1]))) == [_pair(w) for w in want]


def test_g2ops_mul_b3_and_mul_many_match_reference():
    vals, (ta, tb), (ja, jb) = _fq2_batches()
    for ops in (tc._G2Ops, tc._G2PlainOps):
        got = ops.mul_b3(ta)
        ref = jc._G2Ops.mul_b3(ja)
        for g, r in zip(got, ref):
            assert np.array_equal(g.numpy(), np.asarray(r).astype(np.int32))
        pair = ops.mul_b3_pair(ta, tb)
        assert all(torch.equal(x, y) for x, y in zip(pair[0], got))
        assert all(torch.equal(x, y) for x, y in zip(pair[1], ops.mul_b3(tb)))
        many = ops.mul_many([(ta, tb), (tb, tb)])
        jmany = jc._fq2_mul_many([(ja, jb), (jb, jb)])
        for m, jm in zip(many, jmany):
            for g, r in zip(m, jm):
                assert np.array_equal(g.numpy(), np.asarray(r).astype(np.int32))
    b3 = hc.B2 + hc.B2 + hc.B2
    want = [b3 * hf.Fq2(x, y) for x, y in zip(vals[0], vals[1])]
    assert list(zip(FQ.decode(got[0]), FQ.decode(got[1]))) == [_pair(w) for w in want]


# -- device G2 ---------------------------------------------------------------------------


def test_g2_from_affine_host_and_back():
    ta, ja = _both(A_H)
    _assert_same(ta, ja)
    assert int(ta[2][1].abs().sum()) == 0  # every Z.c1 is zero
    assert tc.g2_to_affine_host(ta) == A_H
    assert [_pt(p) for p in jc.g2_to_affine_host(ja)] == [_pt(p) for p in A_H]


def test_g2_add_matches_reference_and_host():
    (ta, ja), (tb, jb) = _both(A_H), _both(B_H)
    got = tc.g2_add(ta, tb)
    _assert_same(got, jc.g2_add(ja, jb))
    assert tc.g2_to_affine_host(got) == [hc.g2_add(a, b) for a, b in zip(A_H, B_H)]


def test_g2_double_matches_reference_and_host():
    ta, ja = _both(A_H)
    got = tc.g2_double(ta)
    _assert_same(got, jc.g2_double(ja))
    assert tc.g2_to_affine_host(got) == [hc.g2_double(a) for a in A_H]


def test_g2_add_mixed_equals_general_add_on_affine_lifts():
    ta, _ = _both(A_H)
    q = [b if b is not None else hc.g2_generator() for b in B_H]
    tq, _ = _both(q)
    for ops in (tc._G2Ops, tc._G2PlainOps):
        got = tc._complete_add_mixed(ops, ta, (tq[0], tq[1]))
        assert tc.g2_to_affine_host(got) == [hc.g2_add(a, b) for a, b in zip(A_H, q)]


def test_g2_neg_select_identity():
    (ta, ja), (tb, jb) = _both(A_H), _both(B_H)
    _assert_same(tc.g2_neg(ta), jc.g2_neg(ja))
    cond = np.arange(8) % 2 == 0
    _assert_same(tc.g2_select(torch.from_numpy(cond), ta, tb),
                 jc.g2_select(jnp.asarray(cond), ja, jb))
    _assert_same(tc.g2_identity((3,), device="cpu"), jc.g2_identity((3,)))
    assert tc.g2_to_affine_host(tc.g2_identity((2,), device="cpu")) == [None, None]


def test_scalar_mul_batch_g2_against_host():
    pts = [p for p in A_H if p is not None][:3]
    k = int.from_bytes(RNG.bytes(40), "little") % R
    got = tc.scalar_mul_batch_g2(
        tc.g2_from_affine_host(pts, device="cpu"), torch.from_numpy(FR.to_limbs(k)))
    assert tc.g2_to_affine_host(got) == [hc.g2_mul(p, k) for p in pts]
