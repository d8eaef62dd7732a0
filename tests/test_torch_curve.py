"""Port G1 arithmetic (testudo_tpu_torch/device/curve.py) against the JAX
package's tpu/curve.py (jitted), limb for limb, and against the host
curve.  Integers: exact equality."""
import numpy as np
import torch

import jax.numpy as jnp

from testudo_tpu.curves import host_curve as jhc
from testudo_tpu.tpu import curve as jc
from testudo_tpu_torch.curves import host_curve as hc
from testudo_tpu_torch.device import curve as tc
from testudo_tpu_torch.device.field import FR
from testudo_tpu_torch.fields.bls12_377 import R

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

RNG = np.random.default_rng(31)


def _host_points(n):
    G = hc.g1_generator()
    return [hc.g1_mul(G, int(k)) for k in RNG.integers(1, 1 << 62, size=n)]


# lanes: P+Q, P+P, P+(-P), P+O, O+Q, O+O, and two more P+Q
A_H = _host_points(8)
B_H = _host_points(8)
B_H[1] = A_H[1]
B_H[2] = hc.g1_neg(A_H[2])
B_H[3] = None
A_H[4] = None
A_H[5] = None
B_H[5] = None


def _np(p):
    return tuple(np.asarray(c).astype(np.int32) for c in p)


def _both(points):
    return (tc.g1_from_affine_host(points, device="cpu"),
            jc.g1_from_affine_host(points))


def _assert_same(tp, jp):
    for t, j in zip(tp, _np(jp)):
        assert t.dtype == torch.int32
        assert np.array_equal(t.numpy(), j)


def test_host_curve_matches_reference_host_curve():
    assert hc.g1_generator() == jhc.g1_generator()
    assert hc.g1_is_on_curve(hc.g1_generator()) and hc.g1_is_on_curve(None)
    assert not hc.g1_is_on_curve((1, 1))
    k = 0x1234567890ABCDEF1234567890ABCDEF
    assert hc.g1_mul(hc.g1_generator(), k) == jhc.g1_mul(jhc.g1_generator(), k)
    assert hc.g1_mul(hc.g1_generator(), R) is None
    assert hc.g1_mul(A_H[0], -5) == hc.g1_neg(hc.g1_mul(A_H[0], 5))
    for a, b in zip(A_H, B_H):
        assert hc.g1_add(a, b) == jhc.g1_add(a, b)
    pts = [p for p in A_H if p is not None]
    ss = [int(s) for s in RNG.integers(0, 1 << 62, size=len(pts))]
    ss[0] = 0
    assert hc.g1_msm(pts, ss) == jhc.g1_msm(pts, ss)


def test_from_affine_host_and_back():
    ta, ja = _both(A_H)
    _assert_same(ta, ja)
    assert tc.g1_to_affine_host(ta) == A_H == jc.g1_to_affine_host(ja)


def test_g1_add_matches_reference_and_host():
    (ta, ja), (tb, jb) = _both(A_H), _both(B_H)
    got = tc.g1_add(ta, tb)
    _assert_same(got, jc.g1_add(ja, jb))
    assert tc.g1_to_affine_host(got) == [hc.g1_add(a, b) for a, b in zip(A_H, B_H)]


def test_g1_double_matches_reference_and_host():
    ta, ja = _both(A_H)
    got = tc.g1_double(ta)
    _assert_same(got, jc.g1_double(ja))
    assert tc.g1_to_affine_host(got) == [hc.g1_double(a) for a in A_H]


def test_g1_add_mixed_equals_general_add_on_affine_lifts():
    ta, _ = _both(A_H)
    q = [b if b is not None else hc.g1_generator() for b in B_H]
    tq, _ = _both(q)
    got = tc._complete_add_mixed(tc._G1Ops, ta, (tq[0], tq[1]))
    assert tc.g1_to_affine_host(got) == [hc.g1_add(a, b) for a, b in zip(A_H, q)]


def test_g1_neg_select_identity():
    (ta, ja), (tb, jb) = _both(A_H), _both(B_H)
    _assert_same(tc.g1_neg(ta), jc.g1_neg(ja))
    cond = np.arange(8) % 2 == 0
    _assert_same(tc.g1_select(torch.from_numpy(cond), ta, tb),
                 jc.g1_select(jnp.asarray(cond), ja, jb))
    _assert_same(tc.g1_identity((3,), device="cpu"), jc.g1_identity((3,)))
    assert tc.g1_to_affine_host(tc.g1_identity((2,), device="cpu")) == [None, None]


def test_scalar_mul_batch_g1_against_host():
    pts = [p for p in A_H if p is not None][:3]
    k = int.from_bytes(RNG.bytes(40), "little") % R
    got = tc.scalar_mul_batch_g1(
        tc.g1_from_affine_host(pts, device="cpu"), torch.from_numpy(FR.to_limbs(k)))
    assert tc.g1_to_affine_host(got) == [hc.g1_mul(p, k) for p in pts]
