"""The port's host tower and pairing (testudo_tpu_torch/fields/host.py,
curves/pairing.py, native/) against the JAX package's host modules: the same
integers out of both, bilinearity, and the native library against the pure
Python pairing.  Host code only; values are exact."""
import numpy as np
import pytest

from testudo_tpu.curves import host_curve as jhc
from testudo_tpu.curves import pairing as jpr
from testudo_tpu.fields import host as jhf
from testudo_tpu_torch import convert, native
from testudo_tpu_torch.curves import host_curve as hc
from testudo_tpu_torch.curves import pairing as pr
from testudo_tpu_torch.fields import host as hf
from testudo_tpu_torch.fields.bls12_377 import P, R

RNG = np.random.default_rng(81)


def _k():
    return int.from_bytes(RNG.bytes(40), "little") % R


def _fq12(mod):
    """A fixed, structured Fq12 element built in the classes of `mod`."""
    c = [mod.Fq2(3 + i, (7 * i + 1) * (P - 11)) for i in range(6)]
    return mod.Fq12(mod.Fq6(*c[:3]), mod.Fq6(*c[3:]))


def _comps(x):
    if isinstance(x, int):
        return [x]
    return [v for name in type(x).__slots__ for v in _comps(getattr(x, name))]


def test_tower_constants_and_arithmetic_match_reference():
    for name in ("FROB6_C1", "FROB6_C2", "FROB12_C1"):
        assert [_comps(x) for x in getattr(hf, name)] == [_comps(x) for x in getattr(jhf, name)]
    a, ja = _fq12(hf), _fq12(jhf)
    b, jb = a.square() + hf.Fq12.one(), ja.square() + jhf.Fq12.one()
    assert _comps(a * b) == _comps(ja * jb)
    assert _comps(a.inv()) == _comps(ja.inv()) and (a * a.inv()).is_one()
    assert _comps(a.frobenius(1)) == _comps(ja.frobenius(1))
    assert _comps(a.frobenius(7)) == _comps(ja.frobenius(7))
    assert _comps(a.pow(0xDEADBEEF)) == _comps(ja.pow(0xDEADBEEF))
    assert a.frobenius(12) == a and a.conj() == a.frobenius(6)
    assert _comps(a.c0.inv()) == _comps(ja.c0.inv())
    assert _comps(a.c0.mul_by_nonresidue()) == _comps(ja.c0.mul_by_nonresidue())
    assert hash(a) == hash(_fq12(hf)) and a != b
    assert convert.fq12_from_reference(ja) == a
    assert _comps(convert.fq12_to_reference(a, jhf)) == _comps(ja)
    assert type(convert.fq12_to_reference(a, jhf)) is jhf.Fq12


def test_pairing_matches_reference_and_is_bilinear():
    g1, g2 = hc.g1_generator(), hc.g2_generator()
    assert g1 == jhc.g1_generator() and _comps(g2[0]) == _comps(jhc.g2_generator()[0])
    a, b = _k(), _k()
    e = pr.pairing(g1, g2)
    assert _comps(e) == _comps(jpr.pairing(jhc.g1_generator(), jhc.g2_generator()))
    assert not e.is_one() and e.pow(R).is_one()
    lhs = pr.pairing(hc.g1_mul(g1, a), hc.g2_mul(g2, b))
    assert lhs == pr.gt_pow(e, a * b % R)
    assert pr.pairing(None, g2).is_one() and pr.pairing(g1, None).is_one()
    # e(aG, H) e(-G, aH) = 1
    prod = pr.multi_pairing([hc.g1_mul(g1, a), hc.g1_neg(g1)], [g2, hc.g2_mul(g2, a)])
    assert prod == hf.Fq12.one()


def test_native_library_equals_the_pure_python_pairing():
    if native.compiler() is None:
        pytest.skip("no g++: the pure-Python pairing is the only one here")
    assert native.available(), native.build_error()
    g1, g2 = hc.g1_generator(), hc.g2_generator()
    ps = [hc.g1_mul(g1, _k()) for _ in range(3)] + [None]
    qs = [hc.g2_mul(g2, _k()) for _ in range(3)] + [g2]
    pure = pr.final_exponentiation(pr.multi_miller_loop(zip(ps, qs)))
    assert native.multi_pairing(ps, qs) == pure == pr.multi_pairing(ps, qs)
    f, e = pure, _k()
    assert native.gt_pow(f, e) == f.pow(e)
    assert native.gt_batch_pow([f, f.square()], [e, 5]) == [f.pow(e), f.square().pow(5)]
    ks = [_k() for _ in ps[:3]]
    assert native.g1_msm(ps[:3], ks) == hc.g1_msm(ps[:3], ks)
    assert native.g2_msm(qs[:3], ks) == hc.g2_msm(qs[:3], ks)
    assert native.g1_mul(ps[0], e) == hc.g1_mul(ps[0], e)
    assert native.g2_mul(qs[0], e) == hc.g2_mul(qs[0], e)


def test_native_library_is_the_ports_own_build():
    import os

    import testudo_tpu_torch

    pkg = os.path.dirname(os.path.abspath(testudo_tpu_torch.__file__))
    path = native.library_path()
    assert path.startswith(os.path.join(pkg, "_build") + os.sep)
    assert os.path.dirname(path) != os.path.join(pkg, "native")
    if native.available():
        assert os.path.exists(path)
    src = os.path.join(pkg, "native", "testudo_native.cpp")
    ref = os.path.join(os.path.dirname(pkg), "testudo_tpu", "native", "testudo_native.cpp")
    body = lambda p: [l for l in open(p).read().splitlines() if not l.startswith("//")]
    assert body(src) == body(ref)  # the copy differs in its header comment only
