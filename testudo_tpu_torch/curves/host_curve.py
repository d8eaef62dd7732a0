"""Host-side (pure Python) BLS12-377 G1 and G2 arithmetic: the port's oracle.

Counterpart of testudo_tpu/curves/host_curve.py (its generic affine group
law, the G1 and G2 APIs and the generator search).  Points are affine
`(x, y)` tuples, the point at infinity is `None`.  G1 coordinates are Python
ints (Fq), G2 coordinates are `Fq2` elements; the group law is generic over
the coordinate field through a small ops namespace.  No native backend:
every function here is plain Python, slow and obviously right, and is what
the device code is checked against.
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..fields import host as hf
from ..fields.bls12_377 import B1, H1, H2, P, R
from ..fields.host import Fq2

# G2 curve coefficient: b2 = 1 / u = -u / 5 (D-type twist).
B2 = Fq2(0, 1).inv()

Point = Optional[Tuple[object, object]]


class _FqOps:
    add = staticmethod(lambda a, b: (a + b) % P)
    sub = staticmethod(lambda a, b: (a - b) % P)
    mul = staticmethod(lambda a, b: a * b % P)
    sqr = staticmethod(lambda a: a * a % P)
    inv = staticmethod(lambda a: pow(a, -1, P))
    neg = staticmethod(lambda a: (-a) % P)
    is_zero = staticmethod(lambda a: a % P == 0)
    b_coeff = B1


class _Fq2Ops:
    add = staticmethod(lambda a, b: a + b)
    sub = staticmethod(lambda a, b: a - b)
    mul = staticmethod(lambda a, b: a * b)
    sqr = staticmethod(lambda a: a.square())
    inv = staticmethod(lambda a: a.inv())
    neg = staticmethod(lambda a: -a)
    is_zero = staticmethod(lambda a: a.is_zero())
    b_coeff = B2


# -- generic affine group law ---------------------------------------------------


def _double(F, p: Point) -> Point:
    if p is None:
        return None
    x, y = p
    if F.is_zero(y):
        return None
    x2 = F.sqr(x)
    lam = F.mul(F.add(F.add(x2, x2), x2), F.inv(F.add(y, y)))  # 3x^2 / 2y
    x3 = F.sub(F.sqr(lam), F.add(x, x))
    y3 = F.sub(F.mul(lam, F.sub(x, x3)), y)
    return (x3, y3)


def _add(F, p1: Point, p2: Point) -> Point:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if F.is_zero(F.add(y1, y2)):
            return None
        return _double(F, p1)
    lam = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
    x3 = F.sub(F.sub(F.sqr(lam), x1), x2)
    y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
    return (x3, y3)


def _neg(F, p: Point) -> Point:
    if p is None:
        return None
    return (p[0], F.neg(p[1]))


def _mul(F, p: Point, k: int) -> Point:
    # scalars may exceed r (cofactor clearing), so no reduction here
    if k < 0:
        return _mul(F, _neg(F, p), -k)
    res: Point = None
    add = p
    while k:
        if k & 1:
            res = _add(F, res, add)
        add = _double(F, add)
        k >>= 1
    return res


def _is_on_curve(F, p: Point) -> bool:
    if p is None:
        return True
    x, y = p
    return F.sqr(y) == F.add(F.mul(F.sqr(x), x), F.b_coeff)


def _msm(F, points, scalars) -> Point:
    """sum_i scalars[i] * points[i], one double-and-add per term."""
    acc = None
    for pt, s in zip(points, scalars):
        s %= R
        if s == 0 or pt is None:
            continue
        acc = _add(F, acc, _mul(F, pt, s))
    return acc


# -- G1 ---------------------------------------------------------------------------


def g1_double(p: Point) -> Point:
    return _double(_FqOps, p)


def g1_add(p1: Point, p2: Point) -> Point:
    return _add(_FqOps, p1, p2)


def g1_neg(p: Point) -> Point:
    return _neg(_FqOps, p)


def g1_mul(p: Point, k: int) -> Point:
    return _mul(_FqOps, p, k)


def g1_is_on_curve(p: Point) -> bool:
    return _is_on_curve(_FqOps, p)


def g1_msm(points, scalars) -> Point:
    return _msm(_FqOps, points, scalars)


# -- G2 ---------------------------------------------------------------------------


def g2_double(p: Point) -> Point:
    return _double(_Fq2Ops, p)


def g2_add(p1: Point, p2: Point) -> Point:
    return _add(_Fq2Ops, p1, p2)


def g2_neg(p: Point) -> Point:
    return _neg(_Fq2Ops, p)


def g2_mul(p: Point, k: int) -> Point:
    return _mul(_Fq2Ops, p, k)


def g2_is_on_curve(p: Point) -> bool:
    return _is_on_curve(_Fq2Ops, p)


def g2_msm(points, scalars) -> Point:
    return _msm(_Fq2Ops, points, scalars)


# -- generators (deterministic derivation, as in the JAX package) -----------------

_G1_GEN = None
_G2_GEN = None


def g1_generator() -> Point:
    """Deterministic generator of the order-r subgroup: the smallest x >= 1
    with x^3 + 1 a square, the smaller root y, cleared by the cofactor."""
    global _G1_GEN
    if _G1_GEN is None:
        x = 1
        while True:
            y = hf.fq_sqrt((x * x * x + B1) % P)
            if y is not None:
                pt = g1_mul((x, min(y, P - y)), H1)
                if pt is not None and g1_mul(pt, R) is None:
                    _G1_GEN = pt
                    break
            x += 1
    return _G1_GEN


def g2_generator() -> Point:
    """Deterministic generator of the order-r subgroup of the twist: the
    smallest k >= 0 with x = k + u on the curve, the root `Fq2.sqrt` returns,
    cleared by the cofactor h2."""
    global _G2_GEN
    if _G2_GEN is None:
        k = 0
        while True:
            x = Fq2(k, 1)
            y = (x.square() * x + B2).sqrt()
            if y is not None:
                pt = g2_mul((x, y), H2)
                if pt is not None and g2_mul(pt, R) is None:
                    _G2_GEN = pt
                    break
            k += 1
    return _G2_GEN
