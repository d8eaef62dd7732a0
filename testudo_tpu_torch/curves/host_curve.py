"""Host-side (pure Python) BLS12-377 G1 arithmetic: the port's oracle.

Counterpart of testudo_tpu/curves/host_curve.py (its generic affine group
law and the G1 API).  Points are affine `(x, y)` tuples of Python ints, the
point at infinity is `None`.  No native backend: every function here is
plain Python, slow and obviously right, and is what the device MSM is
checked against.
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..fields import host as hf
from ..fields.bls12_377 import B1, H1, P, R

Point = Optional[Tuple[int, int]]


def g1_double(p: Point) -> Point:
    if p is None:
        return None
    x, y = p
    if y % P == 0:
        return None
    lam = 3 * x * x * pow(2 * y, -1, P) % P
    x3 = (lam * lam - 2 * x) % P
    y3 = (lam * (x - x3) - y) % P
    return (x3, y3)


def g1_add(p1: Point, p2: Point) -> Point:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        return g1_double(p1)
    lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_neg(p: Point) -> Point:
    if p is None:
        return None
    return (p[0], (-p[1]) % P)


def g1_mul(p: Point, k: int) -> Point:
    # scalars may exceed r (cofactor clearing), so no reduction here
    if k < 0:
        return g1_mul(g1_neg(p), -k)
    res: Point = None
    add = p
    while k:
        if k & 1:
            res = g1_add(res, add)
        add = g1_double(add)
        k >>= 1
    return res


def g1_is_on_curve(p: Point) -> bool:
    if p is None:
        return True
    x, y = p
    return y * y % P == (x * x * x + B1) % P


def g1_msm(points, scalars) -> Point:
    """sum_i scalars[i] * points[i], one double-and-add per term."""
    acc = None
    for pt, s in zip(points, scalars):
        s %= R
        if s == 0 or pt is None:
            continue
        acc = g1_add(acc, g1_mul(pt, s))
    return acc


_G1_GEN = None


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
