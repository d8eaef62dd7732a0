"""Host-side BLS12-381: G1/G2 arithmetic and the optimal ate pairing.

Counterpart of testudo_tpu/curves/bls12_381.py (host code; the port keeps
its own copy), itself the counterpart of curves/host_curve.py +
curves/pairing.py for the second curve family Testudo wires in
(ark-bls12-381 / ark-blst, Cargo.toml:25-26).  Differences from BLS12-377 handled
here:

  - M-type twist: G2 is y^2 = x^3 + 4*(u+1); the untwist map is
    (x', y') -> (x'/w^2, y'/w^3), so line evaluations land on the
    w^0 / w^3 / w^5 basis positions (vs w^0 / w^1 / w^3 for the D twist),
    after scaling by XI (an Fq2 element, killed by the final
    exponentiation).
  - Negative seed: the Miller loop runs over |x| and the result is
    conjugated (f^(p^6) == f^-1 up to FE-killed factors).

Tower classes come from the generic factory (fields/tower.py).
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

from ..fields.bls12_381 import (
    B1, H1, H2, P, R, X_ABS, X_SEED, XI, FQ2_NONRESIDUE,
)
from ..fields import tower

Fq2, Fq6, Fq12 = tower.make_tower(P, FQ2_NONRESIDUE, XI)

XI2 = Fq2(*XI)
B2 = XI2.mul_scalar(B1)  # M-twist: b2 = b * XI


# ---------------------------------------------------------------------------
# Group ops (generic affine, same shape as host_curve's helpers)
# ---------------------------------------------------------------------------


class _FqOps:
    add = staticmethod(lambda a, b: (a + b) % P)
    sub = staticmethod(lambda a, b: (a - b) % P)
    mul = staticmethod(lambda a, b: a * b % P)
    sqr = staticmethod(lambda a: a * a % P)
    inv = staticmethod(lambda a: pow(a, -1, P))
    neg = staticmethod(lambda a: (-a) % P)
    is_zero = staticmethod(lambda a: a % P == 0)
    zero = 0
    one = 1
    b_coeff = B1


class _Fq2Ops:
    add = staticmethod(lambda a, b: a + b)
    sub = staticmethod(lambda a, b: a - b)
    mul = staticmethod(lambda a, b: a * b)
    sqr = staticmethod(lambda a: a.square())
    inv = staticmethod(lambda a: a.inv())
    neg = staticmethod(lambda a: -a)
    is_zero = staticmethod(lambda a: a.is_zero())
    zero = Fq2.zero()
    one = Fq2.one()
    b_coeff = B2


def _add(F, p1, p2):
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
    return (x3, F.sub(F.mul(lam, F.sub(x1, x3)), y1))


def _double(F, p):
    if p is None:
        return None
    x, y = p
    if F.is_zero(y):
        return None
    x2 = F.sqr(x)
    lam = F.mul(F.add(F.add(x2, x2), x2), F.inv(F.add(y, y)))
    x3 = F.sub(F.sqr(lam), F.add(x, x))
    return (x3, F.sub(F.mul(lam, F.sub(x, x3)), y))


def _neg(F, p):
    return None if p is None else (p[0], F.neg(p[1]))


def _mul(F, p, k: int):
    if k < 0:
        return _mul(F, _neg(F, p), -k)
    res = None
    add = p
    while k:
        if k & 1:
            res = _add(F, res, add)
        add = _add(F, add, add)
        k >>= 1
    return res


def _is_on_curve(F, p):
    if p is None:
        return True
    x, y = p
    return F.sqr(y) == F.add(F.mul(F.sqr(x), x), F.b_coeff)


def g1_add(p1, p2):
    return _add(_FqOps, p1, p2)


def g1_neg(p):
    return _neg(_FqOps, p)


def g1_mul(p, k):
    return _mul(_FqOps, p, k)


def g1_is_on_curve(p):
    return _is_on_curve(_FqOps, p)


def g2_add(p1, p2):
    return _add(_Fq2Ops, p1, p2)


def g2_neg(p):
    return _neg(_Fq2Ops, p)


def g2_mul(p, k):
    return _mul(_Fq2Ops, p, k)


def g2_is_on_curve(p):
    return _is_on_curve(_Fq2Ops, p)


def _msm(F, points, scalars):
    """Host Pippenger (c = 8) — the ark-blst role for this curve family."""
    c = 8
    nbits = max((int(s).bit_length() for s in scalars), default=1)
    W = max(1, -(-nbits // c))
    acc = None
    for w in reversed(range(W)):
        if acc is not None:
            for _ in range(c):
                acc = _add(F, acc, acc)
        buckets = {}
        for p, s in zip(points, scalars):
            d = (int(s) >> (w * c)) & ((1 << c) - 1)
            if d:
                buckets[d] = _add(F, buckets.get(d), p)
        run = None
        tot = None
        for d in range(max(buckets) if buckets else 0, 0, -1):
            run = _add(F, run, buckets.get(d))
            tot = _add(F, tot, run)
        acc = _add(F, acc, tot)
    return acc


def g1_msm(points, scalars):
    return _msm(_FqOps, points, scalars)


def g2_msm(points, scalars):
    return _msm(_Fq2Ops, points, scalars)


# ---------------------------------------------------------------------------
# Generators (deterministic derivation, as for BLS12-377)
# ---------------------------------------------------------------------------


def _sqrt_fq(x: int):
    # p = 3 mod 4: sqrt = x^((p+1)/4)
    s = pow(x % P, (P + 1) // 4, P)
    return s if s * s % P == x % P else None


def _find_g1_generator():
    x = 1
    while True:
        y = _sqrt_fq(x * x * x + B1)
        if y is not None:
            pt = _mul(_FqOps, (x, min(y, P - y)), H1)
            if pt is not None and _mul(_FqOps, pt, R) is None:
                return pt
        x += 1


def _find_g2_generator():
    k = 0
    while True:
        x = Fq2(k, 1)
        y = (x.square() * x + B2).sqrt()
        if y is not None:
            pt = _mul(_Fq2Ops, (x, y), H2)
            if pt is not None and _mul(_Fq2Ops, pt, R) is None:
                return pt
        k += 1


_G1_GEN = None
_G2_GEN = None


def g1_generator():
    global _G1_GEN
    if _G1_GEN is None:
        _G1_GEN = _find_g1_generator()
    return _G1_GEN


def g2_generator():
    global _G2_GEN
    if _G2_GEN is None:
        _G2_GEN = _find_g2_generator()
    return _G2_GEN


# ---------------------------------------------------------------------------
# Pairing (M-twist lines, negative seed)
# ---------------------------------------------------------------------------


def _sparse_line_m(lam: "Fq2", c0: "Fq2", xp: int, yp: int) -> "Fq12":
    """l = XI*yp + (lam*xT - yT)*w^3 - lam*xp*w^5 (M-twist untwist
    (x'/w^2, y'/w^3), scaled by XI in Fq2 — FE-killed).
    Basis: w^0 -> c0.c0, w^3 = v*w -> c1.c1, w^5 = v^2*w -> c1.c2."""
    a = Fq6(XI2.mul_scalar(yp), Fq2.zero(), Fq2.zero())
    b = Fq6(Fq2.zero(), c0, -(lam.mul_scalar(xp)))
    return Fq12(a, b)


def _line_double(q, p):
    (xq, yq) = q
    (xp, yp) = p
    lam = xq.square().mul_scalar(3) * (yq + yq).inv()
    x3 = lam.square() - xq - xq
    y3 = lam * (xq - x3) - yq
    c0 = lam * xq - yq
    return (x3, y3), _sparse_line_m(lam, c0, xp, yp)


def _line_add(q1, q2, p):
    (x1, y1) = q1
    (x2, y2) = q2
    lam = (y2 - y1) * (x2 - x1).inv()
    x3 = lam.square() - x1 - x2
    y3 = lam * (x1 - x3) - y1
    c0 = lam * x1 - y1
    return (x3, y3), _sparse_line_m(lam, c0, p[0], p[1])


def multi_miller_loop(pairs: Iterable[Tuple[object, object]]) -> "Fq12":
    pairs = [(p, q) for (p, q) in pairs if p is not None and q is not None]
    if not pairs:
        return Fq12.one()
    f = Fq12.one()
    ts = [q for (_, q) in pairs]
    for b in bin(X_ABS)[3:]:
        f = f.square()
        for i, (p, q) in enumerate(pairs):
            ts[i], l = _line_double(ts[i], p)
            f = f * l
        if b == "1":
            for i, (p, q) in enumerate(pairs):
                ts[i], l = _line_add(ts[i], q, p)
                f = f * l
    # negative seed: f_{x} = conj(f_{|x|}) up to FE-killed factors
    return f.conj()


def miller_loop(p, q) -> "Fq12":
    return multi_miller_loop([(p, q)])


def final_exponentiation(f: "Fq12") -> "Fq12":
    """f^((p^12-1)/r): easy part, then the hard part in base-p digits
    (same decomposition as curves/pairing.py:110-129)."""
    f1 = f.conj() * f.inv()
    m = f1.frobenius(2) * f1
    hard = (P**4 - P**2 + 1) // R
    res = Fq12.one()
    i = 0
    while hard:
        res = res * m.pow(hard % P).frobenius(i)
        hard //= P
        i += 1
    return res


def pairing(p, q) -> "Fq12":
    return final_exponentiation(miller_loop(p, q))


def multi_pairing(g1s: List[object], g2s: List[object]) -> "Fq12":
    return final_exponentiation(multi_miller_loop(zip(g1s, g2s)))
