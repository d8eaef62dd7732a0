"""Host-side BW6-761: G1/G2 arithmetic, Fq6 tower, Tate pairing.

Counterpart of testudo_tpu/curves/bw6_761.py.  The outer curve of the
one-layer recursion (fields/bw6_761.py): its scalar field is BLS12-377's Fq,
so Groth16 over this curve proves the Fq-native TestudoCommVerifier circuit
(core/circuit_verifier.py, core/groth16_bw6.py).

Embedding degree 6: both G1 (y^2 = x^3 - 1) and the sextic M-twist G2
(y^2 = x^3 + 4) live over Fq, and GT sits in Fq6 = Fq[w]/(w^6 + 4).
The pairing is the reduced TATE pairing, one r-length Miller loop: simple
and right, for the host verification path (a Groth16 verify is one 4-pair
multi-pairing).  Plain Python, the oracle the device group is held against.
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

from ..fields.bw6_761 import B1, B2, H1, H2, Q, R, XI
from ..fields.host import _tonelli_shanks

# ---------------------------------------------------------------------------
# Fq6 = Fq[w] / (w^6 - XI), XI = -4 (direct sextic extension)
# ---------------------------------------------------------------------------


_FROB_G = pow(XI, (Q - 1) // 6, Q)


class Fq6:
    __slots__ = ("c",)

    def __init__(self, c):
        self.c = tuple(x % Q for x in c)
        assert len(self.c) == 6

    @staticmethod
    def zero():
        return Fq6((0,) * 6)

    @staticmethod
    def one():
        return Fq6((1, 0, 0, 0, 0, 0))

    @staticmethod
    def from_fq(x: int):
        return Fq6((x, 0, 0, 0, 0, 0))

    def is_zero(self):
        return all(x == 0 for x in self.c)

    def __add__(self, o):
        return Fq6(tuple(a + b for a, b in zip(self.c, o.c)))

    def __sub__(self, o):
        return Fq6(tuple(a - b for a, b in zip(self.c, o.c)))

    def __neg__(self):
        return Fq6(tuple(-a for a in self.c))

    def __mul__(self, o):
        prod = [0] * 11
        for i, a in enumerate(self.c):
            if a == 0:
                continue
            for j, b in enumerate(o.c):
                prod[i + j] += a * b
        out = list(prod[:6])
        for k in range(6, 11):
            out[k - 6] += prod[k] * XI
        return Fq6(tuple(out))

    def mul_fq(self, s: int):
        return Fq6(tuple(a * s for a in self.c))

    def square(self):
        return self * self

    def pow(self, e: int):
        if e < 0:
            return self.inv().pow(-e)
        res, base = Fq6.one(), self
        while e:
            if e & 1:
                res = res * base
            base = base.square()
            e >>= 1
        return res

    def inv(self):
        """a^{-1} = (prod_{k=1..5} frob^k(a)) / Norm(a), Norm in Fq."""
        conj = Fq6.one()
        for k in range(1, 6):
            conj = conj * self.frobenius(k)
        norm = self * conj
        assert all(x == 0 for x in norm.c[1:]), "norm not in Fq"
        return conj.mul_fq(pow(norm.c[0], -1, Q))

    def frobenius(self, power: int = 1):
        # w^q = XI^((q-1)/6) * w =: g*w with g in Fq (a 6th root of unity),
        # so frob^k scales coefficient i by g^(k*i).
        gp = pow(_FROB_G, power % 6, Q)
        return Fq6(tuple(self.c[i] * pow(gp, i, Q) % Q for i in range(6)))

    def conj3(self):
        """Frobenius^3 (the 'conjugation' of the quadratic subextension)."""
        return self.frobenius(3)

    def __eq__(self, o):
        return isinstance(o, Fq6) and self.c == o.c

    def __hash__(self):
        return hash(self.c)

    def __repr__(self):
        return f"Fq6_761({self.c})"


# ---------------------------------------------------------------------------
# Group ops (affine, both groups over Fq)
# ---------------------------------------------------------------------------


def _add(b, p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % Q == 0:
            return None
        return _double(b, p1)
    lam = (y2 - y1) * pow(x2 - x1, -1, Q) % Q
    x3 = (lam * lam - x1 - x2) % Q
    return (x3, (lam * (x1 - x3) - y1) % Q)


def _double(b, p):
    if p is None:
        return None
    x, y = p
    if y == 0:
        return None
    lam = 3 * x * x * pow(2 * y, -1, Q) % Q
    x3 = (lam * lam - 2 * x) % Q
    return (x3, (lam * (x - x3) - y) % Q)


def _neg(p):
    return None if p is None else (p[0], (-p[1]) % Q)


def _mul(b, p, k: int):
    if k < 0:
        return _mul(b, _neg(p), -k)
    res, add = None, p
    while k:
        if k & 1:
            res = _add(b, res, add)
        add = _add(b, add, add)
        k >>= 1
    return res


def _on_curve(b, p):
    if p is None:
        return True
    x, y = p
    return y * y % Q == (x * x * x + b) % Q


def g1_add(p1, p2):
    return _add(B1, p1, p2)


def g1_neg(p):
    return _neg(p)


def g1_mul(p, k):
    return _mul(B1, p, k)


def g1_is_on_curve(p):
    return _on_curve(B1, p)


def g2_add(p1, p2):
    return _add(B2, p1, p2)


def g2_neg(p):
    return _neg(p)


def g2_mul(p, k):
    return _mul(B2, p, k)


def g2_is_on_curve(p):
    return _on_curve(B2, p)


def _find_generator(b, cofactor):
    x = 1
    while True:
        rhs = (x * x * x + b) % Q
        y = _tonelli_shanks(rhs, Q)
        if y is not None and y != 0:
            pt = _mul(b, (x, min(y, Q - y)), cofactor)
            if pt is not None and _mul(b, pt, R) is None:
                return pt
        x += 1


_G1_GEN = None
_G2_GEN = None


def g1_generator():
    global _G1_GEN
    if _G1_GEN is None:
        _G1_GEN = _find_generator(B1, H1)
    return _G1_GEN


def g2_generator():
    global _G2_GEN
    if _G2_GEN is None:
        _G2_GEN = _find_generator(B2, H2)
    return _G2_GEN


# ---------------------------------------------------------------------------
# Tate pairing
# ---------------------------------------------------------------------------
# Untwist psi: E'(Fq) -> E(Fq6): (x', y') -> (x'/w^2, y'/w^3), w^6 = XI.
# Lines are evaluated at psi(Q) with the Fq-proportional scaling dropped
# (killed by the final exponentiation).


def _sparse_psi_line(lam: int, c0: int, xq: int, yq: int) -> Fq6:
    """l = -XI*c0 + yq*w^3 - lam*xq*w^4  (the line Y - lam*X - c0 through
    the Miller points of G1, evaluated at psi(Q) and scaled by XI in Fq)."""
    c = [0] * 6
    c[0] = (-XI * c0) % Q
    c[3] = yq
    c[4] = (-lam * xq) % Q
    return Fq6(tuple(c))


def miller_loop_tate(p, q2) -> Fq6:
    """f_{r,P}(psi(Q)) for P in G1, Q in G2' (both affine over Fq)."""
    if p is None or q2 is None:
        return Fq6.one()
    xq, yq = q2
    f = Fq6.one()
    t = p
    for bit in bin(R)[3:]:
        # double step
        (xt, yt) = t
        lam = 3 * xt * xt * pow(2 * yt, -1, Q) % Q
        c0 = (yt - lam * xt) % Q
        x3 = (lam * lam - 2 * xt) % Q
        t = (x3, (lam * (xt - x3) - yt) % Q)
        f = f.square() * _sparse_psi_line(lam, c0, xq, yq)
        if bit == "1":
            (xt, yt) = t
            if xt == p[0]:
                # adding P to (r-1)P etc: vertical line, handled by FE
                t = _add(B1, t, p)
                continue
            lam = (p[1] - yt) * pow(p[0] - xt, -1, Q) % Q
            c0 = (yt - lam * xt) % Q
            x3 = (lam * lam - xt - p[0]) % Q
            t = (x3, (lam * (xt - x3) - yt) % Q)
            f = f * _sparse_psi_line(lam, c0, xq, yq)
    return f


def final_exponentiation(f: Fq6) -> Fq6:
    """f^((q^6-1)/r) = easy (q^3-1)(q+1), then (q^2-q+1)/r in base-q
    digits (the same decomposition as curves/pairing.py)."""
    f1 = f.frobenius(3) * f.inv()
    f2 = f1.frobenius(1) * f1
    hard = (Q * Q - Q + 1) // R
    res = Fq6.one()
    m = f2
    i = 0
    while hard:
        res = res * m.pow(hard % Q).frobenius(i)
        hard //= Q
        i += 1
    return res


def pairing(p, q2) -> Fq6:
    return final_exponentiation(miller_loop_tate(p, q2))


def multi_pairing(g1s: List[object], g2s: List[object]) -> Fq6:
    f = Fq6.one()
    for p, q2 in zip(g1s, g2s):
        if p is None or q2 is None:
            continue
        f = f * miller_loop_tate(p, q2)
    return final_exponentiation(f)
