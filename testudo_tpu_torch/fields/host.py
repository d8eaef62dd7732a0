"""Host-side (pure Python int) Fq/Fr helpers and Fq2 for BLS12-377.

Counterpart of testudo_tpu/fields/host.py: the base-field helpers and the
part of `Fq2` (u^2 = -5) the G2 curve needs.  Fq6 and Fq12 wait for the
pairing slice.
"""
from __future__ import annotations

from .bls12_377 import FQ2_NONRESIDUE, P, R


def fr(x: int) -> int:
    return x % R


def fq(x: int) -> int:
    return x % P


def fr_inv(x: int) -> int:
    return pow(x, -1, R)


def fq_inv(x: int) -> int:
    return pow(x, -1, P)


def _tonelli_shanks(x: int, p: int):
    """Square root mod prime p, or None if x is a non-residue."""
    x %= p
    if x == 0:
        return 0
    if pow(x, (p - 1) // 2, p) != 1:
        return None
    q = p - 1
    s = 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, rr = s, pow(z, q, p), pow(x, q, p), pow(x, (q + 1) // 2, p)
    while t != 1:
        t2i, i = t, 0
        while t2i != 1:
            t2i = t2i * t2i % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t, rr = t * c % p, rr * b % p
    return rr


def fq_sqrt(x: int):
    """Square root in Fq, or None (p = 1 mod 2^46: Tonelli-Shanks)."""
    return _tonelli_shanks(x, P)


# ---------------------------------------------------------------------------
# Fq2 = Fq[u] / (u^2 - QNR), QNR = -5
# ---------------------------------------------------------------------------

_QNR = FQ2_NONRESIDUE


class Fq2:
    """c0 + c1 u with u^2 = -5; components are ints reduced mod p."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        self.c0 = c0 % P
        self.c1 = c1 % P

    @staticmethod
    def zero() -> "Fq2":
        return Fq2(0, 0)

    @staticmethod
    def one() -> "Fq2":
        return Fq2(1, 0)

    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def __add__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fq2":
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o: "Fq2") -> "Fq2":
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        # a0 b1 + a1 b0 by Karatsuba
        t2 = (a0 + a1) * (b0 + b1) - t0 - t1
        return Fq2(t0 + _QNR * t1, t2)

    def mul_scalar(self, s: int) -> "Fq2":
        return Fq2(self.c0 * s, self.c1 * s)

    def square(self) -> "Fq2":
        a0, a1 = self.c0, self.c1
        return Fq2(a0 * a0 + _QNR * a1 * a1, 2 * a0 * a1)

    def inv(self) -> "Fq2":
        a0, a1 = self.c0, self.c1
        ninv = pow((a0 * a0 - _QNR * a1 * a1) % P, -1, P)
        return Fq2(a0 * ninv, -a1 * ninv)

    def sqrt(self):
        """Square root in Fq2 (complex method), or None.  The generator
        search of curves/host_curve.py needs it."""
        if self.is_zero():
            return Fq2.zero()
        a0, a1 = self.c0, self.c1
        if a1 == 0:
            s = fq_sqrt(a0)
            if s is not None:
                return Fq2(s, 0)
            # sqrt(a0) = u * sqrt(a0 / qnr)
            s = fq_sqrt(a0 * pow(_QNR, -1, P) % P)
            assert s is not None
            return Fq2(0, s)
        # the norm a0^2 - qnr a1^2 must be a square in Fq
        s = fq_sqrt((a0 * a0 - _QNR * a1 * a1) % P)
        if s is None:
            return None
        two_inv = pow(2, -1, P)
        x0 = fq_sqrt((a0 + s) * two_inv % P)
        if x0 is None:
            x0 = fq_sqrt((a0 - s) * two_inv % P)
            if x0 is None:
                return None
        cand = Fq2(x0, a1 * pow(2 * x0 % P, -1, P) % P)
        if (cand.square() - self).is_zero():
            return cand
        return None

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __repr__(self):
        return f"Fq2({self.c0:#x}, {self.c1:#x})"
