"""Generic Fq2/Fq6/Fq12 tower factory, parameterized by curve constants.

Counterpart of testudo_tpu/fields/tower.py (host code, pure Python ints;
the port keeps its own copy).  The BLS12-377 host tower (fields/host.py) is
specialized for QNR = -5 and XI = u.  This module builds the same tower shape for any BLS12-family
parameter set — used for BLS12-381 (QNR = -1, XI = u + 1), mirroring the
reference's multi-curve wiring (Cargo.toml:24-26: ark-bls12-377,
ark-bls12-381, ark-blst all share one generic `E: Pairing` code path).

Conventions (arkworks 0.4):
  Fq2  = Fq[u] / (u^2 - QNR)
  Fq6  = Fq2[v] / (v^3 - XI)          XI an Fq2 element
  Fq12 = Fq6[w] / (w^2 - v)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


def _tonelli_shanks(x: int, p: int):
    x %= p
    if x == 0:
        return 0
    if pow(x, (p - 1) // 2, p) != 1:
        return None
    q, s = p - 1, 0
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


def make_tower(P: int, QNR: int, XI: Tuple[int, int]):
    """Return (Fq2, Fq6, Fq12) classes for the given parameters."""

    qnr = QNR % P

    class Fq2:
        __slots__ = ("c0", "c1")

        def __init__(self, c0: int, c1: int):
            self.c0 = c0 % P
            self.c1 = c1 % P

        @staticmethod
        def zero():
            return Fq2(0, 0)

        @staticmethod
        def one():
            return Fq2(1, 0)

        def is_zero(self):
            return self.c0 == 0 and self.c1 == 0

        def __add__(self, o):
            return Fq2(self.c0 + o.c0, self.c1 + o.c1)

        def __sub__(self, o):
            return Fq2(self.c0 - o.c0, self.c1 - o.c1)

        def __neg__(self):
            return Fq2(-self.c0, -self.c1)

        def __mul__(self, o):
            t0 = self.c0 * o.c0
            t1 = self.c1 * o.c1
            t2 = (self.c0 + self.c1) * (o.c0 + o.c1) - t0 - t1
            return Fq2(t0 + qnr * t1, t2)

        def mul_scalar(self, s: int):
            return Fq2(self.c0 * s, self.c1 * s)

        def square(self):
            t0 = self.c0 * self.c0
            t1 = self.c1 * self.c1
            return Fq2(t0 + qnr * t1, 2 * self.c0 * self.c1)

        def inv(self):
            norm = (self.c0 * self.c0 - qnr * self.c1 * self.c1) % P
            ninv = pow(norm, -1, P)
            return Fq2(self.c0 * ninv, -self.c1 * ninv)

        def conj(self):
            return Fq2(self.c0, -self.c1)

        def frobenius(self, power: int = 1):
            return Fq2(self.c0, self.c1) if power % 2 == 0 else self.conj()

        def pow(self, e: int):
            res, base = Fq2.one(), self
            while e:
                if e & 1:
                    res = res * base
                base = base.square()
                e >>= 1
            return res

        def sqrt(self):
            if self.is_zero():
                return Fq2.zero()
            a0, a1 = self.c0, self.c1
            if a1 == 0:
                s = _tonelli_shanks(a0, P)
                if s is not None:
                    return Fq2(s, 0)
                s = _tonelli_shanks(a0 * pow(qnr, -1, P) % P, P)
                assert s is not None
                return Fq2(0, s)
            alpha = (a0 * a0 - qnr * a1 * a1) % P
            s = _tonelli_shanks(alpha, P)
            if s is None:
                return None
            two_inv = pow(2, -1, P)
            for delta in ((a0 + s) * two_inv % P, (a0 - s) * two_inv % P):
                x0 = _tonelli_shanks(delta, P)
                if x0 is None or x0 == 0:
                    continue
                x1 = a1 * pow(2 * x0 % P, -1, P) % P
                cand = Fq2(x0, x1)
                if (cand.square() - self).is_zero():
                    return cand
            return None

        def __eq__(self, o):
            return isinstance(o, Fq2) and self.c0 == o.c0 and self.c1 == o.c1

        def __hash__(self):
            return hash((self.c0, self.c1))

        def __repr__(self):
            return f"Fq2({self.c0:#x}, {self.c1:#x})"

    XI2 = Fq2(XI[0], XI[1])

    def _mul_by_xi(a: "Fq2") -> "Fq2":
        return a * XI2

    class Fq6:
        __slots__ = ("c0", "c1", "c2")

        def __init__(self, c0, c1, c2):
            self.c0, self.c1, self.c2 = c0, c1, c2

        @staticmethod
        def zero():
            return Fq6(Fq2.zero(), Fq2.zero(), Fq2.zero())

        @staticmethod
        def one():
            return Fq6(Fq2.one(), Fq2.zero(), Fq2.zero())

        def is_zero(self):
            return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

        def __add__(self, o):
            return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

        def __sub__(self, o):
            return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

        def __neg__(self):
            return Fq6(-self.c0, -self.c1, -self.c2)

        def __mul__(self, o):
            a0, a1, a2 = self.c0, self.c1, self.c2
            b0, b1, b2 = o.c0, o.c1, o.c2
            t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
            c0 = _mul_by_xi((a1 + a2) * (b1 + b2) - t1 - t2) + t0
            c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + _mul_by_xi(t2)
            c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
            return Fq6(c0, c1, c2)

        def square(self):
            return self * self

        def mul_by_fq2(self, s):
            return Fq6(self.c0 * s, self.c1 * s, self.c2 * s)

        def mul_by_nonresidue(self):
            return Fq6(_mul_by_xi(self.c2), self.c0, self.c1)

        def inv(self):
            a0, a1, a2 = self.c0, self.c1, self.c2
            t0 = a0.square() - _mul_by_xi(a1 * a2)
            t1 = _mul_by_xi(a2.square()) - a0 * a1
            t2 = a1.square() - a0 * a2
            t = (_mul_by_xi(a2 * t1 + a1 * t2) + a0 * t0).inv()
            return Fq6(t0 * t, t1 * t, t2 * t)

        def frobenius(self, power: int):
            return Fq6(
                self.c0.frobenius(power),
                self.c1.frobenius(power) * FROB6_C1[power % 6],
                self.c2.frobenius(power) * FROB6_C2[power % 6],
            )

        def __eq__(self, o):
            return (isinstance(o, Fq6) and self.c0 == o.c0
                    and self.c1 == o.c1 and self.c2 == o.c2)

        def __hash__(self):
            return hash((self.c0, self.c1, self.c2))

        def __repr__(self):
            return f"Fq6({self.c0}, {self.c1}, {self.c2})"

    class Fq12:
        __slots__ = ("c0", "c1")

        def __init__(self, c0, c1):
            self.c0, self.c1 = c0, c1

        @staticmethod
        def zero():
            return Fq12(Fq6.zero(), Fq6.zero())

        @staticmethod
        def one():
            return Fq12(Fq6.one(), Fq6.zero())

        def is_one(self):
            return self == Fq12.one()

        def __add__(self, o):
            return Fq12(self.c0 + o.c0, self.c1 + o.c1)

        def __sub__(self, o):
            return Fq12(self.c0 - o.c0, self.c1 - o.c1)

        def __neg__(self):
            return Fq12(-self.c0, -self.c1)

        def __mul__(self, o):
            t0 = self.c0 * o.c0
            t1 = self.c1 * o.c1
            c1 = (self.c0 + self.c1) * (o.c0 + o.c1) - t0 - t1
            return Fq12(t0 + t1.mul_by_nonresidue(), c1)

        def square(self):
            t = self.c0 * self.c1
            c0 = ((self.c0 + self.c1) * (self.c0 + self.c1.mul_by_nonresidue())
                  - t - t.mul_by_nonresidue())
            return Fq12(c0, t + t)

        def inv(self):
            t = (self.c0.square() - self.c1.square().mul_by_nonresidue()).inv()
            return Fq12(self.c0 * t, -(self.c1 * t))

        def conj(self):
            return Fq12(self.c0, -self.c1)

        def frobenius(self, power: int):
            c0 = self.c0.frobenius(power)
            c1 = self.c1.frobenius(power)
            g = FROB12_C1[power % 12]
            return Fq12(c0, Fq6(c1.c0 * g, c1.c1 * g, c1.c2 * g))

        def pow(self, e: int):
            if e < 0:
                return self.inv().pow(-e)
            res, base = Fq12.one(), self
            while e:
                if e & 1:
                    res = res * base
                base = base.square()
                e >>= 1
            return res

        def __eq__(self, o):
            return isinstance(o, Fq12) and self.c0 == o.c0 and self.c1 == o.c1

        def __hash__(self):
            return hash((self.c0, self.c1))

        def __repr__(self):
            return f"Fq12({self.c0}, {self.c1})"

    # Frobenius coefficients: XI^((p^i-1)/3), XI^(2(p^i-1)/3), XI^((p^i-1)/6)
    FROB6_C1 = [Fq2.one()] * 6
    FROB6_C2 = [Fq2.one()] * 6
    FROB12_C1 = [Fq2.one()] * 12
    # XI^e for huge e via the Fq2 multiplicative order p^2 - 1
    order = P * P - 1
    for i in range(1, 6):
        FROB6_C1[i] = XI2.pow(((pow(P, i) - 1) // 3) % order)
        FROB6_C2[i] = XI2.pow((2 * (pow(P, i) - 1) // 3) % order)
    for i in range(1, 12):
        FROB12_C1[i] = XI2.pow(((pow(P, i) - 1) // 6) % order)

    return Fq2, Fq6, Fq12
