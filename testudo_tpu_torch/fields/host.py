"""Host-side (pure Python int) field arithmetic for BLS12-377.

Counterpart of testudo_tpu/fields/host.py: the base-field helpers, `Fq2`
(u^2 = -5), and the tower above it the pairing needs: Fq6 = Fq2[v] / (v^3 - u),
Fq12 = Fq6[w] / (w^2 - v), with their Frobenius tables.
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


def fr_sqrt(x: int):
    """Square root in Fr, or None (r = 1 mod 2^47: Tonelli-Shanks)."""
    return _tonelli_shanks(x, R)


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

    def conj(self) -> "Fq2":
        return Fq2(self.c0, -self.c1)

    def mul_by_nonresidue(self) -> "Fq2":
        """Multiply by XI = u (the Fq6 cubic nonresidue)."""
        # (c0 + c1 u) * u = qnr*c1 + c0 u
        return Fq2(_QNR * self.c1, self.c0)

    def frobenius(self, power: int = 1) -> "Fq2":
        if power % 2 == 0:
            return Fq2(self.c0, self.c1)
        return self.conj()

    def pow(self, e: int) -> "Fq2":
        res, base = Fq2.one(), self
        while e:
            if e & 1:
                res = res * base
            base = base.square()
            e >>= 1
        return res

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


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v] / (v^3 - XI), XI = u
# ---------------------------------------------------------------------------


class Fq6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @staticmethod
    def zero() -> "Fq6":
        return Fq6(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @staticmethod
    def one() -> "Fq6":
        return Fq6(Fq2.one(), Fq2.zero(), Fq2.zero())

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __add__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self) -> "Fq6":
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o: "Fq6") -> "Fq6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        # Toom/Karatsuba style
        c0 = ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_nonresidue() + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_nonresidue()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def square(self) -> "Fq6":
        return self * self

    def mul_by_fq2(self, s: Fq2) -> "Fq6":
        return Fq6(self.c0 * s, self.c1 * s, self.c2 * s)

    def mul_by_nonresidue(self) -> "Fq6":
        """Multiply by v (for the Fq12 tower)."""
        return Fq6(self.c2.mul_by_nonresidue(), self.c0, self.c1)

    def inv(self) -> "Fq6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - (a1 * a2).mul_by_nonresidue()
        t1 = a2.square().mul_by_nonresidue() - a0 * a1
        t2 = a1.square() - a0 * a2
        t = ((a2 * t1 + a1 * t2).mul_by_nonresidue() + a0 * t0).inv()
        return Fq6(t0 * t, t1 * t, t2 * t)

    def frobenius(self, power: int) -> "Fq6":
        c0 = self.c0.frobenius(power)
        c1 = self.c1.frobenius(power) * FROB6_C1[power % 6]
        c2 = self.c2.frobenius(power) * FROB6_C2[power % 6]
        return Fq6(c0, c1, c2)

    def __eq__(self, o) -> bool:
        return (
            isinstance(o, Fq6)
            and self.c0 == o.c0
            and self.c1 == o.c1
            and self.c2 == o.c2
        )

    def __hash__(self):
        return hash((self.c0, self.c1, self.c2))

    def __repr__(self):
        return f"Fq6({self.c0}, {self.c1}, {self.c2})"


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w] / (w^2 - v)
# ---------------------------------------------------------------------------


class Fq12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    @staticmethod
    def zero() -> "Fq12":
        return Fq12(Fq6.zero(), Fq6.zero())

    @staticmethod
    def one() -> "Fq12":
        return Fq12(Fq6.one(), Fq6.zero())

    def is_one(self) -> bool:
        return self == Fq12.one()

    def __add__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fq12":
        return Fq12(-self.c0, -self.c1)

    def __mul__(self, o: "Fq12") -> "Fq12":
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1
        return Fq12(t0 + t1.mul_by_nonresidue(), c1)

    def square(self) -> "Fq12":
        a0, a1 = self.c0, self.c1
        # complex squaring: (a0 + a1 w)^2
        t = a0 * a1
        c0 = (a0 + a1) * (a0 + a1.mul_by_nonresidue()) - t - t.mul_by_nonresidue()
        return Fq12(c0, t + t)

    def inv(self) -> "Fq12":
        a0, a1 = self.c0, self.c1
        t = (a0.square() - a1.square().mul_by_nonresidue()).inv()
        return Fq12(a0 * t, -(a1 * t))

    def conj(self) -> "Fq12":
        """Conjugation = Frobenius^6 (inverse for cyclotomic elements)."""
        return Fq12(self.c0, -self.c1)

    def frobenius(self, power: int) -> "Fq12":
        c0 = self.c0.frobenius(power)
        c1 = self.c1.frobenius(power)
        c1 = Fq6(
            c1.c0 * FROB12_C1[power % 12],
            c1.c1 * FROB12_C1[power % 12],
            c1.c2 * FROB12_C1[power % 12],
        )
        return Fq12(c0, c1)

    def pow(self, e: int) -> "Fq12":
        if e < 0:
            return self.inv().pow(-e)
        res, base = Fq12.one(), self
        while e:
            if e & 1:
                res = res * base
            base = base.square()
            e >>= 1
        return res

    def cyclotomic_square(self) -> "Fq12":
        # For elements in the cyclotomic subgroup Granger-Scott squaring could
        # be used; plain squaring keeps the host reference simple.
        return self.square()

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq12) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __repr__(self):
        return f"Fq12({self.c0}, {self.c1})"


# ---------------------------------------------------------------------------
# Frobenius coefficients (computed once at import)
# ---------------------------------------------------------------------------
# XI = u; Frobenius on Fq6: c1 -> c1^p * XI^((p-1)/3), c2 -> c2^p * XI^(2(p-1)/3)
# Frobenius on Fq12: c1 scaled by XI^((p-1)/6).
# XI^k for Fq2 XI=u: u^(2m) = QNR^m, u^(2m+1) = QNR^m * u.


def _xi_pow(e: int) -> Fq2:
    """Compute XI^e = u^e in Fq2."""
    m, rbit = divmod(e, 2)
    base = pow(_QNR, m, P)
    if rbit:
        return Fq2(0, base)
    return Fq2(base, 0)


def _frob_coeffs():
    frob6_c1 = [Fq2.one()] * 6
    frob6_c2 = [Fq2.one()] * 6
    frob12_c1 = [Fq2.one()] * 12
    for i in range(1, 6):
        # XI^((p^i - 1)/3): p^i = 1 mod 3? (p-1) divisible by 3; use exponent
        frob6_c1[i] = _xi_pow_big((pow(P, i) - 1) // 3)
        frob6_c2[i] = _xi_pow_big(2 * (pow(P, i) - 1) // 3)
    for i in range(1, 12):
        frob12_c1[i] = _xi_pow_big((pow(P, i) - 1) // 6)
    return frob6_c1, frob6_c2, frob12_c1


def _xi_pow_big(e: int) -> Fq2:
    """XI^e in Fq2 for big e: XI = u, u^2 = QNR, so reduce via the order."""
    # u has multiplicative order dividing 2*(p-1) in Fq2*; compute directly:
    # u^e: split e = 2m + b, u^e = QNR^m * u^b with QNR^m computed mod p
    m, b = divmod(e, 2)
    base = pow(_QNR, m % (P - 1), P)
    if b:
        return Fq2(0, base)
    return Fq2(base, 0)


FROB6_C1, FROB6_C2, FROB12_C1 = _frob_coeffs()
