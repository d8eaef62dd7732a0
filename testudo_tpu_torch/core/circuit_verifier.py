"""In-circuit sqrt-PST opening verifier over Fq (TestudoCommVerifier).

Counterpart of testudo_tpu/core/circuit_verifier.py (itself of the Testudo
fork's src/circuit_verifier.rs:133-564), host Python over the port's
core/circuit.py, constraint for constraint and in the same order of
allocation, so both packages build equal systems.  A constraint system over
E::BaseField = Fq that verifies a complete sqrt-PST opening — the full
MIPP transcript replay, T/U challenge folds, the p_h PST(G2) check, the
final pairing checks, and the outer PST check at the row point — so the
whole opening can be wrapped in Groth16 over BW6-761 (whose scalar field
is this Fq), mirroring the fork's one-level-recursion plan.

Design deltas vs the reference gadget (each a strengthening):

  - circuit_verifier.rs:390-447 replays transcript absorbs with native
    `.value().unwrap()` round-trips (unsound constraints).  Here every
    absorbed byte stream (uncompressed G1 / GT serialization,
    poseidon_transcript.rs:22-28) is assembled in-circuit from bit
    decompositions, so the Poseidon replay is constrained end to end.
  - The reference checks pairings with ark's in-circuit Miller/final-exp
    gadgets (check_2_gadget :175-243, check_gadget :245-314).  Here Miller
    loops run in-circuit, but the final exponentiation FE(f) = f^e with
    e = (p^12-1)/r is replaced by the residue-witness equivalence
        FE(f) == y   <=>   f == y^alpha * c^r   for a witness c,
    where alpha = e^(-1) mod r (exists: gcd(e, r) = 1 for BLS12-377).
    Soundness: c^(r*e) = c^(p^12-1) = 1, so f^e = y^(alpha*e) = y^(1+kr)
    = y for y in the order-r subgroup GT.  Completeness: the prover sets
    c = (f * y^(-alpha))^(r^(-1) mod M), M = (p^12-1)/r.  This is the
    "On Proving Pairings" residue-check style and costs ~6x fewer
    constraints than an in-circuit final exponentiation.
  - Fr relations (challenge inversion c = c_inv^(-1), the final_y and
    p_h(rs) products — nonnative arithmetic in an Fq circuit) are enforced
    by an exact integer identity a*b = c + k*r checked in two coprime
    moduli (p and 2^140) over bit decompositions.

Range checking: Fq bit decompositions that feed transcript absorbs or
challenge derivation are range-checked < p (enforce_bits_lt_constant), so
byte streams are canonical.  Nonnative Fr decompositions are deliberately
NOT range-checked: all groups here have order r, so a shifted k + r
witness scalar produces identical folds, and the CRT product identities
only constrain values mod r.  Known caveat: scalar-multiplication ladders
use incomplete affine formulas with a fixed offset point (degenerate
intermediate collisions are cryptographically negligible and asserted at
synthesis).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

from ..fields.bls12_377 import P, R, X_SEED
from ..fields.host import Fq2, Fq6, Fq12
from ..curves import host_curve as hc
from ..curves import pairing as pr
from . import pst
from .circuit import ConstraintSystem, FVar, PoseidonSpongeGadget

QNR = P - 5  # Fq2 = Fq[u]/(u^2 - QNR), fields/host.py:79

# residue-check exponents
_E_HARD = (P**12 - 1) // R
ALPHA = pow(_E_HARD, -1, R)


@lru_cache(maxsize=None)
def _rth_root_exp() -> int:
    """r^(-1) mod M with M = (p^12-1)/r — the r-th-root exponent in the
    subgroup of r-th power residues."""
    return pow(R, -1, _E_HARD)


# ---------------------------------------------------------------------------
# bit gadgets
# ---------------------------------------------------------------------------


def to_bits_le(cs: ConstraintSystem, v: FVar, nbits: int,
               lt_bound: Optional[int] = None) -> List[FVar]:
    """Decompose v into nbits little-endian boolean vars (booleanity +
    recomposition enforced).  With `lt_bound`, additionally enforce that
    the decomposed integer is < lt_bound — REQUIRED for canonicity when
    the bits feed a transcript absorb: for most v < p the shifted
    representation v + p also fits in 377 bits, so without the range
    check a malicious prover could absorb a different byte stream."""
    val = v.value
    assert val < (1 << nbits), "value exceeds bit width"
    bits = []
    for i in range(nbits):
        b = cs.alloc_witness((val >> i) & 1)
        cs.enforce(b, 1 - b, cs.constant(0))
        bits.append(b)
    cs.enforce_equal(bits_lc(cs, bits), v)
    if lt_bound is not None:
        enforce_bits_lt_constant(cs, bits, lt_bound)
    return bits


def enforce_bits_lt_constant(cs: ConstraintSystem, bits: Sequence[FVar],
                             bound: int) -> None:
    """Enforce int(bits, LE) < bound for a constant bound (MSB-first
    comparison; ~1 multiplication constraint per bit).

    Invariants maintained over the MSB->LSB walk: `eq` == 1 iff every bit
    inspected so far equals bound's bit; `lt` == 1 iff the value is
    already strictly below bound at some inspected position.  The final
    check is lt == 1 (eq surviving to the end means value == bound)."""
    one = cs.constant(1)
    eq = one
    lt = cs.constant(0)
    for i in reversed(range(len(bits))):
        b = bits[i]
        if (bound >> i) & 1:
            eq_b = cs.mul(eq, b)  # eq AND b
            lt = lt + eq - eq_b   # lt OR (eq AND NOT b): disjoint events
            eq = eq_b
        else:
            eq = cs.mul(eq, one - b)  # a 1-bit where bound has 0 kills eq
    cs.enforce_equal(lt, one)


def bits_lc(cs: ConstraintSystem, bits: Sequence[FVar], lo: int = 0,
            hi: Optional[int] = None) -> FVar:
    """Linear combination sum bits[lo:hi] * 2^(i-lo) (no constraints)."""
    hi = len(bits) if hi is None else hi
    return cs.lincomb([(1 << (i - lo), bits[i]) for i in range(lo, hi)])


def alloc_bits(cs: ConstraintSystem, value: int, nbits: int) -> List[FVar]:
    """Allocate a fresh value as boolean vars (booleanity enforced)."""
    assert 0 <= value < (1 << nbits)
    bits = []
    for i in range(nbits):
        b = cs.alloc_witness((value >> i) & 1)
        cs.enforce(b, 1 - b, cs.constant(0))
        bits.append(b)
    return bits


# ---------------------------------------------------------------------------
# nonnative Fr arithmetic (bits + CRT integer identity, T = 2^140)
# ---------------------------------------------------------------------------

_T = 140
_TMASK = (1 << _T) - 1


@dataclass
class FrVar:
    """A nonnative Fr value: 253 LE boolean vars + the tracked value."""

    bits: List[FVar]
    value: int
    _lc: FVar = None
    _lo_lc: FVar = None

    def lc(self, cs) -> FVar:
        if self._lc is None:
            self._lc = bits_lc(cs, self.bits)
        return self._lc

    def lo_lc(self, cs) -> FVar:
        if self._lo_lc is None:
            self._lo_lc = bits_lc(cs, self.bits[:_T])
        return self._lo_lc


def fr_alloc(cs: ConstraintSystem, value: int) -> FrVar:
    return FrVar(alloc_bits(cs, value % R, 253), value % R)


def _fr_bind_product(cs, a: FrVar, b, c_lc, c_lo_lc, c_val, add_const: int = 0):
    """Enforce a*b + add_const == c + k*R over the integers (b an FrVar or
    an int constant), via the mod-p and mod-2^T residues."""
    b_val = b if isinstance(b, int) else b.value
    total = a.value * b_val + add_const
    k_val = total // R
    assert total % R == c_val
    k_bits = alloc_bits(cs, k_val, 254)
    k_lc = bits_lc(cs, k_bits)
    k_lo = bits_lc(cs, k_bits[:_T])
    a_lc, a_lo = a.lc(cs), a.lo_lc(cs)

    # mod p: a*b + add == c + k*R  (all operands < p-sized LCs; the field
    # equation is the first CRT residue)
    if isinstance(b, int):
        cs.enforce(a_lc * (b % P) + (add_const % P),
                   cs.constant(1), c_lc + k_lc * (R % P))
        w1 = a_lo * (b & _TMASK) + (add_const & _TMASK)
        w1_val = (a.value & _TMASK) * (b & _TMASK) + (add_const & _TMASK)
    else:
        cs.enforce(a_lc, b.lc(cs), c_lc + k_lc * (R % P) - (add_const % P))
        w1 = cs.mul(a_lo, b.lo_lc(cs)) + (add_const & _TMASK)
        w1_val = ((a.value & _TMASK) * (b.value & _TMASK)
                  + (add_const & _TMASK))
    # mod 2^T: low parts agree up to a multiple of 2^T
    w2 = c_lo_lc + k_lo * (R & _TMASK)
    w2_val = (c_val & _TMASK) + (k_val & _TMASK) * (R & _TMASK)
    off = 1 << (2 * _T + 4)
    dd_val = (w1_val - w2_val + off) >> _T
    dd_bits = alloc_bits(cs, dd_val, _T + 6)
    cs.enforce_equal(bits_lc(cs, dd_bits) * (1 << _T), w1 - w2 + off)


def fr_mul(cs: ConstraintSystem, a: FrVar, b, add_const: int = 0) -> FrVar:
    """(a * b + add_const) mod r, b an FrVar or int constant."""
    b_val = b if isinstance(b, int) else b.value
    c_val = (a.value * b_val + add_const) % R
    c = fr_alloc(cs, c_val)
    _fr_bind_product(cs, a, b, c.lc(cs), c.lo_lc(cs), c_val, add_const)
    return c


def fr_mul_check_one(cs: ConstraintSystem, a: FrVar, b: FrVar) -> None:
    """Enforce a*b == 1 (mod r) — the challenge-inverse binding."""
    _fr_bind_product(cs, a, b, cs.constant(1), cs.constant(1), 1)


def fr_inverse(cs: ConstraintSystem, a: FrVar) -> FrVar:
    inv = fr_alloc(cs, pow(a.value, -1, R))
    fr_mul_check_one(cs, a, inv)
    return inv


def fr_lincomb(cs: ConstraintSystem, const: int,
               terms: List[Tuple[int, FrVar]]) -> FrVar:
    """(const + sum coef*term) mod r with nonnegative int coefs < r."""
    total = const + sum(co * t.value for co, t in terms)
    c_val = total % R
    k_val = total // R
    c = fr_alloc(cs, c_val)
    k_bits = alloc_bits(cs, k_val, 256)
    k_lc, k_lo = bits_lc(cs, k_bits), bits_lc(cs, k_bits[:_T])
    # mod p
    e_lc = cs.constant(const % P)
    for co, t in terms:
        e_lc = e_lc + t.lc(cs) * (co % P)
    cs.enforce_equal(e_lc, c.lc(cs) + k_lc * (R % P))
    # mod 2^T
    w1 = cs.constant(const & _TMASK)
    w1_val = const & _TMASK
    for co, t in terms:
        w1 = w1 + t.lo_lc(cs) * (co & _TMASK)
        w1_val += (co & _TMASK) * (t.value & _TMASK)
    w2 = c.lo_lc(cs) + k_lo * (R & _TMASK)
    w2_val = (c_val & _TMASK) + (k_val & _TMASK) * (R & _TMASK)
    off = 1 << (2 * _T + 8)
    dd_val = (w1_val - w2_val + off) >> _T
    dd_bits = alloc_bits(cs, dd_val, _T + 10)
    cs.enforce_equal(bits_lc(cs, dd_bits) * (1 << _T), w1 - w2 + off)
    return c


# ---------------------------------------------------------------------------
# tower gadgets (formulas mirror fields/host.py)
# ---------------------------------------------------------------------------


@dataclass
class Fq2Var:
    c0: FVar
    c1: FVar

    @staticmethod
    def alloc(cs, v: Fq2) -> "Fq2Var":
        return Fq2Var(cs.alloc_witness(v.c0), cs.alloc_witness(v.c1))

    @staticmethod
    def constant(cs, v: Fq2) -> "Fq2Var":
        return Fq2Var(cs.constant(v.c0), cs.constant(v.c1))

    def value(self) -> Fq2:
        return Fq2(self.c0.value, self.c1.value)

    def add(self, o):
        return Fq2Var(self.c0 + o.c0, self.c1 + o.c1)

    def sub(self, o):
        return Fq2Var(self.c0 - o.c0, self.c1 - o.c1)

    def neg(self):
        return Fq2Var(self.c0 * (P - 1), self.c1 * (P - 1))

    def mul(self, cs, o) -> "Fq2Var":
        t0 = cs.mul(self.c0, o.c0)
        t1 = cs.mul(self.c1, o.c1)
        t2 = cs.mul(self.c0 + self.c1, o.c0 + o.c1)
        return Fq2Var(t0 + t1 * QNR, t2 - t0 - t1)

    def sqr(self, cs) -> "Fq2Var":
        t0 = cs.mul(self.c0, self.c0)
        t1 = cs.mul(self.c1, self.c1)
        cross = cs.mul(self.c0, self.c1)
        return Fq2Var(t0 + t1 * QNR, cross + cross)

    def mul_fq(self, cs, s: FVar) -> "Fq2Var":
        return Fq2Var(cs.mul(self.c0, s), cs.mul(self.c1, s))

    def mul_int(self, k: int) -> "Fq2Var":
        return Fq2Var(self.c0 * k, self.c1 * k)

    def inv_hint(self, cs) -> "Fq2Var":
        v = self.value().inv()
        out = Fq2Var.alloc(cs, v)
        prod = self.mul(cs, out)
        cs.enforce_equal(prod.c0, cs.constant(1))
        cs.enforce_equal(prod.c1, cs.constant(0))
        return out

    def mul_nonresidue(self) -> "Fq2Var":
        return Fq2Var(self.c1 * QNR, self.c0)

    def select(self, cs, bit: FVar, other: "Fq2Var") -> "Fq2Var":
        """bit ? self : other"""
        return Fq2Var(
            other.c0 + cs.mul(bit, self.c0 - other.c0),
            other.c1 + cs.mul(bit, self.c1 - other.c1),
        )


@dataclass
class Fq6Var:
    c0: Fq2Var
    c1: Fq2Var
    c2: Fq2Var

    @staticmethod
    def alloc(cs, v: Fq6) -> "Fq6Var":
        return Fq6Var(*(Fq2Var.alloc(cs, c) for c in (v.c0, v.c1, v.c2)))

    @staticmethod
    def constant(cs, v: Fq6) -> "Fq6Var":
        return Fq6Var(*(Fq2Var.constant(cs, c) for c in (v.c0, v.c1, v.c2)))

    def value(self) -> Fq6:
        return Fq6(self.c0.value(), self.c1.value(), self.c2.value())

    def add(self, o):
        return Fq6Var(self.c0.add(o.c0), self.c1.add(o.c1), self.c2.add(o.c2))

    def sub(self, o):
        return Fq6Var(self.c0.sub(o.c0), self.c1.sub(o.c1), self.c2.sub(o.c2))

    def mul(self, cs, o) -> "Fq6Var":
        t0 = self.c0.mul(cs, o.c0)
        t1 = self.c1.mul(cs, o.c1)
        t2 = self.c2.mul(cs, o.c2)
        c0 = (self.c1.add(self.c2).mul(cs, o.c1.add(o.c2))
              .sub(t1).sub(t2).mul_nonresidue().add(t0))
        c1 = (self.c0.add(self.c1).mul(cs, o.c0.add(o.c1))
              .sub(t0).sub(t1).add(t2.mul_nonresidue()))
        c2 = (self.c0.add(self.c2).mul(cs, o.c0.add(o.c2))
              .sub(t0).sub(t2).add(t1))
        return Fq6Var(c0, c1, c2)

    def mul_nonresidue(self) -> "Fq6Var":
        return Fq6Var(self.c2.mul_nonresidue(), self.c0, self.c1)

    def select(self, cs, bit, other):
        return Fq6Var(
            self.c0.select(cs, bit, other.c0),
            self.c1.select(cs, bit, other.c1),
            self.c2.select(cs, bit, other.c2),
        )


@dataclass
class Fq12Var:
    c0: Fq6Var
    c1: Fq6Var

    @staticmethod
    def alloc(cs, v: Fq12) -> "Fq12Var":
        return Fq12Var(Fq6Var.alloc(cs, v.c0), Fq6Var.alloc(cs, v.c1))

    @staticmethod
    def constant(cs, v: Fq12) -> "Fq12Var":
        return Fq12Var(Fq6Var.constant(cs, v.c0), Fq6Var.constant(cs, v.c1))

    @staticmethod
    def one(cs) -> "Fq12Var":
        return Fq12Var.constant(cs, Fq12.one())

    def value(self) -> Fq12:
        return Fq12(self.c0.value(), self.c1.value())

    def coords(self) -> List[FVar]:
        out = []
        for six in (self.c0, self.c1):
            for two in (six.c0, six.c1, six.c2):
                out.extend([two.c0, two.c1])
        return out

    def mul(self, cs, o) -> "Fq12Var":
        t0 = self.c0.mul(cs, o.c0)
        t1 = self.c1.mul(cs, o.c1)
        c1 = self.c0.add(self.c1).mul(cs, o.c0.add(o.c1)).sub(t0).sub(t1)
        return Fq12Var(t0.add(t1.mul_nonresidue()), c1)

    def sqr(self, cs) -> "Fq12Var":
        t = self.c0.mul(cs, self.c1)
        c0 = (self.c0.add(self.c1)
              .mul(cs, self.c0.add(self.c1.mul_nonresidue()))
              .sub(t).sub(t.mul_nonresidue()))
        return Fq12Var(c0, t.add(t))

    def select(self, cs, bit, other):
        return Fq12Var(self.c0.select(cs, bit, other.c0),
                       self.c1.select(cs, bit, other.c1))

    def enforce_equal(self, cs, o) -> None:
        for a, b in zip(self.coords(), o.coords()):
            cs.enforce_equal(a, b)


def fq12_pow_bits(cs, base: Fq12Var, bits: List[FVar]) -> Fq12Var:
    """Uniform MSB-first square-and-select-multiply ladder."""
    acc = Fq12Var.one(cs)
    for b in reversed(bits):
        acc = acc.sqr(cs)
        t = acc.mul(cs, base)
        acc = t.select(cs, b, acc)
    return acc


def fq12_pow_const(cs, base: Fq12Var, e: int) -> Fq12Var:
    """Fixed-exponent pow (no selects)."""
    assert e > 0
    acc = base
    for bit in bin(e)[3:]:
        acc = acc.sqr(cs)
        if bit == "1":
            acc = acc.mul(cs, base)
    return acc


# ---------------------------------------------------------------------------
# curve point gadgets (incomplete affine + offset ladders)
# ---------------------------------------------------------------------------


class _PointVar:
    """Shared affine add/double/ladder machinery; coordinate ops dispatch
    on whether coords are FVar (G1) or Fq2Var (G2)."""

    __slots__ = ("x", "y")

    def __init__(self, x, y):
        self.x = x
        self.y = y

    # coordinate helpers overridden per group
    def _mul(self, cs, a, b):
        raise NotImplementedError

    def add(self, cs, o):
        xd = self._sub(o.x, self.x)
        assert not self._is_zero_val(xd), "degenerate affine add"
        lam = self._hint_div(cs, self._sub(o.y, self.y), xd)
        x3 = self._hint_from(cs, self._lam_x3(lam, self.x, o.x))
        self._enf_mul(cs, lam, lam, self._add(self._add(x3, self.x), o.x))
        y3 = self._hint_from(cs, self._lam_y3(lam, self.x, x3, self.y))
        self._enf_mul(cs, lam, self._sub(self.x, x3), self._add(y3, self.y))
        return type(self)(x3, y3)

    def double(self, cs):
        xx = self._mul(cs, self.x, self.x)
        lam = self._hint_div(cs, self._scale(xx, 3), self._scale(self.y, 2))
        x3 = self._hint_from(cs, self._lam_x3(lam, self.x, self.x))
        self._enf_mul(cs, lam, lam, self._add(self._add(x3, self.x), self.x))
        y3 = self._hint_from(cs, self._lam_y3(lam, self.x, x3, self.y))
        self._enf_mul(cs, lam, self._sub(self.x, x3), self._add(y3, self.y))
        return type(self)(x3, y3)

    def select(self, cs, bit, other):
        return type(self)(self._select(cs, bit, self.x, other.x),
                          self._select(cs, bit, self.y, other.y))

    def enforce_equal(self, cs, other):
        self._enf_eq(cs, self.x, other.x)
        self._enf_eq(cs, self.y, other.y)


class G1Var(_PointVar):
    @staticmethod
    def alloc(cs, pt):
        assert pt is not None, "infinity G1 not representable in gadget"
        return G1Var(cs.alloc_witness(pt[0]), cs.alloc_witness(pt[1]))

    @staticmethod
    def constant(cs, pt):
        assert pt is not None
        return G1Var(cs.constant(pt[0]), cs.constant(pt[1]))

    def point(self):
        return (self.x.value, self.y.value)

    # coordinate ops (FVar / int arithmetic mod P)
    def _mul(self, cs, a, b):
        return cs.mul(a, b)

    def _sub(self, a, b):
        return a - b

    def _add(self, a, b):
        return a + b

    def _scale(self, a, k):
        return a * k

    def _is_zero_val(self, a):
        return a.value % P == 0

    def _hint_div(self, cs, num, den):
        lam = cs.alloc_witness(num.value * pow(den.value, -1, P) % P)
        cs.enforce(den, lam, num)
        return lam

    def _hint_from(self, cs, value):
        return cs.alloc_witness(value)

    def _lam_x3(self, lam, x1, x2):
        return (lam.value * lam.value - x1.value - x2.value) % P

    def _lam_y3(self, lam, x1, x3, y1):
        return (lam.value * (x1.value - x3.value) - y1.value) % P

    def _enf_mul(self, cs, a, b, c):
        if isinstance(b, int):
            b = cs.constant(b)
        if isinstance(c, int):
            c = cs.constant(c)
        cs.enforce(a, b, c)

    def _select(self, cs, bit, a, b):
        return b + cs.mul(bit, a - b)

    def _enf_eq(self, cs, a, b):
        cs.enforce_equal(a, b)


class G2Var(_PointVar):
    @staticmethod
    def alloc(cs, pt):
        assert pt is not None, "infinity G2 not representable in gadget"
        return G2Var(Fq2Var.alloc(cs, pt[0]), Fq2Var.alloc(cs, pt[1]))

    @staticmethod
    def constant(cs, pt):
        assert pt is not None
        return G2Var(Fq2Var.constant(cs, pt[0]), Fq2Var.constant(cs, pt[1]))

    def point(self):
        return (self.x.value(), self.y.value())

    def _mul(self, cs, a, b):
        return a.mul(cs, b)

    def _sub(self, a, b):
        return a.sub(b)

    def _add(self, a, b):
        return a.add(b)

    def _scale(self, a, k):
        return a.mul_int(k)

    def _is_zero_val(self, a):
        return a.value().is_zero()

    def _hint_div(self, cs, num, den):
        lam_val = num.value() * den.value().inv()
        lam = Fq2Var.alloc(cs, lam_val)
        prod = den.mul(cs, lam)
        cs.enforce_equal(prod.c0, num.c0)
        cs.enforce_equal(prod.c1, num.c1)
        return lam

    def _hint_from(self, cs, value):
        return Fq2Var.alloc(cs, value)

    def _lam_x3(self, lam, x1, x2):
        return lam.value().square() - x1.value() - x2.value()

    def _lam_y3(self, lam, x1, x3, y1):
        return lam.value() * (x1.value() - x3.value()) - y1.value()

    def _enf_mul(self, cs, a, b, c):
        prod = a.mul(cs, b)
        cs.enforce_equal(prod.c0, c.c0)
        cs.enforce_equal(prod.c1, c.c1)
        return prod

    def _select(self, cs, bit, a, b):
        return a.select(cs, bit, b)

    def _enf_eq(self, cs, a, b):
        cs.enforce_equal(a.c0, b.c0)
        cs.enforce_equal(a.c1, b.c1)


# fixed offset points for the uniform ladders (nothing-up-my-sleeve scalar)
_LADDER_SEED = 0x1ADDE12


@lru_cache(maxsize=None)
def _g1_offset(nbits: int):
    S = hc.g1_mul(hc.g1_generator(), _LADDER_SEED)
    endsub = hc.g1_neg(hc.g1_mul(S, 1 << nbits))
    return S, endsub


@lru_cache(maxsize=None)
def _g2_offset(nbits: int):
    S = hc.g2_mul(hc.g2_generator(), _LADDER_SEED)
    endsub = hc.g2_neg(hc.g2_mul(S, 1 << nbits))
    return S, endsub


def g1_scalar_mul(cs, base: G1Var, bits: List[FVar]) -> G1Var:
    """[scalar]base via a uniform select ladder offset by S (acc starts at
    S, ends at [scalar]base + [2^n]S; the constant [2^n]S is subtracted)."""
    S, endsub = _g1_offset(len(bits))
    acc = G1Var.constant(cs, S)
    for b in reversed(bits):
        acc = acc.double(cs)
        t = acc.add(cs, base)
        acc = t.select(cs, b, acc)
    return acc.add(cs, G1Var.constant(cs, endsub))


def g2_scalar_mul(cs, base: G2Var, bits: List[FVar]) -> G2Var:
    S, endsub = _g2_offset(len(bits))
    acc = G2Var.constant(cs, S)
    for b in reversed(bits):
        acc = acc.double(cs)
        t = acc.add(cs, base)
        acc = t.select(cs, b, acc)
    return acc.add(cs, G2Var.constant(cs, endsub))


# ---------------------------------------------------------------------------
# Fq transcript gadget (mirrors poseidon/transcript.py over the Fq sponge)
# ---------------------------------------------------------------------------


def _bits384(cs, v: FVar) -> List[FVar]:
    """377-bit decomposition zero-extended to a 48-byte stream.

    Range-checked < p: these bits feed transcript absorbs, where a
    non-canonical v + p representation would change the byte stream."""
    bits = to_bits_le(cs, v, 377, lt_bound=P)
    zero = cs.constant(0)
    return bits + [zero] * 7


def _chunk_absorb_elems(cs, stream: List[FVar]) -> List[FVar]:
    """Group a bit stream into absorb elements of 47 bytes = 376 bits each
    (sponge.absorb_bytes chunking, poseidon/sponge.py:123-130)."""
    elems = []
    for off in range(0, len(stream), 376):
        elems.append(bits_lc(cs, stream[off : off + 376]))
    return elems


class TranscriptFqGadget:
    """Fresh PoseidonTranscript(fq_params()) replayed in constraints."""

    def __init__(self, cs: ConstraintSystem):
        assert cs.modulus == P, "Fq transcript gadget needs an Fq circuit"
        self.cs = cs
        self.sponge = PoseidonSpongeGadget(cs)

    def append_g1_uncompressed(self, pt: G1Var) -> None:
        stream = _bits384(self.cs, pt.x) + _bits384(self.cs, pt.y)
        self.sponge.absorb(_chunk_absorb_elems(self.cs, stream))

    def append_gt_uncompressed(self, g: Fq12Var) -> None:
        stream: List[FVar] = []
        for coord in g.coords():
            stream.extend(_bits384(self.cs, coord))
        self.sponge.absorb(_chunk_absorb_elems(self.cs, stream))

    def challenge_fr(self) -> FrVar:
        """challenge_scalar(Fr): one native squeeze, low 252 bits
        (sponge.squeeze_foreign_field semantics)."""
        e = self.sponge.squeeze(1)[0]
        bits = to_bits_le(self.cs, e, 377, lt_bound=P)
        fr_bits = bits[:252] + [self.cs.constant(0)]
        return FrVar(fr_bits, bits_lc(self.cs, bits, 0, 252).value)


# ---------------------------------------------------------------------------
# Miller loop + residue-witness pairing checks
# ---------------------------------------------------------------------------


def _sparse_line_mul(cs, f: Fq12Var, lam: Fq2Var, c0l: Fq2Var,
                     p1: G1Var) -> Fq12Var:
    """f *= (yp - lam*xp*w - c0l*w^3), curves/pairing.py:_sparse_line."""
    zero2 = Fq2Var.constant(cs, Fq2.zero())
    a = Fq6Var(Fq2Var(p1.y, cs.constant(0)), zero2, zero2)
    b = Fq6Var(lam.mul_fq(cs, p1.x).neg(), c0l.neg(), zero2)
    return f.mul(cs, Fq12Var(a, b))


def miller_loop_gadget(cs, pairs: List[Tuple[G1Var, G2Var]]) -> Fq12Var:
    """In-circuit multi-Miller loop (affine, hint inverses), mirroring
    curves/pairing.py:multi_miller_loop."""
    f = Fq12Var.one(cs)
    ts = [G2Var(q.x, q.y) for (_, q) in pairs]
    bits = bin(X_SEED)[3:]
    for bit in bits:
        f = f.sqr(cs)
        for i, (p1, q) in enumerate(pairs):
            t = ts[i]
            xx = t.x.sqr(cs)
            lam = t._hint_div(cs, xx.mul_int(3), t.y.mul_int(2))
            c0l = t.y.sub(lam.mul(cs, t.x))
            x3 = Fq2Var.alloc(cs, lam.value().square()
                              - t.x.value() - t.x.value())
            t._enf_mul(cs, lam, lam, x3.add(t.x).add(t.x))
            y3 = Fq2Var.alloc(cs, lam.value() * (t.x.value() - x3.value())
                              - t.y.value())
            t._enf_mul(cs, lam, t.x.sub(x3), y3.add(t.y))
            f = _sparse_line_mul(cs, f, lam, c0l, p1)
            ts[i] = G2Var(x3, y3)
        if bit == "1":
            for i, (p1, q) in enumerate(pairs):
                t = ts[i]
                lam = t._hint_div(cs, q.y.sub(t.y), q.x.sub(t.x))
                c0l = t.y.sub(lam.mul(cs, t.x))
                x3 = Fq2Var.alloc(cs, lam.value().square()
                                  - t.x.value() - q.x.value())
                t._enf_mul(cs, lam, lam, x3.add(t.x).add(q.x))
                y3 = Fq2Var.alloc(cs, lam.value() * (t.x.value() - x3.value())
                                  - t.y.value())
                t._enf_mul(cs, lam, t.x.sub(x3), y3.add(t.y))
                f = _sparse_line_mul(cs, f, lam, c0l, p1)
                ts[i] = G2Var(x3, y3)
    return f


def enforce_pairing_product(cs, pairs: List[Tuple[G1Var, G2Var]],
                            rhs: Optional[Fq12Var] = None) -> None:
    """Enforce FE(prod miller(pairs)) == rhs (or == 1 when rhs is None)
    via the residue-witness equivalence f == rhs^alpha * c^r."""
    f = miller_loop_gadget(cs, pairs)
    f_val = f.value()
    if rhs is None:
        w = f_val
    else:
        w = f_val * pr.gt_pow(rhs.value().inv(), ALPHA)
    c_val = pr.gt_pow(w, _rth_root_exp())
    c = Fq12Var.alloc(cs, c_val)
    expect = fq12_pow_const(cs, c, R)
    if rhs is not None:
        expect = expect.mul(cs, fq12_pow_const(cs, rhs, ALPHA))
    f.enforce_equal(cs, expect)


# ---------------------------------------------------------------------------
# the TestudoCommVerifier circuit
# ---------------------------------------------------------------------------


def build_comm_verifier(
    vk: "pst.VerifierKey",
    U,  # host affine G1 (the folded commitment)
    point: List[int],  # full opening point (Fr scalars)
    v: int,  # claimed evaluation
    pst_proof: List,  # G1 proofs (outer PST open at the row point)
    mipp_proof,  # core.mipp.MippProof
    T: Fq12,  # aggregated pairing commitment
) -> ConstraintSystem:
    """Synthesize the full in-circuit sqrt-PST opening verification
    (mirror of core/sqrt_pst.verify + core/mipp.verify + core/pst.check,
    reference circuit_verifier.rs:133-564).  The returned system is
    satisfied iff the opening verifies."""
    cs = ConstraintSystem(modulus=P)

    ln = len(point)
    odd = ln % 2
    a_pt = point[: ln // 2 + odd]
    b_pt = point[ln // 2 + odd :]

    U_var = G1Var.alloc(cs, U)
    T_var = Fq12Var.alloc(cs, T)
    b_vars = [fr_alloc(cs, bi) for bi in b_pt]
    a_vars = [fr_alloc(cs, ai) for ai in a_pt]
    v_var = fr_alloc(cs, v)

    # ---- MIPP verify (mirror of mipp.verify) ------------------------------
    tr = TranscriptFqGadget(cs)
    tr.append_g1_uncompressed(U_var)

    m = len(mipp_proof.comms_u)
    u_vars, t_vars, xs, xs_inv = [], [], [], []
    final_y = None
    for i, ((u_l, u_r), (t_l, t_r)) in enumerate(
        zip(mipp_proof.comms_u, mipp_proof.comms_t)
    ):
        ul_var, ur_var = G1Var.alloc(cs, u_l), G1Var.alloc(cs, u_r)
        tl_var, tr_var = Fq12Var.alloc(cs, t_l), Fq12Var.alloc(cs, t_r)
        tr.append_g1_uncompressed(ul_var)
        tr.append_g1_uncompressed(ur_var)
        tr.append_gt_uncompressed(tl_var)
        tr.append_gt_uncompressed(tr_var)
        c_inv = tr.challenge_fr()
        c = fr_inverse(cs, c_inv)
        u_vars.append((ul_var, ur_var))
        t_vars.append((tl_var, tr_var))
        xs.append(c)
        xs_inv.append(c_inv)
        # final_y *= (1 + c_inv*b_i - b_i)
        prod_bi = fr_mul(cs, c_inv, b_vars[i])
        term = fr_lincomb(cs, 1, [(1, prod_bi), (R - 1, b_vars[i])])
        final_y = term if final_y is None else fr_mul(cs, final_y, term)

    # fold T and U
    tc = T_var
    uc = U_var
    for (ul_var, ur_var), (tl_var, tr_var), c, c_inv in zip(
        u_vars, t_vars, xs, xs_inv
    ):
        tc = tc.mul(cs, fq12_pow_bits(cs, tl_var, c_inv.bits))
        tc = tc.mul(cs, fq12_pow_bits(cs, tr_var, c.bits))
        uc = uc.add(cs, g1_scalar_mul(cs, ul_var, c_inv.bits))
        uc = uc.add(cs, g1_scalar_mul(cs, ur_var, c.bits))

    rs = [tr.challenge_fr() for _ in range(m)]
    # v_ph = prod (1 - rs_i + xs_inv_i * rs_i)
    v_ph = None
    for i in range(m):
        prod_i = fr_mul(cs, xs_inv[i], rs[i])
        term = fr_lincomb(cs, 1, [(1, prod_i), (R - 1, rs[i])])
        v_ph = term if v_ph is None else fr_mul(cs, v_ph, term)

    # p_h PST check (mirror of pst.check_g2):
    #   e(-g, C_h - h^v_ph) * prod e(g^{t_i} - g^{rs_i}, pi_i) == 1
    vkt = vk.trim(m) if vk.nv != m else vk
    final_h_var = G2Var.alloc(cs, mipp_proof.final_h)
    h_const = G2Var.constant(cs, vk.h)
    g_neg_const = G1Var.constant(cs, hc.g1_neg(vk.g))
    hv = g2_scalar_mul(cs, h_const, v_ph.bits)
    right_pt = final_h_var.add(cs, G2Var(hv.x, hv.y.neg()))
    pairs2: List[Tuple[G1Var, G2Var]] = [(g_neg_const, right_pt)]
    g_const = G1Var.constant(cs, vk.g)
    for i in range(m):
        grs = g1_scalar_mul(cs, g_const, rs[i].bits)
        g_term = G1Var.constant(cs, vkt.g_mask[i]).add(
            cs, G1Var(grs.x, grs.y * (P - 1))
        )
        pairs2.append((g_term, G2Var.alloc(cs, mipp_proof.pst_proof_h[i])))
    enforce_pairing_product(cs, pairs2, rhs=None)

    # final_t: e(final_a, final_h) == tc
    final_a_var = G1Var.alloc(cs, mipp_proof.final_a)
    enforce_pairing_product(cs, [(final_a_var, final_h_var)], rhs=tc)

    # final_u: uc == final_a^{final_y}
    rhs_u = g1_scalar_mul(cs, final_a_var, final_y.bits)
    uc.enforce_equal(cs, rhs_u)

    # ---- outer PST check at the row point (mirror of pst.check) -----------
    #   e(U - g^v, -h) * prod e(pi_i, h^{t_i} - h^{a_i}) == 1
    nv_a = len(a_pt)
    vkt_a = vk.trim(nv_a) if vk.nv != nv_a else vk
    gv = g1_scalar_mul(cs, g_const, v_var.bits)
    left_pt = U_var.add(cs, G1Var(gv.x, gv.y * (P - 1)))
    h_neg_const = G2Var.constant(cs, hc.g2_neg(vk.h))
    pairs3: List[Tuple[G1Var, G2Var]] = [(left_pt, h_neg_const)]
    for i in range(nv_a):
        ha = g2_scalar_mul(cs, h_const, a_vars[i].bits)
        h_term = G2Var.constant(cs, vkt_a.h_mask[i]).add(
            cs, G2Var(ha.x, ha.y.neg())
        )
        pairs3.append((G1Var.alloc(cs, pst_proof[i]), h_term))
    enforce_pairing_product(cs, pairs3, rhs=None)

    return cs
