"""Host-side optimal ate pairing for BLS12-377.

e: G1 x G2 -> GT (subgroup of Fq12*).  Implements the standard BLS12 optimal
ate pairing: Miller loop over the (positive) BLS seed x, followed by the
final exponentiation (easy part + x-power hard part).

Used for low-multiplicity checks (PST `check`, MIPP verification, Groth16
verify) and as the ground truth for the batched device Miller loop.

Reference behavior parity: mirrors E::pairing / E::multi_pairing usage in
Testudo (Rust) src/sqrt_pst.rs:143 and Testudo (Rust) src/mipp.rs:90-94.

Counterpart of testudo_tpu/curves/pairing.py (host code; the port keeps its own copy).
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

from ..fields.bls12_377 import P, R, X_SEED
from ..fields.host import Fq2, Fq6, Fq12

# Untwist: G2 points (x', y') on E': y^2 = x^3 + b/xi map to
# (x' * w^2, y' * w^3) on E(Fq12) for the D-type twist with w^6 = xi... but in
# practice we evaluate line functions in the twisted coordinates and assemble
# sparse Fq12 elements directly (standard trick).


def _fq2_of(c: int) -> Fq2:
    return Fq2(c, 0)


def _line_double(q, p):
    """Double Q (G2 Jacobian-esque affine step) and return line eval at P.

    Works in affine G2 coordinates for clarity.  Returns (2Q, line) where
    line is the sparse Fq12 element l(P).
    """
    (xq, yq) = q
    (xp, yp) = p
    # lambda = 3 xq^2 / 2 yq
    lam = xq.square().mul_scalar(3) * (yq + yq).inv()
    x3 = lam.square() - xq - xq
    y3 = lam * (xq - x3) - yq
    # line: l(P) = yp - lam * xp - (yq - lam xq), expressed in Fq12 basis.
    c0 = yq - lam * xq  # Fq2 coefficient
    return (x3, y3), _sparse_line(lam, c0, xp, yp)


def _line_add(q1, q2, p):
    """Add distinct Q2 to Q1, return line eval at P."""
    (x1, y1) = q1
    (x2, y2) = q2
    lam = (y2 - y1) * (x2 - x1).inv()
    x3 = lam.square() - x1 - x2
    y3 = lam * (x1 - x3) - y1
    c0 = y1 - lam * x1
    return (x3, y3), _sparse_line(lam, c0, p[0], p[1])


def _sparse_line(lam: Fq2, c0: Fq2, xp: int, yp: int) -> Fq12:
    """Assemble l(P) = yp - lam*xp*w - c0*w^3 as an Fq12 element.

    With the D-type twist (x untwists by w^2, y by w^3, w^6 = xi), the
    untwisted slope is lam*w and the line through the untwisted points
    evaluated at P = (xp, yp) in G1 is
      l = yp - (lam*xp) * w - (yT - lam*xT) * w^3.
    Basis: Fq12 = Fq6[w], Fq6 = Fq2[v], v = w^2, so
      w^0 -> (c0).c0, w^1 -> (c1).c0, w^3 -> (c1).c1.
    """
    a = Fq6(_fq2_of(yp), Fq2.zero(), Fq2.zero())
    b = Fq6(-(lam.mul_scalar(xp)), -c0, Fq2.zero())
    return Fq12(a, b)


def miller_loop(p, q) -> Fq12:
    """Miller loop f_{x, Q}(P) for affine G1 point p and G2 point q."""
    if p is None or q is None:
        return Fq12.one()
    f = Fq12.one()
    t = q
    bits = bin(X_SEED)[3:]  # skip the leading 1
    for b in bits:
        f = f.square()
        t, l = _line_double(t, p)
        f = f * l
        if b == "1":
            t, l = _line_add(t, q, p)
            f = f * l
    return f


def multi_miller_loop(pairs: Iterable[Tuple[object, object]]) -> Fq12:
    """Product of Miller loops, sharing the squaring chain."""
    pairs = [(p, q) for (p, q) in pairs if p is not None and q is not None]
    if not pairs:
        return Fq12.one()
    f = Fq12.one()
    ts = [q for (_, q) in pairs]
    bits = bin(X_SEED)[3:]
    for b in bits:
        f = f.square()
        for i, (p, q) in enumerate(pairs):
            ts[i], l = _line_double(ts[i], p)
            f = f * l
        if b == "1":
            for i, (p, q) in enumerate(pairs):
                ts[i], l = _line_add(ts[i], q, p)
                f = f * l
    return f


def final_exponentiation(f: Fq12) -> Fq12:
    """f^((p^12 - 1)/r) via the standard BLS12 decomposition."""
    # Easy part: f^((p^6 - 1)(p^2 + 1))
    f1 = f.conj() * f.inv()  # f^(p^6 - 1)
    f2 = f1.frobenius(2) * f1  # ^(p^2 + 1)
    m = f2

    # Hard part: m^((p^4 - p^2 + 1)/r), evaluated in base-p digits so each
    # digit exponent is ~377 bits and Frobenius replaces p-power chains.
    hard_exp = (P**4 - P**2 + 1) // R
    digits = []
    e = hard_exp
    while e:
        digits.append(e % P)
        e //= P
    # m^(sum d_i p^i) = prod frobenius^i(m^(d_i))
    res = Fq12.one()
    for i, d in enumerate(digits):
        res = res * m.pow(d).frobenius(i)
    return res


def pairing(p, q) -> Fq12:
    if native.available():
        return native.multi_pairing([p], [q])
    return final_exponentiation(miller_loop(p, q))


def multi_pairing(g1s: List[object], g2s: List[object]) -> Fq12:
    g1s, g2s = list(g1s), list(g2s)
    if native.available():
        return native.multi_pairing(g1s, g2s)
    return final_exponentiation(multi_miller_loop(zip(g1s, g2s)))


def gt_pow(f: Fq12, e: int) -> Fq12:
    """GT exponentiation (native-accelerated when available)."""
    if native.available():
        return native.gt_pow(f, e)
    return f.pow(e)


from .. import native  # noqa: E402  (bottom import: avoids partial-init order issues)
