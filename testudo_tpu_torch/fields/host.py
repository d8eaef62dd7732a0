"""Host-side (pure Python int) Fq/Fr helpers for BLS12-377.

Counterpart of testudo_tpu/fields/host.py, base fields only: the extension
towers (Fq2, Fq6, Fq12) wait for the G2/pairing slice.
"""
from __future__ import annotations

from .bls12_377 import P, R


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
