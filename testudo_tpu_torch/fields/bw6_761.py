"""BW6-761 field constants, derived from the Brezing-Weng construction.

Counterpart of testudo_tpu/fields/bw6_761.py.  BW6-761 (El Housni and
Guillevic 2020, "Optimized and secure pairing-friendly elliptic curves
suitable for one layer proof composition") is the outer curve of the
BLS12-377 recursion stack: its scalar field r IS BLS12-377's base field Fq,
so the Fq-native TestudoCommVerifier circuit (core/circuit_verifier.py) is
Groth16-provable over this curve (core/groth16_bw6.py).

Derivation (checked at import): k = 6, D = -3 Brezing-Weng with
r = p_BLS377 and lift cofactors (ht, hy) = (13, 9):
    t = t0 + ht*r,  y = y0 + hy*r,  q = (t^2 + 3*y^2) / 4
with t0 = z + 1, y0 = (z - 1)/sqrt(-3) mod r for the primitive 6th root
of unity z mod r that yields a 761-bit prime q (the only choice).

Curves:  G1: y^2 = x^3 - 1 over Fq;  G2: y^2 = x^3 + 4 over Fq
(sextic M-twist with xi = -4, so Fq6 = Fq[w]/(w^6 + 4)).
"""
from .bls12_377 import P as R  # BW6-761 scalar field = BLS12-377 base field


def _derive():
    from .host import _tonelli_shanks
    from .bls12_377 import _is_probable_prime

    r = R
    s3 = _tonelli_shanks(-3 % r, r)
    assert s3 is not None
    inv2 = pow(2, -1, r)
    for s3c in (s3, r - s3):
        for z in ((1 + s3c) * inv2 % r, (1 - s3c) * inv2 % r):
            t0 = (z + 1) % r
            for s3b in (s3, r - s3):
                y0 = (z - 1) * pow(s3b, -1, r) % r
                for ht in (13, -13):
                    for hy in (9, -9):
                        t = t0 + ht * r
                        y = y0 + hy * r
                        num = t * t + 3 * y * y
                        if num % 4:
                            continue
                        q = num // 4
                        if q.bit_length() != 761:
                            continue
                        n = q + 1 - t
                        if n % r:
                            continue
                        if not _is_probable_prime(q):
                            continue
                        return q, t, y
    raise AssertionError("BW6-761 derivation failed")


Q, TRACE, _CM_Y = _derive()

# Known leading bytes of the published BW6-761 modulus — guards the
# derivation against construction-choice drift.
assert hex(Q).startswith("0x122e824fb83ce0ad"), hex(Q)[:24]

FQ_BITS = Q.bit_length()  # 761
FR_BITS = R.bit_length()  # 377
FQ_BYTES = 96
FR_BYTES = 48

# G1: y^2 = x^3 - 1;  G2 (M-twist by XI = -4): y^2 = x^3 + 4
B1 = Q - 1
XI = Q - 4
B2 = 4

G1_ORDER = Q + 1 - TRACE
H1 = G1_ORDER // R
assert G1_ORDER == H1 * R

# sextic twist order: the (t ± 3y)/2 candidate divisible by r
_T3A = (TRACE + 3 * _CM_Y) // 2 if (TRACE + 3 * _CM_Y) % 2 == 0 else None
_T3B = (TRACE - 3 * _CM_Y) // 2 if (TRACE - 3 * _CM_Y) % 2 == 0 else None
G2_ORDER = None
for _tc in (_T3A, _T3B):
    if _tc is not None and (Q + 1 - _tc) % R == 0:
        G2_ORDER = Q + 1 - _tc
        break
assert G2_ORDER is not None, "no r-order sextic twist"
H2 = G2_ORDER // R

# -- sanity ------------------------------------------------------------------
assert Q % 4 == 3
assert (TRACE * TRACE - 4 * Q) == -3 * _CM_Y * _CM_Y
# q = 1 mod 6 so Fq6 = Fq[w]/(w^6 - xi) is a field when xi is a sextic NR
assert Q % 6 == 1
