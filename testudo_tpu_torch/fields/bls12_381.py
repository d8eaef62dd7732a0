"""BLS12-381 curve and field constants, derived from the BLS seed.

Counterpart of testudo_tpu/fields/bls12_381.py.  Parameters derived from
the (negative) seed x = -0xd201000000010000 with the BLS12 family formulas,
mirroring Testudo's `ark-bls12-381` / `ark-blst` wiring (Cargo.toml:25-26,
33).  Like
fields/bls12_377.py, deriving rather than hard-coding keeps the constants
self-verifying.

Conventions (arkworks 0.4 / blst):
  - Fq2  = Fq[u] / (u^2 + 1)          (QNR = -1)
  - Fq6  = Fq2[v] / (v^3 - XI),  XI = u + 1
  - Fq12 = Fq6[w] / (w^2 - v)
  - G1: y^2 = x^3 + 4 over Fq.
  - G2: y^2 = x^3 + 4*(u+1) over Fq2 (M-type twist).
"""

# The BLS12-381 seed (negative).
X_SEED = -0xD201000000010000
X_ABS = -X_SEED

# Family formulas (even powers make r independent of the sign).
R = X_SEED**4 - X_SEED**2 + 1
P = ((X_SEED - 1) ** 2 * R) // 3 + X_SEED

TRACE = X_SEED + 1

FR_BITS = R.bit_length()  # 255
FQ_BITS = P.bit_length()  # 381

FR_BYTES = 32
FQ_BYTES = 48

# Tower constants.
FQ2_NONRESIDUE = P - 1  # -1: u^2 = -1
XI = (1, 1)  # u + 1, the Fq6 cubic nonresidue

# G1 curve: y^2 = x^3 + 4; G2 (M-twist): b2 = 4 * XI.
B1 = 4

# Cofactors (standard BLS12 polynomials).
H1 = (X_SEED - 1) ** 2 // 3
H2 = (
    X_SEED**8 - 4 * X_SEED**7 + 5 * X_SEED**6 - 4 * X_SEED**4
    + 6 * X_SEED**3 - 4 * X_SEED**2 - 4 * X_SEED + 13
) // 9

G1_ORDER = P + 1 - TRACE
T2 = TRACE * TRACE - 2 * P

# G2 (sextic twist) order via the CM equation t2^2 - 4p^2 = -3 f2^2
# (same derivation as fields/bls12_377.py:60-83).
import math as _math

_F2SQ = (4 * P * P - T2 * T2) // 3
_F2 = _math.isqrt(_F2SQ)
assert _F2 * _F2 == _F2SQ
_TWIST_A = P * P + 1 - (T2 + 3 * _F2) // 2
_TWIST_B = P * P + 1 - (T2 - 3 * _F2) // 2
G2_ORDER = _TWIST_A if _TWIST_A % R == 0 and _TWIST_A == H2 * R else _TWIST_B

# -- sanity (cheap, import-time) -------------------------------------------
assert R.bit_length() == 255 and P.bit_length() == 381
assert G1_ORDER == H1 * R
assert G2_ORDER % R == 0 and G2_ORDER // R == H2
assert P % 4 == 3  # so -1 is a quadratic nonresidue (u^2 = -1 valid)
assert pow(FQ2_NONRESIDUE, (P - 1) // 2, P) == P - 1
