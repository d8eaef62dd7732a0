"""BLS12-377 constants for the G1 and G2 group layer, derived from the BLS seed.

Counterpart of testudo_tpu/fields/bls12_377.py, trimmed to what the two
groups need: r = x^4 - x^2 + 1, p = (x-1)^2 * r / 3 + x, G1: y^2 = x^3 + 1
with cofactor h1 = (x-1)^2 / 3, and for G2 the quadratic non-residue of
Fq2 = Fq[u] / (u^2 + 5) and the cofactor h2 of the twist.  Deriving rather
than hard-coding keeps the constants self-verifying; the asserts below run
at import.  The tower above Fq2 (Fq6 = Fq2[v] / (v^3 - u), Fq12 = Fq6[w] /
(w^2 - v)) needs no constant of its own: fields/host.py derives its
Frobenius tables from the non-residue.
"""

X_SEED = 0x8508C00000000001

R = X_SEED**4 - X_SEED**2 + 1
P = ((X_SEED - 1) ** 2 * R) // 3 + X_SEED

TRACE = X_SEED + 1

FR_BITS = R.bit_length()  # 253
FQ_BITS = P.bit_length()  # 377

# arkworks serialization sizes: 64-bit BigInt limbs * 8 bytes.
FR_BYTES = 32
FQ_BYTES = 48

# Montgomery radices of the limb representation (arkworks' 2^(64 * n_limbs)).
FR_MONT_R = 1 << 256
FQ_MONT_R = 1 << 384

# Fq2 = Fq[u] / (u^2 - FQ2_NONRESIDUE): u^2 = -5.
FQ2_NONRESIDUE = P - 5

# G1 curve: y^2 = x^3 + 1.
B1 = 1

# Cofactors: G1, and the standard BLS12 polynomial for G2.
H1 = (X_SEED - 1) ** 2 // 3
H2 = (
    X_SEED**8 - 4 * X_SEED**7 + 5 * X_SEED**6 - 4 * X_SEED**4
    + 6 * X_SEED**3 - 4 * X_SEED**2 - 4 * X_SEED + 13
) // 9

G1_ORDER = P + 1 - TRACE  # = h1 * r


def _is_probable_prime(n: int, rounds: int = 16) -> bool:
    if n < 2:
        return False
    for sp in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % sp == 0:
            return n == sp
    d = n - 1
    s = 0
    while d % 2 == 0:
        d //= 2
        s += 1
    import random

    rng = random.Random(0xBEEF)
    for _ in range(rounds):
        a = rng.randrange(2, n - 1)
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


assert FR_BITS == 253 and FQ_BITS == 377
assert _is_probable_prime(R), "r not prime"
assert _is_probable_prime(P), "p not prime"
assert G1_ORDER == H1 * R
