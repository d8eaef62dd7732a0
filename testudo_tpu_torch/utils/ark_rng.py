"""Bit-exact ports of the RNG stack the reference uses for deterministic
parameter generation.

The reference derives its trusted-setup SRS and Pedersen generators from
seeded RNGs:

  - `ark_std::test_rng()` (ark-std 0.4) — `rand::rngs::StdRng::from_seed`
    with the fixed 32-byte seed spelling (1, 23, 456, 7890) as LE u32s;
    used for the PST SRS (Testudo (Rust) src/dense_mlpoly.rs:193-195).
  - `rand::rngs::StdRng::from_seed(sponge_bytes)` — used for Pedersen
    generator sampling (Testudo (Rust) src/commitments.rs:17-39).

rand 0.8's StdRng is ChaCha12 (rand_chacha::ChaCha12Rng), wrapped in
rand_core's BlockRng with a 64-word (4 ChaCha blocks) buffer; the buffer
boundary behavior of next_u64 is observable in the output stream, so it
is reproduced exactly here.

On top of the raw stream this module ports arkworks 0.4 sampling:

  - `Fp::rand` — fills N 64-bit limbs (LSB limb first), masks the top
    limb down to the modulus bit size, rejects >= p.  NOTE: arkworks
    samples the MONTGOMERY representation directly (ark-ff fp.rs
    `Distribution<Fp> for Standard` builds `Fp(BigInt::rand(rng))` with
    no conversion), so the canonical value is sample * R^{-1} mod p.
  - `QuadExtField::rand` — c0 then c1.
  - `Affine::rand` — loop { x = F::rand; greatest = rng.gen::<bool>()
    (sign bit of next_u32); get_point_from_x_unchecked; } then
    mul_by_cofactor (ark-ec sw/affine.rs).
  - `Projective::rand` — same loop, `mul_by_cofactor_to_group`; equal to
    the affine result up to representation.

Everything here is host-side Python (parameter generation only — never a
hot path).

Counterpart of testudo_tpu/utils/ark_rng.py (host code; the port keeps its own copy).
"""
from __future__ import annotations

import struct
from typing import List, Tuple

from ..fields.bls12_377 import (
    B1,
    FQ_MONT_R,
    FR_MONT_R,
    H1,
    H2,
    P,
    R,
)
from ..fields import host as hf
from ..curves import host_curve as hc

MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF


def _rotl32(v: int, n: int) -> int:
    return ((v << n) | (v >> (32 - n))) & MASK32


def _chacha_block(key_words, counter: int, stream_words, rounds: int) -> List[int]:
    """One ChaCha block (the "original" 64-bit-counter variant rand_chacha
    uses: words 12-13 = counter, words 14-15 = stream id)."""
    state = [
        0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
        *key_words,
        counter & MASK32, (counter >> 32) & MASK32,
        stream_words[0], stream_words[1],
    ]
    x = list(state)

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & MASK32
        x[d] = _rotl32(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & MASK32
        x[b] = _rotl32(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & MASK32
        x[d] = _rotl32(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & MASK32
        x[b] = _rotl32(x[b] ^ x[c], 7)

    for _ in range(rounds // 2):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)

    return [(x[i] + state[i]) & MASK32 for i in range(16)]


class ChaChaRng:
    """rand_chacha::ChaChaXRng semantics: BlockRng over a 64-word buffer
    (4 sequential ChaCha blocks per refill)."""

    BUF_WORDS = 64

    def __init__(self, seed: bytes, rounds: int = 12):
        assert len(seed) == 32
        self.key = list(struct.unpack("<8I", seed))
        self.rounds = rounds
        self.counter = 0  # 64-byte-block counter
        self.stream = (0, 0)
        self.results: List[int] = []
        self.index = self.BUF_WORDS  # force generate on first use

    def _generate(self) -> None:
        words: List[int] = []
        for i in range(4):
            words.extend(
                _chacha_block(self.key, self.counter + i, self.stream, self.rounds)
            )
        self.counter += 4
        self.results = words
        self.index = 0

    def next_u32(self) -> int:
        if self.index >= self.BUF_WORDS:
            self._generate()
        v = self.results[self.index]
        self.index += 1
        return v

    def next_u64(self) -> int:
        """rand_core BlockRng::next_u64 — the buffer-boundary case (exactly
        one word left) stitches the last word with the first of the next
        buffer."""
        n = self.BUF_WORDS
        if self.index < n - 1:
            lo = self.results[self.index]
            hi = self.results[self.index + 1]
            self.index += 2
            return (hi << 32) | lo
        if self.index >= n:
            self._generate()
            lo, hi = self.results[0], self.results[1]
            self.index = 2
            return (hi << 32) | lo
        # index == n - 1
        lo = self.results[n - 1]
        self._generate()
        hi = self.results[0]
        self.index = 1
        return (hi << 32) | lo

    def fill_bytes(self, nbytes: int) -> bytes:
        """rand_core BlockRng::fill_bytes via fill_via_u32_chunks: LE bytes
        of consecutive u32 words; a partially used word is consumed."""
        out = bytearray()
        while len(out) < nbytes:
            if self.index >= self.BUF_WORDS:
                self._generate()
            need = nbytes - len(out)
            avail = self.results[self.index :]
            nwords = min(len(avail), (need + 3) // 4)
            chunk = struct.pack("<%dI" % nwords, *avail[:nwords])
            out.extend(chunk[:need])
            self.index += nwords
        return bytes(out)

    def gen_bool(self) -> bool:
        """rand 0.8 `Standard` bool: sign bit of the next u32."""
        return (self.next_u32() & 0x8000_0000) != 0


# ---------------------------------------------------------------------------
# ark-std / rand constructors
# ---------------------------------------------------------------------------


def std_rng_from_seed(seed: bytes) -> ChaChaRng:
    """rand 0.8 StdRng::from_seed (= ChaCha12Rng)."""
    return ChaChaRng(seed, rounds=12)


ARK_TEST_RNG_SEED = bytes(
    [1, 0, 0, 0, 23, 0, 0, 0, 200, 1, 0, 0, 210, 30, 0, 0] + [0] * 16
)


def test_rng() -> ChaChaRng:
    """ark_std::test_rng() (ark-std 0.4 rand_helper.rs)."""
    return std_rng_from_seed(ARK_TEST_RNG_SEED)


# ---------------------------------------------------------------------------
# arkworks field / curve sampling
# ---------------------------------------------------------------------------


def _bigint_rand(rng: ChaChaRng, nlimbs: int) -> int:
    v = 0
    for i in range(nlimbs):
        v |= rng.next_u64() << (64 * i)
    return v


def fp_rand_repr(rng: ChaChaRng, modulus: int, nlimbs: int) -> int:
    """ark-ff `Fp::rand`: the MONTGOMERY-form integer (rejection-sampled
    < modulus after masking the top limb to the modulus bit size)."""
    nbits = modulus.bit_length()
    shave = 64 * nlimbs - nbits
    mask = (1 << (64 * nlimbs)) - 1 if shave == 0 else (
        ((MASK64 >> shave) << (64 * (nlimbs - 1)))
        | ((1 << (64 * (nlimbs - 1))) - 1)
    )
    while True:
        tmp = _bigint_rand(rng, nlimbs) & mask
        if tmp < modulus:
            return tmp


def fq_rand(rng: ChaChaRng) -> int:
    """Canonical value of an ark `Fq::rand` draw (6 limbs, Mont R=2^384)."""
    repr_ = fp_rand_repr(rng, P, 6)
    return repr_ * pow(FQ_MONT_R, -1, P) % P


def fr_rand(rng: ChaChaRng) -> int:
    """Canonical value of an ark `Fr::rand` draw (4 limbs, Mont R=2^256)."""
    repr_ = fp_rand_repr(rng, R, 4)
    return repr_ * pow(FR_MONT_R, -1, R) % R


def fq2_rand(rng: ChaChaRng) -> hf.Fq2:
    c0 = fq_rand(rng)
    c1 = fq_rand(rng)
    return hf.Fq2(c0, c1)


def g1_affine_rand(rng: ChaChaRng, mul=hc.g1_mul):
    """ark `G1Affine::rand`: x = Fq::rand, greatest = bool, point-from-x,
    cofactor-cleared by `mul(point, H1)`.  Returns host affine (x, y) or
    None (infinity)."""
    while True:
        x = fq_rand(rng)
        greatest = rng.gen_bool()
        rhs = (x * x * x + B1) % P
        y = hf.fq_sqrt(rhs)
        if y is None:
            continue
        y_big = max(y, (P - y) % P)
        y_small = min(y, (P - y) % P)
        pt = (x, y_big if greatest else y_small)
        return mul(pt, H1)


def g2_affine_rand(rng: ChaChaRng):
    """ark `G2Affine::rand` over the Fq2 twist (greatest compares c1 first,
    ark-ff QuadExtField Ord)."""
    from ..curves.host_curve import B2

    def fq2_cmp_key(v: hf.Fq2) -> Tuple[int, int]:
        return (v.c1, v.c0)

    while True:
        x = fq2_rand(rng)
        greatest = rng.gen_bool()
        rhs = x * x * x + B2
        y = rhs.sqrt()
        if y is None:
            continue
        ny = hf.Fq2((P - y.c0) % P, (P - y.c1) % P)
        hi, lo = (y, ny) if fq2_cmp_key(y) > fq2_cmp_key(ny) else (ny, y)
        pt = (x, hi if greatest else lo)
        return hc.g2_mul(pt, H2)


def g1_projective_rand(rng: ChaChaRng):
    """ark `G1Projective::rand` — same draws, `mul_by_cofactor_to_group`;
    identical affine result."""
    return g1_affine_rand(rng)


def g2_projective_rand(rng: ChaChaRng):
    return g2_affine_rand(rng)
