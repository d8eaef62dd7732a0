"""Poseidon duplex sponge matching ark-crypto-primitives 0.4 semantics.

This is the Fiat-Shamir core: every challenge in every protocol layer is
squeezed from this sponge, so its absorb/squeeze/permute semantics are THE
cross-cutting bit-exactness contract (see SURVEY.md "Transcript-critical
constants checklist").

Semantics mirrored from the arkworks sponge as used by the reference
(Testudo (Rust) src/poseidon_transcript.rs):

  - state layout: [capacity | rate] (capacity elements first); absorbing adds
    into state[capacity + i].
  - permutation: full_rounds/2 full, partial_rounds partial (S-box on
    state[0] only), full_rounds/2 full; each round: add-round-key, S-box
    (x^alpha), MDS matrix.
  - absorb of a native field element: the element itself.
  - absorb of a foreign prime-field element: its canonical little-endian
    bytes re-read mod the sponge modulus (single element).
  - absorb of a byte string: chunks of floor((MODULUS_BITS - 1) / 8) bytes,
    little-endian, one field element per chunk; NO length prefix.
  - absorb of a u64: single element.
  - squeeze of native field elements: direct state reads (full elements).
  - squeeze of foreign field elements: (foreign_bits - 1) bits taken from
    native squeezes, each native element contributing its low
    (native_bits - 1) bits, assembled little-endian.
  - squeeze_bytes(n): native squeezes, each contributing its low
    floor((bits-1)/8) bytes.
  - mode machine: absorb after squeeze permutes first; squeeze after absorb
    permutes first; indices wrap with a permute when the rate is exhausted.

Counterpart of testudo_tpu/poseidon/sponge.py (host code; the port keeps its own copy).
"""
from __future__ import annotations

from typing import List

from . import constants_377 as C

_ABSORBING = 0
_SQUEEZING = 1


class PoseidonParams:
    """Poseidon configuration bound to a prime modulus."""

    __slots__ = ("modulus", "bits", "ark", "mds", "full_rounds", "partial_rounds",
                 "alpha", "rate", "capacity")

    def __init__(self, modulus: int, ark=None, mds=None, full_rounds=None,
                 partial_rounds=None, alpha=None, rate=None, capacity=None):
        self.modulus = modulus
        self.bits = modulus.bit_length()
        self.ark = [[c % modulus for c in row] for row in (ark or C.ARK)]
        self.mds = [[c % modulus for c in row] for row in (mds or C.MDS)]
        self.full_rounds = full_rounds if full_rounds is not None else C.FULL_ROUNDS
        self.partial_rounds = partial_rounds if partial_rounds is not None else C.PARTIAL_ROUNDS
        self.alpha = alpha if alpha is not None else C.ALPHA
        self.rate = rate if rate is not None else C.RATE
        self.capacity = capacity if capacity is not None else C.CAPACITY


class PoseidonSponge:
    __slots__ = ("params", "state", "mode", "index")

    def __init__(self, params: PoseidonParams):
        self.params = params
        self.state = [0] * (params.rate + params.capacity)
        self.mode = _ABSORBING
        self.index = 0  # next absorb or squeeze index within the rate

    # -- permutation --------------------------------------------------------

    def permute(self) -> None:
        p = self.params
        mod = p.modulus
        state = list(self.state)
        half_full = p.full_rounds // 2
        total = p.full_rounds + p.partial_rounds
        for rnd in range(total):
            ark_row = p.ark[rnd]
            state = [(s + a) % mod for s, a in zip(state, ark_row)]
            is_full = rnd < half_full or rnd >= half_full + p.partial_rounds
            if is_full:
                state = [pow(s, p.alpha, mod) for s in state]
            else:
                state[0] = pow(state[0], p.alpha, mod)
            state = [
                sum(m * s for m, s in zip(mrow, state)) % mod for mrow in p.mds
            ]
        self.state = state

    # -- absorb -------------------------------------------------------------

    def _absorb_elems(self, elems: List[int]) -> None:
        if not elems:
            return
        p = self.params
        if self.mode == _SQUEEZING:
            self.permute()
            self.index = 0
        elif self.index == p.rate:
            self.permute()
            self.index = 0
        self.mode = _ABSORBING
        i = self.index
        for e in elems:
            if i == p.rate:
                self.permute()
                i = 0
            self.state[p.capacity + i] = (self.state[p.capacity + i] + e) % p.modulus
            i += 1
        self.index = i

    def absorb_native(self, value: int) -> None:
        self._absorb_elems([value % self.params.modulus])

    def absorb_foreign_field(self, value: int, foreign_bits: int) -> None:
        """Absorb a foreign prime-field element (canonical LE bytes mod p)."""
        nbytes = (foreign_bits + 7) // 8
        # arkworks serializes to the full limb width (32/48 bytes), but the
        # value re-read mod the sponge modulus is unchanged by zero padding.
        del nbytes
        self._absorb_elems([value % self.params.modulus])

    def absorb_bytes(self, data: bytes) -> None:
        p = self.params
        chunk = (p.bits - 1) // 8
        elems = [
            int.from_bytes(data[i : i + chunk], "little") % p.modulus
            for i in range(0, len(data), chunk)
        ]
        self._absorb_elems(elems)

    def absorb_u64(self, value: int) -> None:
        self._absorb_elems([value % self.params.modulus])

    # -- squeeze ------------------------------------------------------------

    def squeeze_native(self, n: int) -> List[int]:
        p = self.params
        out: List[int] = []
        if self.mode == _ABSORBING:
            self.permute()
            self.index = 0
        elif self.index == p.rate:
            self.permute()
            self.index = 0
        self.mode = _SQUEEZING
        i = self.index
        for _ in range(n):
            if i == p.rate:
                self.permute()
                i = 0
            out.append(self.state[p.capacity + i])
            i += 1
        self.index = i
        return out

    def squeeze_bits(self, num_bits: int) -> List[int]:
        p = self.params
        usable = p.bits - 1
        n_elems = -(-num_bits // usable)
        elems = self.squeeze_native(n_elems)
        bits: List[int] = []
        for e in elems:
            bits.extend((e >> k) & 1 for k in range(usable))
        return bits[:num_bits]

    def squeeze_foreign_field(self, foreign_bits: int) -> int:
        """Squeeze one foreign prime-field element ((bits-1)-bit value)."""
        bits = self.squeeze_bits(foreign_bits - 1)
        v = 0
        for k, b in enumerate(bits):
            v |= b << k
        return v

    def squeeze_bytes(self, num_bytes: int) -> bytes:
        p = self.params
        usable = (p.bits - 1) // 8
        n_elems = -(-num_bytes // usable)
        elems = self.squeeze_native(n_elems)
        out = bytearray()
        width = (p.bits + 7) // 8 + 8  # enough bytes to slice from
        for e in elems:
            out += e.to_bytes(width, "little")[:usable]
        return bytes(out[:num_bytes])
