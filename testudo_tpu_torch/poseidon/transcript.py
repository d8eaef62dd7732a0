"""Fiat-Shamir transcript over the Poseidon sponge.

Mirrors the reference PoseidonTranscript (Testudo (Rust) src/
poseidon_transcript.rs) including its encoding quirks:

  - `append_*` label arguments are IGNORED (reference :22, :30).
  - generic `append` serializes UNCOMPRESSED and absorbs the bytes (:22-28);
  - `append_point` / `append_gt` serialize COMPRESSED and absorb bytes
    (:77-86, :98-105);
  - `append_scalar` absorbs the field element itself (cross-field absorbs
    re-read canonical LE bytes mod the sponge modulus) (:73-75);
  - `challenge_scalar` may squeeze a field DIFFERENT from the sponge field
    (e.g. an Fr challenge out of an Fq sponge; squeezes bits) (:30-32);
  - `new_from_state(c)` = fresh sponge + append_scalar(c) (:50-54);
  - `new_from_state2(c)` = fresh sponge + generic append(c) (:57-62).

Counterpart of testudo_tpu/poseidon/transcript.py (host code, pure Python
ints): the BLS12-377 parameters over Fr and Fq, BLS12-381's rate-1 instance
over its Fr (`fr_params_381`) and the per-curve dispatch
(`params_for_curve`).  The sponge is generic over `PoseidonParams` (rate,
width, alpha); nothing here assumes rate 2.  A scalar's serialized width
follows its modulus (32 bytes up to 256 bits, else 48).
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence

from ..fields.bls12_377 import P, R
from ..fields.host import Fq12
from .. import serialize as ser
from .sponge import PoseidonParams, PoseidonSponge


@lru_cache(maxsize=None)
def fr_params() -> PoseidonParams:
    """poseidon_params() of the reference (parameters.rs:156-185)."""
    return PoseidonParams(R)


@lru_cache(maxsize=None)
def fq_params() -> PoseidonParams:
    """get_bls12377_fq_params() (parameters.rs:309-338); identical integers
    re-read in Fq (== params_to_base_field::<Bls12_377>()).  BW6-761's
    scalar field IS this Fq, so this doubles as get_bw6_fr_params()
    (parameters.rs:278-307)."""
    return PoseidonParams(P)


@lru_cache(maxsize=None)
def fr_params_381() -> PoseidonParams:
    """poseidon_params_bls12381() (parameters.rs:341-2585): the rate-1
    t=2 M=128 alpha=5 instance over BLS12-381 Fr (also the ark-blst
    scalar-field params, :2603-2624)."""
    from . import constants_381 as C381
    from ..fields.bls12_381 import R as R381

    return PoseidonParams(
        R381,
        ark=C381.ARK,
        mds=C381.MDS,
        full_rounds=C381.FULL_ROUNDS,
        partial_rounds=C381.PARTIAL_ROUNDS,
        alpha=C381.ALPHA,
        rate=C381.RATE,
        capacity=C381.CAPACITY,
    )


def params_for_curve(curve: str) -> PoseidonParams:
    """Per-curve scalar-field Poseidon dispatch: the counterpart of
    Testudo's `PoseidonConfiguration` trait (parameters.rs:2588-2634)."""
    if curve in ("bls12-377", "bls12_377"):
        return fr_params()
    if curve in ("bls12-381", "bls12_381", "blst"):
        return fr_params_381()
    raise ValueError(f"unknown curve: {curve}")


def _scalar_bytes(modulus: int) -> int:
    """Bytes of a serialized field element: arkworks writes whole 64-bit
    words (Fr of either BLS12 curve: 32; their Fq: 48)."""
    return (modulus.bit_length() + 63) // 64 * 8


class PoseidonTranscript:
    """A transcript over the field given by `params.modulus`."""

    def __init__(self, params: PoseidonParams):
        self.params = params
        self.sponge = PoseidonSponge(params)

    # -- state re-keying ----------------------------------------------------

    def new_from_state(self, challenge: int, field_modulus: int = None) -> None:
        """Fresh sponge re-keyed via append_scalar (reference :50-54).

        The challenge is an Fr scalar in all call sites; `field_modulus`
        names its field (default: BLS12-377's Fr).  Native and cross-field
        absorbs take the same value (the challenge mod the sponge's
        modulus), so the default changes no transcript of another curve."""
        self.sponge = PoseidonSponge(self.params)
        self.append_scalar(challenge, field_modulus or R)

    def new_from_state2_scalar(self, challenge: int, field_modulus: int) -> None:
        """Fresh sponge + generic append of a scalar (reference :57-62)."""
        self.sponge = PoseidonSponge(self.params)
        self.append_serialized_scalar(challenge, field_modulus)

    # -- appends ------------------------------------------------------------

    def append_scalar(self, value: int, field_modulus: int) -> None:
        """append_scalar: absorb a field element (native or foreign)."""
        if field_modulus == self.params.modulus:
            self.sponge.absorb_native(value)
        else:
            self.sponge.absorb_foreign_field(value, field_modulus.bit_length())

    def append_scalar_vector(self, values: Sequence[int], field_modulus: int) -> None:
        for v in values:
            self.append_scalar(v, field_modulus)

    def append_serialized_scalar(self, value: int, field_modulus: int) -> None:
        """Generic append of one scalar: uncompressed LE bytes absorbed."""
        nbytes = _scalar_bytes(field_modulus)
        self.sponge.absorb_bytes((value % field_modulus).to_bytes(nbytes, "little"))

    def append_g1_uncompressed(self, pt) -> None:
        """Generic append of a G1 point (e.g. MIPP's U and comm_u, mipp.rs:56,97-98)."""
        self.sponge.absorb_bytes(ser.g1_to_bytes(pt, compress=False))

    def append_g1_point(self, pt) -> None:
        """append_point/append_g1: compressed bytes (reference :77-86)."""
        self.sponge.absorb_bytes(ser.g1_to_bytes(pt, compress=True))

    def append_g2_uncompressed(self, pt) -> None:
        self.sponge.absorb_bytes(ser.g2_to_bytes(pt, compress=False))

    def append_g2_point(self, pt) -> None:
        self.sponge.absorb_bytes(ser.g2_to_bytes(pt, compress=True))

    def append_gt(self, x: Fq12) -> None:
        """append_gt: compressed == uncompressed for extensions (:98-105)."""
        self.sponge.absorb_bytes(ser.fq12_to_bytes(x))

    def append_gt_uncompressed(self, x: Fq12) -> None:
        """Generic append of a GT element (MIPP comm_t, mipp.rs:99-100)."""
        self.sponge.absorb_bytes(ser.fq12_to_bytes(x))

    def append_bytes(self, data: bytes) -> None:
        self.sponge.absorb_bytes(data)

    def append_u64(self, x: int) -> None:
        self.sponge.absorb_u64(x)

    # -- challenges ---------------------------------------------------------

    def challenge_scalar(self, field_modulus: int) -> int:
        if field_modulus == self.params.modulus:
            return self.sponge.squeeze_native(1)[0]
        return self.sponge.squeeze_foreign_field(field_modulus.bit_length())

    def challenge_scalar_vec(self, field_modulus: int, n: int) -> List[int]:
        return [self.challenge_scalar(field_modulus) for _ in range(n)]

    def challenge_fr(self) -> int:
        return self.challenge_scalar(R)

    def challenge_fr_vec(self, n: int) -> List[int]:
        return self.challenge_scalar_vec(R, n)
