"""arkworks-canonical-compatible serialization for BLS12-377 objects.

Counterpart of testudo_tpu/serialize.py (host code, a copy).

Byte layouts mirror ark-serialize 0.4 as relied on by the reference
transcript (Testudo (Rust) src/poseidon_transcript.rs:22-28, 77-124):

  - Field elements: little-endian, fixed width (Fr: 32 bytes, Fq: 48 bytes).
  - Extension fields: components in tower order (c0 first), no flags; for
    extensions `Compress::Yes` == `Compress::No`.
  - G1/G2 uncompressed: x || y, with point flags in the top bits of the final
    byte of y (infinity = bit 6); infinity serializes x = y = 0.
  - G1/G2 compressed: x only, flags in the top bits of the final byte:
    bit 7 = y is "negative" (lexicographically larger than -y), bit 6 =
    infinity (with x = 0).
  - Vec<T>: u64 little-endian length prefix, then elements.
  - u64/usize: 8 bytes little-endian.

Note: with no Rust toolchain in this environment the flag-bit assignment
cannot be cross-checked against arkworks binaries; the layout above follows
ark-serialize 0.4's SWFlags and is used consistently on both the prover and
verifier sides of this implementation.
"""
from __future__ import annotations

from .fields.bls12_377 import P, R, FR_BYTES, FQ_BYTES
from .fields.host import Fq2, Fq6, Fq12

FLAG_INFINITY = 1 << 6
FLAG_Y_NEG = 1 << 7


def fr_to_bytes(x: int) -> bytes:
    return (x % R).to_bytes(FR_BYTES, "little")


def fq_to_bytes(x: int) -> bytes:
    return (x % P).to_bytes(FQ_BYTES, "little")


def fr_from_bytes(b: bytes):
    """Mirror of F::from_random_bytes (lib.rs:76): None when >= modulus."""
    v = int.from_bytes(b, "little")
    return v if v < R else None


def fq2_to_bytes(x: Fq2) -> bytes:
    return fq_to_bytes(x.c0) + fq_to_bytes(x.c1)


def fq6_to_bytes(x: Fq6) -> bytes:
    return fq2_to_bytes(x.c0) + fq2_to_bytes(x.c1) + fq2_to_bytes(x.c2)


def fq12_to_bytes(x: Fq12) -> bytes:
    return fq6_to_bytes(x.c0) + fq6_to_bytes(x.c1)


def _is_neg_fq(y: int) -> bool:
    # "negative" = y > -y in the canonical integer order
    return y > P - y


def _is_neg_fq2(y: Fq2) -> bool:
    # QuadExtField ordering: compare c1 first, then c0
    ny = -y
    if y.c1 != ny.c1:
        return y.c1 > ny.c1
    return y.c0 > ny.c0


def g1_to_bytes(pt, compress: bool) -> bytes:
    if compress:
        if pt is None:
            out = bytearray(fq_to_bytes(0))
            out[-1] |= FLAG_INFINITY
            return bytes(out)
        x, y = pt
        out = bytearray(fq_to_bytes(x))
        if _is_neg_fq(y % P):
            out[-1] |= FLAG_Y_NEG
        return bytes(out)
    if pt is None:
        out = bytearray(fq_to_bytes(0) * 2)
        out[-1] |= FLAG_INFINITY
        return bytes(out)
    x, y = pt
    return fq_to_bytes(x) + fq_to_bytes(y)


def g2_to_bytes(pt, compress: bool) -> bytes:
    if compress:
        if pt is None:
            out = bytearray(fq2_to_bytes(Fq2.zero()))
            out[-1] |= FLAG_INFINITY
            return bytes(out)
        x, y = pt
        out = bytearray(fq2_to_bytes(x))
        if _is_neg_fq2(y):
            out[-1] |= FLAG_Y_NEG
        return bytes(out)
    if pt is None:
        out = bytearray(fq2_to_bytes(Fq2.zero()) * 2)
        out[-1] |= FLAG_INFINITY
        return bytes(out)
    x, y = pt
    return fq2_to_bytes(x) + fq2_to_bytes(y)


def u64_to_bytes(x: int) -> bytes:
    return int(x).to_bytes(8, "little")


def vec_to_bytes(items, ser_fn) -> bytes:
    out = bytearray(u64_to_bytes(len(items)))
    for it in items:
        out += ser_fn(it)
    return bytes(out)


# ---------------------------------------------------------------------------
# Deserialization (CanonicalDeserialize equivalents)
#
# The reference derives CanonicalDeserialize on every proof struct
# (r1csproof.rs:32, mipp.rs:21, sparse_mlpoly.rs:1441); these readers are
# the byte-exact inverses of the writers above, including compressed-point
# decompression (sqrt + the SWFlags sign bit).
# ---------------------------------------------------------------------------


class DeserializeError(ValueError):
    pass


class Reader:
    """Byte cursor over a proof blob; every read_* consumes exactly the
    bytes its writer produced."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise DeserializeError(
                f"truncated input: need {n} bytes at {self.pos}, "
                f"have {len(self.buf) - self.pos}"
            )
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def finish(self):
        if self.pos != len(self.buf):
            raise DeserializeError(
                f"{len(self.buf) - self.pos} trailing bytes after proof"
            )


def read_u64(r: Reader) -> int:
    return int.from_bytes(r.take(8), "little")


def read_fr(r: Reader) -> int:
    v = int.from_bytes(r.take(FR_BYTES), "little")
    if v >= R:
        raise DeserializeError("non-canonical Fr element")
    return v


def read_fq(r: Reader) -> int:
    v = int.from_bytes(r.take(FQ_BYTES), "little")
    if v >= P:
        raise DeserializeError("non-canonical Fq element")
    return v


def read_fq2(r: Reader) -> Fq2:
    c0 = read_fq(r)
    return Fq2(c0, read_fq(r))


def read_fq6(r: Reader) -> Fq6:
    c0 = read_fq2(r)
    c1 = read_fq2(r)
    return Fq6(c0, c1, read_fq2(r))


def read_fq12(r: Reader) -> Fq12:
    c0 = read_fq6(r)
    return Fq12(c0, read_fq6(r))


def _check_fq_range(v: int, what: str) -> int:
    if v >= P:
        raise DeserializeError(f"non-canonical Fq coordinate in {what}")
    return v


def read_g1(r: Reader, compress: bool):
    """Inverse of g1_to_bytes; compressed decompression solves
    y^2 = x^3 + 1 and picks the root matching the sign flag.

    Matches ark-serialize Validate::Yes: every coordinate is
    range-checked < p, unexpected flag bits are rejected (our writers
    never set Y_NEG on uncompressed points, and infinity+neg is not a
    valid SWFlags combination), and prime-order-subgroup membership is
    enforced on top of the on-curve check."""
    if not compress:
        x = _check_fq_range(
            int.from_bytes(r.take(FQ_BYTES), "little"), "uncompressed G1 x"
        )
        raw = bytearray(r.take(FQ_BYTES))
        flags = raw[-1] & 0xC0
        raw[-1] &= 0x3F
        y = _check_fq_range(
            int.from_bytes(raw, "little"), "uncompressed G1 y"
        )
        if flags & FLAG_Y_NEG:
            raise DeserializeError("unexpected flag bits on uncompressed G1")
        if flags & FLAG_INFINITY:
            if x or y:
                raise DeserializeError("nonzero infinity encoding")
            return None
        pt = (x, y)
    else:
        raw = bytearray(r.take(FQ_BYTES))
        flags = raw[-1] & 0xC0
        raw[-1] &= 0x3F
        x = int.from_bytes(raw, "little")
        if flags == (FLAG_INFINITY | FLAG_Y_NEG):
            raise DeserializeError("invalid flag combination")
        if flags & FLAG_INFINITY:
            if x:
                raise DeserializeError("nonzero infinity encoding")
            return None
        _check_fq_range(x, "compressed G1 x")
        from .fields.host import fq_sqrt

        y = fq_sqrt((x * x % P * x + 1) % P)
        if y is None:
            raise DeserializeError("x not on curve")
        if _is_neg_fq(y) != bool(flags & FLAG_Y_NEG):
            y = P - y
        pt = (x, y)
    from .curves import host_curve as hc

    if not hc.g1_is_on_curve(pt):
        raise DeserializeError("G1 point not on curve")
    if hc.g1_mul(pt, R) is not None:
        raise DeserializeError("G1 point not in the r-order subgroup")
    return pt


def read_g2(r: Reader, compress: bool):
    if not compress:
        x = read_fq2(r)
        raw = bytearray(r.take(2 * FQ_BYTES))
        flags = raw[-1] & 0xC0
        raw[-1] &= 0x3F
        y = Fq2(
            _check_fq_range(
                int.from_bytes(raw[:FQ_BYTES], "little"), "uncompressed G2 y"
            ),
            _check_fq_range(
                int.from_bytes(raw[FQ_BYTES:], "little"), "uncompressed G2 y"
            ),
        )
        if flags & FLAG_Y_NEG:
            raise DeserializeError("unexpected flag bits on uncompressed G2")
        if flags & FLAG_INFINITY:
            if not (x.is_zero() and y.is_zero()):
                raise DeserializeError("nonzero infinity encoding")
            return None
        pt = (x, y)
    else:
        c0 = read_fq(r)
        raw = bytearray(r.take(FQ_BYTES))
        flags = raw[-1] & 0xC0
        raw[-1] &= 0x3F
        if flags == (FLAG_INFINITY | FLAG_Y_NEG):
            raise DeserializeError("invalid flag combination")
        c1 = int.from_bytes(raw, "little")
        x = Fq2(c0, c1)
        if flags & FLAG_INFINITY:
            if not x.is_zero():
                raise DeserializeError("nonzero infinity encoding")
            return None
        _check_fq_range(c1, "compressed G2 x.c1")
        from .curves.host_curve import B2

        y2 = x.square() * x + B2
        y = y2.sqrt()
        if y is None:
            raise DeserializeError("x not on twist curve")
        if _is_neg_fq2(y) != bool(flags & FLAG_Y_NEG):
            y = -y
        pt = (x, y)
    from .curves import host_curve as hc

    if not hc.g2_is_on_curve(pt):
        raise DeserializeError("G2 point not on curve")
    if hc.g2_mul(pt, R) is not None:
        raise DeserializeError("G2 point not in the r-order subgroup")
    return pt


def read_vec(r: Reader, de_fn):
    n = read_u64(r)
    if n > len(r.buf) - r.pos:  # each element is >= 1 byte
        raise DeserializeError(f"vec length {n} exceeds remaining input")
    return [de_fn(r) for _ in range(n)]
