"""Vectorised big-field arithmetic on limb tensors (PyTorch).

Counterpart of testudo_tpu/tpu/field.py: `FieldSpec`, `FR`, `FQ`, `FR381`, `add`,
`sub`, `neg`, `mont_mul`, `mont_sqr`, `pow_fixed`, `inv`, `reduce_sum`,
`_fold_wide`, `select`, `const_array`, `is_zero`.

A field element is `nlimbs` little-endian 16-bit limbs in Montgomery form
(R = 2^(16 * nlimbs)), the same integers the JAX package holds.  PyTorch's
CPU backend has no uint32 arithmetic, so limb tensors are `torch.int32`
(values < 2^16) and these functions compute in int64.  All ops are
elementwise over the leading (batch) axes and run on whatever device the
tensors lie on.  `add`, `sub`, `neg` and `select` are plain tensor code on
every device.  `mont_mul` is the exception: on a CUDA tensor it launches
the hand-written row-major Montgomery kernel (device/packed_field.py
`mont_mul_rm`), at every batch size; `mont_mul_plain` below is that
kernel's plain version and is what a CPU tensor takes.  `pow_fixed`, `inv`
and `reduce_sum` are built on `mont_mul`.

Carries are resolved by a carry-lookahead that packs the generate and
propagate bits of all limbs into one int64 (`_resolve`), which keeps the
op count per field operation small: the CPU tests run hundreds of
sequential group operations.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ..fields.bls12_377 import P, R
from ..fields.bls12_381 import R as R381

LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1


def _int_to_limbs(x: int, n: int) -> np.ndarray:
    return np.frombuffer(int(x).to_bytes(2 * n, "little"), dtype="<u2").astype(
        np.int32
    )


@dataclass(frozen=True)
class FieldSpec:
    """Static description of a prime field in limb representation."""

    modulus: int
    nlimbs: int
    name: str

    @property
    def mont_r(self) -> int:
        return 1 << (LIMB_BITS * self.nlimbs)

    @property
    def p_limbs(self) -> np.ndarray:
        return _int_to_limbs(self.modulus, self.nlimbs)

    @property
    def nprime_limbs(self) -> np.ndarray:
        """-p^{-1} mod R as limbs (for the one-shot m = T*N' mod R)."""
        npr = (-pow(self.modulus, -1, self.mont_r)) % self.mont_r
        return _int_to_limbs(npr, self.nlimbs)

    @property
    def r_mod_p(self) -> int:
        return self.mont_r % self.modulus

    @property
    def r2_mod_p(self) -> int:
        return self.mont_r * self.mont_r % self.modulus

    # -- host <-> limb conversion (numpy int32, values < 2^16) --------------

    def to_limbs(self, values) -> np.ndarray:
        if isinstance(values, int):
            return _int_to_limbs(values % self.modulus, self.nlimbs)
        buf = b"".join(
            (int(v) % self.modulus).to_bytes(2 * self.nlimbs, "little")
            for v in values
        )
        arr = np.frombuffer(buf, dtype="<u2").astype(np.int32)
        return arr.reshape(len(values), self.nlimbs)

    def from_limbs(self, arr) -> List[int]:
        a = _to_numpy(arr)
        flat = a.reshape(-1, self.nlimbs).astype("<u2")
        return [int.from_bytes(row.tobytes(), "little") for row in flat]

    def from_limbs_single(self, arr) -> int:
        return self.from_limbs(arr)[0]

    def to_mont_int(self, x: int) -> int:
        return x * self.mont_r % self.modulus

    def from_mont_int(self, x: int) -> int:
        return x * pow(self.mont_r, -1, self.modulus) % self.modulus

    def encode(self, values) -> np.ndarray:
        """ints -> Montgomery-form limb array (the device representation)."""
        if isinstance(values, int):
            return self.to_limbs(self.to_mont_int(values % self.modulus))
        return self.to_limbs([self.to_mont_int(v % self.modulus) for v in values])

    def decode(self, arr) -> List[int]:
        rinv = pow(self.mont_r, -1, self.modulus)
        return [v * rinv % self.modulus for v in self.from_limbs(arr)]


def _to_numpy(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


FR = FieldSpec(R, 16, "fr")
FQ = FieldSpec(P, 24, "fq")
# BLS12-381's scalar field, the Fr tables of curves/profile.py's bls12_381
# (the JAX package's FieldSpec(r381, 16, "fr381"), curves/profile.py:304)
FR381 = FieldSpec(R381, 16, "fr381")


# ---------------------------------------------------------------------------
# Carry machinery: one carry-lookahead over the limb axis, in int64
# ---------------------------------------------------------------------------


def _shift_up(x: torch.Tensor, d: int) -> torch.Tensor:
    """Shift limbs toward higher indices by d (value * 2^(16 d)), zero fill."""
    return F.pad(x[..., :-d], (d, 0))


_LOOKAHEAD = 56  # positions one int64 carry-lookahead resolves: A + B < 2^57


def _resolve(t: torch.Tensor, nout: int, wide: bool) -> torch.Tensor:
    """Relaxed non-negative int64 limbs -> canonical 16-bit limbs of the
    value mod 2^(16 nout).  Limbs are < 2^18, or < 2^47 with `wide`.

    After the bulk carries are pushed one position up every limb is
    < 2^16 + 4, so each position either generates a carry (g), propagates
    an incoming one (p: limb == 0xFFFF) or absorbs it.  g and p are
    disjoint, so packing them as the bits of two integers A = g|p, B = g
    makes ONE int64 addition run the whole ripple: the carry into position
    k is bit k of (A + B) ^ p.  One addition covers `_LOOKAHEAD` positions;
    a longer limb axis (the 761-bit field's 97-limb products) runs one per
    block of positions, each taking the carry out of the one below."""
    k = t.shape[-1]
    if k < nout:
        t = F.pad(t, (0, nout - k))
    else:
        t = t[..., :nout]
    if wide:  # three 16-bit digits of every limb land on three positions
        t = (t & MASK) + _shift_up((t >> LIMB_BITS) & MASK, 1) + _shift_up(
            t >> (2 * LIMB_BITS), 2
        )
    v = (t & MASK) + _shift_up(t >> LIMB_BITS, 1)
    r = v & MASK
    gen = v >> LIMB_BITS
    prop = (r == MASK).to(torch.int64)
    outs, carry = [], None
    for lo in range(0, nout, _LOOKAHEAD):
        hi = min(nout, lo + _LOOKAHEAD)
        pos = torch.arange(hi - lo, device=t.device)
        g = (gen[..., lo:hi] << pos).sum(dim=-1)
        p = (prop[..., lo:hi] << pos).sum(dim=-1)
        s = (g | p) + g
        if carry is not None:
            s = s + carry
        cin = (s ^ p)[..., None] >> pos
        outs.append((r[..., lo:hi] + (cin & 1)) & MASK)
        carry = (s >> (hi - lo)) & 1
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


@functools.lru_cache(maxsize=256)
def _const_on(data: bytes, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.frombuffer(data, dtype=np.int64).copy(), device=device)


def _const(limbs: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A constant limb vector as int64 on `like`'s device, copied there once
    (a copy to the card waits for it: the field ops must not copy per call).
    Callers never write to it."""
    return _const_on(limbs.astype(np.int64).tobytes(), like.device)


def _check_limbs(spec: FieldSpec, *xs: torch.Tensor) -> None:
    for x in xs:
        if x.dtype != torch.int32:
            raise TypeError(f"limb tensors are int32, got {x.dtype}")
        if x.shape[-1] != spec.nlimbs:
            raise ValueError(
                f"{spec.name} elements have {spec.nlimbs} limbs, got shape {tuple(x.shape)}"
            )


def _resolve_with_offset(spec: FieldSpec, x: torch.Tensor, offset: int):
    """Canonical (..., n+2) limbs of X and of X + offset, resolved side by
    side in one stacked carry pass.  x: relaxed limbs (< 2^17 each) of a
    value X < 2^(16 n + 1); offset < 2^(16 (n+1))."""
    n = spec.nlimbs
    x = F.pad(x, (0, n + 2 - x.shape[-1]))
    off = _const(_int_to_limbs(offset, n + 2), x)
    return _resolve(torch.stack([x, x + off], dim=0), n + 2, False)


def _cond_sub_p(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Relaxed limbs of a value X < 2p -> canonical limbs of X mod p.
    X + (2^(16 (n+1)) - p) carries into limb n+1 exactly when X >= p, and
    its low n limbs are then X - p."""
    n = spec.nlimbs
    plain, shifted = _resolve_with_offset(
        spec, x, (1 << (LIMB_BITS * (n + 1))) - spec.modulus
    )
    need = shifted[..., n + 1] > 0
    return torch.where(need[..., None], shifted[..., :n], plain[..., :n])


# ---------------------------------------------------------------------------
# Field ops
# ---------------------------------------------------------------------------


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p for canonical-limb inputs."""
    _check_limbs(spec, a, b)
    return _cond_sub_p(spec, a.to(torch.int64) + b.to(torch.int64)).to(torch.int32)


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p for canonical-limb inputs."""
    _check_limbs(spec, a, b)
    n = spec.nlimbs
    # a + ~b + 1 = a - b + 2^(16 n): limb n is set exactly when a >= b
    x = a.to(torch.int64) + (MASK - b.to(torch.int64))
    x = x + _const(_int_to_limbs(1, n), x)
    plain, fixed = _resolve_with_offset(spec, x, spec.modulus)
    geq = plain[..., n] > 0
    return torch.where(geq[..., None], plain[..., :n], fixed[..., :n]).to(torch.int32)


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return sub(spec, torch.zeros_like(a), a)


def _shear_cols(M: torch.Tensor) -> torch.Tensor:
    """Anti-diagonal column sums: M (..., n, n) -> T (..., 2n-1) with
    T[k] = sum_{i+j=k} M[i, j].  One pad, one reshape, one sum: rows padded
    to width 2n and re-cut at width 2n-1 slide row i right by i."""
    n = M.shape[-1]
    batch = M.shape[:-2]
    flat = F.pad(M, (0, n)).reshape(batch + (2 * n * n,))
    return flat[..., : n * (2 * n - 1)].reshape(batch + (n, 2 * n - 1)).sum(dim=-2)


def _mul_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full product in relaxed columns: (..., n) x (..., n) -> (..., 2n-1)
    int64.  Each column is a sum of at most n products < 2^32, so < 2^37."""
    return _shear_cols(a[..., :, None] * b[..., None, :])


# int64 entries of the column products one plain call holds at once: larger
# batches are cut into slices (a 761-bit element's matrix is 4,608 entries)
_PLAIN_ENTRIES = {"cpu": 1 << 23, "cuda": 1 << 28}


def _mont_mul_cols(spec: FieldSpec, a64: torch.Tensor, b64: torch.Tensor) -> torch.Tensor:
    n = spec.nlimbs
    Tn = _resolve(_mul_cols(a64, b64), 2 * n, True)  # canonical limbs of a*b
    t_lo = Tn[..., :n]
    m = _resolve(_mul_cols(t_lo, _const(spec.nprime_limbs, t_lo).expand_as(t_lo)), n, True)
    U = _mul_cols(m, _const(spec.p_limbs, m).expand_as(m))
    Sn = _resolve(Tn + F.pad(U, (0, 1)), 2 * n + 1, True)
    # S is divisible by R: its low half is zero, its high n+1 limbs are < 2p
    return _cond_sub_p(spec, Sn[..., n:]).to(torch.int32)


def mont_mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^{-1} mod p in plain tensor ops (non-interleaved:
    T = a*b, m = T*N' mod R, S = T + m*p, result S/R with one conditional
    subtract).  Canonical 16-bit limbs < p in and out.  This is the plain
    version of the Montgomery kernel."""
    _check_limbs(spec, a, b)
    n = spec.nlimbs
    a64, b64 = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
    rows = max(1, _PLAIN_ENTRIES.get(a64.device.type, 1 << 28) // (2 * n * n))
    count = a64[..., 0].numel()
    if count <= rows:
        return _mont_mul_cols(spec, a64, b64)
    a2, b2 = a64.reshape(count, n), b64.reshape(count, n)
    out = torch.cat([_mont_mul_cols(spec, a2[i: i + rows], b2[i: i + rows])
                     for i in range(0, count, rows)])
    return out.reshape(a64.shape)


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^{-1} mod p with broadcasting.  CUDA tensors
    go through the hand-written row-major kernel (packed_field.mont_mul_rm)
    at every batch size; CPU tensors take the plain version."""
    if a.is_cuda or b.is_cuda:
        from . import packed_field

        return packed_field.mont_mul_rm(spec, a, b)
    return mont_mul_plain(spec, a, b)


def mont_sqr(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, a, a)


def pow_fixed(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e (Montgomery form in and out) for a Python int e >= 0:
    LSB-first square-and-multiply, one product and one square per bit."""
    if e < 0:
        raise ValueError("pow_fixed: negative exponent")
    one = torch.as_tensor(_int_to_limbs(spec.r_mod_p, spec.nlimbs), device=a.device)
    res, base = one.expand(a.shape).contiguous(), a
    for i in range(e.bit_length()):
        if (e >> i) & 1:
            res = mont_mul(spec, res, base)
        if i + 1 < e.bit_length():
            base = mont_sqr(spec, base)
    return res


def inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Batched inverse by Fermat: a^(p-2).  0 maps to 0."""
    return pow_fixed(spec, a, spec.modulus - 2)


def _fold_wide(spec: FieldSpec, t: torch.Tensor, mul=mont_mul) -> torch.Tensor:
    """Relaxed non-negative int64 limbs (each < 2^47, value < 2^(16 (n+2)))
    -> the canonical int32 element of the value mod p.  value = lo + hi *
    2^(16 n); lo mod p = mul(lo, R mod p), hi * 2^(16 n) mod p =
    mul(hi, R^2 mod p).  `mul` is the Montgomery product to use."""
    n = spec.nlimbs
    c = _resolve(t, n + 2, True).to(torch.int32)
    lo = c[..., :n].contiguous()
    hi = F.pad(c[..., n:], (0, n - 2))
    r1 = torch.as_tensor(_int_to_limbs(spec.r_mod_p, n), device=t.device)
    r2 = torch.as_tensor(_int_to_limbs(spec.r2_mod_p, n), device=t.device)
    return add(spec, mul(spec, lo, r1), mul(spec, hi, r2))


def reduce_sum(spec: FieldSpec, a: torch.Tensor, axis: int = 0, mul=mont_mul) -> torch.Tensor:
    """Sum of field elements along `axis` (mod p), any domain.  Limbs are
    below 2^16 and are summed in int64, so up to 2^31 elements need no
    chunking; the result is the canonical element, whatever the order of
    the additions.  `mul=mont_mul_plain` keeps it plain tensor code on a
    CUDA tensor too."""
    _check_limbs(spec, a)
    if axis < 0:
        axis += a.dim()
    if not 0 <= axis < a.dim() - 1:
        raise ValueError(f"reduce_sum: axis {axis} is not a batch axis of {tuple(a.shape)}")
    if a.shape[axis] >= 1 << 31:
        raise ValueError("reduce_sum: more than 2^31 - 1 elements along the axis")
    return _fold_wide(spec, a.sum(dim=axis, dtype=torch.int64), mul)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(cond[..., None], a, b)


def const_array(spec: FieldSpec, value: int, mont: bool = True) -> np.ndarray:
    if not isinstance(value, int):
        raise TypeError(value)
    v = spec.to_mont_int(value % spec.modulus) if mont else value % spec.modulus
    return _int_to_limbs(v, spec.nlimbs)


def is_zero(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    _check_limbs(spec, a)
    return (a == 0).all(dim=-1)
