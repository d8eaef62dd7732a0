"""Batched Weierstrass groups over any prime field (PyTorch): BW6-761.

Counterpart of testudo_tpu/tpu/curve_generic.py.  The RCB16 complete
formulas of device/curve.py (`_complete_add`, `_complete_add_mixed`,
`_complete_double`) are generic over a field-ops namespace; `FpGroup(spec, b)` gives them one for
y^2 = x^3 + b over the field of `spec`.  BW6-761's G1 (b = -1) and G2
(b = 4, the sextic twist) both live over its 761-bit base field, so
`bw6_g1()` and `bw6_g2()` are two such groups over `FQ761`, and the
one-level Groth16 wrap (core/groth16_bw6.py) runs its keys and MSMs on them.

A point is a tuple (X, Y, Z) of (..., 48) int32 limb tensors in Montgomery
form (R = 2^768), homogeneous projective; the identity is (0 : 1 : 0).  The
additions, subtractions and selects are tensor ops (the JAX package's XLA
ops); every product goes through `field.mont_mul`, so on CUDA tensors each
stage of a formula is ONE launch of the row-major Montgomery kernel at 48
limbs (csrc/mont_mul_rm.cu) over the stage's stacked products, and on CPU
tensors it is the kernel's plain version.  The sums and differences are
this module's `add` / `sub`, the values of `field.add` / `field.sub` in
int32 tensors: two bulk carry pushes, and the carry-lookahead only when a
carry is still in flight, where `field.add` / `sub` widen every limb to
int64 and always run the lookahead.  A formula's nineteen sums move most of
its bytes; these take a third of the time at 2^20 lanes and fewer launches
at narrow widths (tools/exp_bw6.py measures both forms at 384 to 2^20
lanes).

`fixed_base_mul` takes the scalars 8 bits at a time from a host table of the
base's affine multiples: 48 batched mixed adds and selects for 384-bit
scalars, where the JAX package runs 384 steps of a complete add and a
select.  The points are the same; their projective limbs are not (compare
them in affine).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List

import torch
import torch.nn.functional as F

from ..fields import bw6_761 as bwf
from . import field as tf
from .curve import _complete_add, _complete_add_mixed, _complete_double
from .field import FieldSpec

FQ761 = FieldSpec(bwf.Q, 48, "bw6fq")

FIXED_BASE_WINDOW = 8  # scalar bits a step of `fixed_base_mul` takes


def _push(x: torch.Tensor):
    """One bulk carry push: (limbs, the carry out of the top limb)."""
    hi = x >> tf.LIMB_BITS
    return (x & tf.MASK) + F.pad(hi[..., :-1], (1, 0)), hi[..., -1]


def _resolve32(x: torch.Tensor):
    """int32 limbs (..., n), each < 2^18 -> (canonical limbs of the value mod
    2^(16 n), the carry out of limb n - 1).  Two bulk pushes settle every
    carry but one that meets a run of 0xFFFF limbs; when such a carry is
    left (rare in data, forced by the tests) the field module's
    carry-lookahead finishes exactly, the carry out as limb n."""
    n = x.shape[-1]
    v, c1 = _push(x)
    v, c2 = _push(v)
    carry = (c1 + c2).to(torch.int64)
    if bool((v > tf.MASK).any()):
        r = tf._resolve(v.to(torch.int64), n + 1, False)
        v, carry = r[..., :n].to(torch.int32), carry + r[..., n]
    return v, carry


def _limbs32(limbs, like: torch.Tensor) -> torch.Tensor:
    return tf._const(limbs, like).to(torch.int32)


def _pair(x: torch.Tensor, y: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """(2, ...) int32: x + y, then x + y + off, in one buffer."""
    out = torch.empty((2,) + tuple(torch.broadcast_shapes(x.shape, y.shape)),
                      dtype=torch.int32, device=x.device)
    torch.add(x, y, out=out[0])
    torch.add(out[0], off, out=out[1])
    return out


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod q for canonical limbs, 2q < 2^(16 n): s = a + b and
    s + 2^(16 n) - q resolved side by side; the second carries out of the
    top limb exactly when s >= q, and its limbs are then s - q."""
    n = spec.nlimbs
    off = _limbs32(tf._int_to_limbs((1 << (16 * n)) - spec.modulus, n), a)
    res, carry = _resolve32(_pair(a, b, off))
    return torch.where((carry[1] > 0)[..., None], res[1], res[0])


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod q for canonical limbs: d = a + ~b + 1 = a - b + 2^(16 n)
    carries out of the top limb exactly when a >= b; otherwise d + q mod
    2^(16 n) is a - b + q."""
    n = spec.nlimbs
    d = (tf.MASK - b) + _limbs32(tf._int_to_limbs(1, n), b)
    res, carry = _resolve32(_pair(a, d, _limbs32(spec.p_limbs, a)))
    return torch.where((carry[0] > 0)[..., None], res[0], res[1])


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return sub(spec, torch.zeros_like(a), a)


class _Ops:
    """Field-ops namespace of one group for the RCB16 formulas."""

    def __init__(self, spec: FieldSpec, b: int):
        self.spec = spec
        self._b3 = tf.const_array(spec, 3 * b % spec.modulus)

    def _b3_on(self, like: torch.Tensor) -> torch.Tensor:
        return tf._const(self._b3, like).to(torch.int32)

    def add(self, a, b_):
        return add(self.spec, a, b_)

    def sub(self, a, b_):
        return sub(self.spec, a, b_)

    def mul_many(self, pairs):
        A = torch.stack([p[0] for p in pairs], dim=0)
        B = torch.stack([p[1] for p in pairs], dim=0)
        return list(tf.mont_mul(self.spec, A, B).unbind(0))

    def mul_b3(self, x):
        return tf.mont_mul(self.spec, x, self._b3_on(x))

    def mul_b3_pair(self, x, y):
        out = tf.mont_mul(self.spec, torch.stack([x, y], dim=0), self._b3_on(x))
        return out[0], out[1]

    @staticmethod
    def select(c, a, b_):
        return tf.select(c, a, b_)


@dataclass(frozen=True)
class FpGroup:
    """Batched group ops for y^2 = x^3 + b over a prime field."""

    spec: FieldSpec
    b: int

    @functools.cached_property
    def _ops(self) -> _Ops:
        return _Ops(self.spec, self.b)

    def add(self, p1, p2):
        return _complete_add(self._ops, p1, p2)

    def add_mixed(self, p1, p2):
        """p1 + p2 for an affine p2 = (x, y) that is not the identity."""
        return _complete_add_mixed(self._ops, p1, p2)

    def double(self, p):
        return _complete_double(self._ops, p)

    def neg(self, p):
        return (p[0], neg(self.spec, p[1]), p[2])

    def select(self, cond, p1, p2):
        return tuple(tf.select(cond, a, b) for a, b in zip(p1, p2))

    def identity(self, batch_shape=(), device=torch.device("cuda")):
        shape = tuple(batch_shape) + (self.spec.nlimbs,)
        one = torch.as_tensor(tf.const_array(self.spec, 1), device=device)
        return (
            torch.zeros(shape, dtype=torch.int32, device=device),
            one.expand(shape).contiguous(),
            torch.zeros(shape, dtype=torch.int32, device=device),
        )

    # -- host <-> device ----------------------------------------------------

    def from_affine_host(self, points: List, device=torch.device("cuda")):
        """Affine host points ((x, y) ints or None) -> projective limb tensors."""
        cols = ([], [], [])
        for pt in points:
            for col, v in zip(cols, (0, 1, 0) if pt is None else (pt[0], pt[1], 1)):
                col.append(v)
        return tuple(torch.as_tensor(self.spec.encode(c), device=device) for c in cols)

    def to_affine_host(self, p) -> List:
        """Projective limb tensors -> affine host points (copies to the host)."""
        spec, q = self.spec, self.spec.modulus
        X, Y, Z = (spec.decode(c.detach().cpu().reshape(-1, spec.nlimbs)) for c in p)
        out = []
        for x, y, z in zip(X, Y, Z):
            if z == 0:
                out.append(None)
            else:
                zi = pow(z, -1, q)
                out.append((x * zi % q, y * zi % q))
        return out


@functools.lru_cache(maxsize=None)
def bw6_g1() -> FpGroup:
    return FpGroup(FQ761, bwf.B1)


@functools.lru_cache(maxsize=None)
def bw6_g2() -> FpGroup:
    return FpGroup(FQ761, bwf.B2)


@functools.lru_cache(maxsize=8)
def _window_table(base_host, host_add, nwin: int) -> List:
    """d * 2^(8 w) * base for w < nwin, 0 < d < 256, row-major by w (row
    w * 256 + d; row w * 256 holds 2^(8 w) * base, a stand-in for d = 0):
    host affine points."""
    c = FIXED_BASE_WINDOW
    rows, step = [], base_host
    for _ in range(nwin):
        acc = step
        rows.append(step)
        for _ in range(1, 1 << c):
            rows.append(acc)
            acc = host_add(acc, step)
        step = acc  # 2^c * step
    return rows


def _window_digits(scalars_canon: torch.Tensor, w: int) -> torch.Tensor:
    c = FIXED_BASE_WINDOW
    per = 16 // c
    limb = scalars_canon[:, w // per].to(torch.int64)
    return (limb >> ((w % per) * c)) & ((1 << c) - 1)


def fixed_base_mul(G: FpGroup, scalars_canon: torch.Tensor, base_host, host_add):
    """[s_i] * base for one shared host affine base: a projective batch on
    the scalars' device.  `scalars_canon` is (N, k) canonical 16-bit limbs
    (any width), `host_add` the host affine addition of the group.  Step w
    adds the affine table row of window w's digit to every lane (one batched
    complete mixed add; lanes whose digit is 0 keep their sum); windows that
    are zero in every lane are skipped.  Every table row must be a point, not
    the identity: true for a base of prime order above 2^8, such as either
    BW6 generator."""
    dev = scalars_canon.device
    nwin = 16 * scalars_canon.shape[1] // FIXED_BASE_WINDOW
    rows = _window_table(base_host, host_add, nwin)
    if any(pt is None for pt in rows):
        raise ValueError("fixed_base_mul: a table row is the identity (the base's order is small)")
    tx, ty, _ = G.from_affine_host(rows, device=dev)
    width = 1 << FIXED_BASE_WINDOW
    acc = G.identity((scalars_canon.shape[0],), device=dev)
    for w in range(nwin):
        digits = _window_digits(scalars_canon, w)
        if not bool(digits.any()):
            continue
        idx = digits + w * width
        new = G.add_mixed(acc, (tx.index_select(0, idx), ty.index_select(0, idx)))
        acc = G.select(digits != 0, new, acc)
    return acc
