"""Batched BLS12-377 G1 and G2 arithmetic on limb tensors (PyTorch).

Counterpart of testudo_tpu/tpu/curve.py: device Fq2, the complete
Renes-Costello-Batina (EuroCrypt 2016) formulas for a = 0 curves
(`_complete_add` Algorithm 7, `_complete_add_mixed` Algorithm 8,
`_complete_double` Algorithm 9) evaluated over a field-ops namespace, the
public `g1_*` / `g2_*` (add, double, neg, select, identity), the host
conversions, `fixed_base_mul_g1/g2` and `scalar_mul_batch_g1/g2`.

G1 points are tuples (X, Y, Z) of (..., 24) int32 limb tensors in
Montgomery form, homogeneous projective; the identity is (0 : 1 : 0).  G2
points are the same over Fq2 = Fq[u] / (u^2 + 5): every coordinate is a
(c0, c1) pair of such tensors, the identity is ((0, 0), (1, 0), (0, 0)).
The formulas are staged exactly as in the JAX package (independent
products of a stage stacked into one `mont_mul` call) so results agree
limb for limb.  These same three functions are the group law of the plain
versions of the packed kernels (device/packed_curve.py).  On CUDA tensors
`g1_add`/`g2_add`/`fq2_mul`... reach the Montgomery kernel through
`field.mont_mul`.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from ..curves.host_curve import B2
from ..fields.bls12_377 import P
from ..fields.host import Fq2 as HostFq2
from ..utils.timer import Timer
from . import field as tf
from .field import FQ, LIMB_BITS

G1Point = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Fq2Dev = Tuple[torch.Tensor, torch.Tensor]
G2Point = Tuple[Fq2Dev, Fq2Dev, Fq2Dev]

# b3 = 3 b2 = (0, k) in Fq2 with k = -3/5 mod p, so b3 (a0 + a1 u) =
# (-5 k a1, k a0) = (3 a1, k a0).
_B3_K = (B2 + B2 + B2).c1


# ---------------------------------------------------------------------------
# Device Fq2 arithmetic (for G2)
# ---------------------------------------------------------------------------


def fq2_add(a: Fq2Dev, b: Fq2Dev) -> Fq2Dev:
    return (tf.add(FQ, a[0], b[0]), tf.add(FQ, a[1], b[1]))


def fq2_sub(a: Fq2Dev, b: Fq2Dev) -> Fq2Dev:
    return (tf.sub(FQ, a[0], b[0]), tf.sub(FQ, a[1], b[1]))


def fq2_neg(a: Fq2Dev) -> Fq2Dev:
    return (tf.neg(FQ, a[0]), tf.neg(FQ, a[1]))


def fq2_select(cond: torch.Tensor, a: Fq2Dev, b: Fq2Dev) -> Fq2Dev:
    return (tf.select(cond, a[0], b[0]), tf.select(cond, a[1], b[1]))


def _fq2_mul_many(pairs, mont_mul=tf.mont_mul):
    """Batched Karatsuba: one stacked product of 3k Fq elements for k Fq2
    products; the non-residue -5 folds in by additions (c0 = t0 - 5 t1)."""
    k = len(pairs)
    sides = []
    for side in (0, 1):
        sides.append(torch.stack(
            [p[side][0] for p in pairs]
            + [p[side][1] for p in pairs]
            + [tf.add(FQ, p[side][0], p[side][1]) for p in pairs],
            dim=0,
        ))
    out = mont_mul(FQ, sides[0], sides[1])
    t0, t1, s = out[:k], out[k : 2 * k], out[2 * k :]
    c1 = tf.sub(FQ, tf.sub(FQ, s, t0), t1)
    t1_2 = tf.add(FQ, t1, t1)
    c0 = tf.sub(FQ, t0, tf.add(FQ, tf.add(FQ, t1_2, t1_2), t1))
    return [(c0[i], c1[i]) for i in range(k)]


def fq2_mul(a: Fq2Dev, b: Fq2Dev) -> Fq2Dev:
    return _fq2_mul_many([(a, b)])[0]


class _G1Ops:
    """Field-ops namespace over (..., 24) int32 Fq limb tensors."""

    @staticmethod
    def add(a, b):
        return tf.add(FQ, a, b)

    @staticmethod
    def sub(a, b):
        return tf.sub(FQ, a, b)

    @staticmethod
    def mul_many(pairs):
        A = torch.stack([p[0] for p in pairs], dim=0)
        B = torch.stack([p[1] for p in pairs], dim=0)
        out = tf.mont_mul(FQ, A, B)
        return [out[i] for i in range(len(pairs))]

    @staticmethod
    def mul_b3(x):
        # b3 = 3 b = 3 for G1
        return tf.add(FQ, tf.add(FQ, x, x), x)

    @classmethod
    def mul_b3_pair(cls, x, y):
        return cls.mul_b3(x), cls.mul_b3(y)

    @staticmethod
    def select(c, a, b):
        return tf.select(c, a, b)


class _G1PlainOps(_G1Ops):
    """The same namespace with the product pinned to the plain tensor-op
    version on every device: the group law of the kernels' plain versions,
    which must not launch a kernel even on CUDA tensors."""

    @staticmethod
    def mul_many(pairs):
        A = torch.stack([p[0] for p in pairs], dim=0)
        B = torch.stack([p[1] for p in pairs], dim=0)
        out = tf.mont_mul_plain(FQ, A, B)
        return [out[i] for i in range(len(pairs))]


def _times3(v):
    return tf.add(FQ, tf.add(FQ, v, v), v)


class _G2Ops:
    """Field-ops namespace over Fq2 elements ((c0, c1) pairs of (..., 24)
    int32 Fq limb tensors)."""

    _mont_mul = staticmethod(tf.mont_mul)
    add = staticmethod(fq2_add)
    sub = staticmethod(fq2_sub)
    select = staticmethod(fq2_select)

    @classmethod
    def mul_many(cls, pairs):
        return _fq2_mul_many(pairs, cls._mont_mul)

    @classmethod
    def mul_b3_pair(cls, x, y):
        # b3 a = (3 a1, k a0): the two k-products go through one call
        kc = torch.as_tensor(tf.const_array(FQ, _B3_K), device=x[0].device)
        out = cls._mont_mul(FQ, torch.stack([x[0], y[0]], dim=0), kc)
        return (_times3(x[1]), out[0]), (_times3(y[1]), out[1])

    @classmethod
    def mul_b3(cls, x):
        kc = torch.as_tensor(tf.const_array(FQ, _B3_K), device=x[0].device)
        return (_times3(x[1]), cls._mont_mul(FQ, x[0], kc))


class _G2PlainOps(_G2Ops):
    """`_G2Ops` with the product pinned to the plain tensor-op version on
    every device (see `_G1PlainOps`)."""

    _mont_mul = staticmethod(tf.mont_mul_plain)


def _complete_add(F, p1, p2):
    """RCB16 Algorithm 7 (a = 0): complete projective addition, staged."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    # stage 1: all pairwise coordinate products
    t0, t1, t2, m3, m4, m5 = F.mul_many(
        [
            (X1, X2),
            (Y1, Y2),
            (Z1, Z2),
            (F.add(X1, Y1), F.add(X2, Y2)),
            (F.add(Y1, Z1), F.add(Y2, Z2)),
            (F.add(X1, Z1), F.add(X2, Z2)),
        ]
    )
    t3 = F.sub(m3, F.add(t0, t1))
    t4 = F.sub(m4, F.add(t1, t2))
    Y3 = F.sub(m5, F.add(t0, t2))
    X3 = F.add(t0, t0)
    t0 = F.add(X3, t0)
    t2b, Y3b = F.mul_b3_pair(t2, Y3)
    Z3 = F.add(t1, t2b)
    t1 = F.sub(t1, t2b)
    # stage 3: six independent products
    a1, a2, a3, a4, a5, a6 = F.mul_many(
        [(t4, Y3b), (t3, t1), (Y3b, t0), (t1, Z3), (t0, t3), (Z3, t4)]
    )
    X3 = F.sub(a2, a1)
    Y3 = F.add(a4, a3)
    Z3 = F.add(a6, a5)
    return (X3, Y3, Z3)


def _complete_add_mixed(F, p1, p2):
    """RCB16 Algorithm 8 (a = 0, Z2 = 1): complete mixed addition.

    p2 = (X2, Y2) is affine (the projective Z2 is implicitly mont(1)).
    Complete for ANY p1 (identity, p1 = +-p2) but p2 must not be the
    identity: callers mask such lanes."""
    X1, Y1, Z1 = p1
    X2, Y2 = p2
    t0, t1, m3, m4, m5 = F.mul_many(
        [
            (X1, X2),
            (Y1, Y2),
            (F.add(X1, Y1), F.add(X2, Y2)),
            (Y2, Z1),
            (X2, Z1),
        ]
    )
    t3 = F.sub(m3, F.add(t0, t1))
    t4 = F.add(m4, Y1)
    Y3 = F.add(m5, X1)
    X3 = F.add(t0, t0)
    t0 = F.add(X3, t0)
    t2b, Y3b = F.mul_b3_pair(Z1, Y3)
    Z3 = F.add(t1, t2b)
    t1 = F.sub(t1, t2b)
    a1, a2, a3, a4, a5, a6 = F.mul_many(
        [(t4, Y3b), (t3, t1), (Y3b, t0), (t1, Z3), (t0, t3), (Z3, t4)]
    )
    X3 = F.sub(a2, a1)
    Y3 = F.add(a4, a3)
    Z3 = F.add(a6, a5)
    return (X3, Y3, Z3)


def _complete_double(F, p):
    """RCB16 Algorithm 9 (a = 0): complete projective doubling, staged."""
    X, Y, Z = p
    t0, t1, t2, txy = F.mul_many([(Y, Y), (Y, Z), (Z, Z), (X, Y)])
    z3 = F.add(t0, t0)
    z3 = F.add(z3, z3)
    z3 = F.add(z3, z3)  # 8 Y^2
    t2b = F.mul_b3(t2)
    y3 = F.add(t0, t2b)
    t1d = F.add(t2b, t2b)
    t2t = F.add(t1d, t2b)
    t0 = F.sub(t0, t2t)
    b1, b2, b3_, b4 = F.mul_many([(t2b, z3), (t1, z3), (t0, y3), (t0, txy)])
    Y3 = F.add(b1, b3_)
    X3 = F.add(b4, b4)
    Z3 = b2
    return (X3, Y3, Z3)


# -- public wrappers --------------------------------------------------------


def g1_add(p1: G1Point, p2: G1Point) -> G1Point:
    return _complete_add(_G1Ops, p1, p2)


def g1_double(p: G1Point) -> G1Point:
    return _complete_double(_G1Ops, p)


def g1_neg(p: G1Point) -> G1Point:
    return (p[0], tf.neg(FQ, p[1]), p[2])


def g1_select(cond: torch.Tensor, p1: G1Point, p2: G1Point) -> G1Point:
    return tuple(tf.select(cond, a, b) for a, b in zip(p1, p2))


def g1_identity(batch_shape=(), device=torch.device("cuda")) -> G1Point:
    shape = tuple(batch_shape) + (FQ.nlimbs,)
    one = torch.as_tensor(tf.const_array(FQ, 1), device=device).expand(shape)
    return (
        torch.zeros(shape, dtype=torch.int32, device=device),
        one.contiguous(),
        torch.zeros(shape, dtype=torch.int32, device=device),
    )


def g2_add(p1: G2Point, p2: G2Point) -> G2Point:
    return _complete_add(_G2Ops, p1, p2)


def g2_double(p: G2Point) -> G2Point:
    return _complete_double(_G2Ops, p)


def g2_neg(p: G2Point) -> G2Point:
    return (p[0], fq2_neg(p[1]), p[2])


def g2_select(cond: torch.Tensor, p1: G2Point, p2: G2Point) -> G2Point:
    return tuple(fq2_select(cond, a, b) for a, b in zip(p1, p2))


def g2_identity(batch_shape=(), device=torch.device("cuda")) -> G2Point:
    shape = tuple(batch_shape) + (FQ.nlimbs,)
    one = torch.as_tensor(tf.const_array(FQ, 1), device=device).expand(shape)

    def z():
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return ((z(), z()), (one.contiguous(), z()), (z(), z()))


# ---------------------------------------------------------------------------
# Host <-> device conversion
# ---------------------------------------------------------------------------


def g1_from_affine_host(points: List, device=torch.device("cuda")) -> G1Point:
    """Affine host points ((x, y) ints or None) -> projective limb tensors."""
    xs, ys, zs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(0)
            ys.append(1)
            zs.append(0)
        else:
            xs.append(pt[0])
            ys.append(pt[1])
            zs.append(1)
    return tuple(
        torch.as_tensor(FQ.encode(v), device=device) for v in (xs, ys, zs)
    )


def g1_to_affine_host(p: G1Point) -> List:
    """Projective limb tensor point(s) -> affine host points (slow; small
    batches).  Copies to the host, which waits for the device."""
    X, Y, Z = (
        FQ.decode(np.asarray(c.detach().cpu()).reshape(-1, FQ.nlimbs)) for c in p
    )
    out = []
    for x, y, z in zip(X, Y, Z):
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, P)
            out.append((x * zi % P, y * zi % P))
    return out


def g2_from_affine_host(points: List, device=torch.device("cuda")) -> G2Point:
    """Affine host points ((x, y) of host Fq2, or None) -> projective limb
    tensors; the identity is ((0, 0), (1, 0), (0, 0)) and every Z.c1 is 0."""
    cols = [[], [], [], [], []]  # x0, x1, y0, y1, z0
    for pt in points:
        vals = (0, 0, 1, 0, 0) if pt is None else (pt[0].c0, pt[0].c1, pt[1].c0, pt[1].c1, 1)
        for col, v in zip(cols, vals):
            col.append(v)
    x0, x1, y0, y1, z0 = (torch.as_tensor(FQ.encode(v), device=device) for v in cols)
    return ((x0, x1), (y0, y1), (z0, torch.zeros_like(z0)))


def g2_to_affine_host(p: G2Point) -> List:
    """Projective limb tensor point(s) -> affine host points (slow; small
    batches).  Copies to the host, which waits for the device."""
    comps = [
        FQ.decode(np.asarray(p[c][i].detach().cpu()).reshape(-1, FQ.nlimbs))
        for c in range(3) for i in range(2)
    ]
    out = []
    for x0, x1, y0, y1, z0, z1 in zip(*comps):
        z = HostFq2(z0, z1)
        if z.is_zero():
            out.append(None)
        else:
            zi = z.inv()
            out.append((HostFq2(x0, x1) * zi, HostFq2(y0, y1) * zi))
    return out


# ---------------------------------------------------------------------------
# Batched fixed-base scalar multiplication (key and SRS generation)
# ---------------------------------------------------------------------------


def fixed_base_table(Gp, base_host, nbits: int, device) -> torch.Tensor:
    """The packed (rows, nbits) table of the doublings 2^k base, k < nbits,
    of a host affine point: what `PackedGroup.fixed_base` reads."""
    from ..curves import host_curve as hc

    g1 = Gp.ncomp == 1
    double = hc.g1_double if g1 else hc.g2_double
    doublings, cur = [], base_host
    for _ in range(nbits):
        doublings.append(cur)
        cur = double(cur)
    return Gp.pack((g1_from_affine_host if g1 else g2_from_affine_host)(doublings, device=device))


@functools.lru_cache(maxsize=8)
def window_table(Gp, base_host, nbits: int, device: torch.device) -> torch.Tensor:
    """The window kernel's table of a host affine base (`PackedGroup.
    window_table` over `fixed_base_table`), built once per base, width and
    device and kept: the batches of one setup share it (Groth16's four G1
    key batches share g1).  Callers must not write to it.  Timer labels
    `fixed_base::host doublings` and `fixed_base::window table` (the latter
    ends in a synchronise on the card)."""
    tdbl = Timer("fixed_base::host doublings")
    table = fixed_base_table(Gp, base_host, nbits, device)
    tdbl.stop()
    twin = Timer("fixed_base::window table")
    wtable = Gp.window_table(table)
    if wtable.is_cuda:
        torch.cuda.synchronize(wtable.device)
    twin.stop()
    return wtable


def _fixed_base_mul(Gp, scalars_canon: torch.Tensor, base_host, device):
    """[s_i] * base for one shared host affine base, ONE fixed-base launch
    on the card.  Up to FIXED_TEAM_MAX_LANES lanes (`Gp.fixed_base_kernel`)
    a host table of the 256 doublings 2^k base is packed and the team kernel
    runs, for every lane, the complete adds of the columns its scalar's bits
    select: the same adds and selects as the JAX package's `fori_loop`, so
    the projective limbs agree.  Above, the window kernel adds one row of
    the base's `window_table` per 8-bit window: the same points, other
    projective limbs."""
    device = torch.device(device)
    scal = scalars_canon.to(device=device, dtype=torch.int32).contiguous()
    nbits = LIMB_BITS * scal.shape[1]
    if Gp.fixed_base_kernel(scal.shape[0]) == "fixed_base_window":
        return Gp.unpack(Gp.fixed_base_window(window_table(Gp, base_host, nbits, device), scal))
    tdbl = Timer("fixed_base::host doublings")
    table = fixed_base_table(Gp, base_host, nbits, device)
    tdbl.stop()
    return Gp.unpack(Gp.fixed_base(table, scal))


def fixed_base_mul_g1(scalars_canon: torch.Tensor, base_host,
                      device=torch.device("cuda")) -> G1Point:
    """[s_i] * base over G1: `scalars_canon` is (N, 16) canonical Fr limbs,
    `base_host` a host affine point; returns a projective batch on `device`."""
    from .packed_curve import G1P

    return _fixed_base_mul(G1P, scalars_canon, base_host, device)


def fixed_base_mul_g2(scalars_canon: torch.Tensor, base_host,
                      device=torch.device("cuda")) -> G2Point:
    from .packed_curve import G2P

    return _fixed_base_mul(G2P, scalars_canon, base_host, device)


# ---------------------------------------------------------------------------
# Batched single-scalar multiplication (MIPP compression folds)
# ---------------------------------------------------------------------------


def _scalar_mul_batch(Gp, points, scalar_canon: torch.Tensor):
    packed = Gp.pack(points)
    n = packed.shape[1]
    scal = scalar_canon.to(packed.device)[:, None].expand(-1, n).contiguous()
    return Gp.unpack(Gp.ladder(packed, scal))


def scalar_mul_batch_g1(points: G1Point, scalar_canon: torch.Tensor) -> G1Point:
    """[c] * P_i for one scalar (canonical Fr limbs, shape (16,)) applied to
    a whole point batch: one ladder launch (LSB-first double-and-add) on
    the packed layout, on the device the points lie on."""
    from .packed_curve import G1P

    return _scalar_mul_batch(G1P, points, scalar_canon)


def scalar_mul_batch_g2(points: G2Point, scalar_canon: torch.Tensor) -> G2Point:
    from .packed_curve import G2P

    return _scalar_mul_batch(G2P, points, scalar_canon)
