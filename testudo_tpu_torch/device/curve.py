"""Batched BLS12-377 G1 arithmetic on limb tensors (PyTorch).

Counterpart of the G1 half of testudo_tpu/tpu/curve.py: the complete
Renes-Costello-Batina (EuroCrypt 2016) formulas for a = 0 curves
(`_complete_add` Algorithm 7, `_complete_add_mixed` Algorithm 8,
`_complete_double` Algorithm 9) evaluated over a field-ops namespace, the
public `g1_add` / `g1_double` / `g1_neg` / `g1_select` / `g1_identity`,
the host conversions and `scalar_mul_batch_g1`.

G1 points are tuples (X, Y, Z) of (..., 24) int32 limb tensors in
Montgomery form, homogeneous projective; the identity is (0 : 1 : 0).
The formulas are staged exactly as in the JAX package (independent
products of a stage stacked into one `mont_mul` call) so results agree
limb for limb.  These same three functions are the group law of the plain
versions of the packed kernels (device/packed_curve.py).  On CUDA tensors
`g1_add`/`g1_double` reach the Montgomery kernel through `field.mont_mul`.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..fields.bls12_377 import P
from . import field as tf
from .field import FQ

G1Point = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


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


# ---------------------------------------------------------------------------
# Batched single-scalar multiplication
# ---------------------------------------------------------------------------


def scalar_mul_batch_g1(points: G1Point, scalar_canon: torch.Tensor) -> G1Point:
    """[c] * P_i for one scalar (canonical Fr limbs, shape (16,)) applied to
    a whole point batch: one ladder launch (LSB-first double-and-add) on
    the packed layout, on the device the points lie on."""
    from .packed_curve import G1P

    n = points[0].shape[0]
    scal = scalar_canon.to(points[0].device)[:, None].expand(-1, n).contiguous()
    return G1P.unpack(G1P.ladder(G1P.pack(points), scal))
