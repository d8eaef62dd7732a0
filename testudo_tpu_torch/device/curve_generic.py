"""Batched Weierstrass groups over any prime field (PyTorch): BW6-761.

Counterpart of testudo_tpu/tpu/curve_generic.py.  The RCB16 complete
formulas of device/curve.py (`_complete_add`, `_complete_add_mixed`,
`_complete_double`) are generic over a field-ops namespace; `FpGroup(spec, b)` gives them one for
y^2 = x^3 + b over the field of `spec`.  BW6-761's G1 (b = -1) and G2
(b = 4, the sextic twist) both live over its 761-bit base field, so
`bw6_g1()` and `bw6_g2()` are two such groups over `FQ761`, and the
one-level Groth16 wrap (core/groth16_bw6.py) runs its keys and MSMs on them.

A point is a tuple (X, Y, Z) of (..., 48) int32 limb tensors in Montgomery
form (R = 2^768), homogeneous projective; the identity is (0 : 1 : 0).

On CUDA tensors every group operation is one launch of csrc/fp_group.cu,
the group law a thread a lane (ec.cuh's formulas over the strict policy
`Fq761Coord`): `add`, `add_mixed` and `double` elementwise, `chunk_sums`
(the in-order sums of `msm_fp`'s bucket runs, cut into chunks) and
`fixed_base_mul`.  The kernels take BW6-761's two groups only; any other
field or b raises there.  On CPU tensors each runs its plain version
(`*_plain`), the formulas in tensor ops as the JAX package writes them: the
sums and differences are this module's `add` / `sub` (the values of
`field.add` / `field.sub` in int32 tensors: two bulk carry pushes, and the
carry-lookahead only when a carry is still in flight), each formula stage's
products one `field.mont_mul_plain` over the stage's stacked pairs.  The
plain versions never launch a kernel, on CUDA tensors either.

`fixed_base_mul` takes the scalars 8 bits at a time from a host table of the
base's affine multiples: 48 mixed adds and selects for 384-bit scalars,
where the JAX package runs 384 steps of a complete add and a select.  The
points are the same; their projective limbs are not (compare them in
affine).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List

import torch
import torch.nn.functional as F

from ..fields import bw6_761 as bwf
from . import build, packed_field
from . import field as tf
from .curve import _complete_add, _complete_add_mixed, _complete_double
from .field import FieldSpec

FQ761 = FieldSpec(bwf.Q, 48, "bw6fq")

FIXED_BASE_WINDOW = 8  # scalar bits a step of `fixed_base_mul` takes (ec.cuh's FB_WINDOW)


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
    """Field-ops namespace of one group for the RCB16 formulas: the sums in
    int32 tensor ops, the products by `mont_mul` (the plain tensor-op
    version unless a caller asks for another)."""

    def __init__(self, spec: FieldSpec, b: int, mont_mul=tf.mont_mul_plain):
        self.spec = spec
        self._b3 = tf.const_array(spec, 3 * b % spec.modulus)
        self._mont_mul = mont_mul

    def _b3_on(self, like: torch.Tensor) -> torch.Tensor:
        return tf._const(self._b3, like).to(torch.int32)

    def add(self, a, b_):
        return add(self.spec, a, b_)

    def sub(self, a, b_):
        return sub(self.spec, a, b_)

    def mul_many(self, pairs):
        A = torch.stack([p[0] for p in pairs], dim=0)
        B = torch.stack([p[1] for p in pairs], dim=0)
        return list(self._mont_mul(self.spec, A, B).unbind(0))

    def mul_b3(self, x):
        return self._mont_mul(self.spec, x, self._b3_on(x))

    def mul_b3_pair(self, x, y):
        out = self._mont_mul(self.spec, torch.stack([x, y], dim=0), self._b3_on(x))
        return out[0], out[1]

    @staticmethod
    def select(c, a, b_):
        return tf.select(c, a, b_)


# The kernels' groups (csrc/fp_group.cu): the curve constant b mod q -> the
# b its launchers take, and the suffix of their launch counters.
_KERNEL_B = {bwf.B1: (-1, ""), bwf.B2: (4, "_g2")}
_OP_ADD, _OP_ADD_MIXED, _OP_DOUBLE = 0, 1, 2  # fp_group.cu `FpgOp`


def _on_cuda(*tensors) -> bool:
    return any(t.is_cuda for t in tensors)


def _rows(name: str, n: int, coords) -> tuple:
    """Coordinates of one broadcast shape (..., n) -> (leading shape,
    contiguous (lanes, n) views or copies)."""
    shape = torch.broadcast_shapes(*(c.shape for c in coords))
    if shape[-1] != n:
        raise ValueError(f"{name}: coordinates of {n} limbs expected, got shape {tuple(shape)}")
    flat = [c.expand(shape).contiguous().view(-1, n) for c in coords]
    return shape[:-1], flat


@dataclass(frozen=True)
class FpGroup:
    """Batched group ops for y^2 = x^3 + b over a prime field."""

    spec: FieldSpec
    b: int

    @functools.cached_property
    def _ops(self) -> _Ops:
        return _Ops(self.spec, self.b)

    def _kernel(self, name: str):
        """(field id, the launchers' b, the counter's name) of this group;
        raises for a field or a b the kernels are not built for."""
        fid = packed_field.field_id(self.spec, name, ("bw6fq",))
        entry = _KERNEL_B.get(self.b % self.spec.modulus)
        if entry is None:
            raise ValueError(f"{name}: no kernel for the curve constant b = {self.b}")
        return fid, entry[0], name + entry[1]

    @staticmethod
    def _launch(kernel: str, ids, ins, outs, *args) -> None:
        """Launch `kernel` on (ins, outs, args, field id, b) and count it as
        `ids` (`_kernel`'s triple) says."""
        fid, b, counted = ids
        named = {f"arg{i}": t for i, t in enumerate((*ins, *outs))}
        build.require_cuda_int32(counted, **named)
        build.require_aligned(counted, 16, **named)
        with torch.cuda.device(outs[0].device):
            build.launch(kernel, *(t.data_ptr() for t in (*ins, *outs)), *args, fid, b,
                         counted_as=counted)

    def _op(self, op: int, counter: str, coords):
        """One launch of the elementwise kernel: formula `op` over the lanes
        of the broadcast shape of `coords` (p1's three, then p2's: three for
        the double, two for the mixed add).  The kernel reads six arrays and
        ignores those the formula has no use for."""
        n = self.spec.nlimbs
        lead, flat = _rows(counter, n, coords)
        lanes = flat[0].shape[0]
        outs = tuple(torch.empty((lanes, n), dtype=torch.int32, device=flat[0].device)
                     for _ in range(3))
        ids = self._kernel(counter)  # a field or a b without a kernel raises at every width
        if lanes:
            ins = flat + flat if len(flat) == 3 else (flat + flat[3:4])[:6]
            self._launch("fp_group_op", ids, ins, outs, lanes, op)
        return tuple(o.view(lead + (n,)) for o in outs)

    def add(self, p1, p2):
        """p1 + p2, complete: on CUDA tensors one launch of csrc/fp_group.cu
        (broadcast shapes are copied out first), else `add_plain`."""
        if _on_cuda(*p1, *p2):
            return self._op(_OP_ADD, "bw6_add", (*p1, *p2))
        return self.add_plain(p1, p2)

    def add_plain(self, p1, p2):
        return _complete_add(self._ops, p1, p2)

    def add_mixed(self, p1, p2):
        """p1 + p2 for an affine p2 = (x, y) that is not the identity."""
        if _on_cuda(*p1, *p2):
            return self._op(_OP_ADD_MIXED, "bw6_add_mixed", (*p1, *p2))
        return self.add_mixed_plain(p1, p2)

    def add_mixed_plain(self, p1, p2):
        return _complete_add_mixed(self._ops, p1, p2)

    def double(self, p):
        if _on_cuda(*p):
            return self._op(_OP_DOUBLE, "bw6_double", p)
        return self.double_plain(p)

    def double_plain(self, p):
        return _complete_double(self._ops, p)

    def chunk_sums(self, points, idx: torch.Tensor, start: torch.Tensor, count: torch.Tensor):
        """Lane l: the points points[idx[start[l] + t]] for t < count[l],
        added in order onto the identity (the identity for count 0): one
        chunk of a bucket run of `msm_fp`.  On CUDA tensors one launch of
        csrc/fp_group.cu (a thread a lane, the gather through idx in the
        kernel), else `chunk_sums_plain`.  Every idx entry a lane reads must
        index a point; `points` are (N, n) coordinates."""
        if not _on_cuda(*points, idx, start, count):
            return self.chunk_sums_plain(points, idx, start, count)
        n = self.spec.nlimbs
        lanes = start.shape[0]
        if start.shape != count.shape or start.dim() != 1 or idx.dim() != 1:
            raise ValueError("chunk_sums: idx, start and count must be vectors, start and count "
                             "of one length")
        _, pts = _rows("bw6_chunk_sum", n, points)
        ids = self._kernel("bw6_chunk_sum")
        outs = tuple(torch.empty((lanes, n), dtype=torch.int32, device=start.device)
                     for _ in range(3))
        if lanes:
            ins = (*pts, *(t.to(torch.int32).contiguous() for t in (idx, start, count)))
            self._launch("fp_chunk_sums", ids, ins, outs, lanes)
        return outs

    def chunk_sums_plain(self, points, idx, start, count):
        """Plain version of `chunk_sums`: step t adds entry t of every lane
        that has one (one batched complete add over those lanes); the other
        lanes keep their sums."""
        lanes = start.shape[0]
        acc = self.identity((lanes,), device=start.device)
        steps = int(count.max()) if lanes else 0
        s64, c64, idx64 = start.to(torch.int64), count.to(torch.int64), idx.to(torch.int64)
        for t in range(steps):
            at = (c64 > t).nonzero().squeeze(1)
            rows = idx64.index_select(0, s64.index_select(0, at) + t)
            s = self.add_plain(tuple(c.index_select(0, at) for c in acc),
                               tuple(c.index_select(0, rows) for c in points))
            for coord, part in zip(acc, s):
                coord.index_copy_(0, at, part)
        return acc

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


def window_digits(scalars_canon: torch.Tensor, w: int) -> torch.Tensor:
    """Digit w (FIXED_BASE_WINDOW bits) of every scalar of the (N, k) 16-bit
    limbs, int64 (N,)."""
    c = FIXED_BASE_WINDOW
    per = 16 // c
    limb = scalars_canon[:, w // per].to(torch.int64)
    return (limb >> ((w % per) * c)) & ((1 << c) - 1)


def fixed_base_table(G: FpGroup, base_host, host_add, nl: int, device):
    """The affine table of `fixed_base_mul` for (N, nl) scalars: its x and y
    coordinates, (16 nl / 8 256, n) each, on `device`.  Every row must be a
    point, not the identity: true for a base of prime order above 2^8, such
    as either BW6 generator."""
    rows = _window_table(base_host, host_add, 16 * nl // FIXED_BASE_WINDOW)
    if any(pt is None for pt in rows):
        raise ValueError("fixed_base_mul: a table row is the identity (the base's order is small)")
    tx, ty, _ = G.from_affine_host(rows, device=device)
    return tx, ty


def fixed_base_mul(G: FpGroup, scalars_canon: torch.Tensor, base_host, host_add):
    """[s_i] * base for one shared host affine base: a projective batch on
    the scalars' device.  `scalars_canon` is (N, k) canonical 16-bit limbs
    (any width; up to 32 limbs on the card), `host_add` the host affine
    addition of the group: `fixed_base_mul_table` over `fixed_base_table`."""
    tx, ty = fixed_base_table(G, base_host, host_add, scalars_canon.shape[1],
                              scalars_canon.device)
    return fixed_base_mul_table(G, scalars_canon, tx, ty)


def fixed_base_mul_table(G: FpGroup, scalars_canon: torch.Tensor, tx: torch.Tensor,
                         ty: torch.Tensor):
    """[s_i] * base from the base's table (tx, ty) (`fixed_base_table`).
    Window w of a lane adds the table row of its digit (the complete mixed
    add; a lane whose digit is 0 keeps its sum).  On CUDA tensors one launch
    of csrc/fp_group.cu, a thread a lane over all windows (a window skipped
    where no lane of a warp has a nonzero digit), else
    `fixed_base_mul_plain` (a window skipped where every lane's digit is 0):
    the same adds in the same order, so the same limbs."""
    if not _on_cuda(scalars_canon, tx, ty):
        return fixed_base_mul_plain(G, scalars_canon, tx, ty)
    n = G.spec.nlimbs
    lanes, nl = scalars_canon.shape
    if not 1 <= nl <= 32 or tx.shape != ty.shape or tx.shape != (nl * 16 // FIXED_BASE_WINDOW
                                                                  << FIXED_BASE_WINDOW, n):
        raise ValueError(f"fixed_base_mul: (N, 1..32) scalars and their table on the card, got "
                         f"{tuple(scalars_canon.shape)} and {tuple(tx.shape)}")
    scal = scalars_canon.to(torch.int32).contiguous()
    ids = G._kernel("bw6_fixed_base")
    outs = tuple(torch.empty((lanes, n), dtype=torch.int32, device=scal.device) for _ in range(3))
    if lanes:
        G._launch("fp_fixed_base", ids, (tx, ty, scal), outs, lanes, nl)
    return outs


def fixed_base_mul_plain(G: FpGroup, scalars_canon: torch.Tensor, tx: torch.Tensor,
                         ty: torch.Tensor):
    """Plain version of `fixed_base_mul` over its table's coordinates (tx,
    ty): step w adds the row of window w's digit to every lane (one batched
    complete mixed add) and selects; windows that are zero in every lane are
    skipped."""
    dev = scalars_canon.device
    nwin = 16 * scalars_canon.shape[1] // FIXED_BASE_WINDOW
    width = 1 << FIXED_BASE_WINDOW
    acc = G.identity((scalars_canon.shape[0],), device=dev)
    for w in range(nwin):
        digits = window_digits(scalars_canon, w)
        if not bool(digits.any()):
            continue
        idx = digits + w * width
        new = G.add_mixed_plain(acc, (tx.index_select(0, idx), ty.index_select(0, idx)))
        acc = G.select(digits != 0, new, acc)
    return acc
