"""Curve profiles: the genericity axis of the protocol layers.

Counterpart of testudo_tpu/curves/profile.py.  A `CurveProfile` bundles the
scalar-field spec, the host group operations, the pairing, the Poseidon
parameters, the transcript encodings and two batch group backends; the
protocol modules (core/pst.py, core/mipp.py, core/sqrt_pst.py,
core/r1csproof.py) reach every group operation through it.  Two curves:
BLS12-377 (`bls12_377`) and BLS12-381 (`bls12_381`).

Backends: `_Dev377Backend` holds G1/G2 batches as limb tensors on one torch
device and drives the packed CUDA kernels (device/msm.py, device/curve.py);
`HostGroupBackend` holds lists of host affine points and is what the tests
compare against.  The caller picks the backend by argument
(`bls12_377(device=..., host_groups=...)`); there is no environment switch.
BLS12-381 keeps its groups on the host, as the JAX package does (the role
ark-blst plays for Testudo): its G1/G2 backends are `HostGroupBackend`s over
curves/bls12_381.py, and only its Fr tables live on `device`, where every
product of theirs runs the row-major kernel at BLS12-381's Fr.

`fused_sumcheck` says whether the profile's R1CS proof runs the fused
sumcheck provers (device Poseidon and round kernels, which exist for
BLS12-377's Fr only): True for BLS12-377, False for BLS12-381, whose proof
runs the looped provers as the JAX package's does (curves/profile.py:367).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, List

import numpy as np
import torch

from ..device.field import FR, FieldSpec
from ..utils.timer import Timer


class GroupBackend:
    """Batch group-operation interface consumed by PST/MIPP/sqrt-PST.

    A "repr" is an opaque batched point container (a tuple of device limb
    tensors for the device backend, a list of host affine points for the
    host backend)."""

    def from_affine(self, pts: List):  # -> repr
        raise NotImplementedError

    def to_affine(self, repr_) -> List:
        raise NotImplementedError

    def size(self, repr_) -> int:
        raise NotImplementedError

    def slice(self, repr_, lo: int, hi: int):
        raise NotImplementedError

    def msm(self, repr_, scalars: List[int]):  # -> host affine
        raise NotImplementedError

    def multi_msm(self, basis_repr, scal_rows: List[List[int]]):  # -> repr
        raise NotImplementedError

    def fold(self, l_repr, r_repr, c: int):  # -> repr of l + c*r
        raise NotImplementedError

    def fixed_base_mul(self, base_affine, scalars: List[int]):  # -> repr
        raise NotImplementedError


class HostGroupBackend(GroupBackend):
    """Pure-host backend over a host curve module's primitive ops.
    `batch_mul(points, scalars)`, where given, multiplies many points at
    once (the native library's threaded batch) and returns what `mul`
    returns point by point."""

    def __init__(self, add, mul, msm, order: int, batch_mul=None):
        self._add = add
        self._mul = mul
        self._msm = msm
        self._batch_mul = batch_mul
        self.order = order

    def from_affine(self, pts):
        return list(pts)

    def to_affine(self, repr_):
        return list(repr_)

    def size(self, repr_):
        return len(repr_)

    def slice(self, repr_, lo, hi):
        return repr_[lo:hi]

    def msm(self, repr_, scalars):
        """`scalars`: ints, or canonical 16-limb scalars as a tensor (either
        Fr: the limbs are read as integers)."""
        if isinstance(scalars, torch.Tensor):
            scalars = FR.from_limbs(scalars)
        return self._msm(repr_, [int(s) for s in scalars])

    def multi_msm(self, basis_repr, scal_rows):
        return [self.msm(basis_repr, row) for row in scal_rows]

    def fold(self, l_repr, r_repr, c):
        return [
            self._add(l, self._mul(r, c % self.order))
            for l, r in zip(l_repr, r_repr)
        ]

    def fixed_base_mul(self, base_affine, scalars):
        scalars = [int(s) % self.order for s in scalars]
        if self._batch_mul is not None:
            return self._batch_mul([base_affine] * len(scalars), scalars)
        return [self._mul(base_affine, s) for s in scalars]


@dataclass
class CurveProfile:
    name: str
    R: int  # scalar field modulus
    P: int  # base field modulus
    fr_spec: FieldSpec
    fr_params: Callable  # Poseidon config over Fr
    fq_params: Callable  # Poseidon config over Fq (commitment transcript)
    # host single-point ops
    g1_add: Callable
    g1_neg: Callable
    g1_mul: Callable
    g1_generator: Callable
    g2_add: Callable
    g2_neg: Callable
    g2_mul: Callable
    g2_generator: Callable
    pairing: Callable
    multi_pairing: Callable
    fq12_one: Callable
    gt_pow: Callable
    # transcript encodings
    ser_g1_uncompressed: Callable
    ser_g2_uncompressed: Callable
    ser_gt: Callable
    # batch backends
    g1b: GroupBackend = None
    g2b: GroupBackend = None
    # where Fr tables live (the device backends' device; the tests ask for the CPU)
    device: torch.device = torch.device("cuda")
    # the R1CS proof's sumcheck provers: fused (True) or looped
    fused_sumcheck: bool = True


# ---------------------------------------------------------------------------
# BLS12-377: device backends over the packed CUDA kernels
# ---------------------------------------------------------------------------


class _Dev377Backend(GroupBackend):
    """G1 or G2 batches as projective limb tensors on `device`."""

    def __init__(self, group: str, device):
        if group not in ("g1", "g2"):
            raise ValueError(f"unknown group {group!r}")
        self.group = group
        self.device = torch.device(device)

    def _pick(self, g1_fn, g2_fn):
        return g1_fn if self.group == "g1" else g2_fn

    def from_affine(self, pts):
        from ..device import curve as tc

        fn = self._pick(tc.g1_from_affine_host, tc.g2_from_affine_host)
        return fn(pts, device=self.device)

    def to_affine(self, repr_):
        from ..device import curve as tc

        return self._pick(tc.g1_to_affine_host, tc.g2_to_affine_host)(repr_)

    def size(self, repr_):
        first = repr_[0] if self.group == "g1" else repr_[0][0]
        return first.shape[0]

    def slice(self, repr_, lo, hi):
        from ..device import msm

        return msm._map_coords(lambda c: c[lo:hi], repr_)

    def _canon(self, scalars) -> torch.Tensor:
        if isinstance(scalars, torch.Tensor):
            return scalars.to(self.device)
        return torch.as_tensor(
            FR.to_limbs([int(s) % FR.modulus for s in scalars]), device=self.device
        )

    def msm(self, repr_, scalars):
        from ..device import msm

        fn = self._pick(msm.msm_g1, msm.msm_g2)
        return fn(repr_, self._canon(scalars), device=self.device)

    def multi_msm(self, basis_repr, scal_rows):
        from ..device import msm

        canon = torch.as_tensor(
            np.stack([FR.to_limbs([int(s) % FR.modulus for s in row]) for row in scal_rows]),
            device=self.device,
        )
        return msm._multi_msm_device(
            self.group, basis_repr, canon, msm._pick_window(canon.shape[1])
        )

    def fold(self, l_repr, r_repr, c):
        from ..device import curve as tc

        c_canon = torch.as_tensor(FR.to_limbs(c % FR.modulus), device=self.device)
        if self.group == "g1":
            return tc.g1_add(l_repr, tc.scalar_mul_batch_g1(r_repr, c_canon))
        return tc.g2_add(l_repr, tc.scalar_mul_batch_g2(r_repr, c_canon))

    def fixed_base_mul(self, base_affine, scalars):
        from ..device import curve as tc

        fn = self._pick(tc.fixed_base_mul_g1, tc.fixed_base_mul_g2)
        tconv = Timer("fixed_base::scalars to limbs")
        canon = self._canon(scalars)
        tconv.stop()
        return fn(canon, base_affine, device=self.device)


def _host_msm_g1_377(points, scalars):
    from .. import native
    from . import host_curve as hc

    if native.available():
        return native.g1_msm(list(points), [int(s) for s in scalars])
    return hc.g1_msm(list(points), [int(s) for s in scalars])


def _host_batch_mul_377(g1: bool):
    """The native library's batch multiply for one group, or None when the
    library is not loaded (the backend then multiplies point by point)."""
    from .. import native

    if not native.available():
        return None
    return native.g1_batch_mul if g1 else native.g2_batch_mul


def _host_msm_g2_377(points, scalars):
    from .. import native
    from . import host_curve as hc

    if native.available():
        return native.g2_msm(list(points), [int(s) for s in scalars])
    return hc.g2_msm(list(points), [int(s) for s in scalars])


@lru_cache(maxsize=None)
def _bls12_377(device: torch.device, host_groups: bool) -> CurveProfile:
    from .. import serialize as ser
    from ..fields.bls12_377 import P as P377, R as R377
    from ..fields.host import Fq12
    from ..poseidon.transcript import fq_params, fr_params
    from . import host_curve as hc
    from . import pairing as pr

    if host_groups:
        g1b = HostGroupBackend(hc.g1_add, hc.g1_mul, _host_msm_g1_377, R377,
                               _host_batch_mul_377(True))
        g2b = HostGroupBackend(hc.g2_add, hc.g2_mul, _host_msm_g2_377, R377,
                               _host_batch_mul_377(False))
    else:
        g1b = _Dev377Backend("g1", device)
        g2b = _Dev377Backend("g2", device)
    return CurveProfile(
        name="bls12_377",
        R=R377,
        P=P377,
        fr_spec=FR,
        fr_params=fr_params,
        fq_params=fq_params,
        g1_add=hc.g1_add,
        g1_neg=hc.g1_neg,
        g1_mul=hc.g1_mul,
        g1_generator=hc.g1_generator,
        g2_add=hc.g2_add,
        g2_neg=hc.g2_neg,
        g2_mul=hc.g2_mul,
        g2_generator=hc.g2_generator,
        pairing=pr.pairing,
        multi_pairing=pr.multi_pairing,
        fq12_one=Fq12.one,
        gt_pow=pr.gt_pow,
        ser_g1_uncompressed=lambda pt: ser.g1_to_bytes(pt, compress=False),
        ser_g2_uncompressed=lambda pt: ser.g2_to_bytes(pt, compress=False),
        ser_gt=ser.fq12_to_bytes,
        g1b=g1b,
        g2b=g2b,
        device=device,
    )


def bls12_377(device=torch.device("cuda"), host_groups: bool = False) -> CurveProfile:
    """The BLS12-377 profile whose Fr tables and group batches live on
    `device` (one profile per device, cached).  `host_groups=True` swaps the
    device group backends for host ones (every curve operation through the
    native library or pure Python; the Fr tables stay on `device`)."""
    return _bls12_377(torch.device(device), bool(host_groups))


# ---------------------------------------------------------------------------
# BLS12-381: host group backends (the ark-blst role), Fr tables on `device`
# ---------------------------------------------------------------------------

FQ381_BYTES = 48


def _fq381_to_bytes(x: int) -> bytes:
    from ..fields.bls12_381 import P as P381

    return (x % P381).to_bytes(FQ381_BYTES, "little")


def _fq2_381_to_bytes(x) -> bytes:
    return _fq381_to_bytes(x.c0) + _fq381_to_bytes(x.c1)


def ser_g1_381_uncompressed(pt) -> bytes:
    """x || y, 48 little-endian bytes each; the identity is zeros with the
    infinity flag (bit 6) in the last byte (ark-serialize's SWFlags)."""
    from .. import serialize as ser

    if pt is None:
        b = bytearray(2 * FQ381_BYTES)
        b[-1] |= ser.FLAG_INFINITY
        return bytes(b)
    return _fq381_to_bytes(pt[0]) + _fq381_to_bytes(pt[1])


def ser_g2_381_uncompressed(pt) -> bytes:
    """x.c0 || x.c1 || y.c0 || y.c1 (48 bytes each), the identity flagged as
    in G1."""
    from .. import serialize as ser

    if pt is None:
        b = bytearray(4 * FQ381_BYTES)
        b[-1] |= ser.FLAG_INFINITY
        return bytes(b)
    return _fq2_381_to_bytes(pt[0]) + _fq2_381_to_bytes(pt[1])


def ser_gt_381(x) -> bytes:
    """An Fq12 element as its twelve Fq coefficients in tower order (c0 then
    c1 of Fq12; c0, c1, c2 of each Fq6; c0, c1 of each Fq2), 576 bytes."""
    return b"".join(_fq2_381_to_bytes(c2) for c6 in (x.c0, x.c1)
                    for c2 in (c6.c0, c6.c1, c6.c2))


@lru_cache(maxsize=None)
def _bls12_381(device: torch.device) -> CurveProfile:
    from ..device.field import FR381
    from ..fields import bls12_381 as f381
    from ..poseidon.transcript import fr_params_381
    from . import bls12_381 as c381

    def gt_pow(x, e: int):
        return x.pow(e % f381.R)

    return CurveProfile(
        name="bls12_381",
        R=f381.R,
        P=f381.P,
        fr_spec=FR381,
        # Testudo ships Poseidon parameters over BLS12-381's Fr only
        # (poseidon_params_bls12381, parameters.rs:341-2587), and its 381 test
        # path uses them for both transcripts, as the JAX package does
        fr_params=fr_params_381,
        fq_params=fr_params_381,
        g1_add=c381.g1_add,
        g1_neg=c381.g1_neg,
        g1_mul=c381.g1_mul,
        g1_generator=c381.g1_generator,
        g2_add=c381.g2_add,
        g2_neg=c381.g2_neg,
        g2_mul=c381.g2_mul,
        g2_generator=c381.g2_generator,
        pairing=c381.pairing,
        multi_pairing=c381.multi_pairing,
        fq12_one=c381.Fq12.one,
        gt_pow=gt_pow,
        ser_g1_uncompressed=ser_g1_381_uncompressed,
        ser_g2_uncompressed=ser_g2_381_uncompressed,
        ser_gt=ser_gt_381,
        g1b=HostGroupBackend(c381.g1_add, c381.g1_mul, c381.g1_msm, f381.R),
        g2b=HostGroupBackend(c381.g2_add, c381.g2_mul, c381.g2_msm, f381.R),
        device=device,
        fused_sumcheck=False,
    )


def bls12_381(device=torch.device("cuda")) -> CurveProfile:
    """The BLS12-381 profile whose Fr tables live on `device` (one profile
    per device, cached); its groups, pairing and Poseidon are host Python
    (curves/bls12_381.py), as in the JAX package (curves/profile.py:297-369)."""
    return _bls12_381(torch.device(device))
