"""Curve profiles: the genericity axis of the protocol layers.

Counterpart of testudo_tpu/curves/profile.py.  A `CurveProfile` bundles the
scalar-field spec, the host group operations, the pairing, the Poseidon
parameters, the transcript encodings and two batch group backends; the
protocol modules (core/pst.py, core/mipp.py, core/sqrt_pst.py) reach every
group operation through it.  This slice carries BLS12-377 only.

Backends: `_Dev377Backend` holds G1/G2 batches as limb tensors on one torch
device and drives the packed CUDA kernels (device/msm.py, device/curve.py);
`HostGroupBackend` holds lists of host affine points and is what the tests
compare against.  The caller picks the backend by argument
(`bls12_377(device=..., host_groups=...)`); there is no environment switch.
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
    """Pure-host backend over a host curve module's primitive ops."""

    def __init__(self, add, mul, msm, order: int):
        self._add = add
        self._mul = mul
        self._msm = msm
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
        return self._msm(repr_, [int(s) for s in scalars])

    def multi_msm(self, basis_repr, scal_rows):
        return [self.msm(basis_repr, row) for row in scal_rows]

    def fold(self, l_repr, r_repr, c):
        return [
            self._add(l, self._mul(r, c % self.order))
            for l, r in zip(l_repr, r_repr)
        ]

    def fixed_base_mul(self, base_affine, scalars):
        return [self._mul(base_affine, int(s) % self.order) for s in scalars]


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
        g1b = HostGroupBackend(hc.g1_add, hc.g1_mul, _host_msm_g1_377, R377)
        g2b = HostGroupBackend(hc.g2_add, hc.g2_mul, _host_msm_g2_377, R377)
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
