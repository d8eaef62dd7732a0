"""State carried across from the JAX package to the port and back.

No counterpart module in testudo_tpu: these functions sit on the boundary
between the two packages.  Both hold a field element as little-endian 16-bit
limbs in Montgomery form with R = 2^(16 * nlimbs); the JAX package stores
them as uint32, the port as int32 (PyTorch's CPU backend has no uint32
arithmetic).  So every conversion is an exact change of dtype and container,
checked for range.  The reference side is numpy (`np.asarray(jax_array)`),
so nothing here imports JAX.  A commitment-key/SRS converter waits for the
PST slice.
"""
from __future__ import annotations

import numpy as np
import torch

from .device.field import FQ, FR, MASK

_ROWS_G1 = 3 * FQ.nlimbs


def _limbs_in(arr, nlimbs: int, what: str, axis: int = -1) -> np.ndarray:
    a = np.asarray(arr)
    if a.dtype.kind not in "ui":
        raise TypeError(f"{what}: expected an integer limb array, got {a.dtype}")
    if a.shape[axis] != nlimbs:
        raise ValueError(f"{what}: expected {nlimbs} limbs on axis {axis}, got shape {a.shape}")
    if a.size and (int(a.min()) < 0 or int(a.max()) > MASK):
        raise ValueError(f"{what}: limbs must lie in [0, 2^16)")
    return a.astype(np.int32)


def _limbs_out(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.uint32)


def points_from_reference(coords, device=torch.device("cuda")):
    """The JAX package's G1 pytree, (X, Y, Z) of (N, 24) uint32 arrays, ->
    the port's (X, Y, Z) int32 tensors on `device`."""
    if len(coords) != 3:
        raise ValueError("a G1 point batch is an (X, Y, Z) triple")
    return tuple(
        torch.as_tensor(_limbs_in(c, FQ.nlimbs, "G1 coordinate"), device=device)
        for c in coords
    )


def points_to_reference(points):
    """Inverse of points_from_reference: (X, Y, Z) of numpy uint32 arrays."""
    return tuple(_limbs_out(c) for c in points)


def packed_from_reference(packed, device=torch.device("cuda")) -> torch.Tensor:
    """A packed G1 batch, (72, L) uint32 limb rows, -> int32 tensor."""
    return torch.as_tensor(_limbs_in(packed, _ROWS_G1, "packed G1 batch", axis=0), device=device)


def packed_to_reference(packed: torch.Tensor) -> np.ndarray:
    return _limbs_out(packed)


def scalars_from_reference(scalars, device=torch.device("cuda")) -> torch.Tensor:
    """Canonical (non-Montgomery) Fr scalars, (N, 16) uint32 limbs -> int32."""
    return torch.as_tensor(_limbs_in(scalars, FR.nlimbs, "Fr scalars"), device=device)


def scalars_to_reference(scalars: torch.Tensor) -> np.ndarray:
    return _limbs_out(scalars)
