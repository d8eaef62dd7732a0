"""State carried across from the JAX package to the port and back.

No counterpart module in testudo_tpu: these functions sit on the boundary
between the two packages.  Both hold a field element as little-endian 16-bit
limbs in Montgomery form with R = 2^(16 * nlimbs); the JAX package stores
them as uint32, the port as int32 (PyTorch's CPU backend has no uint32
arithmetic).  So every conversion is an exact change of dtype and container,
checked for range.  The reference side is numpy (`np.asarray(jax_array)`),
so nothing here imports JAX.  A commitment-key/SRS converter waits for the
PST slice.  Points convert for both groups: a G2 batch keeps the reference's
nesting, every coordinate a (c0, c1) pair.
"""
from __future__ import annotations

import numpy as np
import torch

from .device.field import FQ, FR, MASK

_PACKED_ROWS = {3 * FQ.nlimbs: "G1", 6 * FQ.nlimbs: "G2"}


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


def _is_fq2(coord) -> bool:
    """A G2 coordinate is a (c0, c1) pair of limb arrays, a G1 coordinate
    one 2-D limb array."""
    return isinstance(coord, (tuple, list))


def points_from_reference(coords, device=torch.device("cuda")):
    """The JAX package's point pytree -> the port's int32 tensors on
    `device`, in the same nesting: (X, Y, Z) of (N, 24) uint32 arrays for
    G1, ((X0, X1), (Y0, Y1), (Z0, Z1)) for G2."""
    if len(coords) != 3:
        raise ValueError("a point batch is an (X, Y, Z) triple")

    def one(c):
        return torch.as_tensor(_limbs_in(c, FQ.nlimbs, "point coordinate"), device=device)

    out = []
    for coord in coords:
        if _is_fq2(coord):
            if len(coord) != 2:
                raise ValueError("a G2 coordinate is a (c0, c1) pair")
            out.append((one(coord[0]), one(coord[1])))
        else:
            out.append(one(coord))
    return tuple(out)


def points_to_reference(points):
    """Inverse of points_from_reference: numpy uint32 arrays, same nesting."""
    return tuple(
        tuple(_limbs_out(c) for c in coord) if _is_fq2(coord) else _limbs_out(coord)
        for coord in points
    )


def packed_from_reference(packed, device=torch.device("cuda")) -> torch.Tensor:
    """A packed batch of uint32 limb rows, (72, L) for G1 or (144, L) for
    G2, -> int32 tensor."""
    rows = np.asarray(packed).shape[0] if np.ndim(packed) == 2 else None
    if rows not in _PACKED_ROWS:
        raise ValueError(
            f"packed batch: expected (72, L) or (144, L) limb rows, got shape {np.shape(packed)}")
    what = f"packed {_PACKED_ROWS[rows]} batch"
    return torch.as_tensor(_limbs_in(packed, rows, what, axis=0), device=device)


def packed_to_reference(packed: torch.Tensor) -> np.ndarray:
    return _limbs_out(packed)


def scalars_from_reference(scalars, device=torch.device("cuda")) -> torch.Tensor:
    """Canonical (non-Montgomery) Fr scalars, (N, 16) uint32 limbs -> int32."""
    return torch.as_tensor(_limbs_in(scalars, FR.nlimbs, "Fr scalars"), device=device)


def scalars_to_reference(scalars: torch.Tensor) -> np.ndarray:
    return _limbs_out(scalars)
