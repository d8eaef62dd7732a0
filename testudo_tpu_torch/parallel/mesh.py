"""Sharding of the prover's hot paths over several devices, from one process.

Counterpart of testudo_tpu/parallel/mesh.py.  As there, one controller
holds a mesh of devices and the prover consults an ambient mesh
(`use_mesh`), so that `r1csproof.prove`, `sqrt_pst.Polynomial.commit` and
`msm.msm_g1` / `msm_g2` shard when a mesh is active.  A `Mesh` here is a
tuple of torch devices, and data moves between them by explicit
`.to(device)` copies.  A device may appear more than once: one card listed
D times runs every sharded path on its kernels, as the JAX package's tests
run theirs on a virtual 8-CPU mesh.

  - Sumcheck tables are split cyclically: global row i = q D + d lives on
    shard d at row q.  The fold partner of row i, i + n/2, then lives on
    the same shard at row q + n/(2D), so every fold stays local until a
    shard holds one row.  The D one-row tables are then gathered on the
    mesh's first device, which runs the last log2 D rounds
    (core/sumcheck.py).  Each round sums the shards' evaluations on the
    first device, where the transcript runs.
  - MSM: result-level data parallelism.  The batch is cut into D equal
    contiguous shards (zero-padded), each device runs the whole
    single-device pipeline (device/msm.py `msm_pipeline`) on its shard,
    and the D affine partial sums are added on the host.
  - sqrt-PST column commitments: the K column MSMs are independent, so the
    columns are cut into D contiguous blocks and the results concatenate on
    the first device.

The JAX package's one-program XLA form of the MSM (`_sharded_msm_xla`) has
no counterpart: the port has only the packed pipeline.
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..curves import host_curve as hc
from ..device import msm

AXIS = "shard"


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices, one a shard; a device may repeat."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        devices = tuple(torch.device(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devices)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of `devices`; by default every CUDA device (cuda:0 .. cuda:k-1).
    Raises where there is none: a CPU mesh is built only when asked for."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass the devices to shard over")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(tuple(devices))


def shard_mesh(n_shards: int, device) -> Mesh:
    """A mesh of `n_shards` shards on `device`'s kind: the first n_shards
    CUDA devices where `device` is CUDA and the machine has that many, else
    `device` listed n_shards times."""
    device = torch.device(device)
    if device.type == "cuda":
        if torch.cuda.device_count() >= n_shards > 1:
            return make_mesh([torch.device("cuda", i) for i in range(n_shards)])
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return make_mesh([device] * n_shards)


def mesh_devices(mesh: Mesh) -> List[torch.device]:
    return list(mesh.devices)


# ---------------------------------------------------------------------------
# Ambient mesh context
# ---------------------------------------------------------------------------

_ACTIVE: list = []


def active_mesh() -> Optional[Mesh]:
    """The mesh the prover should shard over, or None (one device)."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Make `mesh` the ambient prover mesh: inside the context `msm.msm_g1`,
    `msm.msm_g2`, `sqrt_pst` commits and the sumcheck provers shard over it.
    `use_mesh(None)` switches sharding off (per-shard work runs under it, so
    that it does not shard again)."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


# ---------------------------------------------------------------------------
# Sumcheck: the cyclic table layout (the rounds are in core/sumcheck.py)
# ---------------------------------------------------------------------------


def cyclic_split(mesh: Mesh, t: torch.Tensor) -> List[torch.Tensor]:
    """(..., n, limbs) tables -> one (..., n/D, limbs) copy a shard, on its
    device: shard d holds the global rows q D + d.  Every shard is a fresh
    tensor, never a view of `t`, even where its device is t's."""
    D, n = mesh.size, t.shape[-2]
    if n % D:
        raise ValueError(f"cyclic_split: {n} rows do not split into {D} shards")
    return [t[..., d::D, :].to(dev, copy=True) for d, dev in enumerate(mesh.devices)]


def cyclic_join(ts: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """The D shards of `cyclic_split` -> the (..., q D, limbs) tables in
    natural order, on `device` (default: the first shard's)."""
    device = ts[0].device if device is None else torch.device(device)
    t = torch.stack([x.to(device) for x in ts], dim=-2)  # (..., q, D, limbs)
    return t.reshape(*t.shape[:-3], t.shape[-3] * t.shape[-2], t.shape[-1])


# ---------------------------------------------------------------------------
# MSM: result-level data parallelism
# ---------------------------------------------------------------------------


def _drive_all(pipes):
    """Run pipeline generators to their ends round-robin: each one's next
    stage is enqueued on every device before any device's wait blocks the
    host.  Returns their values in order."""
    results = [None] * len(pipes)
    active = list(range(len(pipes)))
    while active:
        still = []
        for i in active:
            try:
                next(pipes[i])
                still.append(i)
            except StopIteration as stop:
                results[i] = stop.value
        active = still
    return results


def sharded_msm(mesh: Mesh, group: str, points, scalars_canon: torch.Tensor,
                c: Optional[int] = None, affine: bool = False,
                signed_c: int = msm._SIGNED_C):
    """The MSM over the mesh: the batch zero-padded to D equal shards, shard
    d moved to the mesh's device d, one `msm_pipeline` a shard (each pads
    again to a power of two), the pipelines driven round-robin, the D host
    affine partials added on the host.  Returns a host affine point.

    Zero padding is safe with `affine=True` too: a zero scalar has no
    nonzero digit, so its all-zero point (Z = 0, no affine lift) is never
    read."""
    D = mesh.size
    N = scalars_canon.shape[0]
    shard = -(-N // D)
    points, scal = msm._pad_to(points, scalars_canon, shard * D)
    with use_mesh(None):  # per-shard work must not shard again
        pipes = []
        for d, dev in enumerate(mesh.devices):
            part = slice(d * shard, (d + 1) * shard)
            pts_d = msm._map_coords(lambda coord: coord[part].to(dev), points)
            pipes.append(msm.msm_pipeline(group, pts_d, scal[part].to(dev), c, affine, signed_c))
        partials = _drive_all(pipes)
    add = hc.g1_add if group == "g1" else hc.g2_add
    return functools.reduce(add, partials)


def sharded_multi_msm(mesh: Mesh, group: str, basis, scalars_canon: torch.Tensor, c: int):
    """K MSMs over one shared basis (the sqrt-PST columns) sharded along K:
    the columns zero-padded to D equal blocks, block d run by
    `_multi_msm_device` on the mesh's device d (which copies the basis
    there), the results concatenated on the first device and trimmed to K.
    Returns a projective batch of K points, as `_multi_msm_device` does."""
    D = mesh.size
    K = scalars_canon.shape[0]
    shard = -(-K // D)
    scal = F.pad(scalars_canon, (0, 0, 0, 0, 0, shard * D - K))
    with use_mesh(None):
        parts = [msm._multi_msm_device(group, basis, scal[d * shard:(d + 1) * shard].to(dev), c)
                 for d, dev in enumerate(mesh.devices)]
    dev0 = mesh.devices[0]
    return msm._map_coords(lambda *cols: torch.cat([x.to(dev0) for x in cols])[:K], *parts)
