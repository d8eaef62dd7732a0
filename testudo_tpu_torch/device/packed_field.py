"""Montgomery product on limb-row batches: kernel wrapper and plain version.

Counterpart of testudo_tpu/tpu/pallas_field.py.  `mont_mul_rows` takes the
kernel's own layout, `(n, m)` int32 rows of 16-bit limbs (n = 24 for Fq,
16 for Fr) with the batch along m; `mont_mul` is the drop-in behind
`field.mont_mul` for `(..., n)` tensors.

On a CUDA tensor `mont_mul_rows` launches the hand-written kernel
(csrc/mont_mul.cu) or raises; on a CPU tensor it runs `mont_mul_rows_plain`,
the plain PyTorch version of the same function.  There is no batch-size
threshold and no tile padding: the kernel masks its ragged edge.
"""
from __future__ import annotations

import torch

from . import build
from .field import FieldSpec, mont_mul_plain


def mont_mul_rows_plain(spec: FieldSpec, at: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: (n, m) x (n, m) -> (n, m)."""
    return mont_mul_plain(spec, at.T, bt.T).T.contiguous()


def _check_rows(spec: FieldSpec, at: torch.Tensor, bt: torch.Tensor) -> None:
    if at.shape != bt.shape or at.dim() != 2 or at.shape[0] != spec.nlimbs:
        raise ValueError(
            f"mont_mul_rows: expected two ({spec.nlimbs}, m) arrays, got "
            f"{tuple(at.shape)} and {tuple(bt.shape)}"
        )
    if spec.nlimbs not in (16, 24):
        raise ValueError(f"mont_mul_rows: no kernel for {spec.nlimbs}-limb fields")


def mont_mul_rows(spec: FieldSpec, at: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Batched a*b*R^{-1} mod p on (n, m) limb rows, canonical in and out."""
    _check_rows(spec, at, bt)
    if not (at.is_cuda or bt.is_cuda):
        return mont_mul_rows_plain(spec, at, bt)
    build.require_cuda_int32("mont_mul_rows", at=at, bt=bt)
    out = torch.empty_like(at)
    with torch.cuda.device(at.device):
        build.launch(
            "mont_mul", at.data_ptr(), bt.data_ptr(), out.data_ptr(),
            spec.nlimbs, at.shape[1],
        )
    return out


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Drop-in for field.mont_mul on (..., n) tensors: broadcasts, moves the
    limb axis in front for the kernel and back."""
    n = spec.nlimbs
    shape = torch.broadcast_shapes(a.shape, b.shape)
    at = a.expand(shape).reshape(-1, n).T.contiguous()
    bt = b.expand(shape).reshape(-1, n).T.contiguous()
    return mont_mul_rows(spec, at, bt).T.reshape(shape)
