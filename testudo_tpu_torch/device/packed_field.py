"""Montgomery products on limb batches: kernel wrappers and plain versions.

Counterpart of testudo_tpu/tpu/pallas_field.py (`mont_mul_rows`),
testudo_tpu/tpu/kernels.py (`mont_mul_rm`) and the kernels of the two
measuring harnesses tools/exp_montmul_block.py and tools/exp_mulmany_wide.py
(`mont_mul_chain`, `mont_mul_chain_group`).

  - `mont_mul_rows` takes `(n, m)` int32 rows of 16-bit limbs (n = 24 for
    Fq, 16 for Fr) with the batch along m, the layout of the packed group
    kernels (csrc/mont_mul.cu).
  - `mont_mul_rm` takes row-major `(..., n)` tensors, an element's limbs
    contiguous, which is the layout of every table of the protocol, and is
    what `field.mont_mul` launches on CUDA tensors (csrc/mont_mul_rm.cu).
    `b` may be a single element: the kernel then reads the one element for
    every lane and nothing is broadcast in memory.
  - `mont_mul_chain` / `mont_mul_chain_group` run K chained products
    `a <- a * b` in one launch on `(n, L)` rows, and on G independent pairs
    `(G, n, L)` (csrc/mont_chain.cu); tools/exp_montmul.py derives the
    card's time per product from them.

On CUDA tensors a wrapper launches its hand-written kernel or raises; on CPU
tensors it runs the plain PyTorch version defined beside it.  There is no
batch-size threshold and no tile padding: the kernels mask their ragged
edge.
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


# -- row-major product ----------------------------------------------------------


def mont_mul_rm_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the row-major kernel: `(..., n)` tensors, broadcast."""
    return mont_mul_plain(spec, a, b)


def mont_mul_rm(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^{-1} mod p on `(..., n)` limb tensors with broadcasting,
    canonical in and out.  When one operand is a single element (every
    leading axis of size 1) it is passed as such; any other broadcast is
    expanded in memory first.  Operands of one shape (the sumcheck's
    products) skip the broadcast, and a launch on the current device skips
    the device switch: this wrapper's host time is paid on every launch."""
    n = spec.nlimbs
    if a.shape[-1] != n or b.shape[-1] != n:
        raise ValueError(
            f"mont_mul_rm: {spec.name} elements have {n} limbs, got shapes "
            f"{tuple(a.shape)} and {tuple(b.shape)}"
        )
    if n not in (16, 24):
        raise ValueError(f"mont_mul_rm: no kernel for {n}-limb fields")
    if not (a.is_cuda or b.is_cuda):
        return mont_mul_rm_plain(spec, a, b)
    if a.shape == b.shape:
        shared = False
        a, b = a.contiguous(), b.contiguous()
    else:
        shape = torch.broadcast_shapes(a.shape, b.shape)
        if a.numel() == n and b.numel() != n:
            a, b = b, a  # the product commutes: keep the single element second
        shared = b.numel() == n and a.numel() != n
        a = a.expand(shape).contiguous()
        b = b.reshape(n).contiguous() if shared else b.expand(shape).contiguous()
    dev = a.get_device()
    if a.dtype is not torch.int32 or b.dtype is not torch.int32 or b.get_device() != dev:
        build.require_cuda_int32("mont_mul_rm", a=a, b=b)  # raises, saying why
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("mont_mul_rm: operands must be 16-byte aligned")
    out = torch.empty_like(a)
    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), n, a.numel() // n, int(shared))
    if dev == torch.cuda.current_device():
        build.launch("mont_mul_rm", *args, counted_as="mont_mul_rm_" + spec.name)
    else:
        with torch.cuda.device(dev):
            build.launch("mont_mul_rm", *args, counted_as="mont_mul_rm_" + spec.name)
    return out


# -- chained products (the measuring kernels) -----------------------------------

CHAIN_GROUP = 6  # group size the `seq` kernel is built for


def mont_mul_chain_plain(spec: FieldSpec, at: torch.Tensor, bt: torch.Tensor, K: int):
    """K applications of the plain product, `(n, L)` or `(G, n, L)` rows."""
    a, b = at.transpose(-1, -2), bt.transpose(-1, -2)
    for _ in range(K):
        a = mont_mul_plain(spec, a, b)
    return a.transpose(-1, -2).contiguous()


def _check_chain(name: str, spec: FieldSpec, at, bt, K: int, dims: int) -> None:
    if at.shape != bt.shape or at.dim() != dims or at.shape[-2] != spec.nlimbs:
        lead = "(G, " if dims == 3 else "("
        raise ValueError(
            f"{name}: expected two {lead}{spec.nlimbs}, L) arrays, got "
            f"{tuple(at.shape)} and {tuple(bt.shape)}"
        )
    if spec.nlimbs not in (16, 24):
        raise ValueError(f"{name}: no kernel for {spec.nlimbs}-limb fields")
    if K < 0:
        raise ValueError(f"{name}: K must not be negative, got {K}")


def mont_mul_chain(spec: FieldSpec, at: torch.Tensor, bt: torch.Tensor, K: int,
                   inline_body: bool = True) -> torch.Tensor:
    """a <- a * b, K times, on `(n, L)` limb rows in one launch.
    `inline_body` picks the formulation of the product inside the kernel
    (the inlined body, or the shared out-of-line `fp_mul` of the group-law
    kernels); both give the same limbs."""
    _check_chain("mont_mul_chain", spec, at, bt, K, 2)
    if not (at.is_cuda or bt.is_cuda):
        return mont_mul_chain_plain(spec, at, bt, K)
    build.require_cuda_int32("mont_mul_chain", at=at, bt=bt)
    out = torch.empty_like(at)
    with torch.cuda.device(at.device):
        build.launch(
            "mont_chain", at.data_ptr(), bt.data_ptr(), out.data_ptr(), spec.nlimbs,
            at.shape[1], K, int(inline_body),
        )
    return out


def mont_mul_chain_group(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, K: int,
                         variant: str = "wide", inline_body: bool = True) -> torch.Tensor:
    """The same chain on G independent pairs `(G, n, L)`.  variant "wide":
    the G * L chains are lanes of one launch; "seq": L lanes, each thread
    runs its G products one after the other at every step (G = 6 only)."""
    _check_chain("mont_mul_chain_group", spec, a, b, K, 3)
    if variant not in ("seq", "wide"):
        raise ValueError(f"mont_mul_chain_group: unknown variant {variant!r}")
    G, _, L = a.shape
    if variant == "seq" and G != CHAIN_GROUP:
        raise ValueError(f"mont_mul_chain_group: 'seq' takes G = {CHAIN_GROUP}, got {G}")
    if not (a.is_cuda or b.is_cuda):
        return mont_mul_chain_plain(spec, a, b, K)
    build.require_cuda_int32("mont_mul_chain_group", a=a, b=b)
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        build.launch(
            "mont_chain_group", a.data_ptr(), b.data_ptr(), out.data_ptr(), spec.nlimbs,
            G, L, K, int(variant == "wide"), int(inline_body),
            counted_as="mont_chain_" + variant,
        )
    return out
