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
    what `field.mont_mul` launches on CUDA tensors (csrc/mont_mul_rm.cu):
    n = 24 (Fq), 16 (Fr), 48 (BW6-761's 761-bit Fq, every product of the
    BW6 group of device/curve_generic.py) or 16 (BLS12-381's Fr, every
    product of a table of the 381 profile).
    `b` may be a single element: the kernel then reads the one element for
    every lane and nothing is broadcast in memory.
  - `mont_mul_chain` / `mont_mul_chain_group` run K chained products
    `a <- a * b` in one launch on `(n, L)` rows, and on G independent pairs
    `(G, n, L)` (csrc/mont_chain.cu); tools/exp_montmul.py derives the
    card's time per product from them.

The kernels are told which field to compute in by a field id
(`field_id`, csrc/fp.cuh `FieldId`) that the wrapper derives from the spec's
modulus, never from its limb count: BLS12-377's Fr and BLS12-381's Fr both
have 16 limbs.  A spec whose modulus has no kernel is refused on every
device, the CPU too.

On CUDA tensors a wrapper launches its hand-written kernel or raises; on CPU
tensors it runs the plain PyTorch version defined beside it.  There is no
batch-size threshold and no tile padding: the kernels mask their ragged
edge.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..fields import bls12_377 as f377
from ..fields import bls12_381 as f381
from ..fields import bw6_761 as f761
from . import build
from .field import FieldSpec, mont_mul_plain

# The fields the kernels are built for, by modulus: (field id of csrc/fp.cuh,
# limbs, the name its launches are counted under).
KERNEL_FIELDS = {
    f377.R: (1, 16, "fr"),
    f377.P: (2, 24, "fq"),
    f761.Q: (3, 48, "bw6fq"),
    f381.R: (4, 16, "fr381"),
}
K1_FIELDS = ("fr", "fq", "fr381")  # the fields csrc/mont_mul.cu is built for


def field_id(spec: FieldSpec, kernel: str = "mont_mul_rm",
             fields: Optional[Sequence[str]] = None) -> int:
    """The kernels' id of `spec`'s field, chosen by its modulus; raises
    ValueError for a modulus (or a limb count) that no kernel of `kernel` is
    built for.  `fields` narrows the accepted fields by name."""
    entry = KERNEL_FIELDS.get(spec.modulus)
    if entry is None or entry[1] != spec.nlimbs or (fields is not None and entry[2] not in fields):
        raise ValueError(f"{kernel}: no kernel for the {spec.nlimbs}-limb field {spec.name!r} "
                         f"of modulus {spec.modulus:#x}")
    return entry[0]


def _counter(spec: FieldSpec) -> str:
    return "mont_mul_rm_" + KERNEL_FIELDS[spec.modulus][2]


def mont_mul_rows_plain(spec: FieldSpec, at: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: (n, m) x (n, m) -> (n, m)."""
    return mont_mul_plain(spec, at.T, bt.T).T.contiguous()


def _check_rows(spec: FieldSpec, at: torch.Tensor, bt: torch.Tensor) -> None:
    if at.shape != bt.shape or at.dim() != 2 or at.shape[0] != spec.nlimbs:
        raise ValueError(
            f"mont_mul_rows: expected two ({spec.nlimbs}, m) arrays, got "
            f"{tuple(at.shape)} and {tuple(bt.shape)}"
        )
    field_id(spec, "mont_mul_rows", K1_FIELDS)


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
            field_id(spec), at.shape[1],
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
    fid = field_id(spec)
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
    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), fid, a.numel() // n, int(shared))
    counted = _counter(spec)
    if dev == torch.cuda.current_device():
        build.launch("mont_mul_rm", *args, counted_as=counted)
    else:
        with torch.cuda.device(dev):
            build.launch("mont_mul_rm", *args, counted_as=counted)
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
    field_id(spec, name, None if dims == 2 else ("fr", "fq"))
    if K < 0:
        raise ValueError(f"{name}: K must not be negative, got {K}")


def mont_mul_chain(spec: FieldSpec, at: torch.Tensor, bt: torch.Tensor, K: int,
                   inline_body: bool = True) -> torch.Tensor:
    """a <- a * b, K times, on `(n, L)` limb rows in one launch, in any field
    of KERNEL_FIELDS (the 761-bit and the BLS12-381 Fr chains measure those
    fields' latency).  `inline_body` picks the formulation of the product inside the kernel
    (the inlined body, or the shared out-of-line `fp_mul` of the group-law
    kernels); both give the same limbs."""
    _check_chain("mont_mul_chain", spec, at, bt, K, 2)
    if not (at.is_cuda or bt.is_cuda):
        return mont_mul_chain_plain(spec, at, bt, K)
    build.require_cuda_int32("mont_mul_chain", at=at, bt=bt)
    out = torch.empty_like(at)
    with torch.cuda.device(at.device):
        build.launch(
            "mont_chain", at.data_ptr(), bt.data_ptr(), out.data_ptr(), field_id(spec),
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
            "mont_chain_group", a.data_ptr(), b.data_ptr(), out.data_ptr(), field_id(spec),
            G, L, K, int(variant == "wide"), int(inline_body),
            counted_as="mont_chain_" + variant,
        )
    return out
