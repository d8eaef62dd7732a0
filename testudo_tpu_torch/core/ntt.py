"""Radix-2 NTT over limb tables, generic over the field.

Counterpart of testudo_tpu/core/ntt.py.  Powers Groth16's QAP division
(h = (A B - C) / Z on a coset).  BLS12-377 Fr has 2-adicity 47 and Fq (=
BW6-761's scalar field) 46, so any practical domain is a power of two in
both.

Tables are (m, nlimbs) Montgomery limb tensors.  The bit reversal is one
gather; each of the log2(m) stages is one pass of torch ops: the butterfly's
product through `field.mont_mul` (on a CUDA tensor the hand-written
row-major kernel, csrc/mont_mul_rm.cu), then `add` and `sub`.  A stage's
twiddles are held expanded to the (m / 2, nlimbs) shape of the odd halves,
so its product is one launch of two full operands.  The plans (bit
reversal, twiddles, coset powers) are built on the host once per size,
field and device, and stay cached on the device; nothing crosses to the
host between stages.  The results equal the JAX package's limb for limb.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch

from ..device import field as tf
from ..device.field import FQ, FR, FieldSpec
from ..fields.bls12_377 import R


@lru_cache(maxsize=None)
def _two_adicity(modulus: int) -> int:
    return ((modulus - 1) & -(modulus - 1)).bit_length() - 1


@lru_cache(maxsize=None)
def _mult_generator(modulus: int) -> int:
    """Smallest g with g^((p-1)/2) != 1: enough for the power-of-two roots
    the NTT needs (full generatorhood is not required)."""
    g = 2
    while pow(g, (modulus - 1) // 2, modulus) == 1:
        g += 1
    return g


@lru_cache(maxsize=None)
def root_of_unity(log_m: int, modulus: int = R) -> int:
    adic = _two_adicity(modulus)
    if log_m > adic:
        raise ValueError(f"no 2^{log_m}-th root of unity: the field's 2-adicity is {adic}")
    g = _mult_generator(modulus)
    two_adic_root = pow(g, (modulus - 1) >> adic, modulus)
    return pow(two_adic_root, 1 << (adic - log_m), modulus)


def _spec_of(modulus: int) -> FieldSpec:
    if modulus == FR.modulus:
        return FR
    if modulus == FQ.modulus:
        return FQ
    raise ValueError("unsupported NTT field")


def _powers(base: int, n: int, modulus: int) -> List[int]:
    out = [1] * n
    for k in range(1, n):
        out[k] = out[k - 1] * base % modulus
    return out


@lru_cache(maxsize=None)
def _plan(log_m: int, inverse: bool, modulus: int, device: torch.device
          ) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor]:
    """(bit-reversal index, per-stage twiddles expanded to (m / 2, nlimbs),
    m^-1 in Montgomery form) on `device`."""
    spec = _spec_of(modulus)
    m = 1 << log_m
    w = root_of_unity(log_m, modulus)
    if inverse:
        w = pow(w, -1, modulus)
    idx = np.arange(m)
    rev = np.zeros(m, dtype=np.int64)
    for b in range(log_m):
        rev |= ((idx >> b) & 1) << (log_m - 1 - b)
    stage_tw = []
    for s in range(1, log_m + 1):
        h = 1 << (s - 1)
        tw = spec.encode(_powers(pow(w, m >> s, modulus), h, modulus))
        stage_tw.append(torch.as_tensor(np.tile(tw, (m // (2 * h), 1)), device=device))
    minv = torch.as_tensor(spec.encode(pow(m, -1, modulus)), device=device)
    return torch.as_tensor(rev, device=device), stage_tw, minv


def ntt(table: torch.Tensor, inverse: bool = False, modulus: int = R) -> torch.Tensor:
    """In-order NTT (or inverse NTT) of an (m, nlimbs) Montgomery table, on
    the device the table lies on."""
    spec = _spec_of(modulus)
    m, nl = table.shape
    if m & (m - 1) or m == 0 or nl != spec.nlimbs:
        raise ValueError(f"ntt: expected (2^k, {spec.nlimbs}) limbs, got {tuple(table.shape)}")
    log_m = m.bit_length() - 1
    rev, stage_tw, minv = _plan(log_m, inverse, modulus, table.device)
    x = table[rev]
    for s in range(1, log_m + 1):
        h = 1 << (s - 1)
        xb = x.view(m // (2 * h), 2, h, nl)
        u = xb[:, 0].reshape(m // 2, nl)
        v = tf.mont_mul(spec, xb[:, 1].reshape(m // 2, nl), stage_tw[s - 1])
        x = torch.stack([tf.add(spec, u, v).view(m // (2 * h), h, nl),
                         tf.sub(spec, u, v).view(m // (2 * h), h, nl)], dim=1).view(m, nl)
    if inverse:
        x = tf.mont_mul(spec, x, minv)
    return x


@lru_cache(maxsize=None)
def _coset_powers(m: int, g: int, modulus: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_spec_of(modulus).encode(_powers(g, m, modulus)), device=device)


def coset_scale(table: torch.Tensor, g: int, inverse: bool = False,
                modulus: int = R) -> torch.Tensor:
    """Multiply coefficient i by g^i (g^-i with `inverse`): maps the
    evaluation domain to the coset g H."""
    gg = pow(g, -1, modulus) if inverse else g
    powers = _coset_powers(table.shape[0], gg % modulus, modulus, table.device)
    return tf.mont_mul(_spec_of(modulus), table, powers)
