"""Dense multilinear polynomials over a scalar field as device limb tensors.

Counterpart of testudo_tpu/poly/dense.py (itself of Testudo's
DensePolynomial / EqPolynomial / IdentityPolynomial, dense_mlpoly.rs).
Evaluation tables live on the device in Montgomery form, shape
`(2^nv, nlimbs)` int32; variable binding and equality tables are vectorised;
only scalars cross the host boundary.  Every product of a table goes through
`field.mont_mul`, i.e. the row-major Montgomery kernel on a CUDA device, and
a table times ONE scalar passes the scalar as a single element.

Functions that create a tensor take `device` (default CUDA; the tests ask
for the CPU); the others work where their arguments lie.  There is no `jit`:
these are plain functions.

Conventions (identical to the JAX package):
  - `bound_top` folds index pairs (i, i + n/2): Z'[i] = Z[i] + r (Z[i+n/2]
    - Z[i]): binds the MOST significant index bit to r.
  - `eq_evals(r)` produces chi_i(r) with the MSB-first bit convention.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import field as tf
from ..device.field import FR

R = FR.modulus  # default scalar modulus (BLS12-377 Fr)

_CUDA = torch.device("cuda")


def _to_mont_dev(limbs: torch.Tensor, spec: tf.FieldSpec = FR) -> torch.Tensor:
    """Canonical limbs -> Montgomery form on the device: x * R =
    mont_mul(x, R^2).  The product returns canonical limbs < p, so the
    result is bit-identical to the host `encode`."""
    r2 = torch.as_tensor(tf._int_to_limbs(spec.r2_mod_p, spec.nlimbs), device=limbs.device)
    return tf.mont_mul(spec, limbs, r2)


def encode_table(values: Sequence[int], spec: tf.FieldSpec = FR, device=_CUDA) -> torch.Tensor:
    """Host canonical ints -> device Montgomery table (n, nlimbs)."""
    if isinstance(values, np.ndarray) and values.dtype.kind in "iu":
        return encode_table_small(values, spec, device)
    values = list(values)
    if len(values) > (1 << 14):
        # big tables: canonical limb split on the host, Montgomery lift on
        # the device (skips a Python big-int multiply per element)
        return _to_mont_dev(torch.as_tensor(spec.to_limbs(values), device=device), spec)
    return torch.as_tensor(spec.encode(values), device=device)


def encode_table_small(values: np.ndarray, spec: tf.FieldSpec = FR, device=_CUDA) -> torch.Tensor:
    """Vectorised encode for non-negative machine-int values (< 2^63): a
    numpy limb split and one device Montgomery product."""
    v = np.asarray(values, dtype=np.int64)
    if v.size and int(v.min()) < 0:
        raise ValueError("encode_table_small: negative value")
    u = v.astype(np.uint64)
    limbs = np.zeros((v.shape[0], spec.nlimbs), np.int32)
    for k in range(min(4, spec.nlimbs)):
        limbs[:, k] = ((u >> np.uint64(16 * k)) & np.uint64(0xFFFF)).astype(np.int32)
    return _to_mont_dev(torch.as_tensor(limbs, device=device), spec)


def decode_table(arr, spec: tf.FieldSpec = FR) -> List[int]:
    return spec.decode(arr)


def decode_scalar(arr, spec: tf.FieldSpec = FR) -> int:
    return spec.decode(tf._to_numpy(arr).reshape(1, -1))[0]


def encode_scalar(x: int, spec: tf.FieldSpec = FR, device=_CUDA) -> torch.Tensor:
    return torch.as_tensor(spec.encode(x % spec.modulus), device=device)


def bound_top(Z: torch.Tensor, r: torch.Tensor, spec: tf.FieldSpec = FR) -> torch.Tensor:
    """One variable-binding round: fold the halves with challenge r."""
    n = Z.shape[0] // 2
    lo, hi = Z[:n], Z[n:]
    return tf.add(spec, lo, tf.mont_mul(spec, tf.sub(spec, hi, lo), r))


def bound_bot(Z: torch.Tensor, r: torch.Tensor, spec: tf.FieldSpec = FR) -> torch.Tensor:
    """Fold adjacent pairs (2i, 2i+1) with challenge r (LSB binding)."""
    lo, hi = Z[0::2], Z[1::2]
    return tf.add(spec, lo, tf.mont_mul(spec, tf.sub(spec, hi, lo), r))


def eq_evals_device(rs: Sequence[torch.Tensor], spec: tf.FieldSpec = FR,
                    device=_CUDA) -> torch.Tensor:
    """chi table over {0,1}^len(rs), MSB-first (device Montgomery scalars):
    evals[i] = prod_j (bit_{msb-j}(i) ? r_j : 1 - r_j).  `device` places the
    table of the empty product; the scalars are moved to it."""
    evals = torch.as_tensor(spec.encode(1), device=device).reshape(1, spec.nlimbs)
    for r in rs:
        hi = tf.mont_mul(spec, evals, r.to(evals.device).reshape(1, -1))
        lo = tf.sub(spec, evals, hi)
        evals = torch.stack([lo, hi], dim=1).reshape(-1, spec.nlimbs)
    return evals


def eq_evals(point: Sequence[int], spec: tf.FieldSpec = FR, device=_CUDA) -> torch.Tensor:
    """chi table from host ints (canonical)."""
    return eq_evals_device([encode_scalar(x, spec, device) for x in point], spec, device)


def _dot(Z: torch.Tensor, chis: torch.Tensor, spec: tf.FieldSpec = FR) -> torch.Tensor:
    return tf.reduce_sum(spec, tf.mont_mul(spec, Z, chis))


def evaluate(Z: torch.Tensor, point: Sequence[int], spec: tf.FieldSpec = FR) -> int:
    """Z~(point) in O(n): dot(Z, chi(point)); returns a canonical host int."""
    return decode_scalar(_dot(Z, eq_evals(point, spec, Z.device), spec), spec)


def eq_evaluate(r: Sequence[int], rx: Sequence[int], modulus: int = R) -> int:
    """eq(r, rx) on host ints."""
    acc = 1
    for a, b in zip(r, rx):
        acc = acc * (a * b + (1 - a) * (1 - b)) % modulus
    return acc


def identity_evaluate(point: Sequence[int], modulus: int = R) -> int:
    """IdentityPolynomial evaluation."""
    ln = len(point)
    return sum((1 << (ln - i - 1)) * point[i] for i in range(ln)) % modulus


def factored_lens(ell: int):
    return ell // 2, ell - ell // 2


def bound_L(Z: torch.Tensor, L: torch.Tensor, spec: tf.FieldSpec = FR) -> torch.Tensor:
    """Vector-matrix product: out[i] = sum_j L[j] Z[j * R_size + i]."""
    L_size = L.shape[0]
    R_size = Z.shape[0] // L_size
    Zm = Z.reshape(L_size, R_size, spec.nlimbs)
    return tf.reduce_sum(spec, tf.mont_mul(spec, Zm, L[:, None, :]), axis=0)


def merge_tables(tables: List[torch.Tensor], spec: tf.FieldSpec = FR) -> torch.Tensor:
    """Concatenate, then zero-pad to a power of two."""
    total = sum(t.shape[0] for t in tables)
    target = 1 << max(0, (total - 1).bit_length())
    return F.pad(torch.cat(list(tables), dim=0), (0, 0, 0, target - total))
