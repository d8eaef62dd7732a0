"""R1CS instances: sparse matrix polynomials, satisfiability, digests.

Counterpart of testudo_tpu/core/r1cs.py (itself of Testudo's
src/r1csinstance.rs and the byte-level construction API of lib.rs):

  - A, B, C are sparse multilinear polynomials over the
    (x, y) = (constraints, 2 * num_vars) hypercubes (r1csinstance.rs:116-117:
    num_poly_vars_y = log2(2 * num_vars));
  - `multiply_vec` computes (Az, Bz, Cz): a gather of z at the columns, one
    product per entry, and `index_add_` of the products' limbs into an int64
    accumulator per row, folded mod p once (`field._fold_wide`); the
    canonical result does not depend on the order of the sums;
  - `compute_eval_table_sparse` scatters val * eq_rx[row] into columns the
    same way (r1csinstance.rs:292-306);
  - `evaluate` computes A~(rx, ry) = sum val * eq(rx, row) * eq(ry, col)
    (sparse_mlpoly.rs multi_evaluate);
  - `get_digest`: Shake256 over the canonical serialization
    (r1csinstance.rs:155-164).

A matrix keeps its entries on the host (rows and cols as int32 numpy
arrays, vals as canonical ints) and puts them on a device once, at the
first call that needs them there: rows and cols as int64 index tensors
(torch indexes with int64), vals as a Montgomery table.  Every product goes
through `field.mont_mul` (the row-major Montgomery kernel on CUDA tensors).
"""
from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import field as tf
from ..device.field import FR
from ..poly import dense
from .. import serialize as ser

_CUDA = torch.device("cuda")


def _log2(n: int) -> int:
    if n <= 0 or n & (n - 1):
        raise ValueError(f"expected a power of two, got {n}")
    return n.bit_length() - 1


@dataclass
class SparseMatPolynomial:
    """COO sparse multilinear matrix polynomial (sparse_mlpoly.rs)."""

    num_vars_x: int
    num_vars_y: int
    rows: np.ndarray  # (nnz,) int32
    cols: np.ndarray  # (nnz,) int32
    vals: List[int]  # canonical scalars
    spec: tf.FieldSpec = FR
    _on_device: Dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def nnz(self) -> int:
        return len(self.vals)

    def on(self, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(rows, cols, vals) on `device`: int64 indices and the Montgomery
        table of the values, uploaded at the first call for that device."""
        device = torch.device(device)
        hit = self._on_device.get(device)
        if hit is None:
            hit = (
                torch.as_tensor(self.rows.astype(np.int64), device=device),
                torch.as_tensor(self.cols.astype(np.int64), device=device),
                dense.encode_table(self.vals, self.spec, device),
            )
            self._on_device[device] = hit
        return hit

    def _scatter(self, prods: torch.Tensor, index: torch.Tensor, size: int) -> torch.Tensor:
        """out[index[k]] += prods[k] mod p: int64 limb sums, one fold."""
        acc = torch.zeros((size, self.spec.nlimbs), dtype=torch.int64, device=prods.device)
        acc.index_add_(0, index, prods.to(torch.int64))
        return tf._fold_wide(self.spec, acc)

    def multiply_vec(self, num_rows: int, num_cols: int, z_dev: torch.Tensor) -> torch.Tensor:
        """(M z): out[row] += val * z[col]."""
        rows, cols, vals = self.on(z_dev.device)
        return self._scatter(tf.mont_mul(self.spec, vals, z_dev[cols]), rows, num_rows)

    def eval_table(self, eq_rx_dev: torch.Tensor, num_rows: int, num_cols: int) -> torch.Tensor:
        """out[col] += val * eq_rx[row] (compute_eval_table_sparse)."""
        rows, cols, vals = self.on(eq_rx_dev.device)
        return self._scatter(tf.mont_mul(self.spec, vals, eq_rx_dev[rows]), cols, num_cols)

    def evaluate_tables(self, eq_rx: torch.Tensor, eq_ry: torch.Tensor) -> int:
        """M~(rx, ry) from the two eq tables: sum val * eq_rx[row] * eq_ry[col]."""
        rows, cols, vals = self.on(eq_rx.device)
        spec = self.spec
        prods = tf.mont_mul(spec, tf.mont_mul(spec, vals, eq_rx[rows]), eq_ry[cols])
        return dense.decode_scalar(tf.reduce_sum(spec, prods), spec)

    def evaluate(self, rx: Sequence[int], ry: Sequence[int], device=_CUDA) -> int:
        """M~(rx, ry) = sum val * chi_row(rx) * chi_col(ry)."""
        return self.evaluate_tables(dense.eq_evals(rx, self.spec, device),
                                    dense.eq_evals(ry, self.spec, device))

    def serialize(self) -> bytes:
        """CanonicalSerialize-compatible layout: usize fields as u64 LE,
        Vec<SparseMatEntry> with a u64 length prefix; each entry is row and
        col as u64 LE, then the value's 32 bytes."""
        n = self.nnz
        ent = np.empty((n, 48), np.uint8)
        ent[:, 0:8] = self.rows.astype("<u8").view(np.uint8).reshape(n, 8)
        ent[:, 8:16] = self.cols.astype("<u8").view(np.uint8).reshape(n, 8)
        vals = b"".join(ser.fr_to_bytes(v) for v in self.vals)
        ent[:, 16:] = np.frombuffer(vals, np.uint8).reshape(n, 32)
        return (ser.u64_to_bytes(self.num_vars_x) + ser.u64_to_bytes(self.num_vars_y)
                + ser.u64_to_bytes(n) + ent.tobytes())


@dataclass
class R1CSInstance:
    num_cons: int
    num_vars: int
    num_inputs: int
    A: SparseMatPolynomial
    B: SparseMatPolynomial
    C: SparseMatPolynomial

    @staticmethod
    def new(
        num_cons: int,
        num_vars: int,
        num_inputs: int,
        A: List[Tuple[int, int, int]],
        B: List[Tuple[int, int, int]],
        C: List[Tuple[int, int, int]],
        spec=FR,
    ) -> "R1CSInstance":
        nx = _log2(num_cons)
        ny = _log2(2 * num_vars)
        if num_inputs >= num_vars:
            raise ValueError(f"{num_inputs} inputs need more than {num_vars} variables")
        m = spec.modulus

        def mk(entries):
            rows = np.asarray([e[0] for e in entries], dtype=np.int32)
            cols = np.asarray([e[1] for e in entries], dtype=np.int32)
            vals = [e[2] % m for e in entries]
            return SparseMatPolynomial(nx, ny, rows, cols, vals, spec=spec)

        return R1CSInstance(num_cons, num_vars, num_inputs, mk(A), mk(B), mk(C))

    def get_digest(self) -> bytes:
        """Shake256(serialized instance) -> 256 bytes (r1csinstance.rs:155)."""
        data = (
            ser.u64_to_bytes(self.num_cons)
            + ser.u64_to_bytes(self.num_vars)
            + ser.u64_to_bytes(self.num_inputs)
            + self.A.serialize()
            + self.B.serialize()
            + self.C.serialize()
        )
        return hashlib.shake_256(data).digest(256)

    def z_vector(self, vars_: Sequence[int], inputs: Sequence[int]) -> List[int]:
        """z = vars || 1 || inputs || 0-pad to 2*num_vars (r1csproof.rs:269)."""
        z = list(vars_) + [1] + list(inputs)
        z += [0] * (2 * self.num_vars - len(z))
        return z

    def is_sat(self, vars_: Sequence[int], inputs: Sequence[int]) -> bool:
        """Satisfiability in host ints: (A z) * (B z) == C z row by row."""
        if len(vars_) != self.num_vars:
            raise ValueError(f"{len(vars_)} variables, expected {self.num_vars}")
        if len(inputs) != self.num_inputs:
            raise ValueError(f"{len(inputs)} inputs, expected {self.num_inputs}")
        z = list(vars_) + [1] + list(inputs)
        mod = self.A.spec.modulus

        def mul_vec(m: SparseMatPolynomial):
            out = [0] * self.num_cons
            for r_, c_, v in zip(m.rows.tolist(), m.cols.tolist(), m.vals):
                if c_ < len(z):
                    out[r_] = (out[r_] + v * z[c_]) % mod
            return out

        Az, Bz, Cz = mul_vec(self.A), mul_vec(self.B), mul_vec(self.C)
        return all(a * b % mod == c % mod for a, b, c in zip(Az, Bz, Cz))

    def multiply_vec_dev(self, z_dev: torch.Tensor):
        nc, ncols = self.num_cons, z_dev.shape[0]
        return (
            self.A.multiply_vec(nc, ncols, z_dev),
            self.B.multiply_vec(nc, ncols, z_dev),
            self.C.multiply_vec(nc, ncols, z_dev),
        )

    def compute_eval_table_sparse(self, eq_rx_dev: torch.Tensor, num_cols: int):
        return (
            self.A.eval_table(eq_rx_dev, self.num_cons, num_cols),
            self.B.eval_table(eq_rx_dev, self.num_cons, num_cols),
            self.C.eval_table(eq_rx_dev, self.num_cons, num_cols),
        )

    def evaluate(self, rx: Sequence[int], ry: Sequence[int], device=_CUDA):
        """(A~, B~, C~)(rx, ry), the two eq tables built once on `device`."""
        spec = self.A.spec
        eq_rx = dense.eq_evals(rx, spec, device)
        eq_ry = dense.eq_evals(ry, spec, device)
        return tuple(m.evaluate_tables(eq_rx, eq_ry) for m in (self.A, self.B, self.C))

    @staticmethod
    def produce_synthetic_r1cs(
        num_cons: int, num_vars: int, num_inputs: int, seed: int = 0, spec=FR
    ):
        """Deterministic analogue of r1csinstance.rs:166-242: row i has
        A = z[i], B = z[i + 2] and C = z[i + 3] scaled so that the row
        holds (indices mod |z|)."""
        m = spec.modulus
        rng = random.Random(seed)
        size_z = num_vars + num_inputs + 1
        Z = [rng.randrange(m) for _ in range(size_z)]
        Z[num_vars] = 1
        A, B, C = [], [], []
        for i in range(num_cons):
            a_idx = i % size_z
            b_idx = (i + 2) % size_z
            A.append((i, a_idx, 1))
            B.append((i, b_idx, 1))
            ab = Z[a_idx] * Z[b_idx] % m
            c_idx = (i + 3) % size_z
            cv = Z[c_idx]
            if cv == 0:
                C.append((i, num_vars, ab))
            else:
                C.append((i, c_idx, ab * pow(cv, -1, m) % m))
        inst = R1CSInstance.new(num_cons, num_vars, num_inputs, A, B, C, spec)
        vars_, inputs = Z[:num_vars], Z[num_vars + 1:]
        if not inst.is_sat(vars_, inputs):
            raise AssertionError("the synthetic instance is not satisfied")
        return inst, vars_, inputs


# ---------------------------------------------------------------------------
# Byte-level construction API (lib.rs mirror)
# ---------------------------------------------------------------------------


class R1CSError(Exception):
    pass


class InvalidIndex(R1CSError):
    pass


class InvalidScalar(R1CSError):
    pass


class Assignment:
    """Mirror of lib.rs::Assignment (LE byte vectors -> Fr)."""

    def __init__(self, assignment: List[int]):
        self.assignment = assignment

    @staticmethod
    def new(byte_vecs: List[bytes]) -> "Assignment":
        out = []
        for b in byte_vecs:
            v = ser.fr_from_bytes(b)
            if v is None:
                raise InvalidScalar(bytes(b).hex())
            out.append(v)
        return Assignment(out)

    def pad(self, length: int) -> "Assignment":
        if length <= len(self.assignment):
            raise ValueError(f"cannot pad {len(self.assignment)} values to {length}")
        return Assignment(self.assignment + [0] * (length - len(self.assignment)))


def pad_params(num_cons: int, num_vars: int, num_inputs: int) -> Tuple[int, int]:
    """(num_cons, num_vars) as an Instance pads them (lib.rs:137-157): vars
    to a power of two above the inputs, constraints to a power of two and
    at least 2."""
    num_vars_padded = max(num_vars, num_inputs + 1)
    if num_vars_padded & (num_vars_padded - 1):
        num_vars_padded = 1 << num_vars_padded.bit_length()
    num_cons_padded = num_cons
    if num_cons_padded in (0, 1):
        num_cons_padded = 2
    if num_cons & (num_cons - 1):
        num_cons_padded = 1 << num_cons.bit_length()
    return num_cons_padded, num_vars_padded


class Instance:
    """Mirror of lib.rs::Instance: byte-level R1CS construction with padding
    and input-column remapping (lib.rs:129-235)."""

    def __init__(self, inst: R1CSInstance, digest: bytes):
        self.inst = inst
        self.digest = digest

    @staticmethod
    def new(
        num_cons: int,
        num_vars: int,
        num_inputs: int,
        A: List[Tuple[int, int, bytes]],
        B: List[Tuple[int, int, bytes]],
        C: List[Tuple[int, int, bytes]],
    ) -> "Instance":
        num_cons_padded, num_vars_padded = pad_params(num_cons, num_vars, num_inputs)

        def conv(tups):
            mat = []
            for row, col, val_bytes in tups:
                if row >= num_cons:
                    raise InvalidIndex(f"row {row}")
                if col >= num_vars + 1 + num_inputs:
                    raise InvalidIndex(f"col {col}")
                v = ser.fr_from_bytes(val_bytes)
                if v is None:
                    raise InvalidScalar(bytes(val_bytes).hex())
                if col >= num_vars:
                    # constant/input columns remap past padding (lib.rs:187)
                    mat.append((row, col + num_vars_padded - num_vars, v))
                else:
                    mat.append((row, col, v))
            if num_cons in (0, 1):
                for i in range(len(tups), num_cons_padded):
                    mat.append((i, num_vars, 0))
            return mat

        inst = R1CSInstance.new(
            num_cons_padded, num_vars_padded, num_inputs, conv(A), conv(B), conv(C)
        )
        return Instance(inst, inst.get_digest())

    def is_sat(self, vars_: Assignment, inputs: Assignment) -> bool:
        if len(vars_.assignment) > self.inst.num_vars:
            raise R1CSError("too many vars")
        if len(inputs.assignment) != self.inst.num_inputs:
            raise R1CSError("wrong number of inputs")
        padded = (
            vars_.pad(self.inst.num_vars)
            if self.inst.num_vars > len(vars_.assignment)
            else vars_
        )
        return self.inst.is_sat(padded.assignment, inputs.assignment)

    @staticmethod
    def produce_synthetic_r1cs(num_cons, num_vars, num_inputs, seed: int = 0):
        inst, vars_, inputs = R1CSInstance.produce_synthetic_r1cs(
            num_cons, num_vars, num_inputs, seed
        )
        return (
            Instance(inst, inst.get_digest()),
            Assignment(vars_),
            Assignment(inputs),
        )
