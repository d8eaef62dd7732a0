"""Spark: Spartan's sparse matrix polynomial commitment (the computation
commitment), by offline memory checking.

Counterpart of testudo_tpu/core/spark.py (itself of Testudo's
src/sparse_mlpoly.rs).  The three R1CS matrices are represented jointly by
dense "ops" tables (row address, row read timestamp, col address, col read
timestamp, value; merged into comb_ops) and audit timestamps (merged into
comb_mem), committed with the row-wise Pedersen commitment (polycommit.py).
The evaluation proof is the offline-memory-checking argument: hashed
(addr, val, ts) multisets compared through grand-product trees (GKR,
product_tree.py), then a hash-layer opening of every table at the points
the trees give.

Every table lives on the device of the generators' curve profile: the
addresses and timestamps as numpy on the host (they come from a stable
sort) and as Montgomery tables there, the dereferences as device gathers,
the hashes and the products through `field.mont_mul` and `add` / `sub`.
Claims, challenges and the transcript stay on the host.  The Timer labels
split an encode (`spark::encode addr and timestamps`, `spark::encode
values`, `spark::commit comb_ops`, `spark::commit comb_mem`) and a prove
(`spark::derefs commit`, `spark::product layers`, `spark::hash layer`).

Transcript: the Fr sponge throughout.  `prove` takes `fused` (the product
layers' sumcheck provers, fused by default) and `rng` (the dot-product
arguments' blinds, default `secrets.SystemRandom()`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import field as tf
from ..device.field import FR
from ..poly import dense
from ..utils.timer import Timer
from . import polycommit
from . import product_tree as ptree
from .errors import ProofVerifyError, require

_M = FR.modulus


def _next_pow2_log(v: int) -> int:
    return max(1, (v - 1).bit_length()) if v > 1 else 0


def _pad_pow2(vals: List[int]) -> List[int]:
    target = 1 << max(0, (len(vals) - 1).bit_length())
    return list(vals) + [0] * (target - len(vals))


# ---------------------------------------------------------------------------
# Dense representation with address timestamps
# ---------------------------------------------------------------------------


@dataclass
class AddrTimestamps:
    ops_addr_usize: List[np.ndarray]  # host addresses
    ops_addr: List[torch.Tensor]  # their Montgomery tables
    read_ts: List[torch.Tensor]
    audit_ts: torch.Tensor
    _index: Dict = field(default_factory=dict, repr=False, compare=False)

    @staticmethod
    def new(num_cells: int, num_ops: int, ops_addr: List[np.ndarray],
            device=torch.device("cuda")) -> "AddrTimestamps":
        """Read timestamps (sparse_mlpoly.rs:220-279), vectorised as in the
        reference: read_ts of op i is its rank among equal addresses across
        the concatenated instances (the audit counter carries over from
        instance to instance), and audit_ts is the per-cell total."""
        all_addr = np.concatenate([np.asarray(a, dtype=np.int64) for a in ops_addr])
        total = all_addr.shape[0]
        if total != num_ops * len(ops_addr):
            raise ValueError(f"{total} addresses for {len(ops_addr)} instances of {num_ops} ops")
        if total and (int(all_addr.min()) < 0 or int(all_addr.max()) >= num_cells):
            raise ValueError(f"an address lies outside the {num_cells} memory cells")
        order = np.argsort(all_addr, kind="stable")
        sorted_addr = all_addr[order]
        is_start = np.empty(total, dtype=bool)
        if total:
            is_start[0] = True
            is_start[1:] = sorted_addr[1:] != sorted_addr[:-1]
        run_id = np.cumsum(is_start) - 1
        run_starts = np.flatnonzero(is_start)
        rank = np.arange(total, dtype=np.int64) - run_starts[run_id]
        read_all = np.empty(total, dtype=np.int64)
        read_all[order] = rank
        audit_np = np.bincount(all_addr, minlength=num_cells).astype(np.int64)
        enc = lambda v: dense.encode_table_small(v, FR, device)
        return AddrTimestamps(
            [np.asarray(a, dtype=np.int64) for a in ops_addr],
            [enc(np.asarray(a, dtype=np.int64)) for a in ops_addr],
            [enc(read_all[k * num_ops: (k + 1) * num_ops]) for k in range(len(ops_addr))],
            enc(audit_np),
        )

    def deref(self, mem_val: torch.Tensor) -> List[torch.Tensor]:
        """ops_val[i] = mem_val[addr[i]]: device gathers (the index tensors
        go to the table's device once)."""
        dev = mem_val.device
        idx = self._index.get(dev)
        if idx is None:
            idx = [torch.as_tensor(a, device=dev) for a in self.ops_addr_usize]
            self._index[dev] = idx
        return [mem_val[i] for i in idx]


@dataclass
class MultiSparseMatPolynomialAsDense:
    batch_size: int
    val: List[torch.Tensor]
    row: AddrTimestamps
    col: AddrTimestamps
    comb_ops: torch.Tensor
    comb_mem: torch.Tensor


@dataclass
class SparseMatPolyCommitmentGens:
    gens_ops: polycommit.PolyCommitmentGens
    gens_mem: polycommit.PolyCommitmentGens
    gens_derefs: polycommit.PolyCommitmentGens

    @property
    def profile(self):
        return self.gens_ops.profile

    @staticmethod
    def setup(label: bytes, num_vars_x: int, num_vars_y: int, num_nz_entries: int,
              batch_size: int, profile=None) -> "SparseMatPolyCommitmentGens":
        """sparse_mlpoly.rs:330-360.  Generators of one size (the ops' and
        the derefs' where their rows are as wide) are drawn once."""
        num_vars_ops = _next_pow2_log(num_nz_entries) + _next_pow2_log(batch_size * 5)
        num_vars_mem = max(num_vars_x, num_vars_y) + 1
        num_vars_derefs = _next_pow2_log(num_nz_entries) + _next_pow2_log(batch_size * 2)
        memo = {}
        return SparseMatPolyCommitmentGens(
            polycommit.PolyCommitmentGens.setup(num_vars_ops, label, profile, memo),
            polycommit.PolyCommitmentGens.setup(num_vars_mem, label, profile, memo),
            polycommit.PolyCommitmentGens.setup(num_vars_derefs, label, profile, memo),
        )


@dataclass
class SparseMatPolyCommitment:
    batch_size: int
    num_ops: int
    num_mem_cells: int
    comm_comb_ops: polycommit.PolyCommitment
    comm_comb_mem: polycommit.PolyCommitment

    def write_to_transcript(self, transcript) -> None:
        transcript.append_u64(self.batch_size)
        transcript.append_u64(self.num_ops)
        transcript.append_u64(self.num_mem_cells)
        self.comm_comb_ops.write_to_transcript(transcript)
        self.comm_comb_mem.write_to_transcript(transcript)


def _encode_values(vals: Sequence[int], n: int, device) -> torch.Tensor:
    """A matrix's values, zero-padded to n, as a Montgomery table: the
    machine-int encode where every value fits in 63 bits."""
    vals = list(vals) + [0] * (n - len(vals))
    if not vals or max(vals) < 1 << 63:
        return dense.encode_table_small(np.asarray(vals, dtype=np.int64), FR, device)
    return dense.encode_table(vals, FR, device)


def multi_sparse_to_dense_rep(sparse_polys, device=torch.device("cuda")
                              ) -> MultiSparseMatPolynomialAsDense:
    """sparse_mlpoly.rs:373-437, every table on `device`."""
    if not sparse_polys:
        raise ValueError("no sparse polynomial to encode")
    N = max(max(1, p.nnz) for p in sparse_polys)
    N = 1 << (N - 1).bit_length() if N > 1 else 1

    t_addr = Timer("spark::encode addr and timestamps")
    ops_row_vec, ops_col_vec = [], []
    for p in sparse_polys:
        rows = np.zeros(N, dtype=np.int64)
        cols = np.zeros(N, dtype=np.int64)
        rows[: p.nnz] = p.rows
        cols[: p.nnz] = p.cols
        ops_row_vec.append(rows)
        ops_col_vec.append(cols)
    any_poly = sparse_polys[0]
    num_mem_cells = 1 << max(any_poly.num_vars_x, any_poly.num_vars_y)
    row = AddrTimestamps.new(num_mem_cells, N, ops_row_vec, device)
    col = AddrTimestamps.new(num_mem_cells, N, ops_col_vec, device)
    t_addr.stop()
    t_val = Timer("spark::encode values")
    val_vec = [_encode_values(p.vals, N, device) for p in sparse_polys]
    comb_ops = dense.merge_tables(row.ops_addr + row.read_ts + col.ops_addr + col.read_ts
                                  + val_vec)
    comb_mem = dense.merge_tables([row.audit_ts, col.audit_ts])
    t_val.stop()
    return MultiSparseMatPolynomialAsDense(len(sparse_polys), val_vec, row, col, comb_ops,
                                           comb_mem)


def multi_commit(sparse_polys, gens: SparseMatPolyCommitmentGens):
    """sparse_mlpoly.rs:490-516: (commitment, dense representation)."""
    dense_rep = multi_sparse_to_dense_rep(sparse_polys, gens.profile.device)
    t_ops = Timer("spark::commit comb_ops")
    comm_ops = polycommit.commit(dense_rep.comb_ops, gens.gens_ops)
    t_ops.stop()
    t_mem = Timer("spark::commit comb_mem")
    comm_mem = polycommit.commit(dense_rep.comb_mem, gens.gens_mem)
    t_mem.stop()
    return (
        SparseMatPolyCommitment(dense_rep.batch_size, dense_rep.row.read_ts[0].shape[0],
                                dense_rep.row.audit_ts.shape[0], comm_ops, comm_mem),
        dense_rep,
    )


# ---------------------------------------------------------------------------
# Derefs
# ---------------------------------------------------------------------------


@dataclass
class Derefs:
    row_ops_val: List[torch.Tensor]
    col_ops_val: List[torch.Tensor]
    comb: torch.Tensor

    @staticmethod
    def new(row_ops_val, col_ops_val) -> "Derefs":
        comb = dense.merge_tables(list(row_ops_val) + list(col_ops_val))
        return Derefs(list(row_ops_val), list(col_ops_val), comb)

    def commit(self, gens: polycommit.PolyCommitmentGens) -> "DerefsCommitment":
        return DerefsCommitment(polycommit.commit(self.comb, gens))


@dataclass
class DerefsCommitment:
    comm_ops_val: polycommit.PolyCommitment

    def write_to_transcript(self, transcript) -> None:
        self.comm_ops_val.write_to_transcript(transcript)


@dataclass
class DerefsEvalProof:
    proof_derefs: polycommit.PolyEvalProof


def _bound_bot_chain(evals: List[int], challenges: List[int]) -> int:
    """Fold a small host eval list with bound_poly_var_bot, the last
    challenge first (sparse_mlpoly.rs:108-121)."""
    vals = [v % _M for v in evals]
    for ch in reversed(challenges):
        vals = [(vals[2 * i] + ch * (vals[2 * i + 1] - vals[2 * i])) % _M
                for i in range(len(vals) // 2)]
    if len(vals) != 1:
        raise ValueError("the challenges do not fold the evaluations to one")
    return vals[0]


def _joint_claim(evals: List[int], r: List[int], transcript):
    """Absorb the padded evaluations, squeeze the combining challenges and
    absorb the joint evaluation: (joint point, joint evaluation)."""
    evals = _pad_pow2(evals)
    transcript.append_scalar_vector(evals, _M)
    challenges = transcript.challenge_scalar_vec(_M, len(evals).bit_length() - 1)
    joint = _bound_bot_chain(evals, challenges)
    transcript.append_scalar(joint, _M)
    return challenges + list(r), joint


def derefs_prove(derefs: Derefs, eval_row_vec, eval_col_vec, r, gens, transcript,
                 rng=None) -> DerefsEvalProof:
    """DerefsEvalProof::prove (sparse_mlpoly.rs:138-157)."""
    r_joint, joint = _joint_claim(list(eval_row_vec) + list(eval_col_vec), r, transcript)
    return DerefsEvalProof(polycommit.prove(derefs.comb, r_joint, joint, gens, transcript, rng))


def derefs_verify(proof: DerefsEvalProof, r, eval_row_vec, eval_col_vec, gens,
                  comm: DerefsCommitment, transcript) -> bool:
    r_joint, joint = _joint_claim(list(eval_row_vec) + list(eval_col_vec), r, transcript)
    return polycommit.verify_plain(proof.proof_derefs, gens, transcript, r_joint, joint,
                                   comm.comm_ops_val)


# ---------------------------------------------------------------------------
# Hash layer + product layer
# ---------------------------------------------------------------------------


def _hash_tables(eval_table: torch.Tensor, addrs: List[torch.Tensor],
                 derefs: List[torch.Tensor], read_ts: List[torch.Tensor],
                 audit_ts: torch.Tensor, r_hash: int, r_multiset: int):
    """build_hash_layer (sparse_mlpoly.rs:542-615): hash(addr, val, ts) =
    ts r^2 + val r + addr - r_multiset, on the device.  The init hash has
    ts = 0 (no product for it) and a write hash is its read hash plus r^2."""
    dev = eval_table.device
    rh = dense.encode_scalar(r_hash, FR, dev)
    rh2 = dense.encode_scalar(r_hash * r_hash % _M, FR, dev)
    rm = dense.encode_scalar(r_multiset, FR, dev)
    idx = dense.encode_table_small(np.arange(eval_table.shape[0], dtype=np.int64), FR, dev)

    def val_addr(val, addr):
        return tf.sub(FR, tf.add(FR, tf.mont_mul(FR, val, rh), addr), rm)

    base = val_addr(eval_table, idx)
    init = base
    audit = tf.add(FR, tf.mont_mul(FR, audit_ts, rh2), base)
    reads, writes = [], []
    for a, d, t in zip(addrs, derefs, read_ts):
        read = tf.add(FR, tf.mont_mul(FR, t, rh2), val_addr(d, a))
        reads.append(read)
        writes.append(tf.add(FR, read, rh2))
    return init, reads, writes, audit


@dataclass
class ProductLayer:
    init: ptree.ProductCircuit
    read_vec: List[ptree.ProductCircuit]
    write_vec: List[ptree.ProductCircuit]
    audit: ptree.ProductCircuit


def build_layers(eval_table: torch.Tensor, addr_ts: AddrTimestamps,
                 poly_ops_val: List[torch.Tensor], r_mem_check) -> ProductLayer:
    """Layers::new (sparse_mlpoly.rs:617-665)."""
    r_hash, r_multiset = r_mem_check
    init_h, reads_h, writes_h, audit_h = _hash_tables(
        eval_table, addr_ts.ops_addr, poly_ops_val, addr_ts.read_ts, addr_ts.audit_ts,
        r_hash, r_multiset)
    return ProductLayer(
        ptree.ProductCircuit(init_h),
        [ptree.ProductCircuit(x) for x in reads_h],
        [ptree.ProductCircuit(x) for x in writes_h],
        ptree.ProductCircuit(audit_h),
    )


@dataclass
class ProductLayerProof:
    eval_row: Tuple[int, List[int], List[int], int]
    eval_col: Tuple[int, List[int], List[int], int]
    eval_val: Tuple[List[int], List[int]]
    proof_mem: ptree.ProductCircuitEvalProofBatched
    proof_ops: ptree.ProductCircuitEvalProofBatched


def _prod(vals: List[int]) -> int:
    out = 1
    for v in vals:
        out = out * v % _M
    return out


def _layer_evals(layer: ProductLayer, transcript):
    """The layer's circuit products (init, reads, writes, audit), checked
    (init * writes == reads * audit) and absorbed."""
    k = len(layer.read_vec)
    v = ptree.evaluate_all([layer.init, *layer.read_vec, *layer.write_vec, layer.audit])
    init, read, write, audit = v[0], v[1: 1 + k], v[1 + k: 1 + 2 * k], v[-1]
    if init * _prod(write) % _M != _prod(read) * audit % _M:
        raise RuntimeError("the memory-checking multisets of the prover's layer differ")
    transcript.append_scalar(init, _M)
    transcript.append_scalar_vector(read, _M)
    transcript.append_scalar_vector(write, _M)
    transcript.append_scalar(audit, _M)
    return init, read, write, audit


def product_layer_prove(row_layer: ProductLayer, col_layer: ProductLayer,
                        dense_rep: MultiSparseMatPolynomialAsDense, derefs: Derefs,
                        evals: List[int], transcript, fused: bool = True):
    """ProductLayerProof::prove (sparse_mlpoly.rs:1052-1236).  Returns
    (proof, rand_mem, rand_ops)."""
    eval_row = _layer_evals(row_layer, transcript)
    eval_col = _layer_evals(col_layer, transcript)

    # dot-product circuits proving the claimed evaluations, halves in one copy
    halves = []
    for i in range(len(derefs.row_ops_val)):
        dotp = ptree.DotProductCircuit(derefs.row_ops_val[i], derefs.col_ops_val[i],
                                       dense_rep.val[i])
        halves.extend(dotp.split())
    he = FR.decode(torch.stack([h.evaluate_dev() for h in halves]))
    eval_dotp_left, eval_dotp_right = he[0::2], he[1::2]
    for i, (e_l, e_r) in enumerate(zip(eval_dotp_left, eval_dotp_right)):
        transcript.append_scalar(e_l, _M)
        transcript.append_scalar(e_r, _M)
        if (e_l + e_r) % _M != evals[i] % _M:
            raise ValueError(f"evaluation {i} is not the matrix's at (rx, ry)")

    if len(row_layer.read_vec) != 3:
        raise ValueError("the batch size must be 3 (sparse_mlpoly.rs:1142)")
    prod_list = row_layer.read_vec + row_layer.write_vec + col_layer.read_vec + col_layer.write_vec
    proof_ops, rand_ops = ptree.ProductCircuitEvalProofBatched.prove(
        prod_list, halves, transcript, fused)
    proof_mem, rand_mem = ptree.ProductCircuitEvalProofBatched.prove(
        [row_layer.init, row_layer.audit, col_layer.init, col_layer.audit], [], transcript,
        fused)
    return (
        ProductLayerProof(eval_row, eval_col, (eval_dotp_left, eval_dotp_right), proof_mem,
                          proof_ops),
        rand_mem,
        rand_ops,
    )


def _layer_evals_verify(evals_layer, num_instances: int, transcript) -> None:
    init, read, write, audit = evals_layer
    require(len(read) == num_instances and len(write) == num_instances, "layer claims")
    require(_prod(write) * init % _M == _prod(read) * audit % _M, "memory-checking multisets")
    transcript.append_scalar(init, _M)
    transcript.append_scalar_vector(read, _M)
    transcript.append_scalar_vector(write, _M)
    transcript.append_scalar(audit, _M)


def product_layer_verify(proof: ProductLayerProof, num_ops: int, num_cells: int,
                         evals: List[int], transcript):
    """ProductLayerProof::verify (sparse_mlpoly.rs:1238-1334)."""
    num_instances = len(evals)
    _layer_evals_verify(proof.eval_row, num_instances, transcript)
    _layer_evals_verify(proof.eval_col, num_instances, transcript)
    row_init, row_read, row_write, row_audit = proof.eval_row
    col_init, col_read, col_write, col_audit = proof.eval_col

    dotp_left, dotp_right = proof.eval_val
    require(len(dotp_left) == num_instances and len(dotp_right) == num_instances,
            "dot-product evaluations")
    claims_dotp_circuit = []
    for i in range(num_instances):
        require((dotp_left[i] + dotp_right[i]) % _M == evals[i] % _M, "claimed evaluation")
        transcript.append_scalar(dotp_left[i], _M)
        transcript.append_scalar(dotp_right[i], _M)
        claims_dotp_circuit.extend([dotp_left[i], dotp_right[i]])

    claims_prod_circuit = list(row_read) + list(row_write) + list(col_read) + list(col_write)
    claims_ops, claims_dotp, rand_ops = proof.proof_ops.verify(
        claims_prod_circuit, claims_dotp_circuit, num_ops, transcript)
    claims_mem, _, rand_mem = proof.proof_mem.verify(
        [row_init, row_audit, col_init, col_audit], [], num_cells, transcript)
    return claims_mem, rand_mem, claims_ops, claims_dotp, rand_ops


# ---------------------------------------------------------------------------
# Hash layer proof
# ---------------------------------------------------------------------------


@dataclass
class HashLayerProof:
    eval_row: Tuple[List[int], List[int], int]
    eval_col: Tuple[List[int], List[int], int]
    eval_val: List[int]
    eval_derefs: Tuple[List[int], List[int]]
    proof_ops: polycommit.PolyEvalProof
    proof_mem: polycommit.PolyEvalProof
    proof_derefs: DerefsEvalProof


def _evaluate_many(tables: List[torch.Tensor], point: List[int]) -> List[int]:
    """Each table's multilinear extension at `point`: one eq table, one
    product and sum a table, one copy to the host."""
    chis = dense.eq_evals(point, FR, tables[0].device)
    sums = [tf.reduce_sum(FR, tf.mont_mul(FR, t, chis)) for t in tables]
    return FR.decode(torch.stack(sums))


def hash_layer_prove(rand, dense_rep: MultiSparseMatPolynomialAsDense, derefs: Derefs,
                     gens: SparseMatPolyCommitmentGens, transcript, rng=None) -> HashLayerProof:
    """HashLayerProof::prove (sparse_mlpoly.rs:733-837)."""
    rand_mem, rand_ops = rand
    k = dense_rep.batch_size
    row, col = dense_rep.row, dense_rep.col
    at_ops = _evaluate_many(derefs.row_ops_val + derefs.col_ops_val + row.ops_addr + row.read_ts
                            + col.ops_addr + col.read_ts + dense_rep.val, rand_ops)
    parts = [at_ops[i * k: (i + 1) * k] for i in range(7)]
    eval_row_ops_val, eval_col_ops_val, row_addr, row_read, col_addr, col_read, eval_val = parts
    row_audit, col_audit = _evaluate_many([row.audit_ts, col.audit_ts], rand_mem)

    proof_derefs = derefs_prove(derefs, eval_row_ops_val, eval_col_ops_val, rand_ops,
                                gens.gens_derefs, transcript, rng)

    r_joint_ops, joint_ops = _joint_claim(row_addr + row_read + col_addr + col_read + eval_val,
                                          rand_ops, transcript)
    proof_ops = polycommit.prove(dense_rep.comb_ops, r_joint_ops, joint_ops, gens.gens_ops,
                                 transcript, rng)

    r_joint_mem, joint_mem = _joint_claim([row_audit, col_audit], rand_mem, transcript)
    proof_mem = polycommit.prove(dense_rep.comb_mem, r_joint_mem, joint_mem, gens.gens_mem,
                                 transcript, rng)

    return HashLayerProof(
        (row_addr, row_read, row_audit),
        (col_addr, col_read, col_audit),
        eval_val,
        (eval_row_ops_val, eval_col_ops_val),
        proof_ops,
        proof_mem,
        proof_derefs,
    )


def _hash_layer_verify_helper(rand_mem, claims, eval_ops_val, eval_ops_addr, eval_read_ts,
                              eval_audit_ts, r, r_hash, r_multiset) -> bool:
    """verify_helper (sparse_mlpoly.rs:839-894)."""
    rh2 = r_hash * r_hash % _M

    def hash_f(addr, val, ts):
        return (rh2 * ts + val * r_hash + addr - r_multiset) % _M

    claim_init, claim_read, claim_write, claim_audit = claims
    require(len(eval_ops_addr) == len(eval_ops_val) == len(eval_read_ts) == len(claim_read)
            == len(claim_write), "hash-layer claims")
    eval_init_addr = dense.identity_evaluate(rand_mem, _M)
    eval_init_val = dense.eq_evaluate(list(r), rand_mem, _M)
    if hash_f(eval_init_addr, eval_init_val, 0) != claim_init % _M:
        return False
    for i in range(len(eval_ops_addr)):
        if hash_f(eval_ops_addr[i], eval_ops_val[i], eval_read_ts[i]) != claim_read[i] % _M:
            return False
        if hash_f(eval_ops_addr[i], eval_ops_val[i], eval_read_ts[i] + 1) != claim_write[i] % _M:
            return False
    return hash_f(eval_init_addr, eval_init_val, eval_audit_ts) == claim_audit % _M


def hash_layer_verify(proof: HashLayerProof, rand, claims_row, claims_col, claims_dotp,
                      comm: SparseMatPolyCommitment, gens: SparseMatPolyCommitmentGens,
                      comm_derefs: DerefsCommitment, rx, ry, r_hash, r_multiset,
                      transcript) -> bool:
    """HashLayerProof::verify (sparse_mlpoly.rs:896-1040)."""
    rand_mem, rand_ops = rand
    eval_row_ops_val, eval_col_ops_val = proof.eval_derefs
    if not derefs_verify(proof.proof_derefs, rand_ops, eval_row_ops_val, eval_col_ops_val,
                         gens.gens_derefs, comm_derefs, transcript):
        return False

    eval_val_vec = proof.eval_val
    require(len(claims_dotp) == 3 * len(eval_row_ops_val) == 3 * len(eval_col_ops_val)
            == 3 * len(eval_val_vec), "dot-product claims")
    for i in range(len(claims_dotp) // 3):
        if (claims_dotp[3 * i] % _M != eval_row_ops_val[i] % _M
                or claims_dotp[3 * i + 1] % _M != eval_col_ops_val[i] % _M
                or claims_dotp[3 * i + 2] % _M != eval_val_vec[i] % _M):
            return False

    row_addr, row_read, row_audit = proof.eval_row
    col_addr, col_read, col_audit = proof.eval_col
    r_joint_ops, joint_ops = _joint_claim(
        list(row_addr) + list(row_read) + list(col_addr) + list(col_read) + list(eval_val_vec),
        rand_ops, transcript)
    if not polycommit.verify_plain(proof.proof_ops, gens.gens_ops, transcript, r_joint_ops,
                                   joint_ops, comm.comm_comb_ops):
        return False

    r_joint_mem, joint_mem = _joint_claim([row_audit, col_audit], rand_mem, transcript)
    if not polycommit.verify_plain(proof.proof_mem, gens.gens_mem, transcript, r_joint_mem,
                                   joint_mem, comm.comm_comb_mem):
        return False

    if not _hash_layer_verify_helper(rand_mem, claims_row, eval_row_ops_val, row_addr, row_read,
                                     row_audit, rx, r_hash, r_multiset):
        return False
    return _hash_layer_verify_helper(rand_mem, claims_col, eval_col_ops_val, col_addr, col_read,
                                     col_audit, ry, r_hash, r_multiset)


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------


@dataclass
class SparseMatPolyEvalProof:
    comm_derefs: DerefsCommitment
    proof_prod_layer: ProductLayerProof
    proof_hash_layer: HashLayerProof


def _equalize(rx: List[int], ry: List[int]):
    if len(rx) < len(ry):
        return [0] * (len(ry) - len(rx)) + list(rx), list(ry)
    if len(rx) > len(ry):
        return list(rx), [0] * (len(rx) - len(ry)) + list(ry)
    return list(rx), list(ry)


def prove(dense_rep: MultiSparseMatPolynomialAsDense, rx, ry, evals,
          gens: SparseMatPolyCommitmentGens, transcript, fused: bool = True,
          rng=None) -> SparseMatPolyEvalProof:
    """SparseMatPolyEvalProof::prove (sparse_mlpoly.rs:1473-1532)."""
    if len(evals) != dense_rep.batch_size:
        raise ValueError(f"{len(evals)} evaluations for a batch of {dense_rep.batch_size}")
    dev = dense_rep.comb_ops.device
    rx_ext, ry_ext = _equalize(rx, ry)

    t_d = Timer("spark::derefs commit")
    mem_rx = dense.eq_evals(rx_ext, FR, dev)
    mem_ry = dense.eq_evals(ry_ext, FR, dev)
    derefs = Derefs.new(dense_rep.row.deref(mem_rx), dense_rep.col.deref(mem_ry))
    comm_derefs = derefs.commit(gens.gens_derefs)
    t_d.stop()
    comm_derefs.write_to_transcript(transcript)

    r_mem_check = transcript.challenge_scalar_vec(_M, 2)
    t_p = Timer("spark::product layers")
    row_layers = build_layers(mem_rx, dense_rep.row, derefs.row_ops_val, r_mem_check)
    col_layers = build_layers(mem_ry, dense_rep.col, derefs.col_ops_val, r_mem_check)
    proof_prod, rand_mem, rand_ops = product_layer_prove(
        row_layers, col_layers, dense_rep, derefs, evals, transcript, fused)
    t_p.stop()
    t_h = Timer("spark::hash layer")
    proof_hash = hash_layer_prove((rand_mem, rand_ops), dense_rep, derefs, gens, transcript, rng)
    t_h.stop()
    return SparseMatPolyEvalProof(comm_derefs, proof_prod, proof_hash)


def verify(proof: SparseMatPolyEvalProof, comm: SparseMatPolyCommitment, rx, ry, evals,
           gens: SparseMatPolyCommitmentGens, transcript) -> bool:
    """SparseMatPolyEvalProof::verify (sparse_mlpoly.rs:1534-1568).  Returns
    False on any failed check (the inner layers raise ProofVerifyError, a
    sumcheck's SumcheckError or, for a proof of the wrong shape,
    ValueError)."""
    try:
        return _verify_inner(proof, comm, rx, ry, evals, gens, transcript)
    except (ProofVerifyError, ValueError):
        return False


def _verify_inner(proof: SparseMatPolyEvalProof, comm: SparseMatPolyCommitment, rx, ry, evals,
                  gens: SparseMatPolyCommitmentGens, transcript) -> bool:
    rx_ext, ry_ext = _equalize(rx, ry)
    nz, num_mem_cells = comm.num_ops, comm.num_mem_cells
    require((1 << len(rx_ext)) == num_mem_cells, "the point's length")

    proof.comm_derefs.write_to_transcript(transcript)
    r_mem_check = transcript.challenge_scalar_vec(_M, 2)

    num_instances = len(evals)
    claims_mem, rand_mem, claims_ops, claims_dotp, rand_ops = product_layer_verify(
        proof.proof_prod_layer, nz, num_mem_cells, evals, transcript)
    require(len(claims_mem) == 4, "memory claims")
    require(len(claims_ops) == 4 * num_instances, "ops claims")
    require(len(claims_dotp) == 3 * num_instances, "dot-product claims")

    claims_ops_row = claims_ops[: 2 * num_instances]
    claims_ops_col = claims_ops[2 * num_instances:]
    row_read = claims_ops_row[:num_instances]
    row_write = claims_ops_row[num_instances:]
    col_read = claims_ops_col[:num_instances]
    col_write = claims_ops_col[num_instances:]

    return hash_layer_verify(
        proof.proof_hash_layer,
        (rand_mem, rand_ops),
        (claims_mem[0], row_read, row_write, claims_mem[1]),
        (claims_mem[2], col_read, col_write, claims_mem[3]),
        claims_dotp,
        comm,
        gens,
        proof.comm_derefs,
        rx_ext,
        ry_ext,
        r_mem_check[0],
        r_mem_check[1],
        transcript,
    )
