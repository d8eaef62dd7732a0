"""sqrt-PST: square-root-sized PST commitment with MIPP aggregation.

Counterpart of testudo_tpu/core/sqrt_pst.py (itself of Testudo's
src/sqrt_pst.rs): THE core witness commitment.  A 2^n evaluation table is viewed as a
2^m_row x 2^m_col matrix (m_col = n//2, m_row = n - m_col, odd case adds a
row variable: sqrt_pst.rs:38-43); each column p_i is PST-committed, the
per-column commitments are aggregated into T = prod e(com_i, h_i), and an
opening consists of (U = MSM(com_i, chi_i(b)), a MIPP proof that U folds T
correctly, and a PST opening of q(Y) = sum_j p(j, .)*chi_j at a).

Differences from Testudo (behavior-preserving):
  - the whole matrix lives on the device; all columns are committed by ONE
    shared-table multi-MSM (device/msm.py `_multi_msm_device`; Testudo
    commits per column with rayon, sqrt_pst.rs:120-126);
  - no point reversal before the PST open (sqrt_pst.rs:221-225): our PST
    binds MSB-first, Spartan's own order (see core/pst.py docstring).

Transcript: Fq sponge (PoseidonTranscript over get_bls12377_fq_params),
exactly like sqrt_pst.rs:170, 233.  The curve profile rides on the
CommitterKey and names the device.  Under a mesh (parallel/mesh.py
`use_mesh`) the columns of a device commit shard over the mesh's devices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from ..curves import profile as cprof
from ..device import field as tf
from ..parallel import mesh as pmesh
from ..poly import dense
from ..utils.timer import Timer
from . import mipp, pst


@dataclass
class SqrtPstCommitment:
    comm_dev: object  # backend G1 batch: per-column commitments
    t: object  # aggregated pairing commitment T


class Polynomial:
    """Mirror of sqrt_pst.rs::Polynomial."""

    def __init__(self, matrix: torch.Tensor, m: int, odd: int, profile=None):
        self.matrix = matrix  # (2^m_row, 2^m_col, nlimbs) Montgomery Fr
        self.m = m
        self.odd = odd
        self.profile = profile or cprof.bls12_377(matrix.device)
        self.q: Optional[torch.Tensor] = None
        self.chis_b: Optional[torch.Tensor] = None

    @staticmethod
    def from_evaluations(Z: torch.Tensor, profile=None) -> "Polynomial":
        profile = profile or cprof.bls12_377(Z.device)
        spec = profile.fr_spec
        n = Z.shape[0]
        if n < 1 or n & (n - 1):
            raise ValueError(f"the table length must be a power of two, got {n}")
        num_vars = n.bit_length() - 1
        m_col = num_vars // 2
        m_row = num_vars - m_col
        # Z[(j << m_col) | i] = matrix[j, i]  (sqrt_pst.rs:58)
        matrix = Z.reshape(1 << m_row, 1 << m_col, spec.nlimbs)
        return Polynomial(matrix, m_col, num_vars % 2, profile)

    @property
    def m_row(self) -> int:
        return self.m + self.odd

    def commit(self, ck: pst.CommitterKey) -> Tuple[object, object]:
        """PST-commit every column + aggregate T (sqrt_pst.rs:117-149).

        All column MSMs share the same basis, so they run as one
        shared-table multi-MSM.
        """
        pf = self.profile
        level = ck.nv - self.m_row
        basis = ck.powers_of_g[level]
        cols = self.matrix.transpose(0, 1)  # (2^m_col, 2^m_row, nlimbs)
        tmsm = Timer("sqrt_pst::commit multi-MSM")
        comm_repr = _multi_msm_g1(pf, basis, cols)
        if self.matrix.is_cuda:
            torch.cuda.synchronize(self.matrix.device)  # the timer reads device time
        tmsm.stop()
        h_vec = ck.powers_of_h[level + self.odd]
        tpair = Timer("sqrt_pst::commit multi-pairing T")
        t = pf.multi_pairing(
            pf.g1b.to_affine(comm_repr), pf.g2b.to_affine(h_vec)
        )
        tpair.stop()
        return comm_repr, t

    def _get_q(self, point: List[int]) -> None:
        """q(Y) = sum_j (sum_i p(j, i) chi_i(b)) chi_j(Y) (sqrt_pst.rs:81)."""
        spec = self.profile.fr_spec
        if len(point) != 2 * self.m + self.odd:
            raise ValueError(
                f"a point of {2 * self.m + self.odd} coordinates is needed, got {len(point)}"
            )
        tq = Timer("sqrt_pst::get_q")
        b = point[self.m + self.odd :]
        chis = dense.eq_evals(b, spec, self.matrix.device)  # (2^m, nlimbs) MSB-first
        prods = tf.mont_mul(spec, self.matrix, chis[None, :, :])
        self.q = tf.reduce_sum(spec, prods, axis=1)  # (2^m_row, nlimbs)
        self.chis_b = chis
        if self.matrix.is_cuda:
            torch.cuda.synchronize(self.matrix.device)
        tq.stop()

    def eval(self, point: List[int]) -> int:
        """p(a, b) = q(a) (sqrt_pst.rs:105-115)."""
        a = point[: self.m + self.odd]
        if self.q is None:
            self._get_q(point)
        return dense.evaluate(self.q, a, self.profile.fr_spec)

    def open(
        self,
        transcript,
        comm_repr,
        ck: pst.CommitterKey,
        point: List[int],
        t,
    ):
        """(U, pst_proof, mipp_proof) (sqrt_pst.rs:168-230)."""
        pf = self.profile
        a = point[: self.m + self.odd]
        if self.q is None:
            self._get_q(point)

        # U = MSM(com_i, chi_i(b)): the PST commitment of q
        tu = Timer("sqrt_pst::open U-fold MSM")
        U = pst._msm_table(pf, pf.g1b, comm_repr, self.chis_b)
        tu.stop()

        level = ck.nv - self.m_row
        h_vec = ck.powers_of_h[level + self.odd]
        tmipp = Timer("sqrt_pst::open MIPP prove")
        mipp_proof = mipp.prove(
            transcript, ck, comm_repr, self.chis_b, h_vec, U, t
        )
        tmipp.stop()
        # No a-reversal: our PST binds MSB-first natively (cf.
        # sqrt_pst.rs:221-225 where the reference must reverse for ark).
        tpst = Timer("sqrt_pst::open PST open q")
        pst_proof = pst.open_(ck, self.q, a)
        tpst.stop()
        return U, pst_proof, mipp_proof


def verify(
    transcript,
    vk: pst.VerifierKey,
    U,
    point: List[int],
    v: int,
    pst_proof,
    mipp_proof: mipp.MippProof,
    T,
) -> bool:
    """Mirror of sqrt_pst.rs:232-264."""
    ln = len(point)
    odd = ln % 2
    a = point[: ln // 2 + odd]
    b = point[ln // 2 + odd :]
    res_mipp = mipp.verify(vk, transcript, mipp_proof, b, U, T)
    if not res_mipp:
        return False
    return pst.check(vk, U, a, v, pst_proof)


def _multi_msm_g1(pf, basis, cols_mont: torch.Tensor):
    """Many MSMs sharing one point basis: Montgomery scalar matrix
    (K, N, nlimbs) -> backend repr of K points.

    Used for the per-column sqrt-PST commitments: the device backend runs
    the shared-table multi-MSM, its columns sharded over the ambient mesh
    when there are at least two a shard (`parallel.mesh.sharded_multi_msm`,
    the reference's sqrt_pst.py:186-195); host backends loop over the
    columns, unsharded.
    """
    spec = pf.fr_spec
    if isinstance(pf.g1b, cprof.HostGroupBackend):
        K, N = cols_mont.shape[0], cols_mont.shape[1]
        flat = spec.decode(cols_mont.reshape(-1, spec.nlimbs))
        rows = [flat[i * N : (i + 1) * N] for i in range(K)]
        return pf.g1b.multi_msm(basis, rows)

    from ..device import msm

    scalars_canon = pst._to_canon_scalars(cols_mont, spec)
    c = msm._pick_window(scalars_canon.shape[1])
    mesh = pmesh.active_mesh()
    if mesh is not None and mesh.size >= 2 and scalars_canon.shape[0] >= 2 * mesh.size:
        return pmesh.sharded_multi_msm(mesh, "g1", basis, scalars_canon, c)
    return msm._multi_msm_device("g1", basis, scalars_canon, c)
