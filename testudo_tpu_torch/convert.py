"""State carried across from the JAX package to the port and back.

No counterpart module in testudo_tpu: these functions sit on the boundary
between the two packages.  Both hold a field element as little-endian 16-bit
limbs in Montgomery form with R = 2^(16 * nlimbs); the JAX package stores
them as uint32, the port as int32 (PyTorch's CPU backend has no uint32
arithmetic).  So every conversion is an exact change of dtype and container,
checked for range.  The reference side is numpy (`np.asarray(jax_array)`),
so nothing here imports JAX.  Points convert for both groups: a G2 batch
keeps the reference's nesting, every coordinate a (c0, c1) pair.

Host objects (affine points over `Fq2`, `Fq12` pairing values, PST keys, a
MIPP proof) are carried across by their components: each package has its own
tower classes, so an object of one never compares equal to the other's.
The `*_from_reference` functions read the reference's objects by attribute
and build the port's; the `*_to_reference` functions are handed the
reference's `fields.host` module and classes by the caller, since nothing
here may import them.  R1CS instances carry across by their matrices'
entries (host arrays and ints), R1CS proofs by their components, so that
both packages prove one instance and each verifies the other's proof.
"""
from __future__ import annotations

import numpy as np
import torch

from .device.field import FQ, FR, MASK
from .fields import host as hf

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


def fr_table_from_reference(table, device=torch.device("cuda")) -> torch.Tensor:
    """A Montgomery Fr table, (..., 16) uint32 limbs -> int32 on `device`."""
    return torch.as_tensor(_limbs_in(table, FR.nlimbs, "Fr table"), device=device)


def fr_table_to_reference(table: torch.Tensor) -> np.ndarray:
    return _limbs_out(table)


# -- host objects -----------------------------------------------------------------


def _tower_from(x, towers):
    """Rebuild a tower element (or an int) in the classes of `towers`
    (a module with Fq2, Fq6, Fq12), by the names of its components."""
    if isinstance(x, int):
        return x
    comps = [_tower_from(getattr(x, name), towers) for name in type(x).__slots__]
    return getattr(towers, type(x).__name__)(*comps)


def _point_from(pt, towers):
    return None if pt is None else tuple(_tower_from(c, towers) for c in pt)


def host_point_from_reference(pt):
    """A host affine point of either group ((x, y) of ints or of the
    reference's `Fq2`, or None) in the port's classes."""
    return _point_from(pt, hf)


def host_point_to_reference(pt, towers):
    return _point_from(pt, towers)


def fq12_from_reference(x) -> hf.Fq12:
    return _tower_from(x, hf)


def fq12_to_reference(x: hf.Fq12, towers):
    return _tower_from(x, towers)


def _group_batch_from_reference(batch, backend):
    """One level of a key: a list of the reference's host affine points, or
    its limb pytree (as numpy), -> the repr of the port's `backend`."""
    if isinstance(batch, list):
        return backend.from_affine([host_point_from_reference(p) for p in batch])
    device = getattr(backend, "device", None)
    if device is None:
        raise TypeError("a limb pytree converts only for the port's device backend")
    return points_from_reference(batch, device=device)


def committer_key_from_reference(ck, profile):
    """The reference's `CommitterKey` (read by attribute: nv, powers_of_g,
    powers_of_h, g, h; the powers either host point lists or limb pytrees
    already turned into numpy) -> the port's key over `profile`."""
    from .core import pst

    return pst.CommitterKey(
        ck.nv,
        [_group_batch_from_reference(lvl, profile.g1b) for lvl in ck.powers_of_g],
        [_group_batch_from_reference(lvl, profile.g2b) for lvl in ck.powers_of_h],
        host_point_from_reference(ck.g),
        host_point_from_reference(ck.h),
        profile,
    )


def verifier_key_from_reference(vk, profile):
    from .core import pst

    return pst.VerifierKey(
        vk.nv,
        host_point_from_reference(vk.g),
        host_point_from_reference(vk.h),
        [host_point_from_reference(p) for p in vk.g_mask],
        [host_point_from_reference(p) for p in vk.h_mask],
        profile,
    )


def _mipp_proof(proof, towers, proof_cls):
    point = lambda p: _point_from(p, towers)
    return proof_cls(
        [(_tower_from(l, towers), _tower_from(r, towers)) for l, r in proof.comms_t],
        [(point(l), point(r)) for l, r in proof.comms_u],
        point(proof.final_a),
        point(proof.final_h),
        [point(p) for p in proof.pst_proof_h],
    )


def mipp_proof_from_reference(proof):
    from .core import mipp

    return _mipp_proof(proof, hf, mipp.MippProof)


def mipp_proof_to_reference(proof, towers, proof_cls):
    """The port's `MippProof` in the reference's classes: `towers` is its
    `fields.host` module, `proof_cls` its `MippProof`."""
    return _mipp_proof(proof, towers, proof_cls)


# -- R1CS instances and proofs --------------------------------------------------


def r1cs_instance_from_reference(inst):
    """The reference's `R1CSInstance` (num_cons, num_vars, num_inputs and
    each matrix's rows / cols arrays and vals ints), or its `Instance`
    (the same under `.inst`, with its digest), as the port's."""
    from .core import r1cs

    if hasattr(inst, "inst"):
        port = r1cs_instance_from_reference(inst.inst)
        digest = port.get_digest()
        if digest != bytes(inst.digest):
            raise ValueError("the instance's digest differs from the reference's")
        return r1cs.Instance(port, digest)

    def mat(m):
        return r1cs.SparseMatPolynomial(
            int(m.num_vars_x), int(m.num_vars_y), np.asarray(m.rows, dtype=np.int32),
            np.asarray(m.cols, dtype=np.int32), [int(v) for v in m.vals])

    return r1cs.R1CSInstance(int(inst.num_cons), int(inst.num_vars), int(inst.num_inputs),
                             mat(inst.A), mat(inst.B), mat(inst.C))


def _r1cs_proof(proof, towers, proof_cls, sumcheck_cls, unipoly_cls, mipp_cls):
    point = lambda p: _point_from(p, towers)

    def sc(s):
        return sumcheck_cls([unipoly_cls([int(c) for c in p.coeffs]) for p in s.polys])

    return proof_cls(
        point(proof.comm_U),
        sc(proof.sc_proof_phase1),
        tuple(int(c) for c in proof.claims_phase2),
        sc(proof.sc_proof_phase2),
        int(proof.eval_vars_at_ry),
        [point(p) for p in proof.proof_eval_vars_at_ry],
        [int(x) for x in proof.rx],
        [int(x) for x in proof.ry],
        int(proof.transcript_sat_state),
        int(proof.initial_state),
        _tower_from(proof.t, towers),
        _mipp_proof(proof.mipp_proof, towers, mipp_cls),
    )


def r1cs_proof_from_reference(proof):
    """The reference's `R1CSProof` in the port's classes."""
    from .core import mipp, r1csproof, sumcheck
    from .poly.unipoly import UniPoly

    return _r1cs_proof(proof, hf, r1csproof.R1CSProof, sumcheck.SumcheckInstanceProof,
                       UniPoly, mipp.MippProof)


def r1cs_proof_to_reference(proof, towers, proof_cls, sumcheck_cls, unipoly_cls, mipp_cls):
    """The port's `R1CSProof` in the reference's classes: `towers` is its
    `fields.host` module, the classes its `R1CSProof`,
    `SumcheckInstanceProof`, `UniPoly` and `MippProof`."""
    return _r1cs_proof(proof, towers, proof_cls, sumcheck_cls, unipoly_cls, mipp_cls)
