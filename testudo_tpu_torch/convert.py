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
The keys, MIPP proofs and R1CS proofs convert over either BLS12 curve: the
port's tower classes are those of the profile's curve (fields/host.py for
BLS12-377, curves/bls12_381.py for BLS12-381), and a round polynomial keeps
its modulus.
The `*_from_reference` functions read the reference's objects by attribute
and build the port's; the `*_to_reference` functions are handed the
reference's `fields.host` module and classes by the caller, since nothing
here may import them.  R1CS instances carry across by their matrices'
entries (host arrays and ints), R1CS proofs by their components, so that
both packages prove one instance and each verifies the other's proof.
Groth16's keys carry across by their host points and their batches (the
reference's limb pytrees, the port's batches on either backend), its proofs
and the SNARK's verifier proof by their components.  So do the keys and
proofs of the BW6-761 wrap (core/groth16_bw6.py), whose host points are int
pairs in both packages and whose batches are (N, 48) limb triples.
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


def towers_of(profile):
    """The port's module of tower classes (Fq2, Fq6, Fq12) for `profile`'s
    curve; BLS12-377's when `profile` is None."""
    if profile is None or profile.name == "bls12_377":
        return hf
    if profile.name == "bls12_381":
        from .curves import bls12_381

        return bls12_381
    raise ValueError(f"no tower classes for the curve {profile.name!r}")


def _group_batch_from_reference(batch, backend, towers=hf):
    """One level of a key: a list of the reference's host affine points, or
    its limb pytree (as numpy), -> the repr of the port's `backend`."""
    if isinstance(batch, list):
        return backend.from_affine([_point_from(p, towers) for p in batch])
    device = getattr(backend, "device", None)
    if device is None:
        raise TypeError("a limb pytree converts only for the port's device backend")
    return points_from_reference(batch, device=device)


def committer_key_from_reference(ck, profile):
    """The reference's `CommitterKey` (read by attribute: nv, powers_of_g,
    powers_of_h, g, h; the powers either host point lists or limb pytrees
    already turned into numpy) -> the port's key over `profile` (either
    BLS12 curve)."""
    from .core import pst

    towers = towers_of(profile)
    return pst.CommitterKey(
        ck.nv,
        [_group_batch_from_reference(lvl, profile.g1b, towers) for lvl in ck.powers_of_g],
        [_group_batch_from_reference(lvl, profile.g2b, towers) for lvl in ck.powers_of_h],
        _point_from(ck.g, towers),
        _point_from(ck.h, towers),
        profile,
    )


def verifier_key_from_reference(vk, profile):
    from .core import pst

    towers = towers_of(profile)
    return pst.VerifierKey(
        vk.nv,
        _point_from(vk.g, towers),
        _point_from(vk.h, towers),
        [_point_from(p, towers) for p in vk.g_mask],
        [_point_from(p, towers) for p in vk.h_mask],
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


def mipp_proof_from_reference(proof, profile=None):
    """The reference's `MippProof` in the port's classes of `profile`'s curve
    (default BLS12-377)."""
    from .core import mipp

    return _mipp_proof(proof, towers_of(profile), mipp.MippProof)


def mipp_proof_to_reference(proof, towers, proof_cls):
    """The port's `MippProof` in the reference's classes: `towers` is its
    `fields.host` module, `proof_cls` its `MippProof`."""
    return _mipp_proof(proof, towers, proof_cls)


# -- R1CS instances and proofs --------------------------------------------------


def scalar_spec(modulus: int):
    """The port's scalar field spec of that modulus (either BLS12 curve's Fr)."""
    from .device.field import FR381

    for spec in (FR, FR381):
        if spec.modulus == modulus:
            return spec
    raise ValueError(f"no scalar field of modulus {modulus:#x}")


def r1cs_instance_from_reference(inst):
    """The reference's `R1CSInstance` (num_cons, num_vars, num_inputs and
    each matrix's rows / cols arrays, vals ints and scalar field), or its
    `Instance` (the same under `.inst`, with its digest), as the port's."""
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
            np.asarray(m.cols, dtype=np.int32), [int(v) for v in m.vals],
            spec=scalar_spec(int(m.spec.modulus)))

    return r1cs.R1CSInstance(int(inst.num_cons), int(inst.num_vars), int(inst.num_inputs),
                             mat(inst.A), mat(inst.B), mat(inst.C))


def _r1cs_proof(proof, towers, proof_cls, sumcheck_cls, unipoly_cls, mipp_cls):
    point = lambda p: _point_from(p, towers)

    def sc(s):
        return sumcheck_cls([unipoly_cls([int(c) for c in p.coeffs], int(p.modulus))
                             for p in s.polys])

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


def r1cs_proof_from_reference(proof, profile=None):
    """The reference's `R1CSProof` in the port's classes of `profile`'s
    curve (default BLS12-377)."""
    from .core import mipp, r1csproof, sumcheck
    from .poly.unipoly import UniPoly

    return _r1cs_proof(proof, towers_of(profile), r1csproof.R1CSProof,
                       sumcheck.SumcheckInstanceProof, UniPoly, mipp.MippProof)


def r1cs_proof_to_reference(proof, towers, proof_cls, sumcheck_cls, unipoly_cls, mipp_cls):
    """The port's `R1CSProof` in the reference's classes: `towers` is its
    `fields.host` module, the classes its `R1CSProof`,
    `SumcheckInstanceProof`, `UniPoly` and `MippProof`."""
    return _r1cs_proof(proof, towers, proof_cls, sumcheck_cls, unipoly_cls, mipp_cls)


# -- Spark and TestudoSNARK ------------------------------------------------------
#
# Both packages name the classes of Spark's commitment, its generators and the
# SNARK's proof alike and give them the same fields in the same order, so one
# walk carries them across by class name: the caller hands over the modules
# that hold the target classes (the reference's core.snark, core.spark,
# core.polycommit, core.nizk, core.product_tree, core.sumcheck, core.commitments,
# core.r1csproof, core.mipp, poly.unipoly and its fields.host module as
# `towers`).  Leaves are ints and host affine G1 points ((x, y) ints or None),
# which both packages hold alike; the R1CS proof inside keeps its own converter
# (its pairing value and G2 points need the towers), and a MultiCommitGens
# takes the profile of the port's side (the reference's carries none).

_SPARK_CLASSES = (
    "TestudoSnark", "R1CSVerifierProof", "Proof", "R1CSEvalProof", "SparseMatPolyEvalProof",
    "DerefsCommitment", "PolyCommitment", "ProductLayerProof", "ProductCircuitEvalProofBatched",
    "LayerProofBatched", "SumcheckInstanceProof", "HashLayerProof", "PolyEvalProof",
    "DotProductProofLog", "BulletReductionProof", "DerefsEvalProof",
    "SparseMatPolyCommitment", "ComputationCommitment", "R1CSCommitmentGens",
    "SparseMatPolyCommitmentGens", "PolyCommitmentGens", "DotProductProofGens",
    "MultiCommitGens", "UniPoly", "R1CSProof", "MippProof",
)


def _classes(modules) -> dict:
    out = {}
    for m in modules:
        for name in _SPARK_CLASSES:
            if hasattr(m, name):
                out.setdefault(name, getattr(m, name))
    return out


def _port_modules():
    from .core import commitments, groth16, mipp, nizk, polycommit, product_tree, r1csproof
    from .core import snark, spark, sumcheck
    from .poly import unipoly

    return (snark, spark, polycommit, nizk, product_tree, sumcheck, commitments, r1csproof,
            mipp, unipoly, groth16)


def _carry(obj, cls: dict, towers, profile):
    """`obj` rebuilt from the classes in `cls` (see above)."""
    import dataclasses

    if obj is None or isinstance(obj, (bool, bytes)):
        return obj
    if isinstance(obj, int):
        return int(obj)
    if isinstance(obj, (list, tuple)):
        out = [_carry(x, cls, towers, profile) for x in obj]
        return out if isinstance(obj, list) else tuple(out)
    name = type(obj).__name__
    if name == "R1CSProof":
        return _r1cs_proof(obj, towers, cls["R1CSProof"], cls["SumcheckInstanceProof"],
                           cls["UniPoly"], cls["MippProof"])
    if name == "R1CSVerifierProof":
        return _verifier_proof(obj, towers, cls["R1CSVerifierProof"], cls["Proof"],
                               cls["MippProof"])
    if name == "Proof":
        return _groth16_proof(obj, towers, cls["Proof"])
    if name == "UniPoly":
        return cls["UniPoly"]([int(c) for c in obj.coeffs])
    if name == "MultiCommitGens":
        pts = [_point_from(p, towers) for p in obj.G]
        h = _point_from(obj.h, towers)
        if profile is None:
            return cls[name](int(obj.n), pts, h)
        return cls[name](int(obj.n), pts, h, profile)
    if not dataclasses.is_dataclass(obj) or name not in cls:
        raise TypeError(f"no counterpart for a {name}")
    target = cls[name]
    names = [f.name for f in dataclasses.fields(target) if not f.name.startswith("_")]
    return target(*[_carry(getattr(obj, n), cls, towers, profile) for n in names])


def snark_proof_from_reference(proof):
    """The reference's `TestudoSnark`, with its Groth16 verifier proof where
    it has one, in the port's classes."""
    return _carry(proof, _classes(_port_modules()), hf, None)


def snark_proof_to_reference(proof, towers, *modules):
    """The port's `TestudoSnark` in the reference's classes, found in
    `modules` (its core.groth16 among them for a proof with its Groth16
    part); `towers` is its `fields.host` module."""
    return _carry(proof, _classes(modules), towers, None)


def computation_commitment_from_reference(comm):
    """The reference's `ComputationCommitment` (host points and counts)."""
    return _carry(comm, _classes(_port_modules()), hf, None)


def computation_commitment_to_reference(comm, towers, *modules):
    return _carry(comm, _classes(modules), towers, None)


def spark_gens_from_reference(gens, profile):
    """The reference's `R1CSCommitmentGens` or `SparseMatPolyCommitmentGens`
    (their host points) as the port's, over `profile`."""
    return _carry(gens, _classes(_port_modules()), hf, profile)


def spark_gens_to_reference(gens, towers, *modules):
    return _carry(gens, _classes(modules), towers, None)


# -- Groth16 ---------------------------------------------------------------------


def _groth16_proof(proof, towers, proof_cls):
    return proof_cls(_point_from(proof.a, towers), _point_from(proof.b, towers),
                     _point_from(proof.c, towers))


def groth16_proof_from_reference(proof):
    """The reference's `groth16.Proof` (host affine A, B, C) as the port's."""
    from .core import groth16

    return _groth16_proof(proof, hf, groth16.Proof)


def groth16_proof_to_reference(proof, towers, proof_cls):
    return _groth16_proof(proof, towers, proof_cls)


def _verifier_proof(vp, towers, vp_cls, proof_cls, mipp_cls):
    return vp_cls(
        comm_U=_point_from(vp.comm_U, towers),
        circuit_proof=_groth16_proof(vp.circuit_proof, towers, proof_cls),
        initial_state=int(vp.initial_state),
        transcript_sat_state=int(vp.transcript_sat_state),
        eval_vars_at_ry=int(vp.eval_vars_at_ry),
        proof_eval_vars_at_ry=[_point_from(p, towers) for p in vp.proof_eval_vars_at_ry],
        t=_tower_from(vp.t, towers),
        mipp_proof=_mipp_proof(vp.mipp_proof, towers, mipp_cls),
    )


def _key_batch_from_reference(batch, backend):
    """A key's batch, the reference's limb pytree (or None), on `backend`:
    the device backend takes the limbs as they are, the host backend their
    affine points."""
    from .device import curve as tc

    if batch is None:
        return None
    device = getattr(backend, "device", None)
    if device is not None:
        return points_from_reference(batch, device=device)
    pts = points_from_reference(batch, device=torch.device("cpu"))
    to_affine = tc.g2_to_affine_host if _is_fq2(pts[0]) else tc.g1_to_affine_host
    return backend.from_affine(to_affine(pts))


def _key_batch_to_reference(batch, backend, g2: bool):
    """A key's batch on `backend` (or None) as numpy limbs in the reference's
    nesting: the device backend's projective limbs as they are, the host
    backend's affine points lifted (Z = 1; the identity (0, 1, 0))."""
    from .device import curve as tc

    if batch is None:
        return None
    if getattr(backend, "device", None) is None:
        lift = tc.g2_from_affine_host if g2 else tc.g1_from_affine_host
        batch = lift(backend.to_affine(batch), device=torch.device("cpu"))
    return points_to_reference(batch)


_PK_BATCHES = {"a_query": False, "b_g1_query": False, "b_g2_query": True, "h_query": False,
               "l_query": False}
_PK_HOST = ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2")
_VK_HOST = ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2")


def _vk(vk, towers, vk_cls, **extra):
    return vk_cls(**{n: _point_from(getattr(vk, n), towers) for n in _VK_HOST},
                  gamma_abc_g1=[_point_from(p, towers) for p in vk.gamma_abc_g1], **extra)


def groth16_keys_from_reference(pk, vk, profile):
    """The reference's Groth16 (`ProvingKey`, `VerifyingKey`) as the port's
    over `profile`; the proving key's batches go to the profile's backends."""
    from .core import groth16

    pvk = _vk(vk, hf, groth16.VerifyingKey, profile=profile)
    batches = {n: _key_batch_from_reference(getattr(pk, n), profile.g2b if g2 else profile.g1b)
               for n, g2 in _PK_BATCHES.items()}
    ppk = groth16.ProvingKey(
        num_pub=int(pk.num_pub), num_vars=int(pk.num_vars), domain_log=int(pk.domain_log),
        **{n: _point_from(getattr(pk, n), hf) for n in _PK_HOST}, **batches, vk=pvk,
        profile=profile)
    return ppk, pvk


def groth16_keys_to_reference(pk, vk, towers, groth16_module):
    """The port's Groth16 keys in the reference's classes (`groth16_module`
    is its core.groth16): host points in its towers, batches as numpy limb
    pytrees."""
    pf = pk.profile
    rvk = _vk(vk, towers, groth16_module.VerifyingKey)
    batches = {n: _key_batch_to_reference(getattr(pk, n), pf.g2b if g2 else pf.g1b, g2)
               for n, g2 in _PK_BATCHES.items()}
    rpk = groth16_module.ProvingKey(
        num_pub=pk.num_pub, num_vars=pk.num_vars, domain_log=pk.domain_log,
        **{n: _point_from(getattr(pk, n), towers) for n in _PK_HOST}, **batches, vk=rvk)
    return rpk, rvk


# -- BW6-761 (the one-level Groth16 wrap) -------------------------------------------


def _bw6_spec():
    from .device.curve_generic import FQ761

    return FQ761


def bw6_points_from_reference(coords, device=torch.device("cuda")):
    """The JAX package's BW6-761 projective batch, (X, Y, Z) of (N, 48)
    uint32 limb arrays (G1 and G2 alike: both are over the 761-bit field),
    -> the port's int32 tensors on `device`."""
    if len(coords) != 3:
        raise ValueError("a point batch is an (X, Y, Z) triple")
    n = _bw6_spec().nlimbs
    return tuple(torch.as_tensor(_limbs_in(c, n, "BW6 point coordinate"), device=device)
                 for c in coords)


def bw6_points_to_reference(points):
    """Inverse of bw6_points_from_reference: numpy uint32 arrays."""
    return tuple(_limbs_out(c) for c in points)


def _bw6_point(pt):
    return None if pt is None else (int(pt[0]), int(pt[1]))


_BW6_BATCHES = ("a_query", "b_g1_query", "b_g2_query", "h_query", "l_query")


def _bw6_keys(pk, vk, vk_cls, pk_cls, batch):
    """One package's BW6 Groth16 keys in the other's classes: host points
    (int pairs in both) copied, batches through `batch` (None stays None)."""
    out_vk = vk_cls(**{n: _bw6_point(getattr(vk, n)) for n in _VK_HOST},
                    gamma_abc_g1=[_bw6_point(p) for p in vk.gamma_abc_g1])
    out_pk = pk_cls(
        num_pub=int(pk.num_pub), num_vars=int(pk.num_vars), domain_log=int(pk.domain_log),
        **{n: _bw6_point(getattr(pk, n)) for n in _PK_HOST},
        **{n: None if getattr(pk, n) is None else batch(getattr(pk, n)) for n in _BW6_BATCHES},
        vk=out_vk)
    return out_pk, out_vk


def bw6_groth16_keys_from_reference(pk, vk, device=torch.device("cuda")):
    """The reference's core.groth16_bw6 (`ProvingKey`, `VerifyingKey`) as the
    port's, the key batches on `device`."""
    from .core import groth16_bw6

    return _bw6_keys(pk, vk, groth16_bw6.VerifyingKey, groth16_bw6.ProvingKey,
                     lambda b: bw6_points_from_reference(b, device=device))


def bw6_groth16_keys_to_reference(pk, vk, groth16_bw6_module):
    """The port's BW6 Groth16 keys in the reference's classes
    (`groth16_bw6_module` is its core.groth16_bw6), batches as numpy uint32."""
    return _bw6_keys(pk, vk, groth16_bw6_module.VerifyingKey, groth16_bw6_module.ProvingKey,
                     bw6_points_to_reference)


def bw6_groth16_proof_from_reference(proof):
    from .core import groth16_bw6

    return groth16_bw6.Proof(*(_bw6_point(p) for p in (proof.a, proof.b, proof.c)))


def bw6_groth16_proof_to_reference(proof, proof_cls):
    return proof_cls(*(_bw6_point(p) for p in (proof.a, proof.b, proof.c)))
