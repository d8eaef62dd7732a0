"""Proof serialization: arkworks-canonical byte layouts of the proof objects.

Counterpart of testudo_tpu/proofs.py, with the writers and readers of the
objects this package produces so far: the PST opening, the MIPP proof, the
round polynomials, the sumcheck proof, the R1CS satisfiability proof of
TestudoNIZK (`parse_r1cs_proof`), Spark's evaluation proof with its
row-wise Pedersen commitments and dot-product arguments, the Groth16 proof
(A, C compressed G1, B compressed G2: 192 B), and TestudoSNARK
(`parse_testudo_snark`; the Groth16-compressed verifier proof is an arkworks
Option: a 1-byte tag, then the Groth16 proof alone, as the rest of the
verifier proof is the R1CS proof's).  The layouts are
those of ark-serialize 0.4 in compressed mode (serialize.py), so the byte
counts are the proof sizes Testudo reports.
"""
from __future__ import annotations

from typing import List

from . import serialize as ser
from .core import groth16 as groth16_mod
from .core import mipp as mipp_mod
from .core import nizk as nizk_mod
from .core import polycommit as pc_mod
from .core import product_tree as ptree_mod
from .core import r1csproof as rp
from .core import snark as snark_mod
from .core import spark as spark_mod
from .core import sumcheck as sumcheck_mod
from .poly.unipoly import UniPoly


def ser_unipoly(p) -> bytes:
    return ser.vec_to_bytes(p.coeffs, ser.fr_to_bytes)


def ser_sumcheck(s) -> bytes:
    return ser.vec_to_bytes(s.polys, ser_unipoly)


def ser_mipp(m: mipp_mod.MippProof) -> bytes:
    out = bytearray()
    out += ser.vec_to_bytes(
        m.comms_t, lambda t: ser.fq12_to_bytes(t[0]) + ser.fq12_to_bytes(t[1])
    )
    out += ser.vec_to_bytes(
        m.comms_u,
        lambda u: ser.g1_to_bytes(u[0], True) + ser.g1_to_bytes(u[1], True),
    )
    out += ser.g1_to_bytes(m.final_a, True)
    out += ser.g2_to_bytes(m.final_h, True)
    out += ser.vec_to_bytes(m.pst_proof_h, lambda p: ser.g2_to_bytes(p, True))
    return bytes(out)


def ser_pst_proof(proofs: List) -> bytes:
    return ser.vec_to_bytes(proofs, lambda p: ser.g1_to_bytes(p, True))


def ser_r1cs_proof(p: rp.R1CSProof) -> bytes:
    out = bytearray()
    out += ser.g1_to_bytes(p.comm_U, True)
    out += ser_sumcheck(p.sc_proof_phase1)
    for c in p.claims_phase2:
        out += ser.fr_to_bytes(c)
    out += ser_sumcheck(p.sc_proof_phase2)
    out += ser.fr_to_bytes(p.eval_vars_at_ry)
    out += ser_pst_proof(p.proof_eval_vars_at_ry)
    out += ser.vec_to_bytes(p.rx, ser.fr_to_bytes)
    out += ser.vec_to_bytes(p.ry, ser.fr_to_bytes)
    out += ser.fr_to_bytes(p.transcript_sat_state)
    out += ser.fr_to_bytes(p.initial_state)
    out += ser.fq12_to_bytes(p.t)
    out += ser_mipp(p.mipp_proof)
    return bytes(out)


def ser_groth16_proof(p: groth16_mod.Proof) -> bytes:
    return ser.g1_to_bytes(p.a, True) + ser.g2_to_bytes(p.b, True) + ser.g1_to_bytes(p.c, True)


def _ser_g1c(pt) -> bytes:
    return ser.g1_to_bytes(pt, True)


def _ser_polycommit(c: pc_mod.PolyCommitment) -> bytes:
    return ser.vec_to_bytes(c.C, _ser_g1c)


def _ser_dotproduct_log(d: nizk_mod.DotProductProofLog) -> bytes:
    out = bytearray()
    out += ser.vec_to_bytes(d.bullet_reduction_proof.L_vec, _ser_g1c)
    out += ser.vec_to_bytes(d.bullet_reduction_proof.R_vec, _ser_g1c)
    out += _ser_g1c(d.delta)
    out += _ser_g1c(d.beta)
    out += ser.fr_to_bytes(d.z1)
    out += ser.fr_to_bytes(d.z2)
    return bytes(out)


def _ser_layer(layer: ptree_mod.LayerProofBatched) -> bytes:
    return (ser_sumcheck(layer.proof)
            + ser.vec_to_bytes(layer.claims_prod_left, ser.fr_to_bytes)
            + ser.vec_to_bytes(layer.claims_prod_right, ser.fr_to_bytes))


def ser_spark_proof(p: spark_mod.SparseMatPolyEvalProof) -> bytes:
    """SparseMatPolyEvalProof, in the JAX package's layout."""
    out = bytearray()
    out += _ser_polycommit(p.comm_derefs.comm_ops_val)
    pl = p.proof_prod_layer
    for group in (pl.eval_row, pl.eval_col):
        out += ser.fr_to_bytes(group[0])
        out += ser.vec_to_bytes(group[1], ser.fr_to_bytes)
        out += ser.vec_to_bytes(group[2], ser.fr_to_bytes)
        out += ser.fr_to_bytes(group[3])
    out += ser.vec_to_bytes(pl.eval_val[0], ser.fr_to_bytes)
    out += ser.vec_to_bytes(pl.eval_val[1], ser.fr_to_bytes)
    for prf in (pl.proof_mem, pl.proof_ops):
        out += ser.vec_to_bytes(prf.proof, _ser_layer)
        for lst in prf.claims_dotp:
            out += ser.vec_to_bytes(lst, ser.fr_to_bytes)
    hl = p.proof_hash_layer
    for group in (hl.eval_row, hl.eval_col):
        out += ser.vec_to_bytes(group[0], ser.fr_to_bytes)
        out += ser.vec_to_bytes(group[1], ser.fr_to_bytes)
        out += ser.fr_to_bytes(group[2])
    out += ser.vec_to_bytes(hl.eval_val, ser.fr_to_bytes)
    out += ser.vec_to_bytes(hl.eval_derefs[0], ser.fr_to_bytes)
    out += ser.vec_to_bytes(hl.eval_derefs[1], ser.fr_to_bytes)
    out += _ser_dotproduct_log(hl.proof_ops.proof)
    out += _ser_dotproduct_log(hl.proof_mem.proof)
    out += _ser_dotproduct_log(hl.proof_derefs.proof_derefs.proof)
    return bytes(out)


def ser_testudo_snark(p: snark_mod.TestudoSnark) -> bytes:
    """The R1CS proof, Spark's proof, the three evaluations, (rx, ry) and the
    Option of the Groth16 verifier proof (arkworks: a 1-byte tag, then the
    Groth16 proof)."""
    out = bytearray()
    out += ser_r1cs_proof(p.r1cs_sat_proof)
    out += ser_spark_proof(p.r1cs_eval_proof.proof)
    for e in p.inst_evals:
        out += ser.fr_to_bytes(e)
    out += ser.vec_to_bytes(p.r[0], ser.fr_to_bytes)
    out += ser.vec_to_bytes(p.r[1], ser.fr_to_bytes)
    if p.r1cs_verifier_proof is not None:
        out += b"\x01"
        out += ser_groth16_proof(p.r1cs_verifier_proof.circuit_proof)
    else:
        out += b"\x00"
    return bytes(out)


# ---------------------------------------------------------------------------
# Deserialization: byte-exact inverses of the writers above.  Each de_*
# consumes from a serialize.Reader and rebuilds a verifiable proof object.
# ---------------------------------------------------------------------------


def de_unipoly(r: ser.Reader) -> UniPoly:
    return UniPoly(ser.read_vec(r, ser.read_fr))


def de_sumcheck(r: ser.Reader) -> sumcheck_mod.SumcheckInstanceProof:
    return sumcheck_mod.SumcheckInstanceProof(ser.read_vec(r, de_unipoly))


def de_mipp(r: ser.Reader) -> mipp_mod.MippProof:
    comms_t = ser.read_vec(
        r, lambda rd: (ser.read_fq12(rd), ser.read_fq12(rd))
    )
    comms_u = ser.read_vec(
        r, lambda rd: (ser.read_g1(rd, True), ser.read_g1(rd, True))
    )
    final_a = ser.read_g1(r, True)
    final_h = ser.read_g2(r, True)
    pst_proof_h = ser.read_vec(r, lambda rd: ser.read_g2(rd, True))
    return mipp_mod.MippProof(comms_t, comms_u, final_a, final_h, pst_proof_h)


def de_pst_proof(r: ser.Reader) -> List:
    return ser.read_vec(r, lambda rd: ser.read_g1(rd, True))


def de_r1cs_proof(r: ser.Reader) -> rp.R1CSProof:
    comm_U = ser.read_g1(r, True)
    sc1 = de_sumcheck(r)
    claims = tuple(ser.read_fr(r) for _ in range(4))
    sc2 = de_sumcheck(r)
    eval_vars_at_ry = ser.read_fr(r)
    proof_eval = de_pst_proof(r)
    rx = ser.read_vec(r, ser.read_fr)
    ry = ser.read_vec(r, ser.read_fr)
    transcript_sat_state = ser.read_fr(r)
    initial_state = ser.read_fr(r)
    t = ser.read_fq12(r)
    mipp = de_mipp(r)
    return rp.R1CSProof(
        comm_U, sc1, claims, sc2, eval_vars_at_ry, proof_eval,
        rx, ry, transcript_sat_state, initial_state, t, mipp,
    )


def parse_r1cs_proof(data: bytes) -> rp.R1CSProof:
    """The whole of `data` as one R1CS proof; trailing bytes are an error."""
    r = ser.Reader(data)
    out = de_r1cs_proof(r)
    r.finish()
    return out


def de_groth16_proof(r: ser.Reader) -> groth16_mod.Proof:
    return groth16_mod.Proof(ser.read_g1(r, True), ser.read_g2(r, True), ser.read_g1(r, True))


def _read_g1c(r: ser.Reader):
    return ser.read_g1(r, True)


def _read_frs(r: ser.Reader) -> List[int]:
    return ser.read_vec(r, ser.read_fr)


def _de_polycommit(r: ser.Reader) -> pc_mod.PolyCommitment:
    return pc_mod.PolyCommitment(ser.read_vec(r, _read_g1c))


def _de_dotproduct_log(r: ser.Reader) -> nizk_mod.DotProductProofLog:
    L_vec = ser.read_vec(r, _read_g1c)
    R_vec = ser.read_vec(r, _read_g1c)
    delta = _read_g1c(r)
    beta = _read_g1c(r)
    z1 = ser.read_fr(r)
    z2 = ser.read_fr(r)
    return nizk_mod.DotProductProofLog(nizk_mod.BulletReductionProof(L_vec, R_vec), delta, beta,
                                       z1, z2)


def _de_layer(r: ser.Reader) -> ptree_mod.LayerProofBatched:
    prf = de_sumcheck(r)
    return ptree_mod.LayerProofBatched(prf, _read_frs(r), _read_frs(r))


def _de_batched(r: ser.Reader) -> ptree_mod.ProductCircuitEvalProofBatched:
    layers = ser.read_vec(r, _de_layer)
    dotp = tuple(_read_frs(r) for _ in range(3))
    return ptree_mod.ProductCircuitEvalProofBatched(layers, dotp)


def de_spark_proof(r: ser.Reader) -> spark_mod.SparseMatPolyEvalProof:
    comm_derefs = spark_mod.DerefsCommitment(_de_polycommit(r))

    def prod_group():
        return (ser.read_fr(r), _read_frs(r), _read_frs(r), ser.read_fr(r))

    eval_row = prod_group()
    eval_col = prod_group()
    eval_val = (_read_frs(r), _read_frs(r))
    proof_mem = _de_batched(r)
    proof_ops = _de_batched(r)
    pl = spark_mod.ProductLayerProof(eval_row, eval_col, eval_val, proof_mem, proof_ops)

    def hash_group():
        return (_read_frs(r), _read_frs(r), ser.read_fr(r))

    h_row = hash_group()
    h_col = hash_group()
    h_val = _read_frs(r)
    h_derefs = (_read_frs(r), _read_frs(r))
    proof_ops_h = pc_mod.PolyEvalProof(_de_dotproduct_log(r))
    proof_mem_h = pc_mod.PolyEvalProof(_de_dotproduct_log(r))
    proof_derefs = spark_mod.DerefsEvalProof(pc_mod.PolyEvalProof(_de_dotproduct_log(r)))
    hl = spark_mod.HashLayerProof(h_row, h_col, h_val, h_derefs, proof_ops_h, proof_mem_h,
                                  proof_derefs)
    return spark_mod.SparseMatPolyEvalProof(comm_derefs, pl, hl)


def de_testudo_snark(r: ser.Reader) -> snark_mod.TestudoSnark:
    sat = de_r1cs_proof(r)
    eval_proof = snark_mod.R1CSEvalProof(de_spark_proof(r))
    inst_evals = tuple(ser.read_fr(r) for _ in range(3))
    r0 = _read_frs(r)
    r1 = _read_frs(r)
    tag = r.take(1)[0]
    verifier_proof = None
    if tag == 1:
        verifier_proof = rp.R1CSVerifierProof(
            comm_U=sat.comm_U,
            circuit_proof=de_groth16_proof(r),
            initial_state=sat.initial_state,
            transcript_sat_state=sat.transcript_sat_state,
            eval_vars_at_ry=sat.eval_vars_at_ry,
            proof_eval_vars_at_ry=sat.proof_eval_vars_at_ry,
            t=sat.t,
            mipp_proof=sat.mipp_proof,
        )
    elif tag != 0:
        raise ser.DeserializeError(f"bad Option tag {tag}")
    return snark_mod.TestudoSnark(sat, eval_proof, inst_evals, (r0, r1), verifier_proof)


def parse_testudo_snark(data: bytes) -> snark_mod.TestudoSnark:
    """The whole of `data` as one TestudoSNARK proof; trailing bytes are an
    error."""
    r = ser.Reader(data)
    out = de_testudo_snark(r)
    r.finish()
    return out
