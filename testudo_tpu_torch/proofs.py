"""Proof serialization: arkworks-canonical byte layouts of the proof objects.

Counterpart of testudo_tpu/proofs.py, with the writers and readers of the
objects this package produces so far: the PST opening, the MIPP proof, the
round polynomials, the sumcheck proof and the R1CS satisfiability proof of
TestudoNIZK (`ser_*`, `de_*`, `parse_r1cs_proof`).  The layouts are
those of ark-serialize 0.4 in compressed mode (serialize.py), so the byte
counts are the proof sizes Testudo reports.
"""
from __future__ import annotations

from typing import List

from . import serialize as ser
from .core import mipp as mipp_mod
from .core import r1csproof as rp
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
