"""Proof serialization: arkworks-canonical byte layouts of the proof objects.

Counterpart of testudo_tpu/proofs.py, with the writers and readers of the
objects this package produces so far: the PST opening and the MIPP proof
(`ser_pst_proof`, `ser_mipp`, `de_pst_proof`, `de_mipp`).  The layouts are
those of ark-serialize 0.4 in compressed mode (serialize.py), so the byte
counts are the proof sizes Testudo reports.
"""
from __future__ import annotations

from typing import List

from . import serialize as ser
from .core import mipp as mipp_mod


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
