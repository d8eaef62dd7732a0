"""The port's serialization and proof codecs (testudo_tpu_torch/serialize.py,
proofs.py) against the JAX package's: the same bytes for the same objects,
readers that invert the writers and refuse malformed input."""
import numpy as np
import pytest

from testudo_tpu import proofs as jproofs
from testudo_tpu import serialize as jser
from testudo_tpu.core import mipp as jmipp
from testudo_tpu.curves import host_curve as jhc
from testudo_tpu.fields import host as jhf
from testudo_tpu_torch import convert, proofs
from testudo_tpu_torch import serialize as ser
from testudo_tpu_torch.core import mipp
from testudo_tpu_torch.curves import host_curve as hc
from testudo_tpu_torch.curves import pairing as pr
from testudo_tpu_torch.fields.bls12_377 import P, R

RNG = np.random.default_rng(101)


def _k():
    return int.from_bytes(RNG.bytes(40), "little") % R


G1S = [hc.g1_mul(hc.g1_generator(), _k()) for _ in range(4)]
KS2 = [_k() for _ in range(4)]
G2S = [hc.g2_mul(hc.g2_generator(), k) for k in KS2]
JG2S = [jhc.g2_mul(jhc.g2_generator(), k) for k in KS2]


def test_field_and_vector_writers_match_reference():
    for v in (0, 1, R - 1, R + 5):
        assert ser.fr_to_bytes(v) == jser.fr_to_bytes(v)
    for v in (0, P - 1, P + 3):
        assert ser.fq_to_bytes(v) == jser.fq_to_bytes(v)
    assert ser.u64_to_bytes(1 << 33) == jser.u64_to_bytes(1 << 33)
    assert ser.vec_to_bytes([1, 2, R - 1], ser.fr_to_bytes) == jser.vec_to_bytes([1, 2, R - 1], jser.fr_to_bytes)
    assert ser.fr_from_bytes(ser.fr_to_bytes(R - 1)) == R - 1
    assert ser.fr_from_bytes((R).to_bytes(32, "little")) is None
    e = pr.pairing(G1S[0], G2S[0])
    assert ser.fq12_to_bytes(e) == jser.fq12_to_bytes(convert.fq12_to_reference(e, jhf))
    assert len(ser.fq12_to_bytes(e)) == 576


@pytest.mark.parametrize("compress", [False, True])
def test_point_writers_match_reference_and_readers_invert_them(compress):
    for p in G1S + [None, hc.g1_neg(G1S[0])]:
        b = ser.g1_to_bytes(p, compress)
        assert b == jser.g1_to_bytes(p, compress)
        assert ser.read_g1(ser.Reader(b), compress) == p
    for p, jp in list(zip(G2S, JG2S)) + [(None, None), (hc.g2_neg(G2S[1]), jhc.g2_neg(JG2S[1]))]:
        b = ser.g2_to_bytes(p, compress)
        assert b == jser.g2_to_bytes(jp, compress)
        assert ser.read_g2(ser.Reader(b), compress) == p
    assert len(ser.g1_to_bytes(G1S[0], compress)) == (48 if compress else 96)
    assert len(ser.g2_to_bytes(G2S[0], compress)) == (96 if compress else 192)


def test_readers_refuse_malformed_input():
    good = ser.g1_to_bytes(G1S[0], True)
    with pytest.raises(ser.DeserializeError):
        ser.read_g1(ser.Reader(good[:-1]), True)  # truncated
    bad = bytearray(good)
    bad[-1] |= ser.FLAG_INFINITY | ser.FLAG_Y_NEG
    with pytest.raises(ser.DeserializeError):
        ser.read_g1(ser.Reader(bytes(bad)), True)
    with pytest.raises(ser.DeserializeError):
        ser.read_fr(ser.Reader((R).to_bytes(32, "little")))
    off_curve = ser.fq_to_bytes(G1S[0][0]) + ser.fq_to_bytes((G1S[0][1] + 1) % P)
    with pytest.raises(ser.DeserializeError):
        ser.read_g1(ser.Reader(off_curve), False)
    r = ser.Reader(good + b"\x00")
    ser.read_g1(r, True)
    with pytest.raises(ser.DeserializeError):
        r.finish()
    with pytest.raises(ser.DeserializeError):
        ser.read_vec(ser.Reader(ser.u64_to_bytes(1 << 40)), ser.read_fr)


def _proof(mod_mipp, g2s, towers):
    e = pr.pairing(G1S[0], G2S[0])
    gt = lambda x: convert.fq12_to_reference(x, towers) if towers else x
    return mod_mipp.MippProof(
        [(gt(e), gt(e.square())), (gt(e.inv()), gt(e))],
        [(G1S[0], G1S[1]), (None, G1S[2])],
        G1S[3], g2s[0], [g2s[1], g2s[2]],
    )


def test_proof_codecs_match_reference_and_round_trip():
    mine, theirs = _proof(mipp, G2S, None), _proof(jmipp, JG2S, jhf)
    blob = proofs.ser_mipp(mine)
    assert blob == jproofs.ser_mipp(theirs)
    back = proofs.de_mipp(ser.Reader(blob))
    assert proofs.ser_mipp(back) == blob
    assert back.comms_u == mine.comms_u and back.final_h == mine.final_h
    assert back.comms_t == mine.comms_t and back.pst_proof_h == mine.pst_proof_h
    pst_blob = proofs.ser_pst_proof(G1S)
    assert pst_blob == jproofs.ser_pst_proof(G1S) and len(pst_blob) == 8 + 4 * 48
    assert proofs.de_pst_proof(ser.Reader(pst_blob)) == G1S
    # carried across with convert.py, the proof serialises alike on the other side
    assert jproofs.ser_mipp(convert.mipp_proof_to_reference(mine, jhf, jmipp.MippProof)) == blob
    assert proofs.ser_mipp(convert.mipp_proof_from_reference(theirs)) == blob
