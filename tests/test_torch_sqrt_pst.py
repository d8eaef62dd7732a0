"""The slice as a whole: the port's sqrt-PST commitment (setup, from_evaluations,
eval, commit, open with MIPP, verify; testudo_tpu_torch/core/sqrt_pst.py) against
the JAX package's on the same table and point, at nv = 4 (square matrix) and
nv = 5 (one more row variable).  The port runs with its device backends on the
CPU (the kernels' plain versions), the JAX package with its host group
backends, so no JAX curve graph is compiled.  Equal evaluations, equal column
commitments and T, byte-equal proofs, equal sponge states, and each package's
verifier accepts the other's proof and rejects a wrong value.  Exact."""
import numpy as np
import pytest
import torch

from testudo_tpu import proofs as jproofs
from testudo_tpu import serialize as jser
from testudo_tpu.core import mipp as jmipp
from testudo_tpu.core import pst as jpst
from testudo_tpu.core import sqrt_pst as jsq
from testudo_tpu.curves import profile as jprof
from testudo_tpu.fields import host as jhf
from testudo_tpu.poly import dense as jd
from testudo_tpu.poseidon import transcript as jtr
from testudo_tpu_torch import convert, proofs
from testudo_tpu_torch import serialize as ser
from testudo_tpu_torch.core import pst, sqrt_pst
from testudo_tpu_torch.curves import profile as cprof
from testudo_tpu_torch.device import build
from testudo_tpu_torch.fields.bls12_377 import R
from testudo_tpu_torch.poly import dense
from testudo_tpu_torch.poseidon import transcript as ttr

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)


def _run(nv: int) -> dict:
    """commit -> open -> verify in both packages on one table and point."""
    rng = np.random.default_rng(130 + nv)
    Z = [0, 1, R - 1] + [int.from_bytes(rng.bytes(40), "little") % R for _ in range((1 << nv) - 3)]
    point = [int.from_bytes(rng.bytes(40), "little") % R for _ in range(nv)]
    m_row = nv // 2 + nv % 2
    mp = pytest.MonkeyPatch()
    mp.setenv("TESTUDO_HOST_CURVE", "1")  # read when the profile is first built
    jprof.bls12_377.cache_clear()
    jpf = jprof.bls12_377()
    mp.setattr(jpst, "_SETUP_CACHE", {})
    pf = cprof.bls12_377("cpu")
    try:
        out = dict(nv=nv, point=point, pf=pf, jpf=jpf)
        build.reset_launches()
        # the port
        ck, vk = pst.setup(m_row, profile=pf)
        pl = sqrt_pst.Polynomial.from_evaluations(dense.encode_table(Z, device="cpu"), pf)
        out["v"] = pl.eval(point)
        comm, T = pl.commit(ck)
        tp = ttr.PoseidonTranscript(ttr.fq_params())
        U, pst_proof, mipp_proof = pl.open(tp, comm, ck, point, T)
        tv = ttr.PoseidonTranscript(ttr.fq_params())
        out["ok"] = sqrt_pst.verify(tv, vk, U, point, out["v"], pst_proof, mipp_proof, T)
        out.update(pl=pl, vk=vk, comm=pf.g1b.to_affine(comm), T=T, U=U, pst_proof=pst_proof,
                   mipp_proof=mipp_proof, prover_state=list(tp.sponge.state),
                   verifier_state=list(tv.sponge.state), launches=sum(build.LAUNCHES.values()))
        # the JAX package, host group backends
        jck, jvk = jpst.setup(m_row, profile=jpf)
        jpl = jsq.Polynomial.from_evaluations(jd.encode_table(Z), jpf)
        out["jv"] = jpl.eval(point)
        jcomm, jT = jpl.commit(jck)
        jtp = jtr.PoseidonTranscript(jtr.fq_params())
        jU, jpst_proof, jmipp_proof = jpl.open(jtp, jcomm, jck, point, jT)
        jtv = jtr.PoseidonTranscript(jtr.fq_params())
        out["jok"] = jsq.verify(jtv, jvk, jU, point, out["jv"], jpst_proof, jmipp_proof, jT)
        out.update(jpl=jpl, jvk=jvk, jcomm=list(jcomm), jT=jT, jU=jU, jpst_proof=jpst_proof,
                   jmipp_proof=jmipp_proof, jprover_state=list(jtp.sponge.state),
                   jverifier_state=list(jtv.sponge.state))
        return out
    finally:
        jprof.bls12_377.cache_clear()
        mp.undo()


@pytest.fixture(scope="module", params=[4, 5], ids=["nv4", "nv5"])
def run(request):
    return _run(request.param)


def test_matrix_shape_follows_the_parity(run):
    nv, pl = run["nv"], run["pl"]
    assert (pl.m, pl.odd, pl.m_row) == (nv // 2, nv % 2, nv - nv // 2)
    assert tuple(pl.matrix.shape) == (1 << pl.m_row, 1 << pl.m, 16)
    assert (pl.m, pl.odd) == (run["jpl"].m, run["jpl"].odd)
    assert np.array_equal(pl.q.numpy(), np.asarray(run["jpl"].q).astype(np.int32))
    assert run["launches"] == 0  # CPU tensors take the plain versions


def test_eval_equals_reference(run):
    assert run["v"] == run["jv"]


def test_column_commitments_and_t_equal_reference(run):
    assert run["comm"] == run["jcomm"] and len(run["comm"]) == 1 << (run["nv"] // 2)
    assert ser.fq12_to_bytes(run["T"]) == jser.fq12_to_bytes(run["jT"])
    assert run["U"] == run["jU"]


def test_proof_bytes_equal_reference(run):
    mine = proofs.ser_pst_proof(run["pst_proof"]) + proofs.ser_mipp(run["mipp_proof"])
    theirs = jproofs.ser_pst_proof(run["jpst_proof"]) + jproofs.ser_mipp(run["jmipp_proof"])
    assert mine == theirs
    m, m_row = run["nv"] // 2, run["nv"] - run["nv"] // 2
    # PST opening: m_row G1; MIPP: m (GT, GT) pairs, m (G1, G1) pairs, G1, G2, m G2
    assert len(mine) == (8 + 48 * m_row) + (8 + 2 * 576 * m) + (8 + 2 * 48 * m) + 48 + 96 + (8 + 96 * m)


def test_transcripts_end_in_the_same_sponge_state(run):
    assert run["prover_state"] == run["verifier_state"]
    assert run["prover_state"] == run["jprover_state"] == run["jverifier_state"]


def test_verifiers_accept_and_reject(run):
    assert run["ok"] is True and run["jok"] is True
    fresh = lambda: ttr.PoseidonTranscript(ttr.fq_params())
    args = (run["vk"], run["U"], run["point"])
    bad_v = (run["v"] + 1) % R
    assert sqrt_pst.verify(fresh(), *args, bad_v, run["pst_proof"], run["mipp_proof"], run["T"]) is False
    bad_point = run["point"][:-1] + [(run["point"][-1] + 1) % R]
    assert sqrt_pst.verify(fresh(), run["vk"], run["U"], bad_point, run["v"], run["pst_proof"],
                           run["mipp_proof"], run["T"]) is False
    jfresh = lambda: jtr.PoseidonTranscript(jtr.fq_params())
    assert jsq.verify(jfresh(), run["jvk"], run["jU"], run["point"], bad_v, run["jpst_proof"],
                      run["jmipp_proof"], run["jT"]) is False


def test_each_verifier_accepts_the_other_packages_proof(run):
    # the port's proof, carried across, in the JAX package's verifier
    jproof = convert.mipp_proof_to_reference(run["mipp_proof"], jhf, jmipp.MippProof)
    jT = convert.fq12_to_reference(run["T"], jhf)
    jtv = jtr.PoseidonTranscript(jtr.fq_params())
    assert jsq.verify(jtv, run["jvk"], run["U"], run["point"], run["v"], run["pst_proof"],
                      jproof, jT) is True
    jtv = jtr.PoseidonTranscript(jtr.fq_params())
    assert jsq.verify(jtv, run["jvk"], run["U"], run["point"], (run["v"] + 1) % R,
                      run["pst_proof"], jproof, jT) is False
    # and the other way, with the key carried across too
    vk = convert.verifier_key_from_reference(run["jvk"], run["pf"])
    proof = convert.mipp_proof_from_reference(run["jmipp_proof"])
    T = convert.fq12_from_reference(run["jT"])
    tv = ttr.PoseidonTranscript(ttr.fq_params())
    assert sqrt_pst.verify(tv, vk, run["jU"], run["point"], run["jv"], run["jpst_proof"], proof, T) is True
    # through bytes: what a verifier on another machine would read
    blob = proofs.ser_mipp(run["mipp_proof"])
    back = proofs.de_mipp(ser.Reader(blob))
    tv = ttr.PoseidonTranscript(ttr.fq_params())
    assert sqrt_pst.verify(tv, run["vk"], run["U"], run["point"], run["v"], run["pst_proof"],
                           back, run["T"]) is True


def test_from_evaluations_refuses_a_ragged_table():
    with pytest.raises(ValueError):
        sqrt_pst.Polynomial.from_evaluations(torch.zeros((6, 16), dtype=torch.int32),
                                             cprof.bls12_377("cpu"))
    pl = sqrt_pst.Polynomial.from_evaluations(torch.zeros((8, 16), dtype=torch.int32),
                                              cprof.bls12_377("cpu"))
    with pytest.raises(ValueError):
        pl.eval([1, 2])
