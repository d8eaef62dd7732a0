"""The shared-basis multi-MSM in column blocks (testudo_tpu_torch/device/msm.py:
`multi_msm_blocks`, `_multi_msm_index`, `_multi_msm_windows`), the counterpart
of the JAX package's chunks of K (testudo_tpu/tpu/msm.py:1113-1136).

  - The plan: one block wherever the columns' index list stays under 2^31
    entries (every sqrt-PST size up to nv = 25); at nv = 26 and 27 blocks that
    cover the columns, each under 2^31 entries and at least 32,768 lanes; a
    ValueError where no plan exists (no fallback).
  - With the limits monkeypatched down, 5 columns split into 2 or 3 uneven
    blocks: the window sums equal the one-launch sums limb for limb (G1 and
    G2), `_multi_msm_device` hands its Horner those window sums (so its output
    is the unchunked call's, limb for limb) and equals the host MSM per column
    in affine; the same patch under a 2-shard CPU mesh equals the unsharded
    result.
  - sqrt-PST at nv = 4 and 5 with the same patch (and the packed path forced
    at these small bases): commitments and T equal to the JAX package's
    `testudo_tpu.core.sqrt_pst` on the same table and point, as
    tests/test_torch_sqrt_pst.py builds them; at nv = 4 the opening too,
    byte-equal (the opening reads the commitments, not the blocks).

On the CPU the kernels' plain versions run: a Horner ladder costs about a
third of a millisecond a lane-bit, which sets the sizes.  Exact."""
import numpy as np
import pytest
import torch

from testudo_tpu import proofs as jproofs
from testudo_tpu import serialize as jser
from testudo_tpu.core import pst as jpst
from testudo_tpu.core import sqrt_pst as jsq
from testudo_tpu.curves import profile as jprof
from testudo_tpu.poly import dense as jd
from testudo_tpu.poseidon import transcript as jtr
from testudo_tpu_torch import proofs
from testudo_tpu_torch import serialize as ser
from testudo_tpu_torch.core import pst, sqrt_pst
from testudo_tpu_torch.curves import host_curve as hc
from testudo_tpu_torch.curves import profile as cprof
from testudo_tpu_torch.device import curve as tc
from testudo_tpu_torch.device import msm
from testudo_tpu_torch.device.field import FR
from testudo_tpu_torch.device.packed_curve import G1P, G2P
from testudo_tpu_torch.fields.bls12_377 import R
from testudo_tpu_torch.parallel import mesh as pmesh
from testudo_tpu_torch.poly import dense
from testudo_tpu_torch.poseidon import transcript as ttr

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")
K = 5  # columns of the patched runs
W8 = 256 // 8  # windows at c = 8


def _sqrt_pst_shape(nv):
    """(K, N) of the sqrt-PST commit at nv variables: 2^m_col columns of
    2^m_row points."""
    return 1 << (nv // 2), 1 << (nv - nv // 2)


@pytest.mark.parametrize("nv", range(7, 26))
def test_one_block_up_to_nv25(nv):
    Kc, N = _sqrt_pst_shape(nv)
    assert msm.multi_msm_blocks(Kc, N, W8) == [(0, Kc)]


@pytest.mark.parametrize("nv, nblocks", [(26, 2), (27, 4)])
def test_blocks_at_nv26_and_27(nv, nblocks):
    """nv = 26: 2 blocks of 4,096 columns; nv = 27: 4 blocks of 2,048, each
    2^30 index entries and 65,536 lanes."""
    Kc, N = _sqrt_pst_shape(nv)
    blocks = msm.multi_msm_blocks(Kc, N, W8)
    assert len(blocks) == nblocks
    assert blocks[0][0] == 0 and blocks[-1][1] == Kc
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    for k0, k1 in blocks:
        assert (k1 - k0) * W8 * N < 1 << 31
        assert (k1 - k0) * W8 >= 32768
    assert {k1 - k0 for k0, k1 in blocks} == {Kc // nblocks}


def test_no_plan_raises():
    """nv = 31 needs blocks of 512 columns (16,384 lanes): refused, as is a
    column whose own index reaches 2^31 entries."""
    with pytest.raises(ValueError):
        msm.multi_msm_blocks(*_sqrt_pst_shape(31), W8)
    with pytest.raises(ValueError):
        msm.multi_msm_blocks(2, 1 << 26, W8)
    with pytest.raises(ValueError):
        msm.multi_msm_blocks(0, 8, W8)


def _patch_limits(monkeypatch, N, W, cols):
    """An index limit of `cols` columns of N points in W windows, every lane
    count allowed: K = 5 columns then split into 3 blocks (2, 2, 1) at 4 and
    into 2 blocks (3, 2) at 5; K = 4 into (2, 2) at 4; K = 3 into (2, 1) at 3."""
    monkeypatch.setattr(msm, "_INDEX_LIMIT", cols * W * N)
    monkeypatch.setattr(msm, "_MIN_BLOCK_LANES", 1)


@pytest.mark.parametrize("cols, want", [(4, [(0, 2), (2, 4), (4, 5)]), (5, [(0, 3), (3, 5)])])
def test_patched_limits_give_uneven_blocks(monkeypatch, cols, want):
    _patch_limits(monkeypatch, 8, W8, cols)
    assert msm.multi_msm_blocks(K, 8, W8) == want
    assert msm.multi_msm_blocks(2, 8, W8) == [(0, 2)]  # under the limit: one block


def test_a_block_at_the_limit_raises(monkeypatch):
    """`_multi_msm_index` refuses a block whose index reaches the limit (c =
    4: 64 windows of 16 digits)."""
    monkeypatch.setattr(msm, "_INDEX_LIMIT", 2 * 64 * 8)
    scal = torch.zeros((2, 8, FR.nlimbs), dtype=torch.int32)
    with pytest.raises(ValueError):
        msm._multi_msm_index(scal, 4)
    idx, start, count = msm._multi_msm_index(scal[:1], 4)
    assert idx.shape == (64 * 8,) and start.tolist() == [8 * w for w in range(64)]
    assert idx.tolist() == [16 * t for t in range(8)] * 64 and count.tolist() == [8] * 64


def _basis(group, N, seed):
    rng = np.random.default_rng(seed)
    gen, mul = (hc.g1_generator, hc.g1_mul) if group == "g1" else (hc.g2_generator, hc.g2_mul)
    pts = [mul(gen(), int(k)) for k in rng.integers(1, 1 << 62, size=N)]
    to_dev = tc.g1_from_affine_host if group == "g1" else tc.g2_from_affine_host
    return pts, to_dev(pts, device=CPU)


def _columns(N, seed):
    rng = np.random.default_rng(seed)
    cols = [[int.from_bytes(rng.bytes(40), "little") % R for _ in range(N)] for _ in range(K)]
    cols[0][:3] = [0, 1, R - 1]
    cols[3][2] = 0
    return cols, torch.from_numpy(np.stack([FR.to_limbs(c) for c in cols]))


def _host_horner(group, wins_aff, c):
    """sum_w 2^(c w) wins[w] on the host."""
    add, mul = (hc.g1_add, hc.g1_mul) if group == "g1" else (hc.g2_add, hc.g2_mul)
    acc = None
    for w, p in enumerate(wins_aff):
        if p is not None:
            acc = add(acc, mul(p, 1 << (c * w)))
    return acc


@pytest.fixture(scope="module")
def g1_chunked():
    """`_multi_msm_device` on 8 G1 points (the packed path forced: c = 8) and
    K = 5 columns in 3 blocks (2, 2, 1), its Horner's input recorded; the
    window sums of the one-launch plan beside it."""
    mp = pytest.MonkeyPatch()
    try:
        N, c = 8, 8
        pts, dev = _basis("g1", N, 31)
        cols, scal = _columns(N, 32)
        table = msm._multi_msm_table(G1P, msm._cat_points(dev), c)
        one_launch = msm._multi_msm_windows(G1P, table, scal, c)
        mp.setattr(msm, "_SMALL_N", 2)
        _patch_limits(mp, N, W8, 4)
        seen, horner = [], msm._multi_horner_packed

        def spy(Gp, wins, k, cc):
            seen.append(wins.clone())
            return horner(Gp, wins, k, cc)

        mp.setattr(msm, "_multi_horner_packed", spy)
        phases = []
        out = msm._multi_msm_device("g1", dev, scal, c, on_phase=phases.append)
        return dict(pts=pts, dev=dev, cols=cols, scal=scal, c=c, one_launch=one_launch,
                    seen=seen, out=out, phases=phases, N=N)
    finally:
        mp.undo()


def test_g1_chunked_device_equals_the_one_launch_call(g1_chunked):
    """The blocked window sums equal the one-launch sums limb for limb and
    are what the Horner gets: the rest of the call is the unchunked one."""
    r = g1_chunked
    assert r["phases"] == ["table", "bucket", "horner"]
    assert len(r["seen"]) == 1 and torch.equal(r["seen"][0], r["one_launch"])
    assert r["out"][0].shape == (K, 24)


def test_g1_chunked_device_equals_host_msm_per_column(g1_chunked):
    r = g1_chunked
    assert tc.g1_to_affine_host(r["out"]) == [hc.g1_msm(r["pts"], col) for col in r["cols"]]


def test_g2_chunked_windows_equal_one_launch_and_host(monkeypatch):
    """G2, 2 blocks (3, 2): the window sums limb for limb against one launch,
    and each column's window sums, combined on the host, equal its MSM."""
    N, c = 8, 4
    W = 256 // c
    pts, dev = _basis("g2", N, 33)
    cols, scal = _columns(N, 34)
    table = msm._multi_msm_table(G2P, msm._cat_points(dev), c)
    want = msm._multi_msm_windows(G2P, table, scal, c)
    _patch_limits(monkeypatch, N, W, 5)
    assert msm.multi_msm_blocks(K, N, W) == [(0, 3), (3, 5)]
    got = msm._multi_msm_windows(G2P, table, scal, c)
    assert torch.equal(got, want)
    wins = tc.g2_to_affine_host(G2P.unpack(got))
    for k, col in enumerate(cols):
        assert _host_horner("g2", wins[k * W:(k + 1) * W], c) == hc.g2_msm(pts, col), k


def test_chunked_under_a_two_shard_mesh_equals_unsharded(monkeypatch, g1_chunked):
    """The same patch under a 2-shard CPU mesh (3 columns a shard, the
    second padded with a zero column; each shard's 3 columns in blocks 2,
    1): limb for limb the unsharded chunked result."""
    r = g1_chunked
    monkeypatch.setattr(msm, "_SMALL_N", 2)
    _patch_limits(monkeypatch, r["N"], W8, 3)
    assert msm.multi_msm_blocks(3, r["N"], W8) == [(0, 2), (2, 3)]
    got = pmesh.sharded_multi_msm(pmesh.make_mesh([CPU] * 2), "g1", r["dev"], r["scal"], r["c"])
    assert all(torch.equal(a, b) for a, b in zip(got, r["out"]))


def _sqrt_pst_run(nv: int, with_open: bool) -> dict:
    """The commit (and with `with_open` the opening) in both packages on one
    table and point, the port's multi-MSM on the packed path (its bases are
    at most 64: `_SMALL_N` patched down) with its 4 columns in 2 blocks."""
    rng = np.random.default_rng(230 + nv)
    Z = [0, 1, R - 1] + [int.from_bytes(rng.bytes(40), "little") % R for _ in range((1 << nv) - 3)]
    point = [int.from_bytes(rng.bytes(40), "little") % R for _ in range(nv)]
    m_row = nv - nv // 2
    Kc, N = _sqrt_pst_shape(nv)
    W = 256 // msm._pick_window(N)
    mp = pytest.MonkeyPatch()
    mp.setenv("TESTUDO_HOST_CURVE", "1")  # read when the profile is first built
    jprof.bls12_377.cache_clear()
    jpf = jprof.bls12_377()
    mp.setattr(jpst, "_SETUP_CACHE", {})
    mp.setattr(msm, "_SMALL_N", 2)
    _patch_limits(mp, N, W, 4)
    pf = cprof.bls12_377("cpu")
    try:
        assert msm.multi_msm_blocks(Kc, N, W) == [(0, 2), (2, 4)]
        out = dict(nv=nv)
        ck, vk = pst.setup(m_row, profile=pf)
        pl = sqrt_pst.Polynomial.from_evaluations(dense.encode_table(Z, device="cpu"), pf)
        comm, T = pl.commit(ck)
        out.update(comm=pf.g1b.to_affine(comm), T=T)
        jck, jvk = jpst.setup(m_row, profile=jpf)
        jpl = jsq.Polynomial.from_evaluations(jd.encode_table(Z), jpf)
        jcomm, jT = jpl.commit(jck)
        out.update(jcomm=list(jcomm), jT=jT)
        if with_open:
            v = pl.eval(point)
            U, pst_proof, mipp_proof = pl.open(ttr.PoseidonTranscript(ttr.fq_params()), comm, ck,
                                               point, T)
            ok = sqrt_pst.verify(ttr.PoseidonTranscript(ttr.fq_params()), vk, U, point, v,
                                 pst_proof, mipp_proof, T)
            jU, jpst_proof, jmipp_proof = jpl.open(jtr.PoseidonTranscript(jtr.fq_params()), jcomm,
                                                   jck, point, jT)
            out.update(ok=ok, U=U, jU=jU,
                       proof=proofs.ser_pst_proof(pst_proof) + proofs.ser_mipp(mipp_proof),
                       jproof=jproofs.ser_pst_proof(jpst_proof) + jproofs.ser_mipp(jmipp_proof))
        return out
    finally:
        jprof.bls12_377.cache_clear()
        mp.undo()


_PST_RUNS = {}


def _pst_run(nv: int) -> dict:
    """One run a size per test process: nv = 4 with the opening."""
    if nv not in _PST_RUNS:
        _PST_RUNS[nv] = _sqrt_pst_run(nv, with_open=nv == 4)
    return _PST_RUNS[nv]


@pytest.mark.parametrize("nv", [4, 5])
def test_sqrt_pst_chunked_commitments_and_t_equal_reference(nv):
    r = _pst_run(nv)
    assert r["comm"] == r["jcomm"] and len(r["comm"]) == 4
    assert ser.fq12_to_bytes(r["T"]) == jser.fq12_to_bytes(r["jT"])


def test_sqrt_pst_chunked_proof_bytes_equal_reference():
    """nv = 4: the opening of the chunked commitment verifies and is
    byte-equal to the JAX package's, of the codec's size."""
    r = _pst_run(4)
    assert r["ok"] is True and r["U"] == r["jU"]
    assert r["proof"] == r["jproof"]
    assert len(r["proof"]) == 176 + 48 * 2 + 1344 * 2
