"""The chain and fold team kernels (testudo_tpu_torch/csrc/chain_team.cu and
fold_team.cu, their lane and block functions and the pair-add program in
ec_team.cuh) where there is no GPU.

csrc/host_check.cpp runs each kernel's table of the pair add with the
kernel's own lane (`lane_chain_team`) and block (`block_fold_team`)
functions, rank after rank and, for the fold, one team a block taking every
pair of a level in turn; built here with the host C++ compiler (skipped
where there is none), it is held against `chain_plain` and `fold_plain`
(today's sequences of `add2_plain` calls) limb for limb, for G1 and G2:
bases with the identity among them, odd segments, segments of one and two
points, segments that leave columns out.  The fold is also held against
`tree_reduce`'s halving run on the JAX package's `add2` kernel body.  The
table is checked on its own terms (no stage writes a slot that another
operation of it reads, 2 rounds of products for G1 and 3 for G2, and a
Python reading with every stage run backwards gives the host sum).  Then the
wrappers: the CPU path launches nothing, the argument checks, a segment
wider than any path's, the callers in device/msm.py (one fold per call
site, an empty part still None), and the timing tool's refusal to run
without a card.  Integers: exact equality."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from testudo_tpu.tpu import curve as jc
from testudo_tpu.tpu import pallas_curve as pcu
from testudo_tpu_torch.curves import host_curve as hc
from testudo_tpu_torch.device import build
from testudo_tpu_torch.device import curve as tc
from testudo_tpu_torch.device import msm as tmsm
from testudo_tpu_torch.device.packed_curve import G1P, G2P
from testudo_tpu_torch.fields.bls12_377 import P
from testudo_tpu_torch.fields.host import Fq2

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

RNG = np.random.default_rng(131)
MAX_OPS, MAX_STAGES, SLOT_BITS = 400, 48, 10  # ec_team.cuh
PAIR_ADD = 4  # ec_team.cuh: TEAM_PAIR_ADD
GROUPS = {
    "g1": (G1P, hc.g1_generator, hc.g1_mul, hc.g1_add, hc.g1_neg, tc.g1_from_affine_host,
           tc.g1_to_affine_host),
    "g2": (G2P, hc.g2_generator, hc.g2_mul, hc.g2_add, hc.g2_neg, tc.g2_from_affine_host,
           tc.g2_to_affine_host),
}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler found")
    out = tmp_path_factory.mktemp("host_check") / "libhost_check.so"
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-x", "c++",
         "-I", str(build.CSRC), "-o", str(out), str(build.CSRC / "host_check.cpp")],
        check=True, capture_output=True, text=True, timeout=300,
    )
    return ctypes.CDLL(str(out))


def _ptr(t):
    assert t.dtype == torch.int32 and t.is_contiguous()
    return ctypes.c_void_p(t.data_ptr())


def _host_points(group, n):
    _, gen, mul, *_ = GROUPS[group]
    return [mul(gen(), int(k)) for k in RNG.integers(1, 1 << 62, size=n)]


def _batch(group, n):
    """(rows, n) projective points (Z != 1, as ladder outputs are), with the
    identity at 1, point 2 = point 0 and point 3 = -point 0: the folds meet
    P + P, P + (-P) and P + O."""
    Gp, _, _, _, neg, from_affine, _ = GROUPS[group]
    a, b = _host_points(group, n), _host_points(group, n)
    a[1] = b[1] = None
    pts = Gp.pack(from_affine(a, device="cpu"))
    out = Gp.add2_plain(pts, Gp.pack(from_affine(b, device="cpu")))
    out[:, 2] = out[:, 0]
    out[:, 3] = Gp.pack(tc.g1_neg(Gp.unpack(out[:, :1].contiguous())) if group == "g1"
                        else tc.g2_neg(Gp.unpack(out[:, :1].contiguous())))[:, 0]
    return out.contiguous()


def _host_fold(host_lib, Gp, a, seg_off, seg_len):
    """The host fold with the segments as `PackedGroup.fold` hands them to
    the kernel: no table when they are uniform."""
    S, max_len = len(seg_len), max(seg_len)
    table = torch.tensor([seg_off, seg_len], dtype=torch.int32)
    seg = None if Gp.uniform_segments(seg_off, seg_len) else _ptr(table)
    scratch = torch.full((max(1, S * 2 * ((max_len + 1) // 2) * Gp.rows),), -1, dtype=torch.int32)
    out = torch.full((Gp.rows, S), -1, dtype=torch.int32)
    rc = host_lib.host_fold_team(_ptr(a), ctypes.c_long(a.shape[1]), seg, S, max_len,
                                 _ptr(scratch), _ptr(out), Gp.ncomp)
    assert rc == 0
    return out


def _host_chain(host_lib, Gp, ptcat, B):
    out = torch.full((ptcat.shape[0] * B, Gp.rows), -1, dtype=torch.int32)
    rc = host_lib.host_chain_team(_ptr(ptcat), _ptr(out), ctypes.c_long(ptcat.shape[0]), B,
                                  Gp.ncomp)
    assert rc == 0
    return out


# segments: (offsets, lengths) over a batch of 40 points; the first two are
# uniform (the kernel takes no table), the others go as a table
SEGMENTS = {
    "odd": ([0], [13]),                               # 13 -> 7 -> 4 -> 2 -> 1
    "uniform": ([0, 8, 16, 24], [8, 8, 8, 8]),        # the MSM's folds: windows of groups
    "parts": ([0, 16, 24, 28, 30, 31], [16, 8, 4, 2, 1, 1]),  # the open's parts, one of 1
    "gaps": ([3, 30, 11, 0], [5, 10, 1, 2]),          # out of order, columns left out
}


@pytest.mark.parametrize("case", list(SEGMENTS))
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_host_fold_team_equals_fold_plain(host_lib, group, case):
    Gp = GROUPS[group][0]
    a = _batch(group, 40)
    off, ln = SEGMENTS[case]
    want = Gp.fold_plain(a, off, ln)
    assert torch.equal(_host_fold(host_lib, Gp, a, off, ln), want)
    assert torch.equal(Gp.fold(a, off, ln), want)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_host_chain_team_equals_chain_plain(host_lib, group):
    """Five bases, the identity among them, B = 6: every row limb-equal to
    the sequence of add2_plain calls, and row j B + d equal to d G_j."""
    Gp, _, mul, _, _, _, to_affine = GROUPS[group]
    B = 6
    base = _batch(group, 5)
    ptcat = base.T.contiguous()
    want = Gp.chain_plain(ptcat, B)
    assert torch.equal(_host_chain(host_lib, Gp, ptcat, B), want)
    assert torch.equal(tmsm._multi_msm_table(Gp, ptcat, 1), Gp.chain_plain(ptcat, 2))
    got = to_affine(Gp.unpack(want.T.contiguous()))
    bases = to_affine(Gp.unpack(base))
    assert got == [mul(bases[j], d) if bases[j] is not None else None
                   for j in range(5) for d in range(B)]


def test_host_team_kernels_reject_bad_arguments(host_lib):
    a = _batch("g1", 4)
    seg = torch.tensor([[0], [4]], dtype=torch.int32)
    out = torch.empty((72, 1), dtype=torch.int32)
    scratch = torch.empty(4 * 72, dtype=torch.int32)
    fold = lambda S, max_len, ncomp: host_lib.host_fold_team(
        _ptr(a), ctypes.c_long(4), _ptr(seg), S, max_len, _ptr(scratch), _ptr(out), ncomp)
    assert fold(1, 4, 3) == -1  # group
    assert fold(0, 4, 1) == -3  # no segment
    assert fold(1, 0, 1) == -3  # width
    tab = torch.empty((8, 72), dtype=torch.int32)
    chain = lambda B, ncomp: host_lib.host_chain_team(
        _ptr(a.T.contiguous()), _ptr(tab), ctypes.c_long(4), B, ncomp)
    assert chain(2, 3) == -1 and chain(0, 1) == -3 and chain((1 << 16) + 1, 1) == -3


# -- against the JAX package's add2 body ---------------------------------------------


class _Ref:
    """`add2`'s kernel body (pallas_curve.py:415-419) as a plain function:
    curve._complete_add over pallas_curve._make_ops on the packed rows."""

    def __init__(self, ncomp):
        self.ncomp = ncomp
        self.F = pcu._make_ops(P, 24, ncomp, None if ncomp == 1 else pcu._B3_K_INT)
        self.fq = self.F if ncomp == 1 else self.F.fq

    def point(self, packed):
        a = jnp.asarray(packed.astype(np.uint32))
        rv = lambda c, comp: pcu.RV([a[(c * self.ncomp + comp) * 24 + k] for k in range(24)], 1)
        if self.ncomp == 1:
            return tuple(rv(c, 0) for c in range(3))
        return tuple((rv(c, 0), rv(c, 1)) for c in range(3))

    def add2(self, a, b):
        pt = jc._complete_add(self.F, self.point(a), self.point(b))
        comps = pt if self.ncomp == 1 else [comp for coord in pt for comp in coord]
        rows = [r for comp in comps for r in self.fq.finalize(comp)]
        return np.stack([np.asarray(r) for r in rows]).astype(np.int32)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_fold_equals_halving_of_kernel_bodies(host_lib, group):
    """Each segment of the kernel's fold (host_check) against
    pallas_curve.py:717-730's halving of that segment, run on the reference's
    add2 body: odd levels carry their last point."""
    Gp = GROUPS[group][0]
    ref = _Ref(Gp.ncomp)
    a = _batch(group, 12)
    off, ln = [0, 7, 9], [7, 2, 3]
    got = _host_fold(host_lib, Gp, a, off, ln).numpy()
    for s, (o, n) in enumerate(zip(off, ln)):
        x = a[:, o:o + n].numpy()
        while x.shape[1] > 1:
            half = x.shape[1] // 2
            y = ref.add2(x[:, :half], x[:, half:2 * half])
            if x.shape[1] % 2:
                y = np.concatenate([y, x[:, -1:]], axis=1)
            x = y
        assert np.array_equal(got[:, s], x[:, 0]), s


# -- the table -----------------------------------------------------------------------


def _table(host_lib, ncomp):
    ops = np.zeros(MAX_OPS, dtype=np.uint32)
    stages = np.zeros(MAX_STAGES, dtype=np.uint32)
    dims = np.zeros(4, dtype=np.int32)
    rc = host_lib.host_team_program(ncomp, PAIR_ADD, ops.ctypes.data_as(ctypes.c_void_p),
                                    stages.ctypes.data_as(ctypes.c_void_p),
                                    dims.ctypes.data_as(ctypes.c_void_p))
    assert rc == 0
    nops, nstages, nslots, nfixed = (int(d) for d in dims)
    mask = (1 << SLOT_BITS) - 1
    out = []
    for st in stages[:nstages]:
        st = int(st)
        first, count, mul = st & 0xFFFF, (st >> 16) & 0x7FFF, st >> 31
        rows = [(int(w) & mask, (int(w) >> SLOT_BITS) & mask, (int(w) >> 2 * SLOT_BITS) & mask,
                 (int(w) >> 30) & 1, int(w) >> 31) for w in ops[first:first + count]]
        out.append((bool(mul), rows))
    assert sum(len(r) for _, r in out) == nops
    return out, nslots, nfixed


@pytest.mark.parametrize("ncomp", [1, 2])
def test_pair_add_table_has_no_hazard_within_a_stage(host_lib, ncomp):
    stages, nslots, nfixed = _table(host_lib, ncomp)
    assert nfixed == 3 * ncomp * 2 + 3
    zero, kb3, dummy = nfixed - 3, nfixed - 2, nfixed - 1
    for mul, rows in stages:
        writes = [o for _, _, o, _, _ in rows]
        assert len(set(writes)) == len(writes)  # one writer per slot
        for i, (a, b, o, sub, sel) in enumerate(rows):
            assert max(a, b, o) < nslots
            assert o not in (zero, kb3, dummy) and dummy not in (a, b)
            assert not sel and not (mul and sub)
            assert not 3 * ncomp <= o < 6 * ncomp  # the added point is never written
            others = {w for j, w in enumerate(writes) if j != i}
            assert a not in others and b not in others  # nobody else writes what I read
    products = [len(rows) for mul, rows in stages if mul]
    assert (sum(products), len(products)) == ((12, 2) if ncomp == 1 else (38, 3))


@pytest.mark.parametrize("ncomp", [1, 2])
def test_pair_add_table_read_in_python_gives_the_host_sum(host_lib, ncomp):
    """The table run in Python integers (plain field values), every stage's
    operations last first, on P + Q, P + P, P + (-P) and P + O."""
    group = "g1" if ncomp == 1 else "g2"
    *_, add, neg, _, _ = GROUPS[group]
    stages, _, nfixed = _table(host_lib, ncomp)
    p, q = _host_points(group, 2)
    for left, right in ((p, q), (p, p), (p, neg(p)), (p, None), (None, q)):
        slots = {i: 0 for i in range(nfixed)}
        slots[nfixed - 2] = int(tc._B3_K) if ncomp == 2 else 0
        for pt, point in ((0, left), (1, right)):
            comps = (lambda v: [v]) if ncomp == 1 else (lambda v: [v.c0, v.c1])
            one, zero = ([1], [0]) if ncomp == 1 else ([1, 0], [0, 0])
            xyz = zero + one + zero if point is None else comps(point[0]) + comps(point[1]) + one
            for i, v in enumerate(xyz):
                slots[3 * ncomp * pt + i] = v
        for mul, rows in stages:
            for a, b, o, sub, _ in reversed(rows):
                slots[o] = (slots[a] * slots[b] if mul
                            else slots[a] - slots[b] if sub else slots[a] + slots[b]) % P
        if ncomp == 1:
            X, Y, Z = (slots[i] for i in range(3))
            got = None if Z == 0 else (X * pow(Z, -1, P) % P, Y * pow(Z, -1, P) % P)
        else:
            X, Y, Z = (Fq2(slots[2 * i], slots[2 * i + 1]) for i in range(3))
            got = None if Z.is_zero() else (X * Z.inv(), Y * Z.inv())
        assert got == add(left, right)


# -- the wrappers and their callers ---------------------------------------------------


def test_chain_and_fold_on_cpu_are_the_plain_versions_and_launch_nothing():
    a = _batch("g1", 9)
    build.reset_launches()
    folded = G1P.fold(a, [0, 5], [5, 4])
    table = G1P.chain(a.T.contiguous(), 3)
    tree = G1P.tree_reduce(a)
    assert all(v == 0 for v in build.LAUNCHES.values())
    assert torch.equal(folded, G1P.fold_plain(a, [0, 5], [5, 4]))
    assert torch.equal(table, G1P.chain_plain(a.T.contiguous(), 3))
    assert torch.equal(tree, G1P.fold_plain(a, [0], [9]))
    assert {"chain_team", "chain_team_g2", "fold_team", "fold_team_g2"} <= set(build.LAUNCHES)


@pytest.mark.parametrize("fault", ["rows", "none", "count", "empty", "past", "before"])
def test_fold_rejects_bad_arguments(fault):
    a = torch.zeros((72, 6), dtype=torch.int32)
    off, ln = {"rows": ([0], [6]), "none": ([], []), "count": ([0, 3], [3]),
               "empty": ([0], [0]), "past": ([4], [3]), "before": ([-1], [2])}[fault]
    with pytest.raises(ValueError):
        (G2P if fault == "rows" else G1P).fold(a, off, ln)


@pytest.mark.parametrize("fault", ["rows", "layout", "B"])
def test_chain_rejects_bad_arguments(fault):
    ptcat = torch.zeros((4, 72), dtype=torch.int32)
    with pytest.raises(ValueError):
        if fault == "rows":
            G2P.chain(ptcat, 4)
        elif fault == "layout":
            G1P.chain(ptcat.T.contiguous(), 4)
        else:
            G1P.chain(ptcat, 0)


def test_host_fold_team_takes_a_segment_wider_than_the_paths_give(host_lib):
    """The fold has no width limit: a segment of `_LADDER_MAX` + 1 points
    (wider than any path's) beside one of 2, as a table and alone."""
    n = tmsm._LADDER_MAX + 1
    a = _batch("g1", 41).repeat(1, n // 41 + 1)[:, : n + 2].contiguous()
    for off, ln in (([0, n], [n, 2]), ([0], [n])):
        assert torch.equal(_host_fold(host_lib, G1P, a, off, ln), G1P.fold_plain(a, off, ln))


def test_msm_callers_fold_once_and_keep_empty_parts(monkeypatch):
    """`_ladder_parts` folds every non-empty part in one call and gives None
    for an empty one; `_multi_msm_small` folds its columns in one call."""
    calls = []
    orig = G1P.fold

    def counted(a, seg_off, seg_len):
        calls.append((list(seg_off), list(seg_len)))
        return orig(a, seg_off, seg_len)

    monkeypatch.setattr(G1P, "fold", counted)
    pts = _host_points("g1", 6)
    dev = tc.g1_from_affine_host(pts, device="cpu")
    scal = [3, 5, 7, 11, 13, 17]
    limbs = torch.as_tensor(tmsm.FR.to_limbs(scal))
    got = tmsm._ladder_parts(G1P, tc.g1_to_affine_host, dev, limbs, [(0, 4), (4, 4), (4, 6)])
    assert got == [hc.g1_msm(pts[:4], scal[:4]), None, hc.g1_msm(pts[4:], scal[4:])]
    assert calls == [([0, 4], [4, 2])]
    calls.clear()
    out = tmsm._multi_msm_small(G1P, dev, limbs.reshape(1, 6, -1).repeat(2, 1, 1))
    assert calls == [([0, 6], [6, 6])]
    assert tc.g1_to_affine_host(G1P.unpack(out)) == [hc.g1_msm(pts, scal)] * 2


def test_fold_tool_needs_a_card():
    """The timing tool measures the GPU: no CPU path."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the tool runs")
    from testudo_tpu_torch.tools import exp_fold

    with pytest.raises(RuntimeError):
        exp_fold.run("cpu")
    assert exp_fold.main([]) == 1
