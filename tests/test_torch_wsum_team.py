"""The weighted-sum team kernel (testudo_tpu_torch/csrc/wsum_team.cu, its
programs in ec_team.cuh) where there is no GPU.

csrc/host_check.cpp runs the kernel's three tables (scan step, ladder step,
add) with the kernel's own lane and per-rank functions, rank after rank, on
the CPU; built here with the host C++ compiler (skipped where there is
none), it is held against `weighted_sum_plain` limb for limb, for G1 and G2,
signed (plus_one) and unsigned plans, one group of h < 32 buckets (c = 3)
and plans with groups > 1 and h = 32.  The tables are checked on their own
terms: no stage writes a slot that another operation of the same stage
reads, each program's rounds and count of products, and a Python reading
of the scan and add tables, every stage run in reverse order, gives the host
curve's sum_j (j + 1) B_j.  Then the wrapper's argument checks and CPU path,
the build report's name for the kernel, the harness's refusal to run
without a card, and, as a slow stage test, the port's `_weighted_sum_packed`
against the JAX package's (Pallas interpret mode) on the same buckets.
Integers: exact equality."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from testudo_tpu.tpu import msm as jmsm
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

RNG = np.random.default_rng(97)
MAX_OPS, MAX_STAGES, SLOT_BITS = 400, 48, 10  # ec_team.cuh
SCAN, STEP, ADD = 1, 2, 3  # ec_team.cuh: TEAM_WSUM_SCAN, _STEP, _ADD
ACC, RUN, BKT, RUN0, OPD, NPTS = 0, 1, 2, 3, 4, 5  # ec_team.cuh: WS_*
GROUPS = {
    "g1": (G1P, hc.g1_generator, hc.g1_mul, hc.g1_add, tc.g1_from_affine_host, tc.g1_to_affine_host),
    "g2": (G2P, hc.g2_generator, hc.g2_mul, hc.g2_add, tc.g2_from_affine_host, tc.g2_to_affine_host),
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


def _points(group, n):
    """n host points: random multiples of the generator, the identity at 1
    and 6, and 3 = 2 (the scan's run doubles in a group of h = 8)."""
    _, gen, mul, *_ = GROUPS[group]
    pts = [mul(gen(), int(k)) for k in RNG.integers(1, 1 << 62, size=n)]
    pts[1] = pts[6] = None
    pts[3] = pts[2]
    return pts


def _buckets(group, W, c):
    Gp, *_, from_affine, _ = GROUPS[group]
    pts = _points(group, W << c)
    return pts, Gp.pack(from_affine(pts, device="cpu"))


def _host_wsum(host_lib, Gp, buckets, W, c, plus_one):
    _, groups, _ = Gp.wsum_plan(c)
    out = torch.full((Gp.rows, W * groups), -1, dtype=torch.int32)
    rc = host_lib.host_wsum_team(_ptr(buckets), _ptr(out), W, c, int(plus_one), Gp.ncomp)
    assert rc == 0
    return out


# (W, c, plus_one): one group of h = 8 (c = 3); groups of h = 32, 2 a window
# (c = 6, one weight bit) and 4 a window (c = 7, two weight bits)
PLANS = {"c3-signed": (3, 3, True), "c3-unsigned": (3, 3, False),
         "c6-signed": (2, 6, True), "c7-unsigned": (1, 7, False)}


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_host_wsum_team_equals_plain(host_lib, group, plan):
    W, c, plus_one = PLANS[plan]
    Gp = GROUPS[group][0]
    _, buckets = _buckets(group, W, c)
    want = Gp.weighted_sum_plain(buckets, W, c, plus_one)
    assert torch.equal(_host_wsum(host_lib, Gp, buckets, W, c, plus_one), want)


def test_host_wsum_team_gives_the_host_weighted_sums(host_lib):
    """The per-group sums, folded per window, are sum_j w(j) B_j on the host
    curve (G1, c = 6: two groups a window)."""
    Gp, _, mul, add, _, to_affine = GROUPS["g1"]
    W, c = 2, 6
    pts, buckets = _buckets("g1", W, c)
    for plus_one in (True, False):
        got = to_affine(Gp.unpack(_host_wsum(host_lib, Gp, buckets, W, c, plus_one)))
        for lane, point in enumerate(got):
            w, g = divmod(lane, 2)
            want = None
            for j in range(32 * g, 32 * g + 32):
                want = add(want, mul(pts[(w << c) + j], j + plus_one))
            assert point == want, (plus_one, lane)


def test_host_wsum_team_rejects_bad_arguments(host_lib):
    _, buckets = _buckets("g1", 1, 3)
    out = torch.empty((72, 1), dtype=torch.int32)
    assert host_lib.host_wsum_team(_ptr(buckets), _ptr(out), 1, 3, 1, 3) == -1  # group
    assert host_lib.host_wsum_team(_ptr(buckets), _ptr(out), 0, 3, 1, 1) == -3  # W
    assert host_lib.host_wsum_team(_ptr(buckets), _ptr(out), 1, -1, 1, 1) == -3  # c


# -- the tables ----------------------------------------------------------------------


def _table(host_lib, ncomp, program):
    ops = np.zeros(MAX_OPS, dtype=np.uint32)
    stages = np.zeros(MAX_STAGES, dtype=np.uint32)
    dims = np.zeros(4, dtype=np.int32)
    rc = host_lib.host_team_program(ncomp, program, ops.ctypes.data_as(ctypes.c_void_p),
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


# program: (Fq products, rounds of products) for G1 and G2: a scan step is two
# complete adds, a ladder step an add and a double, the closing add one add
PRODUCTS = {SCAN: ((24, 2), (76, 3)), STEP: ((20, 2), (63, 3)), ADD: ((12, 2), (38, 3))}


@pytest.mark.parametrize("program", [SCAN, STEP, ADD], ids=["scan", "step", "add"])
@pytest.mark.parametrize("ncomp", [1, 2])
def test_wsum_tables_have_no_hazard_within_a_stage(host_lib, ncomp, program):
    stages, nslots, nfixed = _table(host_lib, ncomp, program)
    assert nfixed == 3 * ncomp * NPTS + 3
    zero, kb3, dummy = nfixed - 3, nfixed - 2, nfixed - 1
    for mul, rows in stages:
        writes = [o for _, _, o, _, _ in rows]
        assert len(set(writes)) == len(writes)  # one writer per slot
        for i, (a, b, o, sub, sel) in enumerate(rows):
            assert max(a, b, o) < nslots
            assert o not in (zero, kb3, dummy) and dummy not in (a, b)
            assert not (mul and (sub or sel))
            assert sel == (program == STEP and o < 3 * ncomp)  # only the ladder's acc selects
            others = {w for j, w in enumerate(writes) if j != i}
            assert a not in others and b not in others  # nobody else writes what I read
            if sel:  # a select reads its own slot's old value: nobody else touches it
                assert all(o not in (a2, b2) for j, (a2, b2, *_) in enumerate(rows) if j != i)
    products = [len(rows) for mul, rows in stages if mul]
    total, rounds = PRODUCTS[program][ncomp - 1]
    assert (sum(products), len(products)) == (total, rounds)


def _run_tables(programs, ncomp, slots, bit=0):
    """Run tables in Python integers (plain field values, not Montgomery) on
    `slots`, every stage's operations LAST first: a table must not depend
    on the order of its ranks."""
    for stages in programs:
        for mul, rows in stages:
            for a, b, o, sub, sel in reversed(rows):
                if mul:
                    v = slots[a] * slots[b] % P
                else:
                    v = (slots[a] - slots[b] if sub else slots[a] + slots[b]) % P
                    if sel and not bit:
                        v = slots[o]
                slots[o] = v


def _put(slots, ncomp, pt, point):
    """Host affine point (or None) into point slot pt as (X, Y, Z)."""
    comps = (lambda v: [v]) if ncomp == 1 else (lambda v: [v.c0, v.c1])
    one, zero = ([1], [0]) if ncomp == 1 else ([1, 0], [0, 0])
    xyz = zero + one + zero if point is None else comps(point[0]) + comps(point[1]) + one
    for i, v in enumerate(xyz):
        slots[3 * ncomp * pt + i] = v


def _get(slots, ncomp, pt):
    base = 3 * ncomp * pt
    if ncomp == 1:
        X, Y, Z = (slots[base + i] for i in range(3))
        if Z == 0:
            return None
        zi = pow(Z, -1, P)
        return (X * zi % P, Y * zi % P)
    X, Y, Z = (Fq2(slots[base + 2 * i], slots[base + 2 * i + 1]) for i in range(3))
    if Z.is_zero():
        return None
    zi = Z.inv()
    return (X * zi, Y * zi)


@pytest.mark.parametrize("ncomp", [1, 2])
def test_wsum_scan_table_read_in_python_gives_the_host_weighted_sum(host_lib, ncomp):
    """h scan steps from l = h - 1 down leave run = sum B_l and tot =
    sum l B_l; the add table on acc = run and opd = tot then gives
    sum_l (l + 1) B_l."""
    group = "g1" if ncomp == 1 else "g2"
    _, gen, mul, add, *_ = GROUPS[group]
    scan, _, nfixed = _table(host_lib, ncomp, SCAN)
    add_t, _, nfixed_add = _table(host_lib, ncomp, ADD)
    assert nfixed_add == nfixed
    h = 8
    pts = _points(group, h)
    slots = {i: 0 for i in range(nfixed)}
    slots[nfixed - 2] = int(tc._B3_K) if ncomp == 2 else 0
    for pt in (RUN, OPD):
        _put(slots, ncomp, pt, None)
    for l in range(h - 1, -1, -1):
        _put(slots, ncomp, BKT, pts[l])
        _run_tables([scan], ncomp, slots)
    want = None
    for j in range(h):
        want = add(want, mul(pts[j], j)) if pts[j] is not None else want
    assert _get(slots, ncomp, OPD) == want  # tot = sum_l l B_l
    for i in range(3 * ncomp):  # acc = run
        slots[3 * ncomp * ACC + i] = slots[3 * ncomp * RUN + i]
    _run_tables([add_t], ncomp, slots)
    for j in range(h):
        want = add(want, pts[j])
    assert _get(slots, ncomp, ACC) == want


# -- the wrapper ---------------------------------------------------------------------


@pytest.mark.parametrize("fault", ["shape", "window", "rows", "dtype"])
def test_weighted_sum_rejects_bad_arguments(fault):
    good = torch.zeros((72, 2 << 3), dtype=torch.int32)
    with pytest.raises(ValueError if fault != "dtype" else TypeError):
        if fault == "shape":
            G1P.weighted_sum(good[:, :-1], 2, 3)
        elif fault == "window":
            G1P.weighted_sum(good, 0, 3)
        elif fault == "rows":
            G2P.weighted_sum(good, 2, 3)
        else:
            G1P.weighted_sum(good.long(), 2, 3)


def test_weighted_sum_on_cpu_is_the_plain_version_and_launches_nothing():
    _, buckets = _buckets("g1", 2, 3)
    build.reset_launches()
    got = G1P.weighted_sum(buckets, 2, 3, True)
    assert all(v == 0 for v in build.LAUNCHES.values())
    assert torch.equal(got, G1P.weighted_sum_plain(buckets, 2, 3, True))
    assert {"wsum", "wsum_g2"} <= set(build.LAUNCHES)
    assert G1P.wsum_plan(3) == (8, 1, 1) and G1P.wsum_plan(12) == (32, 128, 12)


def test_build_report_names_the_team_kernels():
    """The build report reads the kernels' int template arguments (the team
    size of the weighted sum)."""
    assert (build._kernel_name("_Z11k_wsum_teamI8Fq2CoordLi32EEvPKiPiiibi")
            == "k_wsum_team<Fq2Coord, 32>")
    assert build._kernel_name("_Z11k_wsum_teamI7FqCoordLi16EEvPKiPiiibi") == "k_wsum_team<FqCoord, 16>"
    assert build._kernel_name("_Z8k_bucketI8Fq2CoordLb0EEvPKi") == "k_bucket<Fq2Coord, false>"


def test_wsum_tool_needs_a_card():
    """The team-size harness times the GPU: no CPU path."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the tool runs")
    from testudo_tpu_torch.tools import exp_wsum

    with pytest.raises(RuntimeError):
        exp_wsum.run("cpu")
    assert exp_wsum.main([]) == 1


# -- the stage against the JAX package -------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_weighted_sum_stage_equals_reference(group):
    """`_weighted_sum_packed` (the per-group sums, then the fold) against the
    reference's `_weighted_sum_packed` (the body of `_weighted_sum_packed_jit`,
    its kernels in Pallas interpret mode on the CPU) on the same numpy-made
    buckets, at the smallest plan with two groups a window (c = 6),
    plus_one both ways.  Slow: the reference's kernels compile for minutes
    on the CPU (G1: about eleven, at up to 15 GiB of host memory; under the
    wrapper's `jit` the compile passed 16 GiB), so the body runs without
    that `jit`, one kernel compile at a time."""
    Gp, *_ = GROUPS[group]
    W, c = 1, 6
    _, buckets = _buckets(group, W, c)
    jGp = pcu.G1P if group == "g1" else pcu.G2P
    for plus_one in (True, False):
        got = tmsm._weighted_sum_packed(Gp, buckets, W, c, plus_one)
        ref = jmsm._weighted_sum_packed(
            jGp, jnp.asarray(buckets.numpy().astype(np.uint32)), W, c, plus_one)
        assert np.array_equal(got.numpy().astype(np.int64), np.asarray(ref).astype(np.int64))
