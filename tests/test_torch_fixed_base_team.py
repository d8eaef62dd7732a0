"""The fixed-base kernels (testudo_tpu_torch/csrc/fixed_base_team.cu: the team
kernel's lane function `lane_fixed_base_team` and the masked-add program in
ec_team.cuh, the one-thread body `lane_fixed_base` in ec.cuh) where there is
no GPU.

csrc/host_check.cpp runs each kernel's lane body on the CPU (the team
kernel's table of the masked add rank after rank, and the one-thread body);
built here with the host C++ compiler (skipped where there is none), each is
held against `fixed_base_plain` (today's 256 `add_mask_plain` calls) limb for
limb, for G1 and G2, at 37 lanes with scalars 0, 1, r - 1, 2, 2^252 and
random ones.  The wrapper on the CPU is the plain version, launches nothing
and, through `fixed_base_mul_g1/g2`, gives the JAX package's limbs.  The
table is checked on its own terms (no stage writes a slot another operation
of it reads, only the sum's last sums select, 2 rounds of products for G1
and 3 for G2, and a Python reading gives the host sum or keeps the
accumulator by the bit).  Then the argument checks, the width at which the
wrapper changes kernels, and the timing tool's refusal to run without a
card.  Integers: exact equality."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from testudo_tpu.fields import host as jhf
from testudo_tpu.tpu import curve as jc
from testudo_tpu_torch.curves import host_curve as hc
from testudo_tpu_torch.device import build
from testudo_tpu_torch.device import curve as tc
from testudo_tpu_torch.device import packed_curve
from testudo_tpu_torch.device.field import FR
from testudo_tpu_torch.device.packed_curve import G1P, G2P
from testudo_tpu_torch.fields.bls12_377 import P, R
from testudo_tpu_torch.fields.host import Fq2

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

RNG = np.random.default_rng(151)
MAX_OPS, MAX_STAGES, SLOT_BITS = 400, 48, 10  # ec_team.cuh
MASKED_ADD = 5  # ec_team.cuh: TEAM_MASKED_ADD
N = 37
GROUPS = {
    "g1": (G1P, hc.g1_generator, hc.g1_mul, hc.g1_add, tc.g1_to_affine_host, tc.fixed_base_mul_g1),
    "g2": (G2P, hc.g2_generator, hc.g2_mul, hc.g2_add, tc.g2_to_affine_host, tc.fixed_base_mul_g2),
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


_CASES = {}


def _case(group):
    """(base, packed table of its 256 doublings, (N, 16) scalar limbs, the
    scalars, fixed_base_plain's (rows, N)), built once per group."""
    if group not in _CASES:
        Gp, gen, mul, *_ = GROUPS[group]
        base = mul(gen(), 0xABCDEF)
        table = tc.fixed_base_table(Gp, base, 16 * FR.nlimbs, "cpu")
        ks = [0, 1, R - 1, 2, 1 << 252] + [int.from_bytes(RNG.bytes(40), "little") % R
                                          for _ in range(N - 5)]
        scal = torch.from_numpy(FR.to_limbs(ks))
        _CASES[group] = (base, table, scal, ks, Gp.fixed_base_plain(table, scal))
    return _CASES[group]


def _host_fixed_base(host_lib, Gp, table, scal, one):
    out = torch.full((Gp.rows, scal.shape[0]), -1, dtype=torch.int32)
    rc = host_lib.host_fixed_base(_ptr(table), _ptr(scal), _ptr(out), ctypes.c_long(scal.shape[0]),
                                  scal.shape[1], one, Gp.ncomp)
    assert rc == 0
    return out


@pytest.mark.parametrize("form", ["team", "one_thread"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_host_fixed_base_equals_fixed_base_plain(host_lib, group, form):
    Gp = GROUPS[group][0]
    _, table, scal, _, want = _case(group)
    got = _host_fixed_base(host_lib, Gp, table, scal, one=int(form == "one_thread"))
    assert torch.equal(got, want)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_plain_is_the_host_multiple(group):
    Gp, _, mul, _, to_affine, _ = GROUPS[group]
    base, _, _, ks, want = _case(group)
    assert to_affine(Gp.unpack(want)) == [mul(base, k) for k in ks]


def _leaves(p):
    return [c for coord in p for c in (coord if isinstance(coord, tuple) else (coord,))]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_entry_point_on_cpu_equals_the_jax_package_and_launches_nothing(group):
    """`fixed_base_mul_*` on the CPU (the wrapper's plain version) gives the
    limbs of testudo_tpu.tpu.curve's `fori_loop` and of `fixed_base_plain`."""
    Gp, *_, fixed = GROUPS[group]
    base, _, scal, _, want = _case(group)
    build.reset_launches()
    got = fixed(scal, base, device="cpu")
    assert all(v == 0 for v in build.LAUNCHES.values())
    assert torch.equal(Gp.pack(got), want)
    limbs = jnp.asarray(scal.numpy().astype(np.uint32))
    if group == "g1":
        ref = jc.fixed_base_mul_g1(limbs, base)
    else:
        ref = jc.fixed_base_mul_g2(limbs, (jhf.Fq2(base[0].c0, base[0].c1),
                                           jhf.Fq2(base[1].c0, base[1].c1)))
    for t, j in zip(_leaves(got), _leaves(ref)):
        assert t.dtype == torch.int32 and t.shape == (N, 24)
        assert np.array_equal(t.numpy(), np.asarray(j).astype(np.int32))


def test_entry_point_makes_one_fixed_base_call(monkeypatch):
    """`_fixed_base_mul` hands the whole table and every scalar to ONE
    `fixed_base` call (on the card: one launch), never `add_mask`."""
    calls = []
    orig = G1P.fixed_base

    def counted(table, scal):
        calls.append((tuple(table.shape), tuple(scal.shape)))
        return orig(table, scal)

    monkeypatch.setattr(G1P, "fixed_base", counted)
    monkeypatch.setattr(G1P, "add_mask", lambda *a: pytest.fail("add_mask called"))
    out = tc.fixed_base_mul_g1(torch.from_numpy(FR.to_limbs([3, R - 2])), hc.g1_generator(),
                               device="cpu")
    assert calls == [((72, 256), (2, 16))]
    assert tc.g1_to_affine_host(out) == [hc.g1_mul(hc.g1_generator(), k) for k in (3, R - 2)]


@pytest.mark.parametrize("fault", ["scal_1d", "scal_wide", "table_rows", "table_cols",
                                   "table_dtype", "scal_dtype"])
def test_fixed_base_rejects_bad_arguments(fault):
    table = torch.zeros((72, 256), dtype=torch.int32)
    scal = torch.zeros((4, 16), dtype=torch.int32)
    Gp = G1P
    if fault == "scal_1d":
        scal = scal[0]
    elif fault == "scal_wide":
        scal = torch.zeros((4, 17), dtype=torch.int32)
    elif fault == "table_rows":
        Gp = G2P
    elif fault == "table_cols":
        table = table[:, :128]
    elif fault == "table_dtype":
        table = table.to(torch.int64)
    else:
        scal = scal.to(torch.int64)
    with pytest.raises(TypeError if fault.endswith("dtype") else ValueError):
        Gp.fixed_base(table, scal)


def test_host_fixed_base_rejects_bad_arguments(host_lib):
    table = torch.zeros((72, 256), dtype=torch.int32)
    scal = torch.zeros((2, 16), dtype=torch.int32)
    out = torch.empty((72, 2), dtype=torch.int32)
    call = lambda nl, ncomp, one=0: host_lib.host_fixed_base(
        _ptr(table), _ptr(scal), _ptr(out), ctypes.c_long(2), nl, one, ncomp)
    assert call(16, 3) == -1 and call(16, 3, one=1) == -1  # group
    assert call(0, 1) == -3 and call(17, 1) == -3 and call(17, 2, one=1) == -3  # limbs


def test_fixed_base_kernel_changes_at_the_measured_width():
    for Gp in (G1P, G2P):
        top = packed_curve.FIXED_TEAM_MAX_LANES[Gp.ncomp]
        assert Gp.fixed_base_kernel(2047) == "fixed_base"  # pst.setup at nv = 20
        assert Gp.fixed_base_kernel(top) == "fixed_base"
        assert Gp.fixed_base_kernel(top + 1) == "fixed_base_one"
    assert {"fixed_base", "fixed_base_g2", "fixed_base_one", "fixed_base_one_g2"} <= set(
        build.LAUNCHES)


# -- the table -----------------------------------------------------------------------


def _table(host_lib, ncomp):
    ops = np.zeros(MAX_OPS, dtype=np.uint32)
    stages = np.zeros(MAX_STAGES, dtype=np.uint32)
    dims = np.zeros(4, dtype=np.int32)
    rc = host_lib.host_team_program(ncomp, MASKED_ADD, ops.ctypes.data_as(ctypes.c_void_p),
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
def test_masked_add_table_has_no_hazard_within_a_stage(host_lib, ncomp):
    stages, nslots, nfixed = _table(host_lib, ncomp)
    assert nfixed == 3 * ncomp * 2 + 3
    zero, kb3, dummy = nfixed - 3, nfixed - 2, nfixed - 1
    selects = []
    for mul, rows in stages:
        writes = [o for _, _, o, _, _ in rows]
        assert len(set(writes)) == len(writes)  # one writer per slot
        for i, (a, b, o, sub, sel) in enumerate(rows):
            assert max(a, b, o) < nslots
            assert o not in (zero, kb3, dummy) and dummy not in (a, b)
            assert not (mul and (sub or sel))
            assert not 3 * ncomp <= o < 6 * ncomp  # the added point is never written
            others = {w for j, w in enumerate(writes) if j != i}
            assert a not in others and b not in others  # nobody else writes what I read
            if sel:
                selects.append(o)
    assert sorted(selects) == list(range(3 * ncomp))  # the sum's last sums select, once each
    products = [len(rows) for mul, rows in stages if mul]
    assert (sum(products), len(products)) == ((12, 2) if ncomp == 1 else (38, 3))


@pytest.mark.parametrize("ncomp", [1, 2])
def test_masked_add_table_read_in_python(host_lib, ncomp):
    """The table run in Python integers (plain field values), every stage's
    operations last first: with the bit set it gives the host sum of P + Q,
    P + P, P + (-P), P + O and O + Q; with the bit clear it keeps the
    accumulator."""
    group = "g1" if ncomp == 1 else "g2"
    _, gen, mul_pt, add, *_ = GROUPS[group]
    neg = hc.g1_neg if ncomp == 1 else hc.g2_neg
    stages, _, nfixed = _table(host_lib, ncomp)
    p, q = (mul_pt(gen(), int(k)) for k in RNG.integers(1, 1 << 62, size=2))
    for left, right in ((p, q), (p, p), (p, neg(p)), (p, None), (None, q)):
        for bit in (True, False):
            slots = {i: 0 for i in range(nfixed)}
            slots[nfixed - 2] = int(tc._B3_K) if ncomp == 2 else 0
            for pt, point in ((0, left), (1, right)):
                comps = (lambda v: [v]) if ncomp == 1 else (lambda v: [v.c0, v.c1])
                one, zero = ([1], [0]) if ncomp == 1 else ([1, 0], [0, 0])
                xyz = zero + one + zero if point is None else comps(point[0]) + comps(point[1]) + one
                for i, v in enumerate(xyz):
                    slots[3 * ncomp * pt + i] = v
            for mul, rows in stages:
                for a, b, o, sub, sel in reversed(rows):
                    if sel and not bit:
                        continue
                    slots[o] = (slots[a] * slots[b] if mul
                                else slots[a] - slots[b] if sub else slots[a] + slots[b]) % P
            if ncomp == 1:
                X, Y, Z = (slots[i] for i in range(3))
                got = None if Z == 0 else (X * pow(Z, -1, P) % P, Y * pow(Z, -1, P) % P)
            else:
                X, Y, Z = (Fq2(slots[2 * i], slots[2 * i + 1]) for i in range(3))
                got = None if Z.is_zero() else (X * Z.inv(), Y * Z.inv())
            assert got == (add(left, right) if bit else left)


def test_fixed_base_tool_needs_a_card():
    """The timing tool measures the GPU: no CPU path."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the tool runs")
    from testudo_tpu_torch.tools import exp_fixed_base

    with pytest.raises(RuntimeError):
        exp_fixed_base.run("cpu")
    assert exp_fixed_base.main([]) == 1
