"""The team ladder (testudo_tpu_torch/csrc/ladder_team.cu, ec_team.cuh) where
there is no GPU.

csrc/host_check.cpp runs the kernel's schedule table with the kernel's own
per-rank functions, rank after rank, on the CPU; built here with the host
C++ compiler (skipped where there is none), it is held against the plain
ladder (`ladder_plain`) limb for limb, for G1 and G2 and each kind of scalar.
The table itself is checked on its own terms: no stage writes a slot that
another operation of the same stage reads, a step has 2 rounds of products
for G1 and 3 for G2, and a Python reading of the table, with every stage's
operations run in reverse order, gives the host curve's [k] P.  Last, which
kernel `PackedGroup.ladder` picks on either side of each group's threshold.
Integers: exact equality."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

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

RNG = np.random.default_rng(81)
MAX_OPS, MAX_STAGES, SLOT_BITS = 400, 48, 10  # ec_team.cuh


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


# -- lanes: points (the identity among them) and scalars ---------------------------


def _scalars(nbits):
    """0, 1, r - 1 (or the top of nbits), 2, Horner powers 2^(13 w) below
    2^nbits, and random ones."""
    top = R - 1 if nbits >= 253 else (1 << nbits) - 1
    horner = [1 << (13 * w) for w in range(20) if 13 * w < nbits]
    rand = [int.from_bytes(RNG.bytes(40), "little") % min(R, 1 << nbits) for _ in range(3)]
    return [0, 1, top, 2] + horner[1:] + rand


def _kinds(nbits):
    """The lanes of each kind of scalar in `_scalars(nbits)`."""
    n = 4 + sum(1 for w in range(1, 20) if 13 * w < nbits)
    return {"edges": slice(0, 4), "horner": slice(4, n), "random": slice(n, n + 3)}


def _lanes(group, nbits):
    ks = _scalars(nbits)
    gen, mul = (hc.g1_generator, hc.g1_mul) if group == "g1" else (hc.g2_generator, hc.g2_mul)
    pts = [mul(gen(), int(k)) for k in RNG.integers(1, 1 << 62, size=len(ks))]
    pts[5] = None  # the identity as a base
    Gp = G1P if group == "g1" else G2P
    from_affine = tc.g1_from_affine_host if group == "g1" else tc.g2_from_affine_host
    packed = Gp.pack(from_affine(pts, device="cpu"))
    # a projective base (Z != mont(1)): the sum of two lanes
    packed[:, 6] = Gp.add2_plain(packed[:, 6:7].contiguous(), packed[:, 7:8].contiguous())[:, 0]
    scal = torch.from_numpy(np.ascontiguousarray(FR.to_limbs(ks).T[: -(-nbits // 16)]))
    return Gp, packed, scal


# G1 over all 16 limb rows; G2 over 2 (32 bits), as the one-thread ladder's tests
LANES = {"g1": _lanes("g1", 256), "g2": _lanes("g2", 32)}


@pytest.fixture(scope="module")
def plain():
    return {g: Gp.ladder_plain(pts, scal) for g, (Gp, pts, scal) in LANES.items()}


def _host_team(host_lib, Gp, pts, scal):
    out = torch.full_like(pts, -1)
    rc = host_lib.host_ladder_team(_ptr(pts), _ptr(scal), _ptr(out), ctypes.c_int(scal.shape[0]),
                                   ctypes.c_long(pts.shape[1]), Gp.ncomp)
    assert rc == 0
    return out


@pytest.mark.parametrize("kind", ["edges", "horner", "random"])
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_host_team_ladder_equals_plain(host_lib, plain, group, kind):
    Gp, pts, scal = LANES[group]
    lanes = _kinds(256 if group == "g1" else 32)[kind]
    got = _host_team(host_lib, Gp, pts[:, lanes].contiguous(), scal[:, lanes].contiguous())
    assert torch.equal(got, plain[group][:, lanes])


def test_host_team_ladder_g2_full_width_equals_one_thread_ladder(host_lib):
    """All 256 bits of G2: the team schedule against the one-thread body."""
    Gp, pts, _ = LANES["g2"]
    scal = torch.from_numpy(np.ascontiguousarray(FR.to_limbs(_scalars(256)).T))
    want = torch.empty_like(pts)
    host_lib.host_ladder(_ptr(pts), _ptr(scal), _ptr(want), ctypes.c_int(16),
                         ctypes.c_long(pts.shape[1]), 2)
    assert torch.equal(_host_team(host_lib, Gp, pts, scal), want)


def test_host_team_ladder_rejects_bad_arguments(host_lib):
    Gp, pts, scal = LANES["g1"]
    out = torch.empty_like(pts)
    args = (_ptr(pts), _ptr(scal), _ptr(out), ctypes.c_int(1), ctypes.c_long(2))
    assert host_lib.host_ladder_team(*args, 3) == -1  # group
    assert host_lib.host_ladder_team(*args, 0) == -1


# -- the table ---------------------------------------------------------------------


def _table(host_lib, ncomp):
    ops = np.zeros(MAX_OPS, dtype=np.uint32)
    stages = np.zeros(MAX_STAGES, dtype=np.uint32)
    dims = np.zeros(4, dtype=np.int32)
    rc = host_lib.host_team_table(ncomp, ops.ctypes.data_as(ctypes.c_void_p),
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
def test_team_table_has_no_hazard_within_a_stage(host_lib, ncomp):
    stages, nslots, nfixed = _table(host_lib, ncomp)
    zero, kb3, dummy = 6 * ncomp, 6 * ncomp + 1, 6 * ncomp + 2
    assert nfixed == 6 * ncomp + 3
    for mul, rows in stages:
        writes = [o for _, _, o, _, _ in rows]
        assert len(set(writes)) == len(writes)  # one writer per slot
        for i, (a, b, o, sub, sel) in enumerate(rows):
            assert max(a, b, o) < nslots
            assert o not in (zero, kb3, dummy) and dummy not in (a, b)
            assert not (mul and (sub or sel))
            others = {w for j, w in enumerate(writes) if j != i}
            assert a not in others and b not in others  # nobody else writes what I read
            if sel:  # a select reads its own slot's old value: nobody else touches it
                assert all(o not in (a2, b2) for j, (a2, b2, *_) in enumerate(rows) if j != i)
    products = [len(rows) for mul, rows in stages if mul]
    # rounds of products per step, and the formulas' count of Fq products:
    # 12 + 8 (G1), 3 (12 + 8) + 3 b3 products (G2)
    assert len(products) == (2 if ncomp == 1 else 3)
    assert sum(products) == (20 if ncomp == 1 else 63)


def _run_table(stages, nfixed, ncomp, point, k):
    """[k] point by the table in Python integers (plain field values, not
    Montgomery), every stage's operations run LAST first: the table must not
    depend on the order of its ranks."""
    kb3 = int(tc._B3_K) if ncomp == 2 else 0
    comps = lambda v: [v] if ncomp == 1 else [v.c0, v.c1]
    one = [1] if ncomp == 1 else [1, 0]
    zero = [0] * ncomp
    x, y = point
    slots = {i: 0 for i in range(nfixed)}
    for i, v in enumerate(zero + one + zero + comps(x) + comps(y) + one):
        slots[i] = v
    slots[6 * ncomp + 1] = kb3
    for bit in range(k.bit_length()):
        set_ = (k >> bit) & 1
        for mul, rows in stages:
            for a, b, o, sub, sel in reversed(rows):
                if mul:
                    v = slots[a] * slots[b] % P
                else:
                    v = (slots[a] - slots[b] if sub else slots[a] + slots[b]) % P
                    if sel and not set_:
                        v = slots[o]
                slots[o] = v
    coord = lambda c: slots[c * ncomp] if ncomp == 1 else Fq2(slots[c * 2], slots[c * 2 + 1])
    X, Y, Z = coord(0), coord(1), coord(2)
    if ncomp == 1:
        if Z == 0:
            return None
        zi = pow(Z, -1, P)
        return (X * zi % P, Y * zi % P)
    if Z.is_zero():
        return None
    zi = Z.inv()
    return (X * zi, Y * zi)


@pytest.mark.parametrize("ncomp", [1, 2])
def test_team_table_read_in_python_gives_the_host_multiple(host_lib, ncomp):
    stages, _, nfixed = _table(host_lib, ncomp)
    gen, mul = (hc.g1_generator, hc.g1_mul) if ncomp == 1 else (hc.g2_generator, hc.g2_mul)
    pt = mul(gen(), 0xC0FFEE)
    for k in (1, 2, 3, 1 << 26, int.from_bytes(RNG.bytes(8), "little")):
        assert _run_table(stages, nfixed, ncomp, pt, k) == mul(pt, k), k


# -- dispatch ------------------------------------------------------------------------


@pytest.mark.parametrize("Gp", [G1P, G2P], ids=["g1", "g2"])
def test_ladder_picks_the_team_kernel_up_to_its_threshold(Gp):
    top = packed_curve.TEAM_LADDER_MAX_LANES[Gp.ncomp]
    assert Gp.ladder_kernel(1) == Gp.ladder_kernel(top) == "ladder_team"
    assert Gp.ladder_kernel(top + 1) == "ladder_wide"
    # the launch counters of both kernels exist for the group
    assert {Gp._counter("ladder_team"), Gp._counter("ladder_wide")} <= set(build.LAUNCHES)


def test_ladder_tools_need_a_card():
    """The crossover harness and the open's ladder timer measure the GPU:
    no CPU path."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the tools run")
    from testudo_tpu_torch.tools import exp_ladder, time_open

    with pytest.raises(RuntimeError):
        exp_ladder.run("cpu")
    assert exp_ladder.main([]) == 1
    assert time_open.main() == 1
