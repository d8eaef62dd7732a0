"""The wide ladder (testudo_tpu_torch/csrc/ladder_wide.cu: its lanes in a
given order, each stopping after its scalar's top bit, every lane a team of
ec_team.cuh) where there is no GPU.

csrc/host_check.cpp runs the kernel's lane function
(`lane_ladder_wide_team` on the doubling and step tables) on the CPU,
position by position of the order; built here with the host C++ compiler
(skipped where there is none), it is held against the plain ladder
(`ladder_plain`) limb for limb, for G1 and G2, on the commit's scalars
(2^(8 w), K = 4 columns of W = 32 windows), random scalars and edge lanes
(scalars 0, 1, r - 1, the identity as a base), with the Horner's
longest-first order, a shuffled order and none.  Each lane runs once as a
warp of its own (its skips and its stop follow its own bits) and once as in
a warp where another lane needs every step.  The doubling's table is
checked on its own terms, and the port's `_multi_horner_packed` against the
JAX package's (tpu/msm.py:1082, slow: Pallas interpret mode).  Last, which
kernel `PackedGroup.ladder` picks on either side of its constants, and that
it takes only an order that is a permutation of its lanes.  Integers: exact
equality."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from testudo_tpu_torch.curves import host_curve as hc
from testudo_tpu_torch.device import build
from testudo_tpu_torch.device import curve as tc
from testudo_tpu_torch.device import msm as tmsm
from testudo_tpu_torch.device import packed_curve
from testudo_tpu_torch.device.field import FR
from testudo_tpu_torch.device.packed_curve import G1P, G2P
from testudo_tpu_torch.fields.bls12_377 import P, R
from testudo_tpu_torch.fields.host import Fq2

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

RNG = np.random.default_rng(131)
MAX_OPS, MAX_STAGES, SLOT_BITS = 400, 48, 10  # ec_team.cuh
LADDER_DOUBLE = 6  # ec_team.cuh TEAM_LADDER_DOUBLE
K, W, C = 4, 32, 8  # the commit's Horner at nv = 20 has K = 1,024 columns


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
    if t is None:
        return None
    assert t.dtype == torch.int32 and t.is_contiguous()
    return ctypes.c_void_p(t.data_ptr())


# -- lanes: the commit's Horner, random scalars, edges ------------------------------


def _scalars():
    """K W commit lanes (lane k W + w: 2^(8 w)), then random ones, then the
    edges 0, 1, r - 1, 2 and two lanes whose base is the identity."""
    commit = [1 << (C * (l % W)) for l in range(K * W)]
    rand = [int.from_bytes(RNG.bytes(40), "little") % R for _ in range(6)]
    edges = [0, 1, R - 1, 2, 1 << (C * (W - 1)), rand[0]]
    return commit + rand + edges


KS = _scalars()
NL = len(KS)
IDENTITY_LANES = (NL - 2, NL - 1)


def _lanes(group):
    gen, mul = (hc.g1_generator, hc.g1_mul) if group == "g1" else (hc.g2_generator, hc.g2_mul)
    pts = [mul(gen(), int(k)) for k in RNG.integers(1, 1 << 62, size=NL)]
    for l in IDENTITY_LANES:
        pts[l] = None
    Gp = G1P if group == "g1" else G2P
    from_affine = tc.g1_from_affine_host if group == "g1" else tc.g2_from_affine_host
    packed = Gp.pack(from_affine(pts, device="cpu"))
    # projective bases (Z != mont(1)), as window sums are
    for l in (3, K * W + 1):
        packed[:, l] = Gp.add2_plain(packed[:, l:l + 1].contiguous(),
                                     packed[:, l + 1:l + 2].contiguous())[:, 0]
    scal = torch.from_numpy(np.ascontiguousarray(FR.to_limbs(KS).T))
    return Gp, packed, scal


LANES = {"g1": _lanes("g1"), "g2": _lanes("g2")}


def _longest_first():
    """The Horner's order over the commit lanes (window w has 8 w + 1 bits:
    longest window first, columns in order), the other lanes behind."""
    commit = (np.arange(K)[None, :] * W + np.arange(W - 1, -1, -1)[:, None]).reshape(-1)
    return np.concatenate([commit, np.arange(K * W, NL)])


ORDERS = {
    "none": None,
    "longest_first": _longest_first(),
    "shuffled": np.random.default_rng(7).permutation(NL),
}


@pytest.fixture(scope="module")
def plain():
    """The plain ladder over every lane, all 256 bits (about 20 s for G1,
    60 s for G2 on one core)."""
    return {g: Gp.ladder_plain(pts, scal) for g, (Gp, pts, scal) in LANES.items()}


def _host_wide(host_lib, Gp, pts, scal, order, warp_of_one):
    out = torch.full_like(pts, -1)
    o = None if order is None else torch.as_tensor(order, dtype=torch.int32).contiguous()
    rc = host_lib.host_ladder_wide(_ptr(pts), _ptr(scal), _ptr(o), _ptr(out),
                                   ctypes.c_int(scal.shape[0]), ctypes.c_long(pts.shape[1]),
                                   ctypes.c_int(int(warp_of_one)), ctypes.c_int(Gp.ncomp))
    assert rc == 0
    return out


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_host_wide_ladder_equals_plain(host_lib, plain, group, order):
    """Each lane a warp of its own: every skip of an add and the stop after
    the top bit follow the lane's own scalar."""
    Gp, pts, scal = LANES[group]
    got = _host_wide(host_lib, Gp, pts, scal, ORDERS[order], True)
    assert torch.equal(got, plain[group])


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_host_wide_ladder_in_a_full_warp_equals_plain(host_lib, plain, group, order):
    """Each lane as in a warp where another lane needs every step: no skip,
    no stop before the last bit; the selects keep acc past the top bit."""
    Gp, pts, scal = LANES[group]
    got = _host_wide(host_lib, Gp, pts, scal, ORDERS[order], False)
    assert torch.equal(got, plain[group])


def test_plain_ladder_is_the_host_multiple(plain):
    """The reference itself, on the edge lanes and a commit lane."""
    Gp, pts, _ = LANES["g1"]
    lanes = [W - 1, *range(NL - 6, NL)]
    got = tc.g1_to_affine_host(Gp.unpack(plain["g1"][:, lanes].contiguous()))
    bases = tc.g1_to_affine_host(Gp.unpack(pts[:, lanes].contiguous()))
    assert got == [hc.g1_mul(b, KS[l]) if b is not None else None for b, l in zip(bases, lanes)]


def test_host_wide_ladder_rejects_a_bad_group(host_lib):
    Gp, pts, scal = LANES["g1"]
    out = torch.empty_like(pts)
    args = (_ptr(pts), _ptr(scal), None, _ptr(out), ctypes.c_int(1), ctypes.c_long(2))
    assert host_lib.host_ladder_wide(*args, 0, 3) == -1
    assert host_lib.host_ladder_wide(*args, 0, 0) == -1


# -- the doubling's table ------------------------------------------------------------


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


@pytest.mark.parametrize("ncomp", [1, 2])
def test_double_table_has_no_hazard_within_a_stage(host_lib, ncomp):
    stages, nslots, nfixed = _table(host_lib, ncomp, LADDER_DOUBLE)
    acc = range(3 * ncomp)  # the doubling never touches acc
    assert nfixed == 6 * ncomp + 3
    for mul, rows in stages:
        writes = [o for _, _, o, _, _ in rows]
        assert len(set(writes)) == len(writes)
        for i, (a, b, o, sub, sel) in enumerate(rows):
            assert max(a, b, o) < nslots and o not in acc and not sel
            assert not (mul and sub)
            others = {w for j, w in enumerate(writes) if j != i}
            assert a not in others and b not in others
    products = [len(rows) for mul, rows in stages if mul]
    # the formulas' Fq products of a doubling: 8 (G1), 3 * 8 + 1 (G2)
    assert sum(products) == (8 if ncomp == 1 else 25)
    if ncomp == 1:  # two rounds of the four products a team of WIDE_T = 4 runs side by side
        assert products == [4, 4]


@pytest.mark.parametrize("ncomp", [1, 2])
def test_double_table_read_in_python_gives_the_host_doubling(host_lib, ncomp):
    """k doublings of a point by the table in Python integers (plain field
    values), every stage's operations run LAST first."""
    stages, _, nfixed = _table(host_lib, ncomp, LADDER_DOUBLE)
    gen, mul = (hc.g1_generator, hc.g1_mul) if ncomp == 1 else (hc.g2_generator, hc.g2_mul)
    pt = mul(gen(), 0xBEEF)
    comps = lambda v: [v] if ncomp == 1 else [v.c0, v.c1]
    one = [1] if ncomp == 1 else [1, 0]
    slots = {i: 0 for i in range(nfixed)}
    for i, v in enumerate([0] * ncomp + one + [0] * ncomp + comps(pt[0]) + comps(pt[1]) + one):
        slots[i] = v
    slots[6 * ncomp + 1] = int(tc._B3_K) if ncomp == 2 else 0
    for _ in range(5):
        for is_mul, rows in stages:
            for a, b, o, sub, _ in reversed(rows):
                if is_mul:
                    slots[o] = slots[a] * slots[b] % P
                else:
                    slots[o] = (slots[a] - slots[b] if sub else slots[a] + slots[b]) % P
    base = 3 * ncomp
    if ncomp == 1:
        X, Y, Z = (slots[base + c] for c in range(3))
        zi = pow(Z, -1, P)
        got = (X * zi % P, Y * zi % P)
    else:
        X, Y, Z = (Fq2(slots[base + 2 * c], slots[base + 2 * c + 1]) for c in range(3))
        zi = Z.inv()
        got = (X * zi, Y * zi)
    assert got == mul(pt, 32)


# -- the wrapper, its constants and the Horner's order -----------------------------------


@pytest.mark.parametrize("Gp", [G1P, G2P], ids=["g1", "g2"])
def test_ladder_picks_its_kernel_by_width_and_order(Gp):
    """The team kernel up to TEAM_LADDER_MAX_LANES; above, the wide kernel
    when the lanes come in an order or number at most
    WIDE_LADDER_MAX_UNORDERED, else the one-thread kernel."""
    top = packed_curve.TEAM_LADDER_MAX_LANES[Gp.ncomp]
    wide = packed_curve.WIDE_LADDER_MAX_UNORDERED[Gp.ncomp]
    assert wide > top
    assert Gp.ladder_kernel(top) == Gp.ladder_kernel(top, True) == "ladder_team"
    for L in (top + 1, wide):
        assert Gp.ladder_kernel(L) == Gp.ladder_kernel(L, True) == "ladder_wide"
    for L in (wide + 1, 1 << 15):
        assert Gp.ladder_kernel(L) == "ladder"
        assert Gp.ladder_kernel(L, True) == "ladder_wide"
    assert {Gp._counter(k) for k in ("ladder", "ladder_team", "ladder_wide")} <= set(build.LAUNCHES)


BAD_ORDERS = {
    "short": lambda n: np.arange(n - 1),
    "long": lambda n: np.arange(n + 1),
    "repeated": lambda n: np.r_[np.arange(n - 1), 0],
    "past_the_end": lambda n: np.r_[np.arange(n - 1), n],
    "negative": lambda n: np.r_[-1, np.arange(1, n)],
    "float": lambda n: np.arange(n, dtype=np.float64),
    "2d": lambda n: np.arange(n)[None, :],
}


@pytest.mark.parametrize("bad", list(BAD_ORDERS))
def test_ladder_rejects_an_order_that_is_no_permutation(bad):
    """The wide kernel reads lane order[i] unchecked, so the wrapper takes
    only a permutation of its lanes, on the CPU as on the card."""
    Gp, pts, scal = LANES["g1"]
    with pytest.raises(ValueError, match="order"):
        Gp.ladder(pts, scal, BAD_ORDERS[bad](NL))


def test_lane_order_keeps_a_permutation():
    order = np.random.default_rng(3).permutation(NL)
    got = packed_curve.lane_order(order, NL)
    assert got.dtype == np.int32 and np.array_equal(got, order)
    assert packed_curve.lane_order(torch.arange(4, dtype=torch.int32), 4).tolist() == [0, 1, 2, 3]
    assert packed_curve.lane_order(np.zeros(0, dtype=np.int64), 0).shape == (0,)


def test_ladder_on_cpu_takes_the_plain_version_whatever_the_order():
    """One limb row of scalars keeps the plain ladder short."""
    Gp, pts, scal = LANES["g1"]
    build.reset_launches()
    low = scal[:1].contiguous()
    assert torch.equal(Gp.ladder(pts, low, ORDERS["shuffled"]), Gp.ladder_plain(pts, low))
    assert all(v == 0 for v in build.LAUNCHES.values())


def test_multi_horner_passes_the_lanes_longest_first(monkeypatch):
    """`_multi_horner_packed` hands the ladder its order, built from its
    scalars: a permutation of the K W lanes along which the scalars' bit
    lengths never grow, each window's lanes in column order."""
    seen = {}

    def spy(pts, scal, order=None):
        seen["scal"], seen["order"] = scal, order
        return pts.clone()  # points, so the fold after it runs

    monkeypatch.setattr(G1P, "ladder", spy)
    wins = LANES["g1"][1][:, : 2 * 4].contiguous()  # K = 2 columns of W = 4 windows
    tmsm._multi_horner_packed(G1P, wins, 2, 3)
    order = np.asarray(seen["order"])
    assert sorted(order) == list(range(8))
    bits = [int(v).bit_length() for v in FR.from_limbs(seen["scal"].T.numpy())]
    assert [bits[i] for i in order] == sorted(bits, reverse=True)
    assert list(order[:2]) == [3, 7]


@pytest.mark.slow
def test_multi_horner_equals_the_jax_package():
    """The port's `_multi_horner_packed` (ladder in the longest-first order,
    then one fold) against the JAX package's (a `step` launch a bit, then an
    `add2` a level; Pallas interpret mode on the CPU) at K = 2 columns of W
    = 32 windows, c = 8, G1: limb for limb.  Slow: about 12 minutes on one
    core, most of it the reference's ladder in interpret mode (G2 takes
    more than 40)."""
    import jax.numpy as jnp
    from testudo_tpu.tpu import msm as jmsm

    group = "g1"
    Gp, pts, _ = LANES[group]
    K_ = 2
    wins = pts[:, : K_ * W].contiguous()
    got = tmsm._multi_horner_packed(Gp, wins, K_, C)
    jwins = jnp.asarray(wins.numpy().astype(np.uint32).reshape(Gp.rows, K_, W))
    want = jmsm._multi_horner_packed(group, jwins, C)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int32))
