"""The 8-bit window fixed-base kernel (testudo_tpu_torch/csrc/fixed_base_window.cu:
the lane body `lane_fixed_base_window` in ec.cuh) and its table where there
is no GPU.

Above FIXED_TEAM_MAX_LANES lanes `fixed_base_mul_g1/g2` take the scalars 8
bits at a time: window w of a lane adds row w 256 + d of a table of affine
multiples d 2^(8 w) B (`PackedGroup.window_table`, built by the chain kernel
and a batched inversion, here their plain versions) with the complete mixed
add, and keeps the sum where d != 0.  Its projective limbs differ from the
JAX package's bit-serial `fori_loop` by design, so the plain version
(`fixed_base_window_plain`) is held against that loop and against the host
multiples in affine, at 40 lanes with scalars 0, 1, r - 1, 2^252, a lane of
all-ones limbs (every digit 0xFF) and random ones, window 5 zero in every
lane.  csrc/host_check.cpp's `host_fixed_base_window`, built with the host
C++ compiler (skipped where there is none), runs the kernel's lane body and
equals the plain version limb for limb.  The table's plain route equals the
host's d 2^(8 w) B row for row; `field.batch_inv` equals the host's
inverses; the entry point takes the window path above the threshold (the
threshold patched down) and launches nothing on the CPU; the wrappers
reject bad arguments.  Integers: exact equality."""
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
from testudo_tpu_torch.device import field as tf
from testudo_tpu_torch.device import packed_curve
from testudo_tpu_torch.device.field import FQ, FR
from testudo_tpu_torch.device.packed_curve import G1P, G2P
from testudo_tpu_torch.fields.bls12_377 import R

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

RNG = np.random.default_rng(222)
N = 40
ZERO_WINDOW = 5  # zero in every lane: the plain version skips it
GROUPS = {
    "g1": (G1P, hc.g1_generator, hc.g1_mul, hc.g1_add, tc.g1_to_affine_host, tc.fixed_base_mul_g1),
    "g2": (G2P, hc.g2_generator, hc.g2_mul, hc.g2_add, tc.g2_to_affine_host, tc.fixed_base_mul_g2),
}
CPU = torch.device("cpu")


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


def _scalars():
    """(N, 16) limbs and the scalars they stand for: 0, 1, r - 1, 2^252, all
    ones (2^256 - 1, not canonical: every digit 0xFF), random below r; the
    digit of window ZERO_WINDOW cleared in every lane."""
    ks = [0, 1, R - 1, 1 << 252] + [int.from_bytes(RNG.bytes(40), "little") % R
                                    for _ in range(N - 5)]
    limbs = np.concatenate([FR.to_limbs(ks[:4]), np.full((1, 16), 0xFFFF, np.int32),
                            FR.to_limbs(ks[4:])])
    limbs[:, ZERO_WINDOW // 2] &= ~(0xFF << (8 * (ZERO_WINDOW % 2)))
    vals = [int.from_bytes(row.astype("<u2").tobytes(), "little") for row in limbs]
    return torch.from_numpy(limbs.astype(np.int32)), vals


_CASES = {}


def _case(group):
    """(base, packed doubling table, window table, (N, 16) scalar limbs, the
    scalars, fixed_base_window_plain's (rows, N)), once per group.  The
    window table is the entry point's own (`curve.window_table`), so the
    entry-point test finds it built."""
    if group not in _CASES:
        Gp, gen, mul, *_ = GROUPS[group]
        base = mul(gen(), 0x5EED22)
        table = tc.fixed_base_table(Gp, base, 16 * FR.nlimbs, CPU)
        wtable = tc.window_table(Gp, base, 16 * FR.nlimbs, CPU)
        scal, vals = _scalars()
        _CASES[group] = (base, table, wtable, scal, vals, Gp.fixed_base_window_plain(wtable, scal))
    return _CASES[group]


# -- the table ---------------------------------------------------------------------


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_window_table_is_the_host_multiples(group):
    """Row w 256 + d of the plain route's table is the affine lift of d 2^(8 w)
    B (row w 256: 2^(8 w) B), every Z the Montgomery one: the host's table,
    row for row, built by host additions."""
    Gp, _, _, add, to_affine, _ = GROUPS[group]
    base, _, wtable, *_ = _case(group)
    assert wtable.shape == (32 * 256, Gp.rows) and wtable.dtype == torch.int32
    want, step = [], base
    for _ in range(32):
        acc = step
        want.append(step)
        for _ in range(255):
            want.append(acc)
            acc = add(acc, step)
        step = acc
    assert to_affine(Gp.unpack(wtable.T.contiguous())) == want
    one = torch.as_tensor(FQ.to_limbs(FQ.r_mod_p))
    z = Gp.unpack(wtable.T.contiguous())[2]
    z0 = z if Gp.ncomp == 1 else z[0]
    assert bool((z0 == one).all())
    if Gp.ncomp == 2:
        assert not bool(z[1].any())


@pytest.mark.parametrize("size", [1, 2, 3, 37, 64])
def test_batch_inv_is_the_host_inverse(size):
    vals = [int.from_bytes(RNG.bytes(48), "little") % (FQ.modulus - 1) + 1 for _ in range(size)]
    got = tf.batch_inv(FQ, torch.as_tensor(FQ.encode(vals)))
    assert got.dtype == torch.int32 and got.shape == (size, FQ.nlimbs)
    assert FQ.decode(got.numpy()) == [pow(v, -1, FQ.modulus) for v in vals]


def test_batch_inv_rejects_a_zero_and_bad_shapes():
    with pytest.raises(ValueError):
        tf.batch_inv(FQ, torch.as_tensor(FQ.encode([3, 0, 5])))
    with pytest.raises(ValueError):
        tf.batch_inv(FQ, torch.as_tensor(FQ.encode([3, 5]))[0])
    assert tf.batch_inv(FQ, torch.zeros((0, FQ.nlimbs), dtype=torch.int32)).shape == (0, 24)


@pytest.mark.parametrize("fault", ["rows", "cols", "ragged"])
def test_window_table_rejects_bad_tables(fault):
    table = torch.zeros((72, 256), dtype=torch.int32)
    Gp = G1P
    if fault == "rows":
        Gp = G2P
    elif fault == "cols":
        table = table[:, :8].contiguous()
    else:
        table = table[:, :40].contiguous()
    with pytest.raises(ValueError):
        Gp.window_table(table)


# -- the multiplication ------------------------------------------------------------


def _jax_affine(group, base, scal):
    """The JAX package's bit-serial `fixed_base_mul_*` on the same limbs, in
    affine."""
    limbs = jnp.asarray(scal.numpy().astype(np.uint32))
    if group == "g1":
        ref = jc.fixed_base_mul_g1(limbs, base)
        return tc.g1_to_affine_host(tuple(torch.from_numpy(np.asarray(c).astype(np.int32))
                                          for c in ref))
    ref = jc.fixed_base_mul_g2(limbs, (jhf.Fq2(base[0].c0, base[0].c1),
                                       jhf.Fq2(base[1].c0, base[1].c1)))
    return tc.g2_to_affine_host(tuple(
        tuple(torch.from_numpy(np.asarray(c).astype(np.int32)) for c in coord) for coord in ref))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_plain_equals_the_jax_package_and_the_host_in_affine(group):
    Gp, _, mul, _, to_affine, _ = GROUPS[group]
    base, _, _, scal, vals, got = _case(group)
    assert got.shape == (Gp.rows, N) and got.dtype == torch.int32
    mine = to_affine(Gp.unpack(got))
    assert mine == [mul(base, v % R) for v in vals]
    assert mine[0] is None and mine[1] == base
    assert mine == _jax_affine(group, base, scal)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_host_fixed_base_window_equals_plain(host_lib, group):
    """The kernel's lane body (no skip on the CPU build: every window runs
    its add and the select keeps the sum) gives the plain version's limbs."""
    Gp = GROUPS[group][0]
    _, _, wtable, scal, _, want = _case(group)
    out = torch.full((Gp.rows, N), -1, dtype=torch.int32)
    rc = host_lib.host_fixed_base_window(_ptr(wtable), _ptr(scal), _ptr(out), ctypes.c_long(N),
                                         scal.shape[1], Gp.ncomp)
    assert rc == 0
    assert torch.equal(out, want)


def test_host_fixed_base_window_rejects_bad_arguments(host_lib):
    wtable = torch.zeros((8192, 72), dtype=torch.int32)
    scal = torch.zeros((2, 16), dtype=torch.int32)
    out = torch.empty((72, 2), dtype=torch.int32)
    call = lambda nl, ncomp: host_lib.host_fixed_base_window(
        _ptr(wtable), _ptr(scal), _ptr(out), ctypes.c_long(2), nl, ncomp)
    assert call(16, 3) == -1 and call(16, 0) == -1  # group
    assert call(0, 1) == -3 and call(17, 1) == -3 and call(17, 2) == -3  # limbs


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_entry_point_takes_the_window_path_above_the_threshold(monkeypatch, group):
    """With the threshold patched below N, `fixed_base_mul_*` on the CPU makes
    ONE `fixed_base_window` call over the base's window table (the plain
    version: no launch), no `fixed_base` and no `add_mask` call, and gives
    the plain version's limbs; at the threshold the bit-serial path runs."""
    Gp, _, mul, _, to_affine, fixed = GROUPS[group]
    base, table, wtable, scal, vals, want = _case(group)
    monkeypatch.setitem(packed_curve.FIXED_TEAM_MAX_LANES, Gp.ncomp, N - 1)
    calls = []
    orig = Gp.fixed_base_window

    def counted(wt, sc):
        calls.append(wt is wtable)
        return orig(wt, sc)

    monkeypatch.setattr(Gp, "fixed_base_window", counted)
    monkeypatch.setattr(Gp, "fixed_base", lambda *a: pytest.fail("fixed_base called"))
    monkeypatch.setattr(Gp, "add_mask", lambda *a: pytest.fail("add_mask called"))
    build.reset_launches()
    got = fixed(scal, base, device="cpu")
    assert all(v == 0 for v in build.LAUNCHES.values())
    assert calls == [True]
    assert torch.equal(Gp.pack(got), want)
    monkeypatch.undo()
    monkeypatch.setitem(packed_curve.FIXED_TEAM_MAX_LANES, Gp.ncomp, 2)
    monkeypatch.setattr(Gp, "fixed_base_window", lambda *a: pytest.fail("window path taken"))
    small = fixed(scal[:2].contiguous(), base, device="cpu")
    assert to_affine(small) == [mul(base, v % R) for v in vals[:2]]


def test_fixed_base_above_the_threshold_runs_the_window_kernel(monkeypatch):
    """`PackedGroup.fixed_base` over a table of doublings takes the window
    path above the threshold on every device (here its plain version), over
    `window_table` of that table."""
    base, table, wtable, scal, _, want = _case("g1")
    monkeypatch.setitem(packed_curve.FIXED_TEAM_MAX_LANES, 1, N - 1)
    seen = []

    def built(t):
        seen.append(t is table)
        return wtable

    monkeypatch.setattr(G1P, "window_table", built)
    monkeypatch.setattr(G1P, "fixed_base_plain", lambda *a: pytest.fail("bit-serial path taken"))
    assert G1P.fixed_base_kernel(N) == "fixed_base_window"
    assert torch.equal(G1P.fixed_base(table, scal), want) and seen == [True]


@pytest.mark.parametrize("fault", ["scal_1d", "scal_wide", "scal_dtype", "table_rows",
                                   "table_width", "table_dtype"])
def test_fixed_base_window_rejects_bad_arguments(fault):
    wtable = torch.zeros((8192, 72), dtype=torch.int32)
    scal = torch.zeros((4, 16), dtype=torch.int32)
    Gp = G1P
    if fault == "scal_1d":
        scal = scal[0]
    elif fault == "scal_wide":
        scal = torch.zeros((4, 17), dtype=torch.int32)
    elif fault == "scal_dtype":
        scal = scal.to(torch.int64)
    elif fault == "table_rows":
        Gp = G2P
    elif fault == "table_width":
        wtable = wtable[:4096]
    else:
        wtable = wtable.to(torch.int64)
    with pytest.raises(TypeError if fault.endswith("dtype") else ValueError):
        Gp.fixed_base_window(wtable, scal)
