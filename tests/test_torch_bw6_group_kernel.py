"""BW6-761's group law as one kernel (csrc/fp_group.cu) where there is no GPU.

The kernel's per-lane bodies (ec.cuh `lane_fpg_op`, `lane_fpg_chunk`,
`lane_fpg_fixed_base` over the strict policy `Fq761Coord`) compile as plain
C++ in csrc/host_check.cpp; built here with the host C++ compiler (skipped
where there is none), each is held limb for limb against the plain `FpGroup`
(device/curve_generic.py) on seeded inputs: the identity on either side,
P + P, P + (-P), Z != R mod q, chunks of 0, 1, T, T + 1 and 3T + 2 entries
(T = msm._FP_CHUNK), a digit column that is zero in every lane.  The plain
add, mixed add and double are held limb for limb against the JAX package's
`FpGroup.add` / `double` and tpu/curve.py's `_complete_add_mixed` (a few dozen
lanes: below 512 lanes its product is plain XLA on the CPU), and `msm_fp`
through the chunked bucket sums against the host MSM."""
import ctypes
import random
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from testudo_tpu.tpu import curve as jcurve
from testudo_tpu.tpu import curve_generic as jcg
from testudo_tpu_torch.curves import bw6_761 as bw
from testudo_tpu_torch.device import build, msm
from testudo_tpu_torch.device import curve_generic as cg
from testudo_tpu_torch.device.field import FQ
from testudo_tpu_torch.fields.bw6_761 import R

torch.set_num_threads(1)

CPU = torch.device("cpu")
S = cg.FQ761
Q = S.modulus
# name: (torch group, JAX group, host generator, add, mul, neg, the kernels' b)
GROUPS = {
    "g1": (cg.bw6_g1, jcg.bw6_g1, bw.g1_generator, bw.g1_add, bw.g1_mul, bw.g1_neg, -1),
    "g2": (cg.bw6_g2, jcg.bw6_g2, bw.g2_generator, bw.g2_add, bw.g2_mul, bw.g2_neg, 4),
}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """host_check.cpp built unoptimised (a quarter of -O2's compile time)."""
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler found")
    out = tmp_path_factory.mktemp("host_check_bw6") / "libhost_check.so"
    subprocess.run(
        [cxx, "-std=c++17", "-O0", "-shared", "-fPIC", "-x", "c++",
         "-I", str(build.CSRC), "-o", str(out), str(build.CSRC / "host_check.cpp")],
        check=True, capture_output=True, text=True, timeout=300,
    )
    return ctypes.CDLL(str(out))


def _ptrs(*ts):
    for t in ts:
        assert t.dtype == torch.int32 and t.is_contiguous()
    return [ctypes.c_void_p(t.data_ptr()) for t in ts]


def _out(n):
    return tuple(torch.zeros((n, 48), dtype=torch.int32) for _ in range(3))


def _same(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


def _projective(points, rng):
    """Host affine points -> projective coordinates (x z, y z, z) with a
    random z (Z != R mod q), the identity as (0 : 1 : 0)."""
    cols = ([], [], [])
    for pt in points:
        if pt is None:
            vals = (0, 1, 0)
        else:
            z = rng.randrange(2, Q)
            vals = (pt[0] * z % Q, pt[1] * z % Q, z)
        for col, v in zip(cols, vals):
            col.append(v)
    return tuple(torch.as_tensor(S.encode(c)) for c in cols)


def _stack(proj, ids):
    return tuple(torch.stack([proj[i][c] for i in ids]) for c in range(3))


def _lanes(name):
    """The identity, P, Q, -P, and P and Q again with Z != R mod q, as host
    points and as projective coordinates (P's first copy with Z = R mod q)."""
    _, _, gen, _, mul, neg, _ = GROUPS[name]
    rng = random.Random(31)
    p, q = (mul(gen(), rng.randrange(1, R)) for _ in range(2))
    pts = [None, p, q, neg(p), p, q]
    proj = list(zip(*_projective(pts, rng)))
    proj[1] = tuple(torch.as_tensor(S.encode([v])[0]) for v in (p[0], p[1], 1))
    return pts, proj


def _jax(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


def _from_jax(p):
    return tuple(torch.as_tensor(np.asarray(c).astype(np.int32)) for c in p)


def test_one_table_is_r_mod_q():
    text = (build.CSRC / "fp.cuh").read_text()
    body = text.split("FQ761_ONE[24] = {")[1].split("};")[0]
    words = [int(w.strip().rstrip("u"), 16) for w in body.split(",")]
    assert sum(w << (32 * i) for i, w in enumerate(words)) == S.r_mod_p == (1 << 768) % Q


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_elementwise_bodies_equal_the_plain_group_and_the_jax_package(host_lib, name):
    group, jgroup, _, add, _, _, b = GROUPS[name]
    G, JG = group(), jgroup()
    pts, proj = _lanes(name)
    k = len(pts)
    ia = [i for i in range(k) for _ in range(k)]  # every pair: P + P, P + (-P), O on either side
    ib = [j for _ in range(k) for j in range(k)]
    A, B = _stack(proj, ia), _stack(proj, ib)
    aff = [j for j in range(k) if pts[j] is not None]  # the mixed add's affine second points
    im = [i for i in range(k) for _ in aff]
    jm = [j for _ in range(k) for j in aff]
    Am = _stack(proj, im)
    Xm, Ym, _ = G.from_affine_host([pts[j] for j in jm], device=CPU)
    plain = {"add": G.add_plain(A, B), "mixed": G.add_mixed_plain(Am, (Xm, Ym)),
             "double": G.double_plain(A)}
    for op, (P1, P2, key) in enumerate(((A, B, "add"), (Am, (Xm, Ym, Xm), "mixed"),
                                        (A, A, "double"))):
        n = P1[0].shape[0]
        out = _out(n)
        assert host_lib.host_fp_group_op(*_ptrs(*P1, *P2, *out), ctypes.c_long(n), op, b) == 0
        assert _same(out, plain[key]), key
    assert host_lib.host_fp_group_op(*_ptrs(*A, *B, *_out(k * k)), ctypes.c_long(k * k), 0, 3) == -1
    # the plain formulas are the JAX package's, limb for limb
    assert _same(plain["add"], _from_jax(JG.add(tuple(map(_jax, A)), tuple(map(_jax, B)))))
    assert _same(plain["double"], _from_jax(JG.double(tuple(map(_jax, A)))))
    mixed = jcurve._complete_add_mixed(JG._ops, tuple(map(_jax, Am)), (_jax(Xm), _jax(Ym)))
    assert _same(plain["mixed"], _from_jax(mixed))
    # and the group's: affine results against the host curve
    assert G.to_affine_host(plain["add"]) == [add(pts[i], pts[j]) for i, j in zip(ia, ib)]
    assert G.to_affine_host(plain["mixed"]) == [add(pts[i], pts[j]) for i, j in zip(im, jm)]
    assert G.to_affine_host(plain["double"]) == [add(pts[i], pts[i]) for i in ia]


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_chunk_body_equals_the_plain_chunk_sum(host_lib, name):
    """Chunks of 0, 1, T, T + 1 and 3T + 2 entries (one lane each, longer
    than a chunk of msm_fp may be: the body takes any count), the points
    read through an index that repeats some and holds the identity."""
    group, _, gen, _, mul, neg, b = GROUPS[name]
    G = group()
    rng = random.Random(37)
    base = [mul(gen(), rng.randrange(1, R)) for _ in range(5)]
    pts = _projective(base + [None, neg(base[0])], rng)
    T = msm._FP_CHUNK
    counts = [0, 1, T, T + 1, 3 * T + 2]
    idx = torch.as_tensor([rng.randrange(7) for _ in range(sum(counts))], dtype=torch.int32)
    count = torch.as_tensor(counts, dtype=torch.int32)
    start = torch.cumsum(count, 0, dtype=torch.int32) - count
    want = G.chunk_sums_plain(pts, idx, start, count)
    out = _out(len(counts))
    assert host_lib.host_fp_chunk_sums(*_ptrs(*pts, idx, start, count, *out),
                                       ctypes.c_long(len(counts)), b) == 0
    assert _same(out, want)
    assert G.to_affine_host(want)[0] is None
    assert _same(G.chunk_sums(pts, idx, start, count), want)  # CPU tensors: the plain version


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_fixed_base_body_equals_the_plain_version(host_lib, name):
    """Three-limb scalars (six 8-bit windows) with limb 1 zero in every lane
    (windows 2 and 3: the plain version skips them, the body selects), 0, 1,
    a digit 0 in some lanes only, and random ones."""
    group, _, gen, add, mul, _, b = GROUPS[name]
    G = group()
    rng = np.random.default_rng(41)
    scal = rng.integers(0, 1 << 16, size=(9, 3), dtype=np.int64)
    scal[:, 1] = 0
    scal[0], scal[1] = 0, (1, 0, 0)
    scal[2, 0] = 0x3400  # window 0 digit 0, window 1 not
    st = torch.as_tensor(scal.astype(np.int32))
    tx, ty = cg.fixed_base_table(G, gen(), add, 3, CPU)
    want = cg.fixed_base_mul_plain(G, st, tx, ty)
    out = _out(9)
    assert host_lib.host_fp_fixed_base(*_ptrs(tx, ty, st, *out), ctypes.c_long(9), 3, b) == 0
    assert _same(out, want)
    assert _same(cg.fixed_base_mul(G, st, gen(), add), want)
    ints = [sum(int(v) << (16 * i) for i, v in enumerate(row)) for row in scal]
    assert G.to_affine_host(want) == [mul(gen(), k) for k in ints]


def test_segment_sums_chunk_runs_and_halve_them(monkeypatch):
    """`_segment_sums` on runs of 0, 1, T, T + 1 and 3T + 2 entries with a
    small T: chunk sums, then pairwise levels (3T + 2 is 4 chunks: two)."""
    monkeypatch.setattr(msm, "_FP_CHUNK", 3)
    T = 3
    rng = random.Random(43)
    g = bw.g1_generator()
    ks = [rng.randrange(1, R) for _ in range(6)]
    G = cg.bw6_g1()
    points = G.from_affine_host([bw.g1_mul(g, k) for k in ks], device=CPU)
    counts = [0, 1, T, T + 1, 3 * T + 2]
    idx = [rng.randrange(6) for _ in range(sum(counts))]
    got = G.to_affine_host(msm._segment_sums(G, points, torch.tensor(idx), torch.tensor(counts)))
    want, at = [], 0
    for cnt in counts:
        want.append(bw.g1_mul(g, sum(ks[i] for i in idx[at: at + cnt]) % R) if cnt else None)
        at += cnt
    assert got == want


def test_msm_fp_with_boolean_scalars_equals_the_host(monkeypatch):
    """n = 100 > 64 through the window path with boolean scalars: one run as
    long as the count of ones, cut into chunks of 8 and halved."""
    monkeypatch.setattr(msm, "_FP_CHUNK", 8)
    rng = random.Random(47)
    g = bw.g1_generator()
    ks = [rng.randrange(1, 1 << 64) for _ in range(100)]  # short host multiplications
    scl = [rng.randrange(2) for _ in range(100)]
    G = cg.bw6_g1()
    pts = G.from_affine_host([bw.g1_mul(g, k) for k in ks], device=CPU)
    got = msm.msm_fp(G, bw.g1_add, pts, torch.as_tensor(FQ.to_limbs(scl)), c=4)
    assert sum(scl) > 16
    assert got == bw.g1_mul(g, sum(k * s for k, s in zip(ks, scl)) % R)


def test_kernels_refuse_other_groups_and_fields():
    """The launchers' host checks run before any CUDA call: a group of
    another b, or of another field, raises on every device."""
    other = cg.FpGroup(S, 5)
    with pytest.raises(ValueError, match="curve constant"):
        other._kernel("bw6_add")
    with pytest.raises(ValueError):
        cg.FpGroup(FQ, 1)._kernel("bw6_add")
    assert cg.bw6_g1()._kernel("bw6_add")[1:] == (-1, "bw6_add")
    assert cg.bw6_g2()._kernel("bw6_add")[1:] == (4, "bw6_add_g2")


def test_build_report_names_the_group_law_kernels():
    """ptxas's lines of fp_group.cu name class-template arguments and
    negative ints: chip_smoke.py's rows pick their kernels' lines by name."""
    assert build._kernel_name("_Z8k_fpg_opI10Fq761CoordILin1EELi0EEvPKiS3_S3_S3_S3_S3_PiS4_S4_l") \
        == "k_fpg_op<Fq761Coord<-1>, 0>"
    assert build._kernel_name("_Z11k_fpg_chunkI10Fq761CoordILi4EEEvPKiS3_S3_S3_S3_S3_PiS4_S4_l") \
        == "k_fpg_chunk<Fq761Coord<4>>"
    assert "fp_group.cu" in build.SOURCES and "bw6_chunk_sum_g2" in build.LAUNCHES
