"""The lazy field layer (csrc/lazy.cuh) where there is no GPU.

csrc/host_check.cpp, built with the host C++ compiler (skipped where there is
none), exports the lazy Fq ops at the bound pairs the group law reaches, the
lazy and the strict complete add, mixed add and double, and the bucket body on
either reduction.  Held, all exactly (limb for limb):
  - each lazy op against Python ints: its output below its static bound times
    p, and the right residue;
  - the lazy formulas and the lazy bucket body, after `finalize`, against the
    strict host bodies, the plain PyTorch versions and the JAX package's
    tpu/curve.py formulas traced over pallas_curve.py's `_RowOpsFq` /
    `_RowOpsFq2` (plain jnp on the CPU, no pallas_call), with the identity,
    P == Q and P == -Q among the lanes, and operands anywhere below K_CARRY p;
  - a bound overflow fails to compile, and only the choke point reaches the
    lazy product.
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp
from testudo_tpu.tpu import curve as jc
from testudo_tpu.tpu import pallas_curve as jpc
from testudo_tpu.tpu import pallas_field as jpf
from testudo_tpu_torch.curves import host_curve as hc
from testudo_tpu_torch.device import build
from testudo_tpu_torch.device import curve as tc
from testudo_tpu_torch.device.packed_curve import G1P, G2P, longest_first
from testudo_tpu_torch.fields.bls12_377 import P

torch.set_num_threads(1)

R384 = 1 << 384
MASK32 = (1 << 32) - 1
RNG = np.random.default_rng(2020)
CXX = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")

# host_check.cpp's LZ_* ops and the pairs each is instantiated at (its
# LZ_*_PAIRS lists): (ka, kb), for LZ_SMUL (k, c)
ADD, SUB, SMUL, MUL, FINALIZE, HALVE, CLAMP4, CLAMP8, SELECT = range(9)
ADD_PAIRS = [(1, 1), (2, 2), (2, 4), (4, 2), (4, 4), (6, 6), (2, 12), (8, 8), (16, 16), (36, 2),
             (76, 76), (151, 1)]
SUB_PAIRS = [(2, 2), (2, 4), (2, 6), (4, 2), (2, 10), (2, 12), (2, 18), (4, 4), (6, 6), (8, 8),
             (12, 36), (4, 36), (2, 40), (112, 40)]
SMUL_PAIRS = [(1, 3), (2, 3), (4, 3), (2, 5), (6, 3), (12, 3), (10, 15)]
MUL_PAIRS = [(1, 1), (2, 2), (4, 1), (8, 2), (6, 18), (18, 6), (14, 14), (20, 8), (8, 20),
             (16, 16), (32, 4), (50, 38), (76, 2), (152, 1), (1, 152), (152, 152), (12, 1)]
ONE_BOUNDS = [1, 2, 3, 4, 6, 7, 8, 12, 14, 16, 20, 36, 40, 80, 152]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """host_check.cpp built unoptimised: a quarter of -O2's compile time, and
    these batches are small."""
    if CXX is None:
        pytest.skip("no host C++ compiler found")
    out = tmp_path_factory.mktemp("host_check_lazy") / "libhost_check.so"
    subprocess.run(
        [CXX, "-std=c++17", "-O0", "-shared", "-fPIC", "-x", "c++",
         "-I", str(build.CSRC), "-o", str(out), str(build.CSRC / "host_check.cpp")],
        check=True, capture_output=True, text=True, timeout=300,
    )
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def jax_rows():
    """The JAX package's formulas run eagerly over `_RowOpsFq` / `_RowOpsFq2`
    (plain jnp on the CPU, no pallas_call), with their Montgomery product
    `pallas_field._mont_mul_rows` jitted once per shape: the same function,
    a thirtieth of its eager time."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpc, "_mont_mul_rows", jax.jit(jpf._mont_mul_rows, static_argnums=(2, 3, 4, 5)))
        yield


def _ptr(t):
    """The tensor's data pointer: the caller keeps the tensor alive."""
    assert t.is_contiguous()
    return ctypes.c_void_p(t.data_ptr())


def _words(values):
    return torch.tensor([[(v >> (32 * i)) & MASK32 for i in range(12)] for v in values],
                        dtype=torch.int64).to(torch.int32).contiguous()


def _ints(t):
    w = t.to(torch.int64) & MASK32
    return [sum(int(x) << (32 * i) for i, x in enumerate(row)) for row in w.tolist()]


def _values(k, n, seed):
    """Edges of [0, k p) and random values in it."""
    rng = np.random.default_rng(seed)
    edge = [0, 1, P - 1, P, k * P - 1, (k - 1) * P, (k * P) // 2]
    edge = [v for v in edge if 0 <= v < k * P]
    rand = [int.from_bytes(rng.bytes(56), "little") % (k * P) for _ in range(n - len(edge))]
    return edge + rand


def _run(host_lib, op, ka, kb, a, b):
    n = len(a)
    at, bt = _words(a), _words(b)
    out = torch.zeros_like(at)
    k = host_lib.host_lazy_fq(op, ka, kb, _ptr(at), _ptr(bt), _ptr(out), ctypes.c_long(n))
    assert k > 0, (op, ka, kb)
    return k, _ints(out)


RINV = pow(R384, -1, P)


def _expect(op, ka, kb, x, y):
    if op == ADD:
        return (x + y) % P
    if op == SUB:
        return (x - y) % P
    if op == SMUL:
        return (kb * x) % P
    if op == MUL:
        return x * y * RINV % P
    if op == SELECT:
        return x % P if kb else y % P
    return x % P


def _out_bound(op, ka, kb):
    """The static bound each op's output must carry (lazy.cuh)."""
    half = lambda k: (k + 1) // 2
    if op in (ADD, SUB):
        return ka + kb
    if op == SMUL:
        return ka * kb
    if op == MUL:
        return 2
    if op == FINALIZE:
        return 1
    if op == HALVE:
        return half(ka)
    if op in (CLAMP4, CLAMP8):
        return 4 if op == CLAMP4 else 8
    return max(ka, 1)


def _check_op(host_lib, op, ka, kb, a, b):
    k, out = _run(host_lib, op, ka, kb, a, b)
    assert k == _out_bound(op, ka, kb)
    for x, y, z in zip(a, b, out):
        assert 0 <= z < k * P, (op, ka, kb, x, y)
        assert z % P == _expect(op, ka, kb, x, y), (op, ka, kb, x, y)


def test_kp_table_and_cap_constant():
    text = (build.CSRC / "lazy.cuh").read_text()
    assert int(re.search(r"#define FQ_R_OVER_P (\d+)", text).group(1)) == R384 // P == 152
    kmax = int(re.search(r"#define FQ_KP_MAX (\d+)", text).group(1))
    assert kmax == (R384 // P + 1) // 2
    body = re.search(r"FQ_KP\[FQ_KP_MAX \+ 1\]\[FQN\] = \{(.*?)\n\};", text, re.S).group(1)
    rows = re.findall(r"\{([^{}]*)\}", body)
    assert len(rows) == kmax + 1
    for m, row in enumerate(rows):
        words = [int(w.strip().rstrip("u"), 16) for w in row.split(",")]
        assert sum(w << (32 * i) for i, w in enumerate(words)) == m * P


@pytest.mark.parametrize("op,pairs", [(ADD, ADD_PAIRS), (SUB, SUB_PAIRS), (SMUL, SMUL_PAIRS),
                                      (MUL, MUL_PAIRS)], ids=["add", "sub", "smul", "mul"])
def test_lazy_fq_two_operand_ops_against_python_ints(host_lib, op, pairs):
    for ka, kb in pairs:
        a = _values(ka, 24, ka * 1000 + kb)
        b = _values(1 if op == SMUL else kb, 24, kb * 1000 + ka + 7)[::-1]
        _check_op(host_lib, op, ka, kb, a, b)


@pytest.mark.parametrize("op", [FINALIZE, HALVE, CLAMP4, CLAMP8, SELECT],
                         ids=["finalize", "halve", "clamp4", "clamp8", "select"])
def test_lazy_fq_one_operand_ops_against_python_ints(host_lib, op):
    for k in ONE_BOUNDS:
        if op == HALVE and k == 1:
            continue
        a = _values(k, 24, k)
        b = _values(1, 24, k + 3)
        for flag in ((0, 1) if op == SELECT else (0,)):
            _check_op(host_lib, op, k, flag, a, b)


def test_unlisted_pair_is_refused(host_lib):
    at = _words([1])
    out = torch.zeros_like(at)
    assert host_lib.host_lazy_fq(MUL, 3, 5, _ptr(at), _ptr(at), _ptr(out), ctypes.c_long(1)) == -1


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_lazy_fq_ops_random_values(host_lib, data):
    op, pairs = data.draw(st.sampled_from([(ADD, ADD_PAIRS), (SUB, SUB_PAIRS), (MUL, MUL_PAIRS),
                                           (SMUL, SMUL_PAIRS)]))
    ka, kb = data.draw(st.sampled_from(pairs))
    x = data.draw(st.integers(0, ka * P - 1))
    y = data.draw(st.integers(0, (1 if op == SMUL else kb) * P - 1))
    _check_op(host_lib, op, ka, kb, [x], [y])


def test_lazy_formulas_land_on_k_carry(host_lib):
    """A step's add, mixed add and double of a loop-carried point end at
    exactly K_CARRY (4 for G1, 8 for G2), as in the TPU kernels: the clamp
    of the bucket loop reduces nothing."""
    for ncomp, k in ((1, 4), (2, 8)):
        out = (ctypes.c_int * 4)()
        assert host_lib.host_lazy_bounds(ncomp, out) == 0
        assert list(out) == [k, k, k, k]


# -- the group law --------------------------------------------------------------------------

L = 9


def _group(ncomp):
    if ncomp == 1:
        return G1P, hc.g1_generator, hc.g1_mul, hc.g1_neg, tc.g1_from_affine_host
    return G2P, hc.g2_generator, hc.g2_mul, hc.g2_neg, tc.g2_from_affine_host


def _lanes(ncomp, seed, mixed):
    """First operands projective (a sum with the identity), second ones affine
    lifts.  Lanes: P + Q, P + P, P + (-P), then P + O, O + Q, O + O (the
    mixed add's second operand is never O: there P + Q, O + Q, O + Q), then
    random."""
    Gp, gen, mul, neg, from_affine = _group(ncomp)
    rng = np.random.default_rng(seed)
    a = [mul(gen(), int(k)) for k in rng.integers(1, 1 << 62, size=L)]
    b = [mul(gen(), int(k)) for k in rng.integers(1, 1 << 62, size=L)]
    b[1] = a[1]
    b[2] = neg(a[2])
    a[4] = a[5] = None
    if not mixed:
        b[3] = b[5] = None
    ident = Gp.pack(from_affine([None] * L, device="cpu"))
    pa = Gp.add2_plain(Gp.pack(from_affine(a, device="cpu")), ident)
    return pa, Gp.pack(from_affine(b, device="cpu"))


def _non_canonical(Gp, a, k, seed):
    """The same field elements with each coordinate word-vector raised by a
    random multiple of p below k p (16-bit limb rows)."""
    rng = np.random.default_rng(seed)
    n = Gp.spec.nlimbs
    out = a.clone()
    for r0 in range(0, Gp.rows, n):
        for lane in range(a.shape[1]):
            v = sum(int(a[r0 + i, lane]) << (16 * i) for i in range(n))
            v += int(rng.integers(0, k)) * P
            if v >= k * P:
                v -= P
            for i in range(n):
                out[r0 + i, lane] = (v >> (16 * i)) & 0xFFFF
    return out


def _host_ec(host_lib, op, a, b, lazy, kin_one, ncomp):
    out = torch.full_like(a, -1)
    rc = host_lib.host_ec_op(op, _ptr(a), _ptr(b), _ptr(out), ctypes.c_long(a.shape[1]),
                             lazy, kin_one, ncomp)
    assert rc == 0
    return out


def _jax_rv(Gp, a, k):
    """The packed batch as the JAX kernels' RV coordinates of bound k."""
    n = Gp.spec.nlimbs
    rows = [jnp.asarray(a[i].numpy().astype(np.uint32)) for i in range(Gp.rows)]
    rv = lambda c: jpc.RV(rows[c * n:(c + 1) * n], k)
    if Gp.ncomp == 1:
        return tuple(rv(c) for c in range(3))
    return tuple((rv(2 * c), rv(2 * c + 1)) for c in range(3))


def _jax_point(Gp, F, pt):
    """`_write_point`'s finalize of a JAX result, as a packed int32 batch."""
    rows = []
    for c in range(3):
        if Gp.ncomp == 1:
            rows += F.finalize(pt[c])
        else:
            rows += F.fq.finalize(pt[c][0]) + F.fq.finalize(pt[c][1])
    return torch.as_tensor(np.stack([np.asarray(r) for r in rows]).astype(np.int32))


def _jax_ops(Gp):
    return jpc._make_ops(Gp.spec.modulus, Gp.spec.nlimbs, Gp.ncomp, Gp.b3_k)


def _plain(Gp, op, a, b):
    A, B = Gp.unpack(a), Gp.unpack(b)
    if op == 0:
        return Gp.pack(tc._complete_add(Gp._plain, A, B))
    if op == 1:
        return Gp.pack(tc._complete_add_mixed(Gp._plain, A, (B[0], B[1])))
    return Gp.pack(tc._complete_double(Gp._plain, A))


def _jax(Gp, op, a, b, ka):
    F = _jax_ops(Gp)
    A, B = _jax_rv(Gp, a, ka), _jax_rv(Gp, b, 1)
    if op == 0:
        return _jax_point(Gp, F, jc._complete_add(F, A, B))
    if op == 1:
        return _jax_point(Gp, F, jc._complete_add_mixed(F, A, (B[0], B[1])))
    return _jax_point(Gp, F, jc._complete_double(F, A))


@pytest.mark.parametrize("ncomp", [1, 2], ids=["g1", "g2"])
@pytest.mark.parametrize("op", [0, 1, 2], ids=["add", "mixed", "double"])
def test_lazy_formulas_equal_strict_plain_and_jax(host_lib, jax_rows, ncomp, op):
    Gp = G1P if ncomp == 1 else G2P
    a, b = _lanes(ncomp, 30 + op, op == 1)
    strict = _host_ec(host_lib, op, a, b, 0, 1, ncomp)
    assert torch.equal(strict, _plain(Gp, op, a, b))
    lazy = _host_ec(host_lib, op, a, b, 1, 1, ncomp)
    assert torch.equal(lazy, strict)
    # a loop-carried first operand: any words below K_CARRY p
    k = 4 if ncomp == 1 else 8
    raised = _non_canonical(Gp, a, k, 50 + op)
    assert not torch.equal(raised, a)
    assert torch.equal(_host_ec(host_lib, op, raised, b, 1, 0, ncomp), strict)
    # the JAX formulas on both, in one batch under the bound K_CARRY
    both = _jax(Gp, op, torch.cat([a, raised], 1), torch.cat([b, b], 1), k)
    assert torch.equal(both, torch.cat([strict, strict], 1))


def test_mixed_add_doubles_and_cancels(host_lib):
    """P + P and P + (-P) through the lazy mixed add, P affine: 2P and O."""
    for ncomp in (1, 2):
        Gp, gen, mul, neg, from_affine = _group(ncomp)
        pts = [mul(gen(), 5 + i) for i in range(3)]
        a = Gp.pack(from_affine(pts, device="cpu"))
        b = Gp.pack(from_affine([pts[0], neg(pts[1]), pts[1]], device="cpu"))
        got = _host_ec(host_lib, 1, a, b, 1, 1, ncomp)
        to_affine = tc.g1_to_affine_host if ncomp == 1 else tc.g2_to_affine_host
        dbl = hc.g1_double if ncomp == 1 else hc.g2_double
        add = hc.g1_add if ncomp == 1 else hc.g2_add
        assert to_affine(Gp.unpack(got)) == [dbl(pts[0]), None, add(pts[2], pts[1])]


# -- the bucket body ------------------------------------------------------------------------


def _bucket(host_lib, Gp, table, idx, start, count, mixed, lazy=None):
    """The bucket body over the kernel's schedule: the kernel's arithmetic
    (lazy None), or the lazy (1) or strict (0) one."""
    n = start.shape[0]
    nxt = torch.zeros(1, dtype=torch.int32)
    out = torch.full((Gp.rows, n), -1, dtype=torch.int32)
    perm = longest_first(count)  # held: the call reads it
    args = (_ptr(table), _ptr(idx), _ptr(start), _ptr(count), _ptr(perm), _ptr(nxt), _ptr(out),
            ctypes.c_long(n), ctypes.c_int(mixed), Gp.ncomp)
    rc = (host_lib.host_bucket(*args) if lazy is None
          else host_lib.host_bucket_as(*args, ctypes.c_int(lazy)))
    assert rc == 0 and int(nxt) >= n
    return out


def _jax_bucket(Gp, table, idx, start, count, mixed):
    """The loop of pallas_curve.py's bucket kernel (:486-507) over the JAX
    ops, its lanes side by side: the K_CARRY-clamped identity, then at step t
    the add of each lane's row t, selected where t < count, clamped."""
    F = _jax_ops(Gp)
    n = start.shape[0]
    acc = jpc._clamp_point(F, jpc._ident_point((n,), Gp.ncomp,
                                               jpc._limbs_of(Gp.spec.r_mod_p, Gp.spec.nlimbs)))
    for t in range(int(count.max())):
        live = count > t
        pos = torch.where(live, start + t, 0)  # a masked lane adds a real row all the same
        pts = _jax_rv(Gp, table[idx[pos].long()].T.contiguous(), 1)
        s = (jc._complete_add_mixed(F, acc, (pts[0], pts[1])) if mixed
             else jc._complete_add(F, acc, pts))
        m = jnp.asarray(live.numpy())
        acc = jpc._clamp_point(F, tuple(F.select(m, s[c], acc[c]) for c in range(3)))
    return _jax_point(Gp, F, acc)


@pytest.mark.parametrize("ncomp", [1, 2], ids=["g1", "g2"])
def test_lazy_bucket_equals_strict_plain_and_jax(host_lib, jax_rows, ncomp):
    """Runs of 1..65 and of 512 (the K_CARRY clamp at every step): the lazy
    bucket body equals the strict one; on a few lanes, the plain version and
    the JAX kernel's loop, with P + (-P) + P + Q among them."""
    Gp, gen, mul, neg, from_affine = _group(ncomp)
    base = [mul(gen(), 3 + i) for i in range(40)]
    pts = base + [neg(base[0]), base[0], base[1]]
    table = Gp.pack(from_affine(pts, device="cpu")).T.contiguous()
    rng = np.random.default_rng(ncomp)
    runs = list(range(1, 66)) + [512, 0]
    idx_l, start_l, pos = [], [], 0
    for r in runs:
        start_l.append(pos)
        idx_l += [int(i) for i in rng.integers(0, len(pts), size=r)]
        pos += r
    idx_l[start_l[3]:start_l[3] + 4] = [0, 40, 41, 42]  # P + (-P) + P + Q: cancels, then doubles
    idx_l[start_l[1]:start_l[1] + 2] = [5, 5]  # P + P
    idx = torch.tensor(idx_l, dtype=torch.int32)
    start = torch.tensor(start_l, dtype=torch.int32)
    count = torch.tensor(runs, dtype=torch.int32)
    few = [0, 1, 3, len(runs) - 1]  # runs 1, 2, 4, 0
    for mixed in (1, 0):
        lazy = _bucket(host_lib, Gp, table, idx, start, count, mixed, lazy=1)
        strict = _bucket(host_lib, Gp, table, idx, start, count, mixed, lazy=0)
        assert torch.equal(lazy, strict)
        assert torch.equal(_bucket(host_lib, Gp, table, idx, start, count, mixed), lazy)
        sub_s, sub_c = start[few].contiguous(), count[few].contiguous()
        assert torch.equal(lazy[:, few], Gp.bucket_phase_plain(table, idx, sub_s, sub_c,
                                                               mixed=bool(mixed)))
        assert torch.equal(lazy[:, few], _jax_bucket(Gp, table, idx, sub_s, sub_c, mixed))


@pytest.mark.parametrize("ncomp", [1, 2], ids=["g1", "g2"])
def test_lazy_fixed_base_one_equals_strict(host_lib, ncomp):
    Gp, gen, mul, _, from_affine = _group(ncomp)
    nl, N = 2, 7
    table = Gp.pack(from_affine([mul(gen(), 1 << k) for k in range(16 * nl)], device="cpu"))
    scal = torch.tensor(RNG.integers(0, 1 << 16, size=(N, nl)), dtype=torch.int32)
    scal[0] = 0
    scal[1] = 0xFFFF
    outs = []
    for lazy in (1, 0, None):  # lazy, strict, the kernel's choice
        out = torch.full((Gp.rows, N), -1, dtype=torch.int32)
        if lazy is None:
            rc = host_lib.host_fixed_base(_ptr(table), _ptr(scal), _ptr(out), ctypes.c_long(N),
                                          nl, 1, ncomp)
        else:
            rc = host_lib.host_fixed_base_one_as(_ptr(table), _ptr(scal), _ptr(out),
                                                 ctypes.c_long(N), nl, ncomp, lazy)
        assert rc == 0
        outs.append(out)
    assert torch.equal(outs[0], outs[2])
    assert torch.equal(outs[0], outs[1])


# -- compile-time guards --------------------------------------------------------------------


def _compiles(tmp_path, body):
    src = tmp_path / "probe.cpp"
    src.write_text('#include "ec.cuh"\n' + body + "\n")
    res = subprocess.run([CXX, "-std=c++17", "-fsyntax-only", "-I", str(build.CSRC), str(src)],
                         capture_output=True, text=True, timeout=120)
    return res.returncode == 0, res.stderr


@pytest.mark.skipif(CXX is None, reason="no host C++ compiler found")
def test_bound_overflow_fails_to_compile(tmp_path):
    ok, err = _compiles(tmp_path, "LFq<152> f(const LFq<76>& a) { return lz_add(a, a); }")
    assert ok, err
    ok, err = _compiles(tmp_path, "LFq<154> f(const LFq<77>& a) { return lz_add(a, a); }")
    assert not ok and "k p < 2^384" in err
    ok, err = _compiles(tmp_path, "auto f(const LFq<76>& a) { return lz_smul<3>(a); }")
    assert not ok and "k p < 2^384" in err


@pytest.mark.skipif(CXX is None, reason="no host C++ compiler found")
def test_only_the_choke_point_reaches_the_lazy_product(tmp_path):
    """fp_mul_lazy is called from lz_mul_to and lz2_mul_core only, on
    operands that lz_cap held to the cap (lz2_mul_core's only caller,
    lz2_mul_to, caps its three pairs); no other source calls it."""
    calls = {}
    for path in sorted(build.CSRC.iterdir()):
        for line in path.read_text().splitlines():
            if "fp_mul_lazy<" in line and not line.lstrip().startswith("//"):
                calls[path.name] = calls.get(path.name, 0) + 1
    assert calls == {"lazy.cuh": 4}
    text = (build.CSRC / "lazy.cuh").read_text()
    code = [ln.strip() for ln in text.splitlines() if not ln.lstrip().startswith("//")]
    assert sum(ln.startswith("lz_cap<") for ln in code) == 6  # lz_mul_to, lz2_mul_to's three, itself
    assert sum(ln.startswith("lz2_mul_core(") for ln in code) == 1  # lz2_mul_to
    i = code.index("FP_FN void lz_mul_to(LFq<2>& r, const LFq<KA>& a, const LFq<KB>& b) {")
    assert code[i + 4].startswith("lz_cap<") and code[i + 5].startswith("fp_mul_lazy<")
    assert "if constexpr (KX * KY > FQ_R_OVER_P) {" in text
