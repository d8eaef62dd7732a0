"""The CUDA sources' arithmetic where there is no GPU.

testudo_tpu_torch/csrc/fp.cuh, fp2.cuh and ec.cuh also compile as plain C++;
csrc/host_check.cpp loops the kernels' per-lane bodies over the lanes on the
CPU, for G1 (ncomp 1) and G2 (ncomp 2).  Built here with the host C++
compiler (skipped where there is none), each body is held against the plain
PyTorch version of its kernel: exact equality.  The constant tables of fp.cuh
and fp2.cuh are checked against the fields and curve modules, and the build
module's source list against the directory."""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from testudo_tpu_torch.curves import host_curve as hc
from testudo_tpu_torch.device import build, packed_field
from testudo_tpu_torch.device import curve as tc
from testudo_tpu_torch.device.curve_generic import FQ761
from testudo_tpu_torch.device.field import FQ, FR, FR381
from testudo_tpu_torch.device.packed_curve import G1P, G2P, longest_first
from testudo_tpu_torch.fields.bls12_377 import P, R

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

RNG = np.random.default_rng(71)


def _words(name: str, header: str = "fp.cuh"):
    text = (build.CSRC / header).read_text()
    body = re.search(rf"{name}\[\d+\] = \{{(.*?)\}};", text, re.S).group(1)
    return [int(w.strip().rstrip("u"), 16) for w in body.split(",")]


def _value(words):
    return sum(w << (32 * i) for i, w in enumerate(words))


def test_constant_tables_match_the_fields_module():
    assert _value(_words("FQ_P")) == P and len(_words("FQ_P")) == 12
    assert _value(_words("FR_P")) == R and len(_words("FR_P")) == 8
    assert _value(_words("FQ_ONE")) == (1 << 384) % P == FQ.r_mod_p
    assert _value(_words("FQ761_P")) == FQ761.modulus and len(_words("FQ761_P")) == 24
    assert _value(_words("FR381_P")) == FR381.modulus and len(_words("FR381_P")) == 8
    text = (build.CSRC / "fp.cuh").read_text()
    invs = [int(v, 16) for v in re.findall(r"INV = (0x[0-9a-f]+)u", text)]
    assert invs == [(-pow(q, -1, 1 << 32)) % (1 << 32)
                    for q in (P, R, FQ761.modulus, FR381.modulus)]
    assert invs[2] == 0x8FA798DD  # q761 is not 1 mod 2^32: its INV is no all-ones word


def test_b3k_table_matches_the_curve_constant():
    """FQ_B3K is the Montgomery form of (3 b2).c1 = -3/5 mod p."""
    k = _value(_words("FQ_B3K", "fp2.cuh"))
    assert len(_words("FQ_B3K", "fp2.cuh")) == 12
    assert k == FQ.to_mont_int((3 * hc.B2.c1) % P) == G2P.b3_k
    assert (hc.B2.c0, (5 * hc.B2.c1 + 1) % P) == (0, 0)  # b2 = -u/5
    assert (-5 * FQ.from_mont_int(k)) % P == 3  # b3 (a0 + a1 u) = (3 a1, k a0)


def test_source_hash_covers_every_header(tmp_path, monkeypatch):
    """An edit to any source or header changes the build directory, so a
    stale library is never loaded."""
    base = build._source_hash()
    for name in (*build.SOURCES, *build.HEADERS):
        copy = tmp_path / name
        copy.mkdir()
        for other in (*build.SOURCES, *build.HEADERS):
            text = (build.CSRC / other).read_text()
            (copy / other).write_text(text + "\n// edited\n" if other == name else text)
        monkeypatch.setattr(build, "CSRC", copy)
        assert build._source_hash() != base, name
        monkeypatch.undo()
    assert build._source_hash() == base


def test_build_report_names_each_kernel(tmp_path, monkeypatch):
    assert build._kernel_name("_Z8k_bucketI8Fq2CoordLb1EEvPKiS2_S2_S2_Pil") == "k_bucket<Fq2Coord, true>"
    assert build._kernel_name("_Z6k_add2I7FqCoordEvPKiS2_Pil") == "k_add2<FqCoord>"
    assert build._kernel_name("plain_c_name") == "plain_c_name"
    out = tmp_path / build._source_hash()
    out.mkdir()
    (out / "build_seconds.txt").write_text("2.5\n")
    (out / "build.log").write_text(
        "== ec_ops.cu (exit 0, 2.4 s)\n"
        "ptxas info    : Compiling entry function '_Z6k_add2I8Fq2CoordEvPKiS2_Pil' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z6k_add2I8Fq2CoordEvPKiS2_Pil\n"
        "    2112 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 253 registers, used 0 barriers, 2112 bytes cumulative stack size\n"
        "ptxas info    : Function properties for _Z6fp_mulI8FqParamsEvPjPKjS3_\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n")
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    assert build.build_report() == {"seconds": 2.5, "per_source": {"ec_ops.cu": 2.4}, "ptxas": [
        "k_add2<Fq2Coord>: 253 registers, 2112 bytes stack frame, 0 bytes spill stores, "
        "0 bytes spill loads"]}


def test_build_lists_every_source_and_sets_argtypes():
    on_disk = sorted(p.name for p in build.CSRC.iterdir())
    assert sorted(n for n in on_disk if n.endswith(".cu")) == sorted(build.SOURCES)
    assert sorted(n for n in on_disk if n.endswith(".cuh")) == sorted(build.HEADERS)
    src = "".join((build.CSRC / s).read_text() for s in build.SOURCES)
    for name, (symbol, argtypes) in (*build._SIGNATURES.items(), *build._QUERIES.items()):
        decl = re.search(rf'extern "C" int {symbol}\((.*?)\)', src, re.S).group(1)
        params = [p.strip() for p in decl.split(",")]
        assert len(params) == len(argtypes), name
        if name in build.EC_KERNELS:
            assert params[-2] == "int ncomp", name
        for p, t in zip(params, argtypes):
            want = ctypes.c_void_p if "*" in p else (ctypes.c_long if p.startswith("long") else ctypes.c_int)
            assert t is want, (name, p)
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)


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


def _points(n):
    G = hc.g1_generator()
    return [hc.g1_mul(G, int(k)) for k in RNG.integers(1, 1 << 62, size=n)]


L = 9
A_H, B_H = _points(L), _points(L)
B_H[1] = A_H[1]
B_H[2] = hc.g1_neg(A_H[2])
B_H[3] = None
A_H[4] = None
A_H[5] = None
B_H[5] = None


@pytest.fixture(scope="module")
def batches():
    a = G1P.pack(tc.g1_from_affine_host(A_H, device="cpu"))
    b = G1P.pack(tc.g1_from_affine_host(B_H, device="cpu"))
    return a, b, G1P.add2(a, b)  # the sum is projective (Z != mont(1))


@pytest.mark.parametrize("spec", [FQ, FR], ids=["fq", "fr"])
def test_device_mont_mul_equals_plain(host_lib, spec):
    p = spec.modulus
    m = 133
    va = [0, 1, p - 1, spec.r_mod_p, p - 1] + [int.from_bytes(RNG.bytes(64), "little") % p for _ in range(m - 5)]
    vb = [p - 1, p - 1, p - 1, spec.r_mod_p, 0] + [int.from_bytes(RNG.bytes(64), "little") % p for _ in range(m - 5)]
    at = torch.from_numpy(np.ascontiguousarray(spec.to_limbs(va).T))
    bt = torch.from_numpy(np.ascontiguousarray(spec.to_limbs(vb).T))
    out = torch.empty_like(at)
    rc = host_lib.host_mont_mul(_ptr(at), _ptr(bt), _ptr(out), ctypes.c_int(packed_field.field_id(spec)),
                              ctypes.c_long(m))
    assert rc == 0
    assert torch.equal(out, packed_field.mont_mul_rows_plain(spec, at, bt))


def _elements(spec, n, seed):
    p = spec.modulus
    rng = np.random.default_rng(seed)
    edge = [0, 1, p - 1, spec.r_mod_p, p - 1]
    return edge + [int.from_bytes(rng.bytes(64), "little") % p for _ in range(n - len(edge))]


@pytest.mark.parametrize("spec", [FQ, FR], ids=["fq", "fr"])
def test_device_row_major_mont_mul_equals_plain(host_lib, spec):
    """Bodies of csrc/mont_mul_rm.cu (mont_rm.cuh): the tiled form on one
    block and on one block a tile (grid 1, 2) and the narrow form (grid 0),
    two full operands and one shared second operand, a ragged length.
    tests/test_torch_mont_mul_rm.py covers the tiling in depth."""
    n = 131
    nl = ctypes.c_int(packed_field.field_id(spec))  # the field, by modulus
    a = torch.from_numpy(spec.to_limbs(_elements(spec, n, 72)))
    b = torch.from_numpy(spec.to_limbs(_elements(spec, n, 73)[::-1]).copy())
    one = b[17].clone()
    for grid in (0, 1, 2):
        out = torch.full_like(a, -1)
        rc = host_lib.host_mont_mul_rm(_ptr(a), _ptr(b), _ptr(out), nl, ctypes.c_long(n), 0,
                                       ctypes.c_long(grid))
        assert rc == 0 and torch.equal(out, packed_field.mont_mul_rm_plain(spec, a, b)), grid
        rc = host_lib.host_mont_mul_rm(_ptr(a), _ptr(one), _ptr(out), nl, ctypes.c_long(n), 1,
                                       ctypes.c_long(grid))
        assert rc == 0 and torch.equal(out, packed_field.mont_mul_rm_plain(spec, a, one)), grid
    # a < R but not < p (what _fold_wide hands the product): still canonical out
    wide = torch.from_numpy(np.full((3, spec.nlimbs), 0xFFFF, dtype=np.int32))
    out3 = torch.empty_like(wide)
    host_lib.host_mont_mul_rm(_ptr(wide), _ptr(one), _ptr(out3), nl, ctypes.c_long(3), 1,
                              ctypes.c_long(1))
    assert torch.equal(out3, packed_field.mont_mul_rm_plain(spec, wide, one))
    assert host_lib.host_mont_mul_rm(_ptr(a), _ptr(b), _ptr(out), 20, ctypes.c_long(n), 0,
                                     ctypes.c_long(1)) == -1


@pytest.mark.parametrize("spec", [FQ, FR], ids=["fq", "fr"])
def test_device_mont_chain_bodies_equal_plain(host_lib, spec):
    """Per-lane bodies of csrc/mont_chain.cu: K chained products on (n, L) and
    on (6, n, L), both variants and both formulations of the product."""
    G, L, K = packed_field.CHAIN_GROUP, 11, 5
    rows = lambda seed: torch.from_numpy(
        spec.to_limbs(_elements(spec, G * L, seed))).reshape(G, L, -1).transpose(1, 2).contiguous()
    a, b = rows(74), rows(75)
    want = packed_field.mont_mul_chain_plain(spec, a, b, K)
    nl = ctypes.c_int(packed_field.field_id(spec))  # the field, by modulus
    for wide in (0, 1):
        for inline_body in (0, 1):
            out = torch.full_like(a, -1)
            rc = host_lib.host_mont_chain_group(_ptr(a), _ptr(b), _ptr(out), nl, G, ctypes.c_long(L),
                                                K, wide, inline_body)
            assert rc == 0 and torch.equal(out, want), (wide, inline_body)
    out = torch.full_like(a[0], -1)  # the single chain is one group, wide
    rc = host_lib.host_mont_chain_group(_ptr(a[0]), _ptr(b[0]), _ptr(out), nl, 1, ctypes.c_long(L), K, 1, 1)
    assert rc == 0 and torch.equal(out, packed_field.mont_mul_chain_plain(spec, a[0], b[0], K))
    rc = host_lib.host_mont_chain_group(_ptr(a), _ptr(b), _ptr(out), nl, 2, ctypes.c_long(L), K, 0, 1)
    assert rc == -1  # the seq body is built for groups of six


def test_device_row_major_mont_mul_761_equals_plain(host_lib):
    """The 761-bit field (48 limbs) in csrc/mont_mul_rm.cu: the narrow body
    (the only form the launcher gives this field) on two full operands and
    on a shared second operand, a ragged length, edge values; the tiled form
    is refused."""
    n = 67
    nl = ctypes.c_int(packed_field.field_id(FQ761))
    a = torch.from_numpy(FQ761.to_limbs(_elements(FQ761, n, 76)))
    b = torch.from_numpy(FQ761.to_limbs(_elements(FQ761, n, 77)[::-1]).copy())
    one = b[5].clone()
    out = torch.full_like(a, -1)
    rc = host_lib.host_mont_mul_rm(_ptr(a), _ptr(b), _ptr(out), nl, ctypes.c_long(n), 0,
                                   ctypes.c_long(0))
    want = packed_field.mont_mul_rm_plain(FQ761, a, b)
    assert rc == 0 and torch.equal(out, want)
    rinv = pow(FQ761.mont_r, -1, FQ761.modulus)
    assert FQ761.from_limbs(out) == [x * y * rinv % FQ761.modulus for x, y in
                                     zip(FQ761.from_limbs(a), FQ761.from_limbs(b))]
    rc = host_lib.host_mont_mul_rm(_ptr(a), _ptr(one), _ptr(out), nl, ctypes.c_long(n), 1,
                                   ctypes.c_long(0))
    assert rc == 0 and torch.equal(out, packed_field.mont_mul_rm_plain(FQ761, a, one))
    for grid in (1, 2):
        assert host_lib.host_mont_mul_rm(_ptr(a), _ptr(b), _ptr(out), nl, ctypes.c_long(n), 0,
                                         ctypes.c_long(grid)) == -2


def test_device_mont_chain_761_equals_plain(host_lib):
    """The 761-bit chain of csrc/mont_chain.cu (its latency harness): both
    formulations of the product on (48, L); grouped chains are refused."""
    L, K = 7, 4
    a = torch.from_numpy(FQ761.to_limbs(_elements(FQ761, L, 78)).T.copy())
    b = torch.from_numpy(FQ761.to_limbs(_elements(FQ761, L, 79)).T.copy())
    want = packed_field.mont_mul_chain_plain(FQ761, a, b, K)
    nl = ctypes.c_int(packed_field.field_id(FQ761))
    for inline_body in (0, 1):
        out = torch.full_like(a, -1)
        rc = host_lib.host_mont_chain_group(_ptr(a), _ptr(b), _ptr(out), nl, 1, ctypes.c_long(L),
                                            K, 1, inline_body)
        assert rc == 0 and torch.equal(out, want), inline_body
    assert host_lib.host_mont_chain_group(_ptr(a), _ptr(b), _ptr(out), nl, 2, ctypes.c_long(L),
                                          K, 1, 1) == -1


def test_device_add2_equals_plain(host_lib, batches):
    a, b, s = batches
    out = torch.empty_like(a)
    host_lib.host_add2(_ptr(a), _ptr(b), _ptr(out), ctypes.c_long(L), 1)
    assert torch.equal(out, s)
    host_lib.host_add2(_ptr(s), _ptr(a), _ptr(out), ctypes.c_long(L), 1)
    assert torch.equal(out, G1P.add2_plain(s, a))


def test_device_step_and_scan2b_equal_plain(host_lib, batches):
    a, b, s = batches
    mask = torch.tensor([1, 0, 1, 1, 0, 1, 0, 1, 1], dtype=torch.int32)
    o1, o2 = torch.empty_like(a), torch.empty_like(a)
    host_lib.host_step(_ptr(s), _ptr(b), _ptr(mask), _ptr(o1), _ptr(o2), ctypes.c_long(L), 1)
    w1, w2 = G1P.step_plain(s, b, mask)
    assert torch.equal(o1, w1) and torch.equal(o2, w2)
    host_lib.host_scan2b(_ptr(s), _ptr(a), _ptr(b), _ptr(o1), _ptr(o2), ctypes.c_long(L), 1)
    w1, w2 = G1P.scan2b_plain(s, a, b)
    assert torch.equal(o1, w1) and torch.equal(o2, w2)


def test_device_ladder_equals_plain_and_host(host_lib, batches):
    _, _, s = batches
    ks = [0, 1, R - 1, 2, 5] + [int.from_bytes(RNG.bytes(40), "little") % R for _ in range(L - 5)]
    scal = torch.from_numpy(np.ascontiguousarray(FR.to_limbs(ks).T))
    out = torch.empty_like(s)
    host_lib.host_ladder(_ptr(s), _ptr(scal), _ptr(out), ctypes.c_int(16), ctypes.c_long(L), 1)
    assert torch.equal(out, G1P.ladder_plain(s, scal))
    aff = tc.g1_to_affine_host(G1P.unpack(s))
    assert tc.g1_to_affine_host(G1P.unpack(out)) == [hc.g1_mul(p, k) for p, k in zip(aff, ks)]


# (idx, start, count) of the bucket kernel's per-lane body.  "ragged": a
# doubling lane (the same point twice) and a count-0 lane; "edges": counts 0
# and 1, a long run, a lane that ends at the last entry of idx, the last
# entry alone and an empty lane that starts past the end.
BUCKET_CASES = {
    "ragged": ([3, 3, 1, 0, 2, 9, 8, 7, 6, 5, 4, 4], [0, 2, 5, 5, 11], [2, 3, 0, 6, 1]),
    "edges": ([int(v) for v in np.random.default_rng(76).integers(0, 10, size=40)],
              [0, 3, 1, 25, 39, 40], [0, 1, 20, 15, 1, 0]),
}
BUCKET_PARAMS = pytest.mark.parametrize(
    "mixed,case", [(0, "ragged"), (1, "ragged"), (0, "edges"), (1, "edges")],
    ids=["general", "mixed", "general-edges", "mixed-edges"])


def _host_bucket(host_lib, Gp, table, idx, start, count, mixed, perm=None):
    """host_bucket with the kernel's arguments: the lane order (longest
    first unless given) and a zeroed work counter, which must end past L."""
    L = start.shape[0]
    perm = longest_first(count) if perm is None else perm
    nxt = torch.zeros(1, dtype=torch.int32)
    out = torch.full((Gp.rows, L), -1, dtype=torch.int32)
    rc = host_lib.host_bucket(_ptr(table), _ptr(idx) if idx is not None else None, _ptr(start),
                              _ptr(count), _ptr(perm), _ptr(nxt), _ptr(out), ctypes.c_long(L),
                              ctypes.c_int(mixed), Gp.ncomp)
    assert rc == 0 and int(nxt) >= L
    return out


def _check_bucket(host_lib, Gp, pts, mixed, case):
    table = Gp.pack((tc.g1_from_affine_host if Gp is G1P else tc.g2_from_affine_host)(
        pts, device="cpu")).T.contiguous()
    idx, start, count = (torch.tensor(v, dtype=torch.int32) for v in BUCKET_CASES[case])
    out = _host_bucket(host_lib, Gp, table, idx, start, count, mixed)
    assert torch.equal(out, Gp.bucket_phase_plain(table, idx, start, count, mixed=bool(mixed)))
    # a lane's sum does not depend on when the schedule runs it
    for perm in (torch.arange(len(count), dtype=torch.int32), longest_first(count).flip(0)):
        assert torch.equal(_host_bucket(host_lib, Gp, table, idx, start, count, mixed, perm), out)
    return out


@BUCKET_PARAMS
def test_device_bucket_equals_plain(host_lib, mixed, case):
    pts = _points(10)
    out = _check_bucket(host_lib, G1P, pts, mixed, case)
    aff = tc.g1_to_affine_host(G1P.unpack(out))
    if case == "ragged":
        assert aff[0] == hc.g1_double(pts[3]) and aff[2] is None and aff[4] == pts[4]
    else:
        assert aff[0] is None and aff[5] is None and aff[1] == pts[BUCKET_CASES[case][0][3]]


def test_device_bucket_consecutive_rows_equals_plain(host_lib, batches):
    a, _, s = batches
    table = torch.cat([s, a], dim=1).T.contiguous()  # 18 projective rows
    start = torch.tensor([0, 3, 18], dtype=torch.int32)
    count = torch.tensor([3, 15, 0], dtype=torch.int32)
    out = _host_bucket(host_lib, G1P, table, None, start, count, 0)
    assert torch.equal(out, G1P.bucket_phase_plain(table, None, start, count))


# -- add_mask and scan2 (both groups) and the G2 instantiation of every body ------------


def _g2_points(n):
    G = hc.g2_generator()
    return [hc.g2_mul(G, int(k)) for k in RNG.integers(1, 1 << 62, size=n)]


@pytest.fixture(scope="module")
def batches_g2():
    """Lanes as in `batches`: P+Q, P+P, P+(-P), P+O, O+Q, O+O, P+Q..."""
    a_h, b_h = _g2_points(L), _g2_points(L)
    b_h[1] = a_h[1]
    b_h[2] = hc.g2_neg(a_h[2])
    b_h[3] = None
    a_h[4] = a_h[5] = b_h[5] = None
    a = G2P.pack(tc.g2_from_affine_host(a_h, device="cpu"))
    b = G2P.pack(tc.g2_from_affine_host(b_h, device="cpu"))
    return a, b, G2P.add2(a, b)


MASK = torch.tensor([1, 0, 1, 1, 0, 1, 0, 1, 1], dtype=torch.int32)


def _group_batches(request, group):
    Gp = G1P if group == "g1" else G2P
    return Gp, request.getfixturevalue("batches" if group == "g1" else "batches_g2")


def test_device_fp2_mul_and_mul_b3_equal_plain(host_lib):
    m = 37
    vals = [[int.from_bytes(RNG.bytes(64), "little") % P for _ in range(m)] for _ in range(4)]
    for col, edge in zip(vals, ([0, 1, P - 1], [0, P - 1, P - 1], [P - 1, 0, 1], [1, P - 1, P - 1])):
        col[:3] = edge
    a0, a1, b0, b1 = (torch.from_numpy(FQ.encode(v)) for v in vals)
    rows = lambda c0, c1: torch.cat([c0.T, c1.T], dim=0).contiguous()
    out, out_b3 = torch.empty((48, m), dtype=torch.int32), torch.empty((48, m), dtype=torch.int32)
    assert host_lib.host_fp2_mul(_ptr(rows(a0, a1)), _ptr(rows(b0, b1)), _ptr(out), _ptr(out_b3),
                                 ctypes.c_long(m)) == 0
    assert torch.equal(out, rows(*tc._fq2_mul_many([((a0, a1), (b0, b1))], tc.tf.mont_mul_plain)[0]))
    assert torch.equal(out_b3, rows(*tc._G2PlainOps.mul_b3((a0, a1))))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_device_add_mask_equals_plain(host_lib, request, group):
    Gp, (a, b, s) = _group_batches(request, group)
    out = torch.empty_like(a)
    host_lib.host_add_mask(_ptr(s), _ptr(b), _ptr(MASK), _ptr(out), ctypes.c_long(L), 0, Gp.ncomp)
    assert torch.equal(out, Gp.add_mask_plain(s, b, MASK))
    col = s[:, 6:7].contiguous()  # one projective point added to every lane
    host_lib.host_add_mask(_ptr(a), _ptr(col), _ptr(MASK), _ptr(out), ctypes.c_long(L), 1, Gp.ncomp)
    assert torch.equal(out, Gp.add_mask_plain(a, col, MASK))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_device_scan2_equals_plain(host_lib, request, group):
    Gp, (a, b, s) = _group_batches(request, group)
    o1, o2 = torch.empty_like(a), torch.empty_like(a)
    host_lib.host_scan2(_ptr(s), _ptr(a), _ptr(b), _ptr(o1), _ptr(o2), ctypes.c_long(L), Gp.ncomp)
    w1, w2 = Gp.scan2_plain(s, a, b)
    assert torch.equal(o1, w1) and torch.equal(o2, w2)


def test_device_g2_add2_step_scan2b_equal_plain(host_lib, batches_g2):
    a, b, s = batches_g2
    o1, o2 = torch.empty_like(a), torch.empty_like(a)
    host_lib.host_add2(_ptr(a), _ptr(b), _ptr(o1), ctypes.c_long(L), 2)
    assert torch.equal(o1, s)
    host_lib.host_add2(_ptr(s), _ptr(a), _ptr(o1), ctypes.c_long(L), 2)
    assert torch.equal(o1, G2P.add2_plain(s, a))
    host_lib.host_step(_ptr(s), _ptr(b), _ptr(MASK), _ptr(o1), _ptr(o2), ctypes.c_long(L), 2)
    w1, w2 = G2P.step_plain(s, b, MASK)
    assert torch.equal(o1, w1) and torch.equal(o2, w2)
    host_lib.host_scan2b(_ptr(s), _ptr(a), _ptr(b), _ptr(o1), _ptr(o2), ctypes.c_long(L), 2)
    w1, w2 = G2P.scan2b_plain(s, a, b)
    assert torch.equal(o1, w1) and torch.equal(o2, w2)


def test_device_g2_ladder_equals_plain_and_host(host_lib, batches_g2):
    """Two limb rows (32 bits) against the plain version, the full 256 bits
    against the host curve."""
    _, _, s = batches_g2
    ks = [0, 1, (1 << 32) - 1, 2, 5] + [int(k) for k in RNG.integers(1, 1 << 32, size=L - 5)]
    scal = torch.from_numpy(np.ascontiguousarray(FR.to_limbs(ks).T[:2]))
    out = torch.empty_like(s)
    host_lib.host_ladder(_ptr(s), _ptr(scal), _ptr(out), ctypes.c_int(2), ctypes.c_long(L), 2)
    assert torch.equal(out, G2P.ladder_plain(s, scal))
    ks = [0, 1, R - 1] + [int.from_bytes(RNG.bytes(40), "little") % R for _ in range(L - 3)]
    scal = torch.from_numpy(np.ascontiguousarray(FR.to_limbs(ks).T))
    host_lib.host_ladder(_ptr(s), _ptr(scal), _ptr(out), ctypes.c_int(16), ctypes.c_long(L), 2)
    aff = tc.g2_to_affine_host(G2P.unpack(s))
    assert tc.g2_to_affine_host(G2P.unpack(out)) == [hc.g2_mul(p, k) for p, k in zip(aff, ks)]


@BUCKET_PARAMS
def test_device_g2_bucket_equals_plain(host_lib, mixed, case):
    pts = _g2_points(10)
    out = _check_bucket(host_lib, G2P, pts, mixed, case)
    aff = tc.g2_to_affine_host(G2P.unpack(out))
    if case == "ragged":
        assert aff[0] == hc.g2_double(pts[3]) and aff[2] is None and aff[4] == pts[4]
    else:
        assert aff[0] is None and aff[5] is None and aff[1] == pts[BUCKET_CASES[case][0][3]]


def test_device_g2_bucket_consecutive_rows_equals_plain(host_lib, batches_g2):
    a, _, s = batches_g2
    table = torch.cat([s, a], dim=1).T.contiguous()  # 18 projective rows, identities among them
    start = torch.tensor([0, 3, 18], dtype=torch.int32)
    count = torch.tensor([3, 15, 0], dtype=torch.int32)
    out = _host_bucket(host_lib, G2P, table, None, start, count, 0)
    assert torch.equal(out, G2P.bucket_phase_plain(table, None, start, count))


def test_host_launchers_reject_an_unknown_group(host_lib, batches):
    a, b, _ = batches
    out = torch.empty_like(a)
    assert host_lib.host_add2(_ptr(a), _ptr(b), _ptr(out), ctypes.c_long(L), 3) == -1
