"""The CUDA sources' arithmetic where there is no GPU.

testudo_tpu_torch/csrc/fp.cuh and g1.cuh also compile as plain C++;
csrc/host_check.cpp loops the kernels' per-lane bodies over the lanes on the
CPU.  Built here with the host C++ compiler (skipped where there is none),
each body is held against the plain PyTorch version of its kernel: exact
equality.  The constant tables of fp.cuh are checked against the fields
module, and the build module's source list against the directory."""
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
from testudo_tpu_torch.device.field import FQ, FR
from testudo_tpu_torch.device.packed_curve import G1P
from testudo_tpu_torch.fields.bls12_377 import P, R

RNG = np.random.default_rng(71)


def _words(name: str):
    text = (build.CSRC / "fp.cuh").read_text()
    body = re.search(rf"{name}\[\d+\] = \{{(.*?)\}};", text, re.S).group(1)
    return [int(w.strip().rstrip("u"), 16) for w in body.split(",")]


def _value(words):
    return sum(w << (32 * i) for i, w in enumerate(words))


def test_constant_tables_match_the_fields_module():
    assert _value(_words("FQ_P")) == P and len(_words("FQ_P")) == 12
    assert _value(_words("FR_P")) == R and len(_words("FR_P")) == 8
    assert _value(_words("FQ_ONE")) == (1 << 384) % P == FQ.r_mod_p
    text = (build.CSRC / "fp.cuh").read_text()
    invs = [int(v, 16) for v in re.findall(r"INV = (0x[0-9a-f]+)u", text)]
    assert invs == [(-pow(P, -1, 1 << 32)) % (1 << 32), (-pow(R, -1, 1 << 32)) % (1 << 32)]


def test_build_lists_every_source_and_sets_argtypes():
    on_disk = sorted(p.name for p in build.CSRC.iterdir())
    assert sorted(n for n in on_disk if n.endswith(".cu")) == sorted(build.SOURCES)
    assert sorted(n for n in on_disk if n.endswith(".cuh")) == sorted(build.HEADERS)
    for name, (symbol, argtypes) in build._SIGNATURES.items():
        src = "".join((build.CSRC / s).read_text() for s in build.SOURCES)
        decl = re.search(rf'extern "C" int {symbol}\((.*?)\)', src, re.S).group(1)
        params = [p.strip() for p in decl.split(",")]
        assert len(params) == len(argtypes), name
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
    rc = host_lib.host_mont_mul(_ptr(at), _ptr(bt), _ptr(out), ctypes.c_int(spec.nlimbs), ctypes.c_long(m))
    assert rc == 0
    assert torch.equal(out, packed_field.mont_mul_rows_plain(spec, at, bt))


def test_device_add2_equals_plain(host_lib, batches):
    a, b, s = batches
    out = torch.empty_like(a)
    host_lib.host_add2(_ptr(a), _ptr(b), _ptr(out), ctypes.c_long(L))
    assert torch.equal(out, s)
    host_lib.host_add2(_ptr(s), _ptr(a), _ptr(out), ctypes.c_long(L))
    assert torch.equal(out, G1P.add2_plain(s, a))


def test_device_step_and_scan2b_equal_plain(host_lib, batches):
    a, b, s = batches
    mask = torch.tensor([1, 0, 1, 1, 0, 1, 0, 1, 1], dtype=torch.int32)
    o1, o2 = torch.empty_like(a), torch.empty_like(a)
    host_lib.host_step(_ptr(s), _ptr(b), _ptr(mask), _ptr(o1), _ptr(o2), ctypes.c_long(L))
    w1, w2 = G1P.step_plain(s, b, mask)
    assert torch.equal(o1, w1) and torch.equal(o2, w2)
    host_lib.host_scan2b(_ptr(s), _ptr(a), _ptr(b), _ptr(o1), _ptr(o2), ctypes.c_long(L))
    w1, w2 = G1P.scan2b_plain(s, a, b)
    assert torch.equal(o1, w1) and torch.equal(o2, w2)


def test_device_ladder_equals_plain_and_host(host_lib, batches):
    _, _, s = batches
    ks = [0, 1, R - 1, 2, 5] + [int.from_bytes(RNG.bytes(40), "little") % R for _ in range(L - 5)]
    scal = torch.from_numpy(np.ascontiguousarray(FR.to_limbs(ks).T))
    out = torch.empty_like(s)
    host_lib.host_ladder(_ptr(s), _ptr(scal), _ptr(out), ctypes.c_int(16), ctypes.c_long(L))
    assert torch.equal(out, G1P.ladder_plain(s, scal))
    aff = tc.g1_to_affine_host(G1P.unpack(s))
    assert tc.g1_to_affine_host(G1P.unpack(out)) == [hc.g1_mul(p, k) for p, k in zip(aff, ks)]


@pytest.mark.parametrize("mixed", [0, 1], ids=["general", "mixed"])
def test_device_bucket_equals_plain(host_lib, mixed):
    pts = _points(10)
    table = G1P.pack(tc.g1_from_affine_host(pts, device="cpu")).T.contiguous()
    idx = torch.tensor([3, 3, 1, 0, 2, 9, 8, 7, 6, 5, 4, 4], dtype=torch.int32)
    start = torch.tensor([0, 2, 5, 5, 11], dtype=torch.int32)
    count = torch.tensor([2, 3, 0, 6, 1], dtype=torch.int32)
    out = torch.empty((72, 5), dtype=torch.int32)
    host_lib.host_bucket(_ptr(table), _ptr(idx), _ptr(start), _ptr(count), _ptr(out),
                         ctypes.c_long(5), ctypes.c_int(mixed))
    assert torch.equal(out, G1P.bucket_phase_plain(table, idx, start, count, mixed=bool(mixed)))
    aff = tc.g1_to_affine_host(G1P.unpack(out))
    assert aff[0] == hc.g1_double(pts[3]) and aff[2] is None and aff[4] == pts[4]


def test_device_bucket_consecutive_rows_equals_plain(host_lib, batches):
    a, _, s = batches
    table = torch.cat([s, a], dim=1).T.contiguous()  # 18 projective rows
    start = torch.tensor([0, 3, 18], dtype=torch.int32)
    count = torch.tensor([3, 15, 0], dtype=torch.int32)
    out = torch.empty((72, 3), dtype=torch.int32)
    host_lib.host_bucket(_ptr(table), None, _ptr(start), _ptr(count), _ptr(out),
                         ctypes.c_long(3), ctypes.c_int(0))
    assert torch.equal(out, G1P.bucket_phase_plain(table, None, start, count))
