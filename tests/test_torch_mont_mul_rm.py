"""The row-major Montgomery kernel's indexing where there is no GPU.

csrc/mont_rm.cuh holds both bodies of csrc/mont_mul_rm.cu: the tiled form
(a block stages RM_TPB-row tiles through a swizzled shared array in two
stages and walks the tiles of a persistent grid) and the narrow form (one
thread an element).  csrc/host_check.cpp runs them on the CPU, the shared
array a plain array and the threads of each phase a loop; built here with
the host C++ compiler (skipped where there is none), each run is held
against `mont_mul_rm_plain`: exact equality, on ragged lengths around the
tile, grids from one block to one a tile, a ragged last tile in the
persistent loop, both fields, a shared second operand, and the edge values
0, 1, p - 1 and R mod p.  The plain product is held against the JAX
package's `tpu.field.mont_mul`, the body `tpu/kernels.py` traces into the
TPU kernel."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from testudo_tpu.tpu import field as jf
from testudo_tpu_torch.device import build, packed_field
from testudo_tpu_torch.device.field import FQ, FR

torch.set_num_threads(1)

TILE = 128  # RM_TPB in csrc/mont_rm.cuh
SPECS = {"fq": (FQ, jf.FQ), "fr": (FR, jf.FR)}


def _tile_rows():
    text = (build.CSRC / "mont_rm.cuh").read_text()
    return int(text.split("#define RM_TPB", 1)[1].split()[0])


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler found")
    out = tmp_path_factory.mktemp("host_rm") / "libhost_check.so"
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-x", "c++",
         "-I", str(build.CSRC), "-o", str(out), str(build.CSRC / "host_check.cpp")],
        check=True, capture_output=True, text=True, timeout=300,
    )
    lib = ctypes.CDLL(str(out))
    lib.host_mont_mul_rm.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_long,
                                                             ctypes.c_int, ctypes.c_long]
    return lib


def _ptr(t):
    assert t.dtype == torch.int32 and t.is_contiguous()
    return t.data_ptr()


def _operands(spec, n, seed):
    """(n, nlimbs) rows of a and b: every pairing of the edge values 0, 1,
    p - 1, R mod p first (as far as n reaches), then random elements."""
    p = spec.modulus
    rng = np.random.default_rng(seed)
    edge = [0, 1, p - 1, spec.r_mod_p]
    a = [x for x in edge for _ in edge][:n]
    b = [y for _ in edge for y in edge][:n]
    a += [int.from_bytes(rng.bytes(64), "little") % p for _ in range(n - len(a))]
    b += [int.from_bytes(rng.bytes(64), "little") % p for _ in range(n - len(b))]
    return torch.from_numpy(spec.to_limbs(a)), torch.from_numpy(spec.to_limbs(b))


def _run(lib, spec, a, b, shared, grid):
    out = torch.full_like(a, -1)
    rc = lib.host_mont_mul_rm(_ptr(a), _ptr(b), _ptr(out), spec.nlimbs, a.shape[0], int(shared),
                              grid)
    assert rc == 0, rc
    return out


def test_tile_matches_the_header():
    assert _tile_rows() == TILE


# lengths around one tile and several, and a ragged tile in a longer walk
LENGTHS = (1, 2, TILE - 1, TILE, TILE + 1, 3 * TILE - 1, 3 * TILE, 3 * TILE + 1, 7 * TILE + 5)


@pytest.mark.parametrize("shared", [False, True], ids=["full", "shared"])
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("name", ["fq", "fr"])
def test_tiled_and_narrow_bodies_equal_plain(host_lib, name, n, shared):
    """Every grid the launcher could pick (one block a tile, the persistent
    walk on 1, 2 and 3 blocks, so the last tile of a block's walk is ragged
    or lands in either stage) and the narrow body give the plain limbs."""
    spec = SPECS[name][0]
    a, b = _operands(spec, n, seed=n)
    if shared:
        b = b[n // 2].clone()
    want = packed_field.mont_mul_rm_plain(spec, a, b)
    tiles = -(-n // TILE)
    for grid in sorted({tiles, 1, min(2, tiles), min(3, tiles)}):
        assert torch.equal(_run(host_lib, spec, a, b, shared, grid), want), grid
    assert torch.equal(_run(host_lib, spec, a, b, shared, 0), want)


@pytest.mark.parametrize("name", ["fq", "fr"])
def test_non_canonical_operand_is_reduced(host_lib, name):
    """a < R but not < p (what `_fold_wide` hands the product): canonical out
    from both forms."""
    spec = SPECS[name][0]
    wide = torch.from_numpy(np.full((TILE + 3, spec.nlimbs), 0xFFFF, dtype=np.int32))
    one = torch.from_numpy(spec.to_limbs(spec.r2_mod_p)).reshape(-1).contiguous()
    want = packed_field.mont_mul_rm_plain(spec, wide, one)
    for grid in (0, 1, 2):
        assert torch.equal(_run(host_lib, spec, wide, one, True, grid), want), grid


def test_bad_arguments_are_refused(host_lib):
    a, b = _operands(FR, 3 * TILE, seed=5)
    out = torch.empty_like(a)
    assert host_lib.host_mont_mul_rm(_ptr(a), _ptr(b), _ptr(out), 20, 3 * TILE, 0, 1) == -1
    assert host_lib.host_mont_mul_rm(_ptr(a), _ptr(b), _ptr(out), 16, 3 * TILE, 0, 4) == -2
    assert host_lib.host_mont_mul_rm(_ptr(a), _ptr(b), _ptr(out), 16, 3 * TILE, 0, -1) == -2
    assert host_lib.host_mont_mul_rm(_ptr(a), _ptr(b), _ptr(out), 16, 0, 0, 1) == 0


@pytest.mark.parametrize("name", ["fq", "fr"])
def test_swizzle_spreads_a_quarter_warp_over_the_banks(host_lib, name):
    """`rm_slot`: each row owns its CH slots, and the 8 threads of a
    quarter-warp reading their chunk k hit 8 distinct slots mod 8 (the
    16-byte groups of the 32 banks), so a 128-bit shared read is one
    wavefront."""
    spec = SPECS[name][0]
    ch = spec.nlimbs // 4  # 16-byte chunks a row
    slots = np.array([[host_lib.host_rm_slot(spec.nlimbs, r, k) for k in range(ch)]
                      for r in range(TILE)])
    assert all(set(slots[r]) == set(range(ch * r, ch * r + ch)) for r in range(TILE))
    for r0 in range(0, TILE, 8):
        for k in range(ch):
            assert len({int(s) % 8 for s in slots[r0:r0 + 8, k]}) == 8, (r0, k)


@pytest.mark.parametrize("shared", [False, True], ids=["full", "shared"])
@pytest.mark.parametrize("name", ["fq", "fr"])
def test_plain_product_equals_the_jax_package(name, shared):
    """mont_mul_plain against testudo_tpu.tpu.field.mont_mul (the body
    kernels.py:21-30 traces into the Pallas kernel; below 512 elements the
    JAX package runs it through XLA on the CPU): equal limbs on 200
    elements, edge values among them."""
    ts, js = SPECS[name]
    a, b = _operands(ts, 200, seed=11)
    if shared:
        b = b[37].clone()
    got = packed_field.mont_mul_rm_plain(ts, a, b)
    want = np.asarray(jf.mont_mul(js, a.numpy().astype(np.uint32), b.numpy().astype(np.uint32)))
    assert np.array_equal(got.numpy(), want.astype(np.int32))
