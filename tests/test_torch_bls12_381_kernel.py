"""The Montgomery kernels at BLS12-381's Fr, and the field chosen by modulus,
where there is no GPU.

csrc/mont_mul_rm.cu (row-major: the narrow form and the tiled form with a
shared b), csrc/mont_mul.cu (K1) and csrc/mont_chain.cu take a field id that
device/packed_field.py derives from the spec's modulus: BLS12-377's Fr and
BLS12-381's Fr both have 16 limbs, so the limb count cannot say which field
to reduce in.  csrc/host_check.cpp runs the kernels' bodies on the CPU; built
here with the host C++ compiler (skipped where there is none), they are held
against the plain PyTorch version: exact equality on ragged lengths, with the
edge values 0, 1, r - 1 and R mod r, and with the non-canonical operand R - 1
(below R, above r: what `_fold_wide` hands the product, where r381 leaves
R / r = 2.2 of headroom against 7.6 for r377).  The plain product is held
against the JAX package's `tpu.field.mont_mul` at its FR381 spec."""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from testudo_tpu.curves import profile as jprof
from testudo_tpu.tpu import field as jf
from testudo_tpu_torch.device import build, packed_field
from testudo_tpu_torch.device import field as tf
from testudo_tpu_torch.device.curve_generic import FQ761
from testudo_tpu_torch.device.field import FQ, FR, FR381
from testudo_tpu_torch.fields import bls12_381 as f381

torch.set_num_threads(1)

TILE = 128  # RM_TPB in csrc/mont_rm.cuh
R381 = f381.R


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler found")
    out = tmp_path_factory.mktemp("host_381") / "libhost_check.so"
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-x", "c++",
         "-I", str(build.CSRC), "-o", str(out), str(build.CSRC / "host_check.cpp")],
        check=True, capture_output=True, text=True, timeout=300,
    )
    lib = ctypes.CDLL(str(out))
    lib.host_mont_mul_rm.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_long,
                                                             ctypes.c_int, ctypes.c_long]
    lib.host_mont_mul.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_long]
    lib.host_mont_chain_group.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    return lib


def _ptr(t):
    assert t.dtype == torch.int32 and t.is_contiguous()
    return t.data_ptr()


EDGES = [0, 1, R381 - 1, FR381.r_mod_p]


def _operands(n, seed, wide_a=False):
    """(n, 16) rows of a and b: every pairing of the edge values first (as
    far as n reaches), then random elements; with `wide_a` the first rows of
    a are R - 1 (non-canonical) against canonical b."""
    rng = np.random.default_rng(seed)
    a = [x for x in EDGES for _ in EDGES][:n]
    b = [y for _ in EDGES for y in EDGES][:n]
    a += [int.from_bytes(rng.bytes(40), "little") % R381 for _ in range(n - len(a))]
    b += [int.from_bytes(rng.bytes(40), "little") % R381 for _ in range(n - len(b))]
    ta, tb = torch.from_numpy(FR381.to_limbs(a)), torch.from_numpy(FR381.to_limbs(b))
    if wide_a:
        ta[: min(n, 5)] = 0xFFFF  # R - 1: every limb set
    return ta, tb


def _rm(lib, spec, a, b, shared, grid):
    out = torch.full_like(a, -1)
    rc = lib.host_mont_mul_rm(_ptr(a), _ptr(b), _ptr(out), packed_field.field_id(spec),
                              a.shape[0], int(shared), grid)
    assert rc == 0, rc
    return out


def test_field_ids_match_the_c_enum():
    """KERNEL_FIELDS' ids are csrc/fp.cuh's FieldId values, none of them a
    limb count, and each field is found by its modulus."""
    text = (build.CSRC / "fp.cuh").read_text()
    enum = {k: int(v) for k, v in re.findall(r"(FIELD_\w+) = (\d+)", text)}
    assert enum == {"FIELD_FR": 1, "FIELD_FQ": 2, "FIELD_FQ761": 3, "FIELD_FR381": 4}
    for spec, name in ((FR, "FIELD_FR"), (FQ, "FIELD_FQ"), (FQ761, "FIELD_FQ761"),
                       (FR381, "FIELD_FR381")):
        assert packed_field.field_id(spec) == enum[name]
        assert packed_field.KERNEL_FIELDS[spec.modulus][:2] == (enum[name], spec.nlimbs)
    assert not {16, 24, 48} & set(enum.values())


def test_fr381_table_and_inverse():
    """FR381_P is r381 in words, and its INV is -r^-1 mod 2^32 computed here
    (r381 is 1 mod 2^32, so all ones)."""
    text = (build.CSRC / "fp.cuh").read_text()
    body = re.search(r"FR381_P\[8\] = \{([^}]*)\}", text).group(1)
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]+)u", body)]
    assert sum(w << (32 * i) for i, w in enumerate(words)) == R381 == FR381.modulus
    inv = re.search(r"struct Fr381Params \{[^}]*INV = (0x[0-9a-f]+)u", text).group(1)
    assert int(inv, 16) == (-pow(R381, -1, 1 << 32)) % (1 << 32) == 0xFFFFFFFF
    assert words[-1] < 0x7FFFFFFF  # the top word leaves a spare bit


LENGTHS = (1, 2, TILE - 1, TILE, TILE + 1, 3 * TILE + 1, 7 * TILE + 5)


@pytest.mark.parametrize("shared", [False, True], ids=["full", "shared"])
@pytest.mark.parametrize("n", LENGTHS)
def test_rm_bodies_equal_plain(host_lib, n, shared):
    """The narrow body and the tiled form on every grid the launcher could
    pick give the plain limbs at fr381, edge values and R - 1 among a."""
    a, b = _operands(n, seed=n, wide_a=True)
    if shared:
        b = b[n // 2].clone()
    want = packed_field.mont_mul_rm_plain(FR381, a, b)
    tiles = -(-n // TILE)
    for grid in sorted({0, tiles, 1, min(2, tiles), min(3, tiles)}):
        assert torch.equal(_rm(host_lib, FR381, a, b, shared, grid), want), grid


def test_products_are_the_field_products(host_lib):
    """The kernel's limbs are a * b * R^-1 mod r381 in Python ints, canonical
    even where a is R - 1, and differ from the same limbs taken mod r377."""
    a, b = _operands(3 * TILE + 1, seed=3, wide_a=True)
    got = _rm(host_lib, FR381, a, b, False, 0)
    rinv = pow(FR381.mont_r, -1, R381)
    want = [x * y * rinv % R381 for x, y in zip(FR381.from_limbs(a), FR381.from_limbs(b))]
    assert FR381.from_limbs(got) == want
    assert not torch.equal(_rm(host_lib, FR, a, b, False, 0), got)


def test_non_canonical_operand_is_reduced(host_lib):
    """a = R - 1 on every row times R^2 mod r (what `_fold_wide`'s high half
    meets) and times R mod r (its low half): canonical out of both forms."""
    wide = torch.from_numpy(np.full((TILE + 3, 16), 0xFFFF, dtype=np.int32))
    for c in (FR381.r2_mod_p, FR381.r_mod_p, R381 - 1):
        one = torch.from_numpy(FR381.to_limbs(c)).reshape(-1).contiguous()
        want = packed_field.mont_mul_rm_plain(FR381, wide, one)
        assert all(v < R381 for v in FR381.from_limbs(want))
        for grid in (0, 1, 2):
            assert torch.equal(_rm(host_lib, FR381, wide, one, True, grid), want), (c, grid)


def test_k1_and_chain_bodies_equal_plain(host_lib):
    """K1's body (csrc/mont_mul.cu) on (16, m) rows and the single chain of
    csrc/mont_chain.cu at fr381; the grouped chain is refused."""
    m = 133
    a, b = _operands(m, seed=7)
    at, bt = a.T.contiguous(), b.T.contiguous()
    out = torch.full_like(at, -1)
    fid = packed_field.field_id(FR381)
    assert host_lib.host_mont_mul(_ptr(at), _ptr(bt), _ptr(out), fid, m) == 0
    assert torch.equal(out, packed_field.mont_mul_rows_plain(FR381, at, bt))
    L, K = 9, 4
    at, bt = at[:, :L].contiguous(), bt[:, :L].contiguous()
    want = packed_field.mont_mul_chain_plain(FR381, at, bt, K)
    for inline_body in (0, 1):
        got = torch.full_like(at, -1)
        assert host_lib.host_mont_chain_group(_ptr(at), _ptr(bt), _ptr(got), fid, 1, L, K, 1,
                                              inline_body) == 0
        assert torch.equal(got, want), inline_body
    assert host_lib.host_mont_chain_group(_ptr(at), _ptr(bt), _ptr(got), fid, 6, L, K, 0, 1) == -1


def test_another_16_limb_modulus_raises():
    """A 16-limb spec of a modulus no kernel is built for is refused by every
    wrapper, on the CPU too (before any plain version runs)."""
    odd = tf.FieldSpec(R381 - 2, 16, "other")  # a 16-limb modulus with no kernel
    x = torch.zeros((4, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel"):
        packed_field.field_id(odd)
    with pytest.raises(ValueError, match="no kernel"):
        packed_field.mont_mul_rm(odd, x, x)
    with pytest.raises(ValueError, match="no kernel"):
        packed_field.mont_mul_rows(odd, x.T.contiguous(), x.T.contiguous())
    with pytest.raises(ValueError, match="no kernel"):
        packed_field.mont_mul_chain(odd, x.T.contiguous(), x.T.contiguous(), 2)
    with pytest.raises(ValueError, match="no kernel"):  # a known modulus at a wrong width
        packed_field.field_id(tf.FieldSpec(R381, 24, "wide"))
    from testudo_tpu_torch.device import sponge as ds

    with pytest.raises(ValueError, match="no kernel"):  # no Poseidon constants over r381
        ds.permute(FR381, torch.zeros((3, 16), dtype=torch.int32))


def test_host_launchers_refuse_other_fields(host_lib):
    """The host launchers take a field id, never a limb count: 16 (the limb
    count of both Fr) and unknown ids are refused, and the two 16-limb
    fields' ids give different products on the same limbs."""
    a, b = _operands(2 * TILE, seed=9)
    out = torch.empty_like(a)
    for bad in (0, 16, 24, 48, 5):
        assert host_lib.host_mont_mul_rm(_ptr(a), _ptr(b), _ptr(out), bad, a.shape[0], 0, 0) == -1
        assert host_lib.host_mont_mul(_ptr(a), _ptr(b), _ptr(out), bad, 8) == -1
    assert not torch.equal(_rm(host_lib, FR381, a, b, False, 1), _rm(host_lib, FR, a, b, False, 1))


@pytest.mark.parametrize("shared", [False, True], ids=["full", "shared"])
def test_plain_product_equals_the_jax_package(shared):
    """mont_mul_plain at fr381 against testudo_tpu.tpu.field.mont_mul at the
    JAX package's FR381 (the body its `_mont_mul_call(16, r381)` Pallas
    kernel computes; below 512 elements the JAX package runs it through XLA
    on the CPU): equal limbs on 200 elements, edge values and R - 1 among
    them."""
    js = jprof.bls12_381().fr_spec
    assert (js.modulus, js.nlimbs) == (FR381.modulus, FR381.nlimbs)
    a, b = _operands(200, seed=11, wide_a=True)
    if shared:
        b = b[37].clone()
    got = packed_field.mont_mul_rm_plain(FR381, a, b)
    want = np.asarray(jf.mont_mul(js, a.numpy().astype(np.uint32), b.numpy().astype(np.uint32)))
    assert np.array_equal(got.numpy(), want.astype(np.int32))


def test_field_ops_at_fr381_equal_python_ints():
    """add, sub, reduce_sum (through `_fold_wide`, whose low half is
    non-canonical) and inv at fr381 on a CPU table equal Python ints."""
    rng = np.random.default_rng(13)
    vals = EDGES + [int.from_bytes(rng.bytes(40), "little") % R381 for _ in range(60)]
    x = torch.from_numpy(FR381.encode(vals))
    y = torch.from_numpy(FR381.encode(vals[::-1]))
    dec = FR381.decode
    assert dec(tf.add(FR381, x, y)) == [(u + v) % R381 for u, v in zip(vals, vals[::-1])]
    assert dec(tf.sub(FR381, x, y)) == [(u - v) % R381 for u, v in zip(vals, vals[::-1])]
    assert dec(tf.mont_mul(FR381, x, y)) == [u * v % R381 for u, v in zip(vals, vals[::-1])]
    big = torch.from_numpy(np.full((4096, 16), 0xFFFF, dtype=np.int32))  # 4096 (R - 1)
    assert FR381.from_limbs(tf.reduce_sum(FR381, big)) == [4096 * (FR381.mont_r - 1) % R381]
    assert dec(tf.reduce_sum(FR381, x)) == [sum(vals) % R381]
    inv = dec(tf.inv(FR381, x[4:8]))
    assert [u * w % R381 for u, w in zip(vals[4:8], inv)] == [1] * 4
