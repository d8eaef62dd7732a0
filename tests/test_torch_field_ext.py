"""The port's `pow_fixed`, `inv`, `reduce_sum`, `_fold_wide`, the row-major
Montgomery product and the chained products (testudo_tpu_torch/device/field.py,
packed_field.py) against the JAX package's tpu/field.py, the body the TPU
kernel of tpu/kernels.py traces (called eagerly), and Python ints.  Inputs
come from numpy with a fixed seed; everything is an integer and must agree
exactly (tolerance 0)."""
import numpy as np
import pytest
import torch

from testudo_tpu.tpu import field as jf
from testudo_tpu.tpu import kernels as jk
from testudo_tpu_torch.device import build, packed_field
from testudo_tpu_torch.device import field as tf

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

SPECS = {"fq": (tf.FQ, jf.FQ), "fr": (tf.FR, jf.FR)}
FIELDS = ["fq", "fr"]


def _values(spec, n, seed):
    p = spec.modulus
    rng = np.random.default_rng(seed)
    edge = [0, 1, p - 1, spec.r_mod_p, 2]
    return edge + [int.from_bytes(rng.bytes(64), "little") % p for _ in range(n - len(edge))]


def _both(ts, values):
    """The same Montgomery elements as a port tensor and as a JAX array."""
    enc = ts.encode(values)
    return torch.from_numpy(enc), jf.jnp.asarray(enc.astype(np.uint32))


def _same(t: torch.Tensor, j) -> bool:
    return np.array_equal(t.numpy(), np.asarray(j).astype(np.int32))


@pytest.mark.parametrize("name", FIELDS)
def test_pow_fixed_equals_reference_and_ints(name):
    ts, js = SPECS[name]
    vals = _values(ts, 9, 1)
    a, ja = _both(ts, vals)
    for e in (0, 1, 2, 5, 0b1011001, (1 << 20) + 3):
        got = tf.pow_fixed(ts, a, e)
        assert _same(got, jf.pow_fixed(js, ja, e)), e
        assert ts.decode(got) == [pow(v, e, ts.modulus) for v in vals]
    with pytest.raises(ValueError):
        tf.pow_fixed(ts, a, -1)


@pytest.mark.parametrize("name", FIELDS)
def test_inv_equals_reference_and_maps_zero_to_zero(name):
    ts, js = SPECS[name]
    vals = _values(ts, 7, 2)
    a, ja = _both(ts, vals)
    got = tf.inv(ts, a)
    assert _same(got, jf.inv(js, ja))
    assert ts.decode(got) == [pow(v, -1, ts.modulus) if v else 0 for v in vals]
    one = torch.from_numpy(ts.encode([1] * len(vals)))
    prod = tf.mont_mul(ts, a, got)
    assert torch.equal(prod[1:], one[1:]) and not prod[0].any()


@pytest.mark.parametrize("name", FIELDS)
def test_reduce_sum_equals_reference_on_both_axes(name):
    ts, js = SPECS[name]
    vals = _values(ts, 30, 3)
    a, ja = _both(ts, vals)
    a3, ja3 = a.reshape(5, 6, ts.nlimbs), ja.reshape(5, 6, js.nlimbs)
    p = ts.modulus
    grid = [vals[i * 6:(i + 1) * 6] for i in range(5)]
    got0 = tf.reduce_sum(ts, a3, axis=0)
    assert _same(got0, jf.reduce_sum(js, ja3, axis=0))
    assert ts.decode(got0) == [sum(grid[i][j] for i in range(5)) % p for j in range(6)]
    got1 = tf.reduce_sum(ts, a3, axis=1)
    assert _same(got1, jf.reduce_sum(js, ja3, axis=1))
    assert ts.decode(got1) == [sum(row) % p for row in grid]
    assert torch.equal(tf.reduce_sum(ts, a3, axis=-2), got1)
    flat = tf.reduce_sum(ts, a)
    assert _same(flat, jf.reduce_sum(js, ja)) and ts.decode(flat[None]) == [sum(vals) % p]
    with pytest.raises(ValueError):
        tf.reduce_sum(ts, a3, axis=2)  # the limb axis is no batch axis


def test_reduce_sum_past_the_reference_chunk_length():
    """Above 2^14 elements the JAX package sums in chunks and folds twice;
    the port sums once in int64.  Same canonical element."""
    ts, js = SPECS["fr"]
    n = (1 << 14) + 37
    rng = np.random.default_rng(4)
    limbs = rng.integers(0, 1 << 16, size=(n, ts.nlimbs), dtype=np.int64)
    limbs[:, -1] &= 0x0FFF  # below r
    limbs[:3] = ts.to_limbs([ts.modulus - 1] * 3)
    got = tf.reduce_sum(ts, torch.from_numpy(limbs.astype(np.int32)))
    want = jf.reduce_sum(js, jf.jnp.asarray(limbs.astype(np.uint32)))
    assert _same(got, want)
    assert ts.from_limbs(got[None]) == [sum(ts.from_limbs(limbs)) % ts.modulus]


@pytest.mark.parametrize("name", FIELDS)
def test_fold_wide_equals_reference_and_ints(name):
    ts, js = SPECS[name]
    n = ts.nlimbs
    rng = np.random.default_rng(5)
    relaxed = rng.integers(0, 1 << 30, size=(6, n), dtype=np.int64)
    relaxed[0] = 0
    relaxed[1] = (1 << 30) - 1
    got = tf._fold_wide(ts, torch.from_numpy(relaxed))
    assert got.dtype == torch.int32
    assert _same(got, jf._fold_wide(js, jf.jnp.asarray(relaxed.astype(np.uint32))))
    want = [sum(int(v) << (16 * k) for k, v in enumerate(row)) % ts.modulus for row in relaxed]
    assert ts.from_limbs(got) == want
    # the port's sums reach 2^47 a limb (2^31 elements of 16 bits)
    big = rng.integers(0, 1 << 46, size=(3, n), dtype=np.int64)
    big[:, -1] &= (1 << 31) - 1  # the value stays below 2^(16 (n + 2))
    want = [sum(int(v) << (16 * k) for k, v in enumerate(row)) % ts.modulus for row in big]
    assert ts.from_limbs(tf._fold_wide(ts, torch.from_numpy(big))) == want


# -- the row-major product ------------------------------------------------------------


@pytest.mark.parametrize("name", FIELDS)
def test_row_major_mont_mul_shared_broadcast_and_ragged(name):
    """One shared second operand, a broadcast one and a ragged length (1031,
    a prime: no multiple of any tile) against tpu/field.py and against
    `_mont_mul_body`, the function the TPU kernel's body is."""
    ts, js = SPECS[name]
    n = 1031
    vals, wals = _values(ts, n, 6), _values(ts, n, 7)[::-1]
    a, ja = _both(ts, vals)
    b, jb = _both(ts, wals)
    build.reset_launches()
    full = packed_field.mont_mul_rm(ts, a, b)
    assert _same(full, jf.mont_mul(js, ja, jb))
    assert _same(full, jk._mont_mul_body(js, ja, jb))
    rinv = pow(ts.mont_r, -1, ts.modulus)
    assert ts.from_limbs(full) == [
        x * y * rinv % ts.modulus for x, y in zip(ts.from_limbs(a), ts.from_limbs(b))]
    shared = packed_field.mont_mul_rm(ts, a, b[9])
    assert _same(shared, jk._mont_mul_body(js, ja, jf.jnp.broadcast_to(jb[9], ja.shape)))
    assert torch.equal(packed_field.mont_mul_rm(ts, b[9], a), shared)  # the single element first
    a3, ja3 = a[:1030].reshape(5, 206, -1), ja[:1030].reshape(5, 206, -1)
    bcast = packed_field.mont_mul_rm(ts, a3, b[None, :206])
    assert bcast.shape == (5, 206, ts.nlimbs)
    assert _same(bcast, jf.mont_mul(js, ja3, jb[None, :206]))
    assert torch.equal(tf.mont_mul(ts, a, b), full) and torch.equal(tf.mont_sqr(ts, a),
                                                                     packed_field.mont_mul_rm(ts, a, a))
    assert not any(build.LAUNCHES.values())  # CPU tensors take the plain version


def test_row_major_mont_mul_argument_checks():
    good = torch.zeros((5, 24), dtype=torch.int32)
    with pytest.raises(ValueError):  # the limb axis comes last
        packed_field.mont_mul_rm(tf.FQ, good.T, good.T)
    with pytest.raises(ValueError):
        packed_field.mont_mul_rm(tf.FR, good, good)
    with pytest.raises(TypeError):
        packed_field.mont_mul_rm(tf.FQ, good.long(), good.long())
    odd = tf.FieldSpec(tf.FQ.modulus, 20, "odd")
    with pytest.raises(ValueError):  # no kernel for other widths
        packed_field.mont_mul_rm(odd, torch.zeros((5, 20), dtype=torch.int32),
                                 torch.zeros((5, 20), dtype=torch.int32))


# -- the chained products -------------------------------------------------------------


@pytest.mark.parametrize("name", FIELDS)
def test_chain_plain_version_equals_k_applications(name):
    ts, js = SPECS[name]
    L, K = 7, 5
    vals, wals = _values(ts, L, 8), _values(ts, L, 9)[::-1]
    a, ja = _both(ts, vals)
    b, jb = _both(ts, wals)
    want = ja
    for _ in range(K):
        want = jf.mont_mul(js, want, jb)
    got = packed_field.mont_mul_chain(ts, a.T.contiguous(), b.T.contiguous(), K)
    assert got.shape == (ts.nlimbs, L) and _same(got.T, want)
    assert torch.equal(packed_field.mont_mul_chain(ts, a.T.contiguous(), b.T.contiguous(), K,
                                                   inline_body=False), got)
    assert torch.equal(packed_field.mont_mul_chain(ts, a.T.contiguous(), b.T.contiguous(), 0),
                       a.T.contiguous())
    # a * b^K in integers
    rinv = pow(ts.mont_r, -1, ts.modulus)
    x, y = ts.from_limbs(a), ts.from_limbs(b)
    assert ts.from_limbs(got.T) == [xi * pow(yi * rinv, K, ts.modulus) % ts.modulus
                                    for xi, yi in zip(x, y)]


@pytest.mark.parametrize("name", FIELDS)
def test_grouped_chain_variants_equal_the_single_chains(name):
    ts, _ = SPECS[name]
    G, L, K = packed_field.CHAIN_GROUP, 5, 3
    a = torch.from_numpy(ts.encode(_values(ts, G * L, 10))).reshape(G, L, -1).transpose(1, 2).contiguous()
    b = torch.from_numpy(ts.encode(_values(ts, G * L, 11)[::-1])).reshape(G, L, -1).transpose(1, 2).contiguous()
    singles = torch.stack([packed_field.mont_mul_chain(ts, a[g], b[g], K) for g in range(G)])
    for variant in ("seq", "wide"):
        assert torch.equal(packed_field.mont_mul_chain_group(ts, a, b, K, variant), singles)
    assert torch.equal(packed_field.mont_mul_chain_group(ts, a[:2], b[:2], K, "wide"), singles[:2])
    with pytest.raises(ValueError):  # the seq kernel is built for groups of six
        packed_field.mont_mul_chain_group(ts, a[:2], b[:2], K, "seq")
    with pytest.raises(ValueError):
        packed_field.mont_mul_chain_group(ts, a, b, K, "tall")
    with pytest.raises(ValueError):
        packed_field.mont_mul_chain(ts, a, b, K)  # (G, n, L) is the grouped wrapper's
    with pytest.raises(ValueError):
        packed_field.mont_mul_chain(ts, a[0], b[0], -1)
