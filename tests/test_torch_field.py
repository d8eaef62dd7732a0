"""Port field arithmetic (testudo_tpu_torch/device/field.py) against the JAX
package's tpu/field.py (jitted XLA path, batch < 512) and against Python
ints.  Inputs come from numpy with a fixed seed; all values are integers and
must agree exactly."""
import numpy as np
import pytest
import torch

from testudo_tpu.tpu import field as jf
from testudo_tpu_torch.device import field as tf

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

SPECS = {"fq": (tf.FQ, jf.FQ), "fr": (tf.FR, jf.FR)}
N = 40


def _operands(spec, seed):
    """Two (N, nlimbs) canonical limb arrays: edge values 0, 1, p-1, R mod p
    in every pairing, then random elements."""
    p = spec.modulus
    rng = np.random.default_rng(seed)
    edge = [0, 1, p - 1, spec.r_mod_p]
    a = [x for x in edge for _ in edge]
    b = [y for _ in edge for y in edge]
    more = N - len(a)
    a += [int.from_bytes(rng.bytes(64), "little") % p for _ in range(more)]
    b += [int.from_bytes(rng.bytes(64), "little") % p for _ in range(more)]
    return a, b


@pytest.mark.parametrize("name", ["fq", "fr"])
def test_spec_constants_match_reference(name):
    ts, js = SPECS[name]
    assert (ts.modulus, ts.nlimbs, ts.mont_r, ts.r_mod_p, ts.r2_mod_p) == (
        js.modulus, js.nlimbs, js.mont_r, js.r_mod_p, js.r2_mod_p)
    assert np.array_equal(ts.p_limbs, js.p_limbs.astype(np.int32))
    assert np.array_equal(ts.nprime_limbs, js.nprime_limbs.astype(np.int32))


@pytest.mark.parametrize("name", ["fq", "fr"])
def test_encode_decode_to_limbs_match_reference(name):
    ts, js = SPECS[name]
    a, _ = _operands(ts, 1)
    assert np.array_equal(ts.to_limbs(a), js.to_limbs(a).astype(np.int32))
    assert np.array_equal(ts.to_limbs(a[5]), js.to_limbs(a[5]).astype(np.int32))
    enc = ts.encode(a)
    assert enc.dtype == np.int32
    assert np.array_equal(enc, js.encode(a).astype(np.int32))
    assert ts.decode(enc) == a == js.decode(js.encode(a))
    assert ts.decode(torch.from_numpy(enc)) == a
    assert ts.from_limbs(ts.to_limbs(a)) == a
    assert ts.from_limbs_single(ts.to_limbs(a[7])) == a[7]
    assert ts.from_mont_int(ts.to_mont_int(a[9])) == a[9]
    assert np.array_equal(tf.const_array(ts, 3), np.asarray(jf.const_array(js, 3)).astype(np.int32))
    assert np.array_equal(tf.const_array(ts, 3, mont=False), ts.to_limbs(3))


@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
@pytest.mark.parametrize("name", ["fq", "fr"])
def test_binary_op_matches_reference_and_ints(name, op):
    ts, js = SPECS[name]
    p = ts.modulus
    a, b = _operands(ts, 2)
    la, lb = ts.to_limbs(a), ts.to_limbs(b)
    got = getattr(tf, op)(ts, torch.from_numpy(la), torch.from_numpy(lb))
    assert got.dtype == torch.int32
    ref = getattr(jf, op)(js, la.astype(np.uint32), lb.astype(np.uint32))
    assert np.array_equal(got.numpy(), np.asarray(ref).astype(np.int32))
    rinv = pow(ts.mont_r, -1, p)
    want = {
        "add": [(x + y) % p for x, y in zip(a, b)],
        "sub": [(x - y) % p for x, y in zip(a, b)],
        "mont_mul": [x * y * rinv % p for x, y in zip(a, b)],
    }[op]
    assert ts.from_limbs(got) == want


@pytest.mark.parametrize("name", ["fq", "fr"])
def test_neg_sqr_select_is_zero(name):
    ts, js = SPECS[name]
    p = ts.modulus
    a, b = _operands(ts, 3)
    la, lb = torch.from_numpy(ts.to_limbs(a)), torch.from_numpy(ts.to_limbs(b))
    neg = tf.neg(ts, la)
    assert np.array_equal(neg.numpy(), np.asarray(jf.neg(js, la.numpy().astype(np.uint32))).astype(np.int32))
    assert ts.from_limbs(neg) == [(-x) % p for x in a]
    rinv = pow(ts.mont_r, -1, p)
    assert ts.from_limbs(tf.mont_sqr(ts, la)) == [x * x * rinv % p for x in a]
    cond = torch.from_numpy(np.arange(N) % 3 == 0)
    sel = tf.select(cond, la, lb)
    assert ts.from_limbs(sel) == [x if i % 3 == 0 else y for i, (x, y) in enumerate(zip(a, b))]
    assert tf.is_zero(ts, la).tolist() == [x == 0 for x in a]


@pytest.mark.parametrize("name", ["fq", "fr"])
def test_mont_mul_broadcasts_and_stacks(name):
    ts, _ = SPECS[name]
    p = ts.modulus
    a, b = _operands(ts, 4)
    A = torch.from_numpy(ts.to_limbs(a)).reshape(4, 10, ts.nlimbs)
    one_b = torch.from_numpy(ts.to_limbs(b[17]))
    got = tf.mont_mul(ts, A, one_b)
    rinv = pow(ts.mont_r, -1, p)
    assert got.shape == A.shape
    assert ts.from_limbs(got) == [x * b[17] * rinv % p for x in a]


def test_field_ops_reject_wrong_dtype_and_width():
    x = torch.zeros((3, 24), dtype=torch.int64)
    with pytest.raises(TypeError):
        tf.add(tf.FQ, x, x)
    y = torch.zeros((3, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        tf.mont_mul(tf.FQ, y, y)
    with pytest.raises(TypeError):
        tf.const_array(tf.FQ, 1.5)
