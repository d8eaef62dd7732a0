"""Plain version of the Montgomery kernel (testudo_tpu_torch/device/
packed_field.py) against the JAX kernel BODY, pallas_field._mont_mul_rows,
called directly: the body is plain jnp on (n, L) arrays and runs eagerly on
the CPU without pallas_call.  Integers: exact equality."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from testudo_tpu.tpu import field as jf
from testudo_tpu.tpu import pallas_field as jpf
from testudo_tpu_torch.device import build, packed_field
from testudo_tpu_torch.device import field as tf

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

SPECS = {"fq": (tf.FQ, jf.FQ), "fr": (tf.FR, jf.FR)}


def _rows(spec, m, seed):
    p = spec.modulus
    rng = np.random.default_rng(seed)
    vals = [0, 1, p - 1, spec.r_mod_p] + [
        int.from_bytes(rng.bytes(64), "little") % p for _ in range(m - 4)
    ]
    other = vals[::-1]
    other[0] = p - 1  # (0, p-1) and (p-1, p-1) pairings
    other[2] = p - 1
    return vals, other


@pytest.mark.parametrize("name", ["fq", "fr"])
def test_plain_mont_mul_rows_equals_kernel_body(name):
    ts, js = SPECS[name]
    n = ts.nlimbs
    m = 37  # no multiple of any tile or block size
    a, b = _rows(ts, m, 5)
    at = np.ascontiguousarray(ts.to_limbs(a).T)
    bt = np.ascontiguousarray(ts.to_limbs(b).T)
    p_limbs = jpf._limbs_of(js.modulus, n)
    npr = (-pow(js.modulus, -1, js.mont_r)) % js.mont_r
    ref_rows = jpf._mont_mul_rows(
        jnp.asarray(at.astype(np.uint32)), jnp.asarray(bt.astype(np.uint32)),
        n, p_limbs, jpf._limbs_of(npr, n),
    )
    ref = np.stack([np.asarray(r) for r in ref_rows]).astype(np.int32)
    build.reset_launches()
    got = packed_field.mont_mul_rows(ts, torch.from_numpy(at), torch.from_numpy(bt))
    assert got.shape == (n, m) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)
    rinv = pow(ts.mont_r, -1, ts.modulus)
    assert ts.from_limbs(got.T) == [x * y * rinv % ts.modulus for x, y in zip(a, b)]
    assert build.LAUNCHES["mont_mul"] == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("name", ["fq", "fr"])
def test_mont_mul_drop_in_matches_field_mont_mul(name):
    ts, _ = SPECS[name]
    a, b = _rows(ts, 12, 6)
    A = torch.from_numpy(ts.to_limbs(a)).reshape(3, 4, ts.nlimbs)
    B = torch.from_numpy(ts.to_limbs(b)).reshape(3, 4, ts.nlimbs)
    # against the host's integers and against the (n, m) route on transposed operands
    rinv = pow(ts.mont_r, -1, ts.modulus)
    got = packed_field.mont_mul_rm(ts, A, B)
    assert got.shape == A.shape and got.dtype == torch.int32
    assert ts.from_limbs(got.reshape(12, -1)) == [x * y * rinv % ts.modulus for x, y in zip(a, b)]
    rows = packed_field.mont_mul_rows(ts, A.reshape(12, -1).T.contiguous(), B.reshape(12, -1).T.contiguous())
    assert torch.equal(got.reshape(12, -1), rows.T)
    shared = packed_field.mont_mul_rm(ts, A, B[0, 0])  # one second operand for every element
    assert ts.from_limbs(shared.reshape(12, -1)) == [x * b[0] * rinv % ts.modulus for x in a]
    assert torch.equal(tf.mont_mul(ts, A, B[0, 0]), shared)


def test_mont_mul_rows_argument_checks():
    good = torch.zeros((24, 5), dtype=torch.int32)
    with pytest.raises(ValueError):  # limb axis must come first
        packed_field.mont_mul_rows(tf.FQ, good.T, good.T)
    with pytest.raises(ValueError):  # shapes must agree
        packed_field.mont_mul_rows(tf.FQ, good, good[:, :3])
    with pytest.raises(TypeError):  # the plain version insists on int32 too
        packed_field.mont_mul_rows(tf.FQ, good.long(), good.long())
    odd = tf.FieldSpec(tf.FQ.modulus, 20, "odd")
    with pytest.raises(ValueError):  # no kernel for other widths
        packed_field.mont_mul_rows(odd, torch.zeros((20, 5), dtype=torch.int32),
                                   torch.zeros((20, 5), dtype=torch.int32))
