"""BW6-761 in the port: the field constants, the host curve and pairing, and
the 761-bit Montgomery product, each held against the JAX package
(testudo_tpu/fields/bw6_761.py, curves/bw6_761.py, tpu/field.py's
`mont_mul` at FQ761, a batch under 512: its XLA path) and against Python
ints.  Every comparison is exact."""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from testudo_tpu.curves import bw6_761 as jbw
from testudo_tpu.fields import bw6_761 as jbwf
from testudo_tpu.tpu import curve_generic as jcg
from testudo_tpu.tpu import field as jf
from testudo_tpu_torch.curves import bw6_761 as bw
from testudo_tpu_torch.device import curve_generic as cg
from testudo_tpu_torch.device import field as tf
from testudo_tpu_torch.device import packed_field
from testudo_tpu_torch.fields import bw6_761 as bwf
from testudo_tpu_torch.fields.bls12_377 import P as P377

torch.set_num_threads(1)

RNG = random.Random(761)
Q = bwf.Q


def test_constants_equal_the_jax_package():
    for name in ("Q", "R", "TRACE", "B1", "B2", "XI", "H1", "H2", "G1_ORDER", "G2_ORDER",
                 "FQ_BITS", "FR_BITS"):
        assert getattr(bwf, name) == getattr(jbwf, name), name
    assert bwf.R == P377 and Q.bit_length() == 761
    assert cg.FQ761.modulus == jcg.FQ761.modulus and cg.FQ761.nlimbs == jcg.FQ761.nlimbs == 48
    assert cg.FQ761.name == jcg.FQ761.name == "bw6fq"


def test_host_curve_equals_the_jax_package():
    assert bw.g1_generator() == jbw.g1_generator()
    assert bw.g2_generator() == jbw.g2_generator()
    for gen, mul, add, neg, jmul, jadd, jneg, on_curve in (
            (bw.g1_generator, bw.g1_mul, bw.g1_add, bw.g1_neg, jbw.g1_mul, jbw.g1_add, jbw.g1_neg,
             bw.g1_is_on_curve),
            (bw.g2_generator, bw.g2_mul, bw.g2_add, bw.g2_neg, jbw.g2_mul, jbw.g2_add, jbw.g2_neg,
             bw.g2_is_on_curve)):
        g = gen()
        k1, k2 = RNG.randrange(1, bwf.R), RNG.randrange(1, bwf.R)
        p1, p2 = mul(g, k1), mul(g, k2)
        assert p1 == jmul(g, k1) and on_curve(p1)
        assert add(p1, p2) == jadd(p1, p2) == mul(g, (k1 + k2) % bwf.R)
        assert add(p1, p1) == jadd(p1, p1) == mul(g, 2 * k1 % bwf.R)
        assert neg(p1) == jneg(p1) and add(p1, neg(p1)) is None
        assert add(None, p1) == p1 and mul(g, bwf.R) is None


def test_tower_and_pairing_equal_the_jax_package():
    a = bw.Fq6(tuple(RNG.randrange(Q) for _ in range(6)))
    ja = jbw.Fq6(a.c)
    assert (a * a.inv()) == bw.Fq6.one()
    assert (a * a).c == (ja * ja).c and a.inv().c == ja.inv().c
    assert a.frobenius(1) == a.pow(Q)
    g1, g2 = bw.g1_generator(), bw.g2_generator()
    k = RNG.randrange(1, bwf.R)
    e = bw.pairing(bw.g1_mul(g1, k), g2)
    assert e.c == jbw.pairing(bw.g1_mul(g1, k), g2).c
    # bilinearity: e(kP, Q) = e(P, kQ), and e(kP, Q) e(-P, kQ) = 1
    assert e == bw.pairing(g1, bw.g2_mul(g2, k)) != bw.Fq6.one()
    assert bw.multi_pairing([bw.g1_mul(g1, k), bw.g1_neg(g1)], [g2, bw.g2_mul(g2, k)]) \
        == bw.Fq6.one()


def _operands(n, seed):
    """(n, 48) limb rows of a and b: every pairing of the edge values 0, 1,
    q - 1, R mod q and r (BLS12-377's p, the scalar field) first, then
    random elements."""
    rng = random.Random(seed)
    edge = [0, 1, Q - 1, cg.FQ761.r_mod_p, bwf.R]
    a = [x for x in edge for _ in edge] + [rng.randrange(Q) for _ in range(n - 25)]
    b = [y for _ in edge for y in edge] + [rng.randrange(Q) for _ in range(n - 25)]
    return a, b


def test_mont_mul_761_equals_ints_and_the_jax_package():
    a, b = _operands(203, 1)
    A, B = (torch.from_numpy(cg.FQ761.to_limbs(v)) for v in (a, b))
    got = tf.mont_mul_plain(cg.FQ761, A, B)
    rinv = pow(cg.FQ761.mont_r, -1, Q)
    assert cg.FQ761.from_limbs(got) == [x * y * rinv % Q for x, y in zip(a, b)]
    ref = jf.mont_mul(jcg.FQ761, jnp.asarray(A.numpy().astype(np.uint32)),
                      jnp.asarray(B.numpy().astype(np.uint32)))
    assert np.array_equal(np.asarray(ref).astype(np.int64), got.numpy().astype(np.int64))
    # the wrappers take the plain version for CPU tensors, broadcasting a single b
    assert torch.equal(tf.mont_mul(cg.FQ761, A, B), got)
    assert torch.equal(packed_field.mont_mul_rm(cg.FQ761, A, B[3]),
                       tf.mont_mul_plain(cg.FQ761, A, B[3].expand_as(A)))


def test_mont_mul_plain_cuts_large_batches_into_slices(monkeypatch):
    """A batch past `_PLAIN_ENTRIES` runs slice by slice: the same limbs."""
    a, b = _operands(61, 2)
    A, B = (torch.from_numpy(cg.FQ761.to_limbs(v)).reshape(61, 1, 48) for v in (a, b))
    whole = tf.mont_mul_plain(cg.FQ761, A, B)
    monkeypatch.setitem(tf._PLAIN_ENTRIES, "cpu", 2 * 48 * 48 * 7)
    assert torch.equal(tf.mont_mul_plain(cg.FQ761, A, B), whole)
    assert whole.shape == (61, 1, 48)


@pytest.mark.parametrize("spec", [cg.FQ761, tf.FQ, tf.FR], ids=["bw6fq", "fq", "fr"])
def test_group_sums_equal_field_ops_and_ints(spec):
    """curve_generic's int32 add / sub / neg against field.add / sub and
    Python ints, on edge values (0, 1, q - 1, q - 2, R mod q, q // 2 and
    neighbours of the carry boundaries) and random elements."""
    q = spec.modulus
    rng = random.Random(3)
    # runs of 0xFFFF limbs that a carry or a borrow crosses end to end take
    # the lookahead after the two bulk pushes
    runs = [(1 << (16 * k)) - 1 for k in (3, 9, spec.nlimbs - 4)] + [1 << (16 * (spec.nlimbs - 4))]
    edge = [0, 1, 2, q - 1, q - 2, spec.r_mod_p, q // 2, (q + 1) // 2,
            (1 << (16 * spec.nlimbs - 1)) % q, (1 << 16) - 1, (1 << 32) - 1, *runs]
    vals = edge + [rng.randrange(q) for _ in range(300)]
    a = [x for x in edge for _ in edge] + vals
    b = [y for _ in edge for y in edge] + vals[::-1]
    A, B = (torch.from_numpy(spec.to_limbs(v)) for v in (a, b))
    s, d = cg.add(spec, A, B), cg.sub(spec, A, B)
    assert s.dtype == d.dtype == torch.int32
    assert spec.from_limbs(s) == [(x + y) % q for x, y in zip(a, b)]
    assert spec.from_limbs(d) == [(x - y) % q for x, y in zip(a, b)]
    assert torch.equal(s, tf.add(spec, A, B)) and torch.equal(d, tf.sub(spec, A, B))
    assert spec.from_limbs(cg.neg(spec, A)) == [(-x) % q for x in a]
    # a run crossed end to end (the lookahead finishes) and no run at all
    one = torch.from_numpy(spec.to_limbs([1]))
    chain = torch.from_numpy(spec.to_limbs([runs[2]]))
    assert spec.from_limbs(cg.add(spec, chain, one)) == [(runs[2] + 1) % q]
    assert spec.from_limbs(cg.sub(spec, torch.from_numpy(spec.to_limbs([runs[3]])), one)) == [
        runs[3] - 1]
    assert spec.from_limbs(cg.add(spec, one, one)) == [2]


def test_resolve_runs_long_limb_axes_in_blocks():
    """field._resolve on more positions than one lookahead covers (the
    761-bit product's 97): a carry that ripples across every block."""
    n = 97
    t = torch.full((3, n), 0xFFFF, dtype=torch.int64)
    t[0, 0] = 0x10000  # one carry in at the bottom runs to the top
    t[1, 60] = 0x1FFFF
    got = tf._resolve(t, n, False)
    for row, out in zip(t.tolist(), got.tolist()):
        value = sum(v << (16 * i) for i, v in enumerate(row)) % (1 << (16 * n))
        assert sum(v << (16 * i) for i, v in enumerate(out)) == value
        assert all(0 <= v < 1 << 16 for v in out)
