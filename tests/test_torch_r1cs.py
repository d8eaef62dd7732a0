"""The port's R1CS instances (testudo_tpu_torch/core/r1cs.py) against the JAX
package's core/r1cs.py on the same instances, carried across with
`convert.r1cs_instance_from_reference`: `multiply_vec`, `eval_table`,
`evaluate`, `get_digest`, `is_sat`, and the byte-level `Instance.new` with its
padding, input-column remap and errors.  Inputs come from a numpy seed; every
result is a field element or a byte string and must be equal (exact)."""
import numpy as np
import pytest
import torch

from testudo_tpu.core import r1cs as jr1cs
from testudo_tpu.poly import dense as jd
from testudo_tpu_torch import convert
from testudo_tpu_torch.core import r1cs
from testudo_tpu_torch.device import build
from testudo_tpu_torch.device.field import FR
from testudo_tpu_torch.fields.bls12_377 import R
from testudo_tpu_torch.poly import dense

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _ints(rng, n):
    return [int.from_bytes(rng.bytes(40), "little") % R for _ in range(n)]


def _dense_matrix(nc, ncols, entries):
    out = [[0] * ncols for _ in range(nc)]
    for r, c, v in entries:
        out[r][c] = (out[r][c] + v) % R
    return out


def _entries(m):
    return list(zip(m.rows.tolist(), m.cols.tolist(), m.vals))


def _random_instance(seed, nc=16, nv=16, ni=3, nnz=70):
    """Entries anywhere in the z columns, several a row and repeated (row,
    col) pairs, with values 0, 1 and r - 1 among them: not satisfiable, but
    every sum runs."""
    rng = np.random.default_rng(seed)
    mats = []
    for k in range(3):
        rows = rng.integers(0, nc, size=nnz)
        cols = rng.integers(0, 2 * nv, size=nnz)
        vals = _ints(rng, nnz)
        vals[:3] = [0, 1, R - 1]
        rows[3:6] = rows[2]
        cols[3:6] = cols[2]
        mats.append([(int(r), int(c), v) for r, c, v in zip(rows, cols, vals)])
    return jr1cs.R1CSInstance.new(nc, nv, ni, *mats)


@pytest.fixture(scope="module", params=["synthetic", "random"])
def pair(request):
    """(the JAX package's instance, the port's, a z vector)."""
    rng = np.random.default_rng(40)
    if request.param == "synthetic":
        jinst, vars_, inputs = jr1cs.R1CSInstance.produce_synthetic_r1cs(32, 16, 3, seed=5)
    else:
        jinst = _random_instance(41)
        vars_, inputs = _ints(rng, jinst.num_vars), _ints(rng, jinst.num_inputs)
    inst = convert.r1cs_instance_from_reference(jinst)
    return jinst, inst, jinst.z_vector(vars_, inputs), vars_, inputs


def test_produce_synthetic_r1cs_equals_reference():
    inst, vars_, inputs = r1cs.R1CSInstance.produce_synthetic_r1cs(32, 16, 3, seed=5)
    jinst, jvars, jinputs = jr1cs.R1CSInstance.produce_synthetic_r1cs(32, 16, 3, seed=5)
    assert (vars_, inputs) == (jvars, jinputs)
    for m, jm in ((inst.A, jinst.A), (inst.B, jinst.B), (inst.C, jinst.C)):
        assert _entries(m) == _entries(jm)
        assert (m.num_vars_x, m.num_vars_y) == (jm.num_vars_x, jm.num_vars_y) == (5, 5)
    assert inst.get_digest() == jinst.get_digest()
    assert inst.is_sat(vars_, inputs)


def test_digest_and_serialization_equal_reference(pair):
    jinst, inst = pair[:2]
    for m, jm in ((inst.A, jinst.A), (inst.B, jinst.B), (inst.C, jinst.C)):
        assert m.serialize() == jm.serialize()
    assert inst.get_digest() == jinst.get_digest() and len(inst.get_digest()) == 256


def test_multiply_vec_equals_reference(pair):
    jinst, inst, z = pair[:3]
    build.reset_launches()
    got = inst.multiply_vec_dev(dense.encode_table(z, device=CPU))
    want = jinst.multiply_vec_dev(jd.encode_table(z))
    assert sum(build.LAUNCHES.values()) == 0  # CPU tensors take the plain versions
    ncols = len(z)
    for g, w, m in zip(got, want, (inst.A, inst.B, inst.C)):
        assert g.shape == (inst.num_cons, FR.nlimbs) and g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int32))
        dm = _dense_matrix(inst.num_cons, ncols, _entries(m))
        assert dense.decode_table(g) == [sum(a * b for a, b in zip(row, z)) % R for row in dm]


def test_eval_table_equals_reference(pair):
    jinst, inst, z = pair[:3]
    rx = _ints(np.random.default_rng(42), inst.num_cons.bit_length() - 1)
    eq_rx = dense.eq_evals(rx, device=CPU)
    got = inst.compute_eval_table_sparse(eq_rx, len(z))
    want = jinst.compute_eval_table_sparse(jd.eq_evals(rx), len(z))
    eq_host = dense.decode_table(eq_rx)
    for g, w, m in zip(got, want, (inst.A, inst.B, inst.C)):
        assert g.shape == (len(z), FR.nlimbs)
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int32))
        dm = _dense_matrix(inst.num_cons, len(z), _entries(m))
        assert dense.decode_table(g) == [
            sum(dm[r][c] * eq_host[r] for r in range(inst.num_cons)) % R for c in range(len(z))]


def test_evaluate_equals_reference(pair):
    jinst, inst = pair[:2]
    rng = np.random.default_rng(43)
    rx = _ints(rng, inst.num_cons.bit_length() - 1)
    ry = _ints(rng, (2 * inst.num_vars).bit_length() - 1)
    got = inst.evaluate(rx, ry, CPU)
    assert got == tuple(jinst.evaluate(rx, ry))
    eq_x = dense.decode_table(dense.eq_evals(rx, device=CPU))
    eq_y = dense.decode_table(dense.eq_evals(ry, device=CPU))
    for g, m in zip(got, (inst.A, inst.B, inst.C)):
        assert g == sum(v * eq_x[r] * eq_y[c] for r, c, v in _entries(m)) % R
        assert m.evaluate(rx, ry, CPU) == g


def test_is_sat_equals_reference(pair):
    jinst, inst, _, vars_, inputs = pair
    assert inst.is_sat(vars_, inputs) == jinst.is_sat(vars_, inputs)
    bad = list(vars_)
    bad[2] = (bad[2] + 1) % R
    assert inst.is_sat(bad, inputs) is False and jinst.is_sat(bad, inputs) is False
    with pytest.raises(ValueError):
        inst.is_sat(vars_[:-1], inputs)
    with pytest.raises(ValueError):
        inst.is_sat(vars_, inputs + [1])


def test_device_tables_are_uploaded_once():
    inst = convert.r1cs_instance_from_reference(_random_instance(44))
    rows, cols, vals = inst.A.on(CPU)
    assert rows.dtype == cols.dtype == torch.int64 and vals.dtype == torch.int32
    assert inst.A.on("cpu")[0] is rows
    assert dense.decode_table(vals) == inst.A.vals


def test_empty_matrix():
    inst = r1cs.R1CSInstance.new(4, 4, 1, [(0, 0, 5)], [], [])
    z = dense.encode_table([3] * 8, device=CPU)
    Az, Bz, Cz = inst.multiply_vec_dev(z)
    assert dense.decode_table(Az) == [15, 0, 0, 0] and dense.decode_table(Bz) == [0] * 4
    assert inst.evaluate([0, 0], [0, 0, 0], CPU) == (5, 0, 0)


# -- byte-level construction ---------------------------------------------------


def _le32(v: int) -> bytes:
    return v.to_bytes(32, "little")


def _byte_entries(rng, nc, ncols, nnz):
    return [(int(rng.integers(0, nc)), int(rng.integers(0, ncols)), _le32(v))
            for v in _ints(rng, nnz)]


@pytest.mark.parametrize("nc,nv,ni", [(3, 5, 2), (1, 4, 1), (16, 16, 2), (5, 2, 3)])
def test_instance_new_pads_and_remaps_as_reference(nc, nv, ni):
    rng = np.random.default_rng(50 + nc)
    mats = [_byte_entries(rng, nc, nv + 1 + ni, 7) for _ in range(3)]
    inst = r1cs.Instance.new(nc, nv, ni, *mats)
    jinst = jr1cs.Instance.new(nc, nv, ni, *mats)
    assert inst.digest == jinst.digest
    assert (inst.inst.num_cons, inst.inst.num_vars, inst.inst.num_inputs) == (
        jinst.inst.num_cons, jinst.inst.num_vars, jinst.inst.num_inputs)
    nvp = inst.inst.num_vars
    assert nvp & (nvp - 1) == 0 and nvp >= max(nv, ni + 1)
    for m, jm, src in zip((inst.inst.A, inst.inst.B, inst.inst.C),
                          (jinst.inst.A, jinst.inst.B, jinst.inst.C), mats):
        assert _entries(m) == _entries(jm)
        for (r, c, v), (r0, c0, _) in zip(_entries(m), src):  # columns >= nv move past the padding
            assert r == r0 and c == (c0 if c0 < nv else c0 + nvp - nv)
    conv = convert.r1cs_instance_from_reference(jinst)
    assert conv.digest == inst.digest


def test_instance_new_rejects_bad_entries():
    with pytest.raises(r1cs.InvalidIndex):
        r1cs.Instance.new(4, 8, 1, [(5, 0, _le32(1))], [], [])
    with pytest.raises(r1cs.InvalidIndex):
        r1cs.Instance.new(4, 8, 1, [(0, 8 + 1 + 1, _le32(1))], [], [])
    for bad in (_le32(R), b"\xff" * 32):
        with pytest.raises(r1cs.InvalidScalar):
            r1cs.Instance.new(4, 8, 1, [], [], [(0, 0, bad)])
    with pytest.raises(r1cs.InvalidScalar):
        r1cs.Assignment.new([_le32(R + 5)])
    with pytest.raises(ValueError):
        r1cs.R1CSInstance.new(3, 4, 1, [], [], [])  # constraints not a power of two


def test_instance_is_sat_pads_the_assignment():
    inst, vars_, inputs = r1cs.Instance.produce_synthetic_r1cs(16, 16, 2, seed=7)
    jinst, _, _ = jr1cs.Instance.produce_synthetic_r1cs(16, 16, 2, seed=7)
    assert inst.digest == jinst.digest
    assert inst.is_sat(vars_, inputs)
    a = r1cs.Assignment.new([_le32(v) for v in (0, 1, R - 1)])
    assert a.assignment == [0, 1, R - 1] and a.pad(5).assignment == [0, 1, R - 1, 0, 0]
    short = r1cs.Assignment(vars_.assignment[:-1])  # the last variable padded with 0
    assert inst.is_sat(short, inputs) == jinst.is_sat(jr1cs.Assignment(short.assignment),
                                                      jr1cs.Assignment(inputs.assignment))
    with pytest.raises(r1cs.R1CSError):
        inst.is_sat(r1cs.Assignment(vars_.assignment + [1]), inputs)
    with pytest.raises(r1cs.R1CSError):
        inst.is_sat(vars_, r1cs.Assignment(inputs.assignment[:1]))
