"""The port's dense multilinear polynomials (testudo_tpu_torch/poly/dense.py)
against the JAX package's poly/dense.py, function by function.  Inputs come
from numpy with a fixed seed and go through both; tables are integers and
must agree limb for limb (tolerance 0)."""
import numpy as np
import pytest
import torch

from testudo_tpu.poly import dense as jd
from testudo_tpu_torch.device.field import FR
from testudo_tpu_torch.fields.bls12_377 import R
from testudo_tpu_torch.poly import dense as td

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    return [0, 1, R - 1][: min(3, n)] + [
        int.from_bytes(rng.bytes(40), "little") % R for _ in range(max(0, n - 3))]


def _same(t: torch.Tensor, j) -> bool:
    return t.dtype == torch.int32 and np.array_equal(t.numpy(), np.asarray(j).astype(np.int32))


def _host_evaluate(Z, point):
    for r in point:
        half = len(Z) // 2
        Z = [(lo + r * (hi - lo)) % R for lo, hi in zip(Z[:half], Z[half:])]
    return Z[0]


def test_encode_table_and_decode_match_reference():
    vals = _ints(16, 1)
    t, j = td.encode_table(vals, device=CPU), jd.encode_table(vals)
    assert _same(t, j)
    assert td.decode_table(t) == vals == jd.decode_table(j)
    assert td.decode_scalar(t[5]) == vals[5] == jd.decode_scalar(j[5])
    assert _same(td.encode_scalar(vals[4] + R, device=CPU), jd.encode_scalar(vals[4] + R))


def test_encode_table_above_the_host_threshold_lifts_on_the_device():
    """Past 2^14 entries both packages split limbs on the host and multiply
    by R^2 on the device; the table equals the host encode bit for bit."""
    n = (1 << 14) + 5
    rng = np.random.default_rng(2)
    vals = [int(v) for v in rng.integers(0, 1 << 62, size=n)]
    vals[:3] = [0, R - 1, 1 << 200]
    t = td.encode_table(vals, device=CPU)
    assert _same(t, jd.encode_table(vals))
    assert np.array_equal(t[:64].numpy(), FR.encode(vals[:64]))
    canon = torch.from_numpy(FR.to_limbs(vals[:9]))
    assert _same(td._to_mont_dev(canon), jd._to_mont_dev(jd.jnp.asarray(FR.to_limbs(vals[:9]).astype(np.uint32)), jd.FR))


def test_encode_table_small_matches_reference_and_rejects_negatives():
    v = np.asarray([0, 1, 65535, 65536, (1 << 62) + 12345, 7], dtype=np.int64)
    t = td.encode_table_small(v, device=CPU)
    assert _same(t, jd.encode_table_small(v))
    assert _same(td.encode_table(v, device=CPU), jd.encode_table(v))  # integer arrays take this path
    assert td.decode_table(t) == [int(x) for x in v]
    with pytest.raises(ValueError):
        td.encode_table_small(np.asarray([3, -1]), device=CPU)


def test_bound_top_and_bound_bot_match_reference():
    vals, r = _ints(16, 3), _ints(5, 4)[4]
    t, j = td.encode_table(vals, device=CPU), jd.encode_table(vals)
    rt, rj = td.encode_scalar(r, device=CPU), jd.encode_scalar(r)
    top = td.bound_top(t, rt)
    assert top.shape == (8, 16) and _same(top, jd.bound_top(j, rj))
    assert td.decode_table(top) == [(vals[i] + r * (vals[i + 8] - vals[i])) % R for i in range(8)]
    bot = td.bound_bot(t, rt)
    assert _same(bot, jd.bound_bot(j, rj))
    assert td.decode_table(bot) == [
        (vals[2 * i] + r * (vals[2 * i + 1] - vals[2 * i])) % R for i in range(8)]


def test_eq_evals_match_reference_and_are_msb_first():
    point = _ints(7, 5)[3:]  # four random coordinates
    chi = td.eq_evals(point, device=CPU)
    assert chi.shape == (16, 16) and _same(chi, jd.eq_evals(point))
    dev_scalars = [td.encode_scalar(x, device=CPU) for x in point]
    assert torch.equal(td.eq_evals_device(dev_scalars, device=CPU), chi)
    want = []
    for i in range(16):
        acc = 1
        for k, r in enumerate(point):
            acc = acc * (r if (i >> (3 - k)) & 1 else 1 - r) % R
        want.append(acc)
    assert td.decode_table(chi) == want
    empty = td.eq_evals([], device=CPU)
    assert _same(empty, jd.eq_evals([])) and td.decode_table(empty) == [1]


def test_dot_and_evaluate_match_reference_and_host():
    vals, point = _ints(32, 6), _ints(8, 7)[3:]
    t, j = td.encode_table(vals, device=CPU), jd.encode_table(vals)
    chi_t, chi_j = td.eq_evals(point, device=CPU), jd.eq_evals(point)
    assert _same(td._dot(t, chi_t), jd._dot(j, chi_j))
    got = td.evaluate(t, point)
    assert got == jd.evaluate(j, point) == _host_evaluate(vals, point)
    # binding every variable from the top gives the same value
    cur = t
    for r in point:
        cur = td.bound_top(cur, td.encode_scalar(r, device=CPU))
    assert td.decode_table(cur) == [got]


def test_host_side_helpers_match_reference():
    r, rx = _ints(8, 8)[3:], _ints(8, 9)[3:]
    assert td.eq_evaluate(r, rx) == jd.eq_evaluate(r, rx)
    assert td.eq_evaluate(r, r[:]) == jd.eq_evaluate(r, r)
    bits = [1, 0, 1, 1, 0]
    assert td.eq_evaluate(bits, bits) == 1 and td.eq_evaluate(bits, [1, 0, 1, 1, 1]) == 0
    assert td.identity_evaluate(r) == jd.identity_evaluate(r)
    assert td.identity_evaluate(bits) == 0b10110
    assert [td.factored_lens(k) for k in range(6)] == [jd.factored_lens(k) for k in range(6)]
    assert td.R == jd.R == R


def test_bound_L_matches_reference():
    vals, lv = _ints(32, 10), _ints(7, 11)[3:]
    t, j = td.encode_table(vals, device=CPU), jd.encode_table(vals)
    Lt, Lj = td.encode_table(lv, device=CPU), jd.encode_table(lv)
    got = td.bound_L(t, Lt)
    assert got.shape == (8, 16) and _same(got, jd.bound_L(j, Lj))
    assert td.decode_table(got) == [
        sum(lv[k] * vals[k * 8 + i] for k in range(4)) % R for i in range(8)]


def test_merge_tables_matches_reference():
    parts = [_ints(n, 20 + n) for n in (4, 2, 3)]
    ts = [td.encode_table(p, device=CPU) for p in parts]
    js = [jd.encode_table(p) for p in parts]
    got = td.merge_tables(ts)
    assert got.shape == (16, 16) and _same(got, jd.merge_tables(js))
    assert td.decode_table(got) == parts[0] + parts[1] + parts[2] + [0] * 7
    assert torch.equal(td.merge_tables(ts[:2] + ts[1:2]), torch.cat(ts[:2] + ts[1:2]))  # 8 already


def test_table_makers_default_to_cuda():
    import inspect

    for fn in (td.encode_table, td.encode_table_small, td.encode_scalar, td.eq_evals,
               td.eq_evals_device):
        assert inspect.signature(fn).parameters["device"].default == torch.device("cuda"), fn
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            td.encode_scalar(3)
