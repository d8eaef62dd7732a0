"""The shared-basis multi-MSM of the port (testudo_tpu_torch/device/msm.py:
`_multi_msm_device`, `_multi_msm_small`, `_multi_msm_packed`) against the host
oracle, column by column, for both groups and both paths, and the generator
form of the single MSM.  Two slow-marked tests run the JAX package's kernels
in Pallas interpret mode: one holds the table against the reference's scan
of `add2` (one kernel to compile), the other runs the packed multi-MSM
itself (tens of minutes of CPU compile) and compares table rows, window sums
and Horner output limb for limb.  Integers: exact equality."""
import numpy as np
import pytest
import torch

from testudo_tpu_torch.curves import host_curve as hc
from testudo_tpu_torch.device import curve as tc
from testudo_tpu_torch.device import msm as tmsm
from testudo_tpu_torch.device.field import FR
from testudo_tpu_torch.device.packed_curve import G1P, G2P
from testudo_tpu_torch.fields.bls12_377 import R

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

RNG = np.random.default_rng(111)
_PRNG = __import__("random").Random(111)


def _rand_g1(n):
    G = hc.g1_generator()
    return [hc.g1_mul(G, int(k)) for k in RNG.integers(1, 1 << 62, size=n)]


def _rand_g2(n):
    G = hc.g2_generator()
    return [hc.g2_mul(G, int(k)) for k in RNG.integers(1, 1 << 62, size=n)]


def _columns(K, N, bits=253):
    cols = [[_PRNG.randrange(min(R, 1 << bits)) for _ in range(N)] for _ in range(K)]
    cols[0][:3] = [0, 1, R - 1]
    return cols


def _limbs(cols):
    return torch.from_numpy(np.stack([FR.to_limbs(c) for c in cols]))


def test_pick_window_matches_reference():
    from testudo_tpu.tpu import msm as jmsm

    for n in (1, 8, 64, 65, 128, 1024, 1 << 20):
        assert tmsm._pick_window(n) == jmsm._pick_window(n)


@pytest.mark.parametrize("N", [8, 5])
def test_small_path_equals_host_msm_per_column(N):
    """N <= 64: one ladder launch over K * N lanes and folds over N (an odd N
    carries its last lane through the folds)."""
    K = 4 if N == 8 else 2
    pts, cols = _rand_g1(N), _columns(K, N)
    dev = tc.g1_from_affine_host(pts, device="cpu")
    out = tmsm._multi_msm_device("g1", dev, _limbs(cols), tmsm._pick_window(N))
    assert out[0].shape == (K, 24)
    assert tc.g1_to_affine_host(out) == [hc.g1_msm(pts, c) for c in cols]


def test_packed_path_equals_host_msm_per_column():
    """N = 128 > 64: the shared table, one bucket launch over K * W lanes, the
    Horner ladder; c = 4 keeps the table at 128 * 16 rows."""
    N, K, c = 128, 2, 4
    pts, cols = _rand_g1(N), _columns(K, N)
    pts[5] = None  # an identity base contributes nothing
    cols[1][7] = 0
    dev = tc.g1_from_affine_host(pts, device="cpu")
    phases = []
    out = tmsm._multi_msm_device("g1", dev, _limbs(cols), c, on_phase=phases.append)
    assert phases == ["table", "bucket", "horner"]
    assert tc.g1_to_affine_host(out) == [hc.g1_msm(pts, col) for col in cols]


def test_packed_stages_have_the_documented_layout():
    """table[j * B + d] = d * G_j with the identity at d = 0; window sums are
    lanes k-major; the Horner output is sum_w 2^(c w) wins[k, w]."""
    N, K, c = 4, 2, 4
    B, W = 1 << c, 256 // c
    pts = _rand_g1(N)
    cols = _columns(K, N, bits=20)  # windows above bit 20 sum to the identity
    cols[0][2] = 5  # _columns put r - 1 here
    scal = _limbs(cols)
    table = tmsm._multi_msm_table(G1P, tmsm._cat_points(tc.g1_from_affine_host(pts, device="cpu")), c)
    assert table.shape == (N * B, 72)
    rows = tc.g1_to_affine_host(G1P.unpack(table.T.contiguous()))
    assert rows == [hc.g1_mul(pts[j], d) for j in range(N) for d in range(B)]
    assert torch.equal(table[0], G1P.identity_packed(1, device="cpu")[:, 0])
    wins = tmsm._multi_msm_windows(G1P, table, scal, c)
    assert wins.shape == (72, K * W)
    got = tc.g1_to_affine_host(G1P.unpack(wins))
    for k in range(K):
        for w in range(6):
            digits = [(s >> (c * w)) & (B - 1) for s in cols[k]]
            assert got[k * W + w] == hc.g1_msm(pts, digits), (k, w)
        assert all(p is None for p in got[k * W + 6:(k + 1) * W])
    out = tmsm._multi_horner_packed(G1P, wins, K, c)
    assert tc.g1_to_affine_host(G1P.unpack(out)) == [hc.g1_msm(pts, col) for col in cols]


def test_packed_path_g2_equals_host_msm_per_column():
    N, K, c = 8, 2, 4
    pts, cols = _rand_g2(N), _columns(K, N)
    dev = tc.g2_from_affine_host(pts, device="cpu")
    out = tmsm._multi_msm_packed(G2P, dev, _limbs(cols), c)
    assert out[0][0].shape == (K, 24)
    assert tc.g2_to_affine_host(out) == [hc.g2_msm(pts, col) for col in cols]


def test_small_path_g2_equals_host_msm_per_column():
    N, K = 4, 2
    pts, cols = _rand_g2(N), _columns(K, N)
    dev = tc.g2_from_affine_host(pts, device="cpu")
    out = tmsm._multi_msm_device("g2", dev, _limbs(cols), 4)
    assert tc.g2_to_affine_host(out) == [hc.g2_msm(pts, col) for col in cols]


def test_multi_msm_argument_checks():
    dev = tc.g1_from_affine_host(_rand_g1(4), device="cpu")
    with pytest.raises(ValueError):  # one column is (1, N, 16), not (N, 16)
        tmsm._multi_msm_device("g1", dev, _limbs(_columns(1, 4))[0], 4)
    with pytest.raises(ValueError):  # basis and columns differ in length
        tmsm._multi_msm_device("g1", dev, _limbs(_columns(2, 3)), 4)
    with pytest.raises(ValueError):
        tmsm._multi_msm_device("g3", dev, _limbs(_columns(2, 4)), 4)
    wins = G1P.identity_packed(2 * 3, device="cpu")
    with pytest.raises(ValueError):  # three windows do not fold by halves
        tmsm._multi_horner_packed(G1P, wins, 2, 4)


def test_msm_pipeline_yields_at_its_two_waits_and_returns_the_sum():
    """The generator form: one yield for the ladder path; two for Pippenger
    (before the host plan, before the result's copy)."""
    pts = _rand_g1(70)
    scl = [_PRNG.randrange(1 << 24) for _ in range(70)]  # short scalars: short runs on the CPU
    dev = tc.g1_from_affine_host(pts, device="cpu")
    scal = torch.from_numpy(FR.to_limbs(scl))
    gen = tmsm.msm_pipeline("g1", dev, scal, affine=True, signed_c=4)
    assert next(gen) is None and next(gen) is None
    with pytest.raises(StopIteration) as stop:
        next(gen)
    assert stop.value.value == hc.g1_msm(pts, scl)
    small = tmsm.msm_pipeline("g1", tmsm._map_coords(lambda c: c[:5], dev), scal[:5])
    assert next(small) is None
    assert tmsm._drive_one(small) == hc.g1_msm(pts[:5], scl[:5])
    with pytest.raises(ValueError):
        tmsm._drive_one(tmsm.msm_pipeline("g1", dev, scal[:9]))


# -- against the JAX packed multi-MSM itself (slow: Pallas interpret mode) ------------


@pytest.mark.slow
def test_multi_msm_table_stage_equals_reference_tab_build():
    """`_multi_msm_table` (on the CPU the chain kernel's plain version: B - 1
    `add2_plain` calls and the re-layout) against the reference's table as
    `tab_build` builds it (testudo_tpu/tpu/msm.py:1038-1045: a `lax.scan` of
    the `add2` kernel from the identity, each step storing the previous
    value), the kernel in Pallas interpret mode, at N = 8 numpy-made points
    and c = 4: all N * 16 rows limb for limb.  Split out of the stage test
    below, which never ran to its end: this one compiles a single
    interpret-mode kernel.  Slow all the same (minutes of CPU compile)."""
    import jax

    from testudo_tpu.tpu import curve as jc
    from testudo_tpu.tpu import msm as jmsm
    from testudo_tpu.tpu import pallas_curve as pcu

    N, c = 8, 4
    B = 1 << c
    pts = _rand_g1(N)
    table = tmsm._multi_msm_table(G1P, tmsm._cat_points(tc.g1_from_affine_host(pts, device="cpu")), c)
    base = jmsm._cat_points("g1", jc.g1_from_affine_host(pts)).T  # (rows, N) packed

    def tab_step(prev, _):  # tpu/msm.py:1038-1043
        return pcu.G1P.add2(prev, base), prev

    _, tab = jax.lax.scan(tab_step, pcu.G1P.identity_packed(N), None, length=B)
    want = np.asarray(tab).transpose(2, 0, 1).reshape(N * B, 72).astype(np.int32)
    assert np.array_equal(table.numpy(), want)


@pytest.mark.slow
def test_multi_msm_packed_stages_equal_reference_packed_multi_msm(monkeypatch):
    """Runs testudo_tpu's `_multi_msm_packed_impl` and `_multi_horner_packed`
    (N = 128, K = 2, c = 4) through their Pallas kernels in interpret mode and
    holds the port's table rows, window sums and Horner output against them
    limb for limb.  Slow: every EC kernel costs minutes of CPU compile in
    interpret mode."""
    import jax.numpy as jnp

    from testudo_tpu.tpu import curve as jc
    from testudo_tpu.tpu import msm as jmsm
    from testudo_tpu.tpu import pallas_curve as pcu

    monkeypatch.setenv("TESTUDO_PACKED", "1")
    N, K, c = 128, 2, 4
    B, W = 1 << c, 256 // c
    pts, cols = _rand_g1(N), _columns(K, N)
    scal = _limbs(cols)

    ptcat = tmsm._cat_points(tc.g1_from_affine_host(pts, device="cpu"))
    table = tmsm._multi_msm_table(G1P, ptcat, c)
    wins = tmsm._multi_msm_windows(G1P, table, scal, c)
    out = tmsm._multi_horner_packed(G1P, wins, K, c)

    jpts = jc.g1_from_affine_host(pts)
    jptcat = jmsm._cat_points("g1", jpts)
    assert np.array_equal(np.asarray(jptcat).astype(np.int32), ptcat.numpy())
    # the table as the reference's scan builds it: prev, then prev + base
    base = jptcat.T
    cur = pcu.G1P.identity_packed(N)
    for d in range(B):
        want = np.asarray(cur).astype(np.int32)  # (rows, N): row d of every base
        assert np.array_equal(table.reshape(N, B, 72)[:, d, :].numpy(), want.T), d
        cur = pcu.G1P.add2(cur, base)
    jscal = jnp.asarray(scal.numpy().astype(np.uint32))
    kc = K
    while (kc * W) % 128:
        kc += 1
    jscal_p = jnp.pad(jscal, ((0, kc - K), (0, 0), (0, 0)))
    jwins = jmsm._multi_msm_packed_impl("g1", jptcat, jscal_p, c, kc, 1024)  # (rows, kc, W)
    assert np.array_equal(
        np.asarray(jwins)[:, :K].astype(np.int32), wins.reshape(72, K, W).numpy())
    jout = jmsm._multi_horner_packed("g1", jwins, c)  # (rows, kc)
    assert np.array_equal(np.asarray(jout)[:, :K].astype(np.int32), out.numpy())
    assert tc.g1_to_affine_host(G1P.unpack(out)) == [hc.g1_msm(pts, col) for col in cols]
