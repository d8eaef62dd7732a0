"""The port's mesh (testudo_tpu_torch/parallel/mesh.py) on the CPU: meshes of
`torch.device("cpu")` listed D times, D in {2, 4, 8}, inputs from a numpy seed.

  - `Mesh`, `make_mesh` (CUDA by default, raising without a card), `use_mesh`.
  - `cyclic_split` / `cyclic_join`: a round trip, fresh shards, and each shard
    equal to the JAX package's `cyclic_split` on its 8-CPU mesh.
  - `msm._mesh_for_batch`: the JAX package's thresholds.
  - `msm_g1` / `msm_g2` under a mesh, N no multiple of D: routed to
    `sharded_msm`, equal to the unsharded port and to `host_curve`.
  - The sharded multi-MSM, K no multiple of D, and the sqrt-PST commit under a
    mesh: limb-equal to the unsharded port (T equal); a host-group profile
    stays unsharded.
Exact: limbs and host points."""
import numpy as np
import pytest
import torch

from testudo_tpu_torch.core import pst, sqrt_pst
from testudo_tpu_torch.curves import host_curve as hc
from testudo_tpu_torch.curves import profile as cprof
from testudo_tpu_torch.device import curve as tc
from testudo_tpu_torch.device import msm
from testudo_tpu_torch.device.field import FR
from testudo_tpu_torch.fields.bls12_377 import R
from testudo_tpu_torch.parallel import mesh as pmesh
from testudo_tpu_torch.poly import dense

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _mesh(D):
    return pmesh.make_mesh([CPU] * D)


def _spy(monkeypatch, name):
    """Count the calls of parallel.mesh's function `name`."""
    calls = []
    real = getattr(pmesh, name)

    def spy(*a, **k):
        calls.append(a[0].size)
        return real(*a, **k)

    monkeypatch.setattr(pmesh, name, spy)
    return calls


def test_mesh_is_an_immutable_tuple_of_devices():
    m = pmesh.make_mesh(["cpu", CPU, "cpu"])
    assert m.size == 3 and m.devices == (CPU, CPU, CPU)
    assert pmesh.mesh_devices(m) == [CPU] * 3
    assert hash(m) == hash(_mesh(3)) and m == _mesh(3) and m != _mesh(2)
    with pytest.raises(Exception):
        m.devices = (CPU,)
    with pytest.raises(ValueError):
        pmesh.make_mesh([])
    assert pmesh.shard_mesh(4, "cpu") == _mesh(4)
    assert pmesh.AXIS == "shard"


def test_make_mesh_defaults_to_the_cuda_devices():
    if torch.cuda.is_available():
        assert pmesh.make_mesh().devices == tuple(
            torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.make_mesh()


def test_use_mesh_stacks_and_restores():
    a, b = _mesh(2), _mesh(4)
    assert pmesh.active_mesh() is None
    with pmesh.use_mesh(a):
        assert pmesh.active_mesh() is a
        with pmesh.use_mesh(None):
            assert pmesh.active_mesh() is None
            with pytest.raises(KeyError):
                with pmesh.use_mesh(b):
                    assert pmesh.active_mesh() is b
                    raise KeyError
            assert pmesh.active_mesh() is None
        assert pmesh.active_mesh() is a
    assert pmesh.active_mesh() is None


def _table(seed, n):
    rng = np.random.default_rng(seed)
    vals = [0, 1, R - 1] + [int.from_bytes(rng.bytes(40), "little") % R for _ in range(n - 3)]
    return dense.encode_table(vals, device=CPU)


@pytest.mark.parametrize("D", [2, 4, 8])
def test_cyclic_split_join_round_trip_equals_reference(D):
    import jax

    from testudo_tpu.parallel import mesh as jmesh

    t = _table(40 + D, 64)
    shards = pmesh.cyclic_split(_mesh(D), t)
    assert len(shards) == D and all(s.shape == (64 // D, FR.nlimbs) for s in shards)
    for d, s in enumerate(shards):
        assert torch.equal(s, t[d::D])  # global row q D + d at row q
        assert s.is_contiguous() and s.untyped_storage().data_ptr() != t.untyped_storage().data_ptr()
    assert torch.equal(pmesh.cyclic_join(shards), t)
    # a stack of tables splits along its rows
    stack = torch.stack([t, t.flip(0)])
    back = pmesh.cyclic_join(pmesh.cyclic_split(_mesh(D), stack), CPU)
    assert torch.equal(back, stack)
    # the JAX package's layout on its virtual 8-CPU mesh
    jm = jmesh.make_mesh(jax.devices("cpu")[:D])
    theirs = np.asarray(jmesh.cyclic_split(jm, jax.device_put(t.numpy().astype(np.uint32),
                                                              jax.devices("cpu")[0])))
    assert theirs.shape == (D, 64 // D, FR.nlimbs)
    for d, s in enumerate(shards):
        assert np.array_equal(theirs[d].astype(np.int32), s.numpy())
    with pytest.raises(ValueError):
        pmesh.cyclic_split(_mesh(3), t)


@pytest.mark.parametrize("D,n,sharded", [
    (1, 1000, False),  # a mesh of one shard
    (2, 64, False),  # at or below _SMALL_N
    (2, 65, True),
    (8, 65, True),
    (40, 79, False),  # fewer than two points a shard
    (40, 80, True),
])
def test_mesh_for_batch_thresholds_equal_reference(D, n, sharded):
    from testudo_tpu.tpu import msm as jmsm

    assert msm._SMALL_N == jmsm._SMALL_N == 64
    assert msm._mesh_for_batch(n) is None
    m = _mesh(D)
    with pmesh.use_mesh(m):
        assert (msm._mesh_for_batch(n) is m) == sharded
        with pmesh.use_mesh(None):
            assert msm._mesh_for_batch(n) is None


_GROUPS = {
    "g1": (hc.g1_generator, hc.g1_mul, hc.g1_msm, tc.g1_from_affine_host, msm.msm_g1),
    "g2": (hc.g2_generator, hc.g2_mul, hc.g2_msm, tc.g2_from_affine_host, msm.msm_g2),
}


@pytest.mark.parametrize("group,N,D", [("g1", 131, 2), ("g1", 67, 8), ("g2", 67, 4)])
def test_sharded_msm_equals_unsharded_and_host(monkeypatch, group, N, D):
    """131 points over 2 shards: each shard's Pippenger; 67 over 4 and 8: each
    shard's ladder, the last shard partly padding.  30-bit scalars on two limbs
    keep the plain versions quick (the signed windows need two bits of room)."""
    gen, mul, host_msm, from_affine, msm_fn = _GROUPS[group]
    rng = np.random.default_rng(60 + N + D)
    pts = [mul(gen(), int(k)) for k in rng.integers(1, 1 << 62, size=N)]
    scal = [0, 1] + [int(s) for s in rng.integers(0, 1 << 30, size=N - 2)]
    limbs = torch.as_tensor(np.array([[s & 0xFFFF, s >> 16] for s in scal], dtype=np.int32))
    dev_pts = from_affine(pts, device=CPU)
    calls = _spy(monkeypatch, "sharded_msm")
    one = msm_fn(dev_pts, limbs, affine=True, signed_c=4, device=CPU)
    assert calls == []
    with pmesh.use_mesh(_mesh(D)):
        got = msm_fn(dev_pts, limbs, affine=True, signed_c=4, device=CPU)
    assert calls == [D]
    assert got == one == host_msm(pts, scal)


def test_sharded_multi_msm_equals_unsharded():
    """7 columns over 2 shards (one padding column), limb for limb."""
    rng = np.random.default_rng(70)
    K, N = 7, 16
    G = hc.g1_generator()
    basis = tc.g1_from_affine_host([hc.g1_mul(G, int(k)) for k in rng.integers(1, 1 << 62, size=N)],
                                   device=CPU)
    cols = [[int.from_bytes(rng.bytes(40), "little") % R for _ in range(N)] for _ in range(K)]
    cols[0][:3] = [0, 1, R - 1]
    scal = torch.from_numpy(np.stack([FR.to_limbs(c) for c in cols]))
    c = msm._pick_window(N)
    want = msm._multi_msm_device("g1", basis, scal, c)
    got = pmesh.sharded_multi_msm(_mesh(2), "g1", basis, scal, c)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tc.g1_to_affine_host(got)[3] == hc.g1_msm(tc.g1_to_affine_host(basis), cols[3])


def test_sqrt_pst_commit_under_a_mesh_equals_unsharded(monkeypatch):
    """nv = 6 (8 columns of 8): two columns a shard on 4 shards; the column
    commitments limb-equal, T equal.  Under a host-group profile the columns
    are not sharded."""
    nv = 6
    t = _table(80, 1 << nv)
    calls = _spy(monkeypatch, "sharded_multi_msm")
    pf = cprof.bls12_377("cpu")
    ck, _ = pst.setup(nv - nv // 2, profile=pf)
    pl = sqrt_pst.Polynomial.from_evaluations(t, pf)
    comm, T = pl.commit(ck)
    assert calls == []
    with pmesh.use_mesh(_mesh(4)):
        comm2, T2 = pl.commit(ck)
    assert calls == [4]
    assert all(torch.equal(a, b) for a, b in zip(comm, comm2)) and T2 == T
    hpf = cprof.bls12_377("cpu", host_groups=True)
    hck, _ = pst.setup(nv - nv // 2, profile=hpf)
    hpl = sqrt_pst.Polynomial.from_evaluations(t, hpf)
    with pmesh.use_mesh(_mesh(4)):
        assert hpl.commit(hck)[1] == T
    assert calls == [4]


@pytest.mark.slow
def test_sharded_msm_equals_reference_sharded_msm(monkeypatch):
    """The JAX package's `sharded_msm` (its XLA path, TESTUDO_PACKED=0 and
    TESTUDO_PALLAS=0 as tests/test_sharding.py pins them) on its virtual 8-CPU
    mesh and the port's on 8 CPU shards, at the JAX package's dry run's shapes:
    128 points, 32-bit scalars on two limbs, c = 4.  Slow: XLA compiles the
    per-shard ladder on the CPU for minutes."""
    import jax
    import jax.numpy as jnp

    from testudo_tpu.parallel import mesh as jmesh
    from testudo_tpu.tpu import curve as jc
    from testudo_tpu.tpu import msm as jmsm

    monkeypatch.setenv("TESTUDO_PACKED", "0")
    monkeypatch.setenv("TESTUDO_PALLAS", "0")
    rng = np.random.default_rng(75)
    G = hc.g1_generator()
    pts = [hc.g1_mul(G, int(k)) for k in rng.integers(1, 1 << 62, size=128)]
    scal = [int(s) for s in rng.integers(0, 1 << 32, size=128)]
    limbs = np.array([[s & 0xFFFF, s >> 16] for s in scal], dtype=np.int32)
    cpu0 = jax.devices("cpu")[0]
    with jax.default_device(cpu0):
        with jmesh.use_mesh(jmesh.make_mesh(jax.devices("cpu")[:8])):
            theirs = jmsm.msm_g1(jc.g1_from_affine_host(pts),
                                 jnp.asarray(limbs.astype(np.uint32)), c=4)
    with pmesh.use_mesh(_mesh(8)):
        ours = msm.msm_g1(tc.g1_from_affine_host(pts, device=CPU), torch.from_numpy(limbs), c=4,
                          device=CPU)
    assert ours == theirs == hc.g1_msm(pts, scal)
