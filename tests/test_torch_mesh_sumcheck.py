"""The port's sharded sumcheck provers (testudo_tpu_torch/core/sumcheck.py under
parallel/mesh.py's `use_mesh`) on the CPU, on meshes of `torch.device("cpu")`
listed D times, D in {2, 4, 8}, tables of 16 rows from a numpy seed:

  - `prove_quad`, `prove_cubic_with_additive_term` and `prove_cubic`, fused and
    looped, each routed to its sharded form: round polynomials, challenges,
    final values and the sponge's state, mode and index equal to the unsharded
    port's and to the JAX package's unsharded looped prover (with an Fr-sponge
    transcript; phase one also with an Fq-sponge transcript);
  - the routing (the JAX package's `_sharded_mesh_for`): a mesh of one shard,
    n no multiple of D, n < D, BLS12-381's Fr and `prove_cubic_batched` stay
    unsharded and give the unsharded results;
  - the looped prover on 8 shards against the JAX package's own
    `_prove_looped_sharded` on its virtual 8-CPU mesh.
Exact: field elements and sponge states."""
import numpy as np
import pytest
import torch

from testudo_tpu_torch.core import sumcheck as sc
from testudo_tpu_torch.device.field import FR, FR381
from testudo_tpu_torch.fields.bls12_377 import R
from testudo_tpu_torch.parallel import mesh as pmesh
from testudo_tpu_torch.poly import dense
from testudo_tpu_torch.poseidon import transcript as ttr

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")
LOG2N = 4
TABLES = {"quad": 2, "cubic_tau": 4, "cubic": 3}


def _mesh(D):
    return pmesh.make_mesh([CPU] * D)


def _vals(kind, modulus=R):
    rng = np.random.default_rng(90 + TABLES[kind])
    return [[0, 1, modulus - 1][: j % 4] + [int.from_bytes(rng.bytes(48), "little") % modulus
                                            for _ in range((1 << LOG2N) - j % 4)]
            for j in range(TABLES[kind])]


def _claim(kind, vals, modulus=R):
    if kind == "quad":
        return sum(a * b for a, b in zip(*vals)) % modulus
    if kind == "cubic":
        return sum(a * b * c for a, b, c in zip(*vals)) % modulus
    return sum(t * (a * b - c) for t, a, b, c in zip(*vals)) % modulus


def _prove(kind, tables, claim, transcript, fused, spec=FR):
    if kind == "quad":
        return sc.prove_quad(claim, LOG2N, *tables, transcript, spec, fused=fused)
    if kind == "cubic_tau":
        return sc.prove_cubic_with_additive_term(claim, LOG2N, *tables, transcript, spec,
                                                 fused=fused)
    return sc.prove_cubic(claim, LOG2N, *tables, transcript, fused=fused)


def _run(kind, fused, mesh=None, params=ttr.fr_params, spec=FR):
    """((coeffs, rs, finals), (state, mode, index)) of one prove."""
    vals = _vals(kind, spec.modulus)
    tables = [dense.encode_table(v, spec, CPU) for v in vals]
    tp = ttr.PoseidonTranscript(params())
    with pmesh.use_mesh(mesh):
        proof, rs, finals = _prove(kind, tables, _claim(kind, vals, spec.modulus), tp, fused, spec)
    sp = tp.sponge
    return ([p.coeffs for p in proof.polys], rs, list(finals)), (list(sp.state), sp.mode, sp.index)


@pytest.fixture(scope="module")
def unsharded():
    """The unsharded port's result of each (kind, fused, sponge)."""
    cache = {}

    def get(kind, fused, params=ttr.fr_params):
        key = (kind, fused, params)
        if key not in cache:
            cache[key] = _run(kind, fused, None, params)
        return cache[key]

    return get


@pytest.fixture(scope="module")
def reference(monkeypatch_module):
    """The JAX package's unsharded looped prover on each kind's tables."""
    from testudo_tpu.core import sumcheck as jsc
    from testudo_tpu.poly import dense as jd
    from testudo_tpu.poseidon import transcript as jtr

    cache = {}

    def get(kind):
        if kind not in cache:
            vals = _vals(kind)
            jt = [jd.encode_table(v) for v in vals]
            jtp = jtr.PoseidonTranscript(jtr.fr_params())
            fn = {"quad": jsc.prove_quad, "cubic_tau": jsc.prove_cubic_with_additive_term,
                  "cubic": jsc.prove_cubic}[kind]
            proof, rs, finals = fn(_claim(kind, vals), LOG2N, *jt, jtp)
            cache[kind] = (([p.coeffs for p in proof.polys], rs, list(finals)),
                           (list(jtp.sponge.state), jtp.sponge.mode, jtp.sponge.index))
        return cache[kind]

    return get


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    mp.setenv("TESTUDO_FUSED_SUMCHECK", "0")  # the JAX package's looped provers
    mp.setenv("TESTUDO_FUSED_SPARK", "0")
    yield mp
    mp.undo()


def _spy_split(monkeypatch):
    calls = []
    real = pmesh.cyclic_split

    def spy(mesh, t):
        calls.append(mesh.size)
        return real(mesh, t)

    monkeypatch.setattr(pmesh, "cyclic_split", spy)
    return calls


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "looped"])
@pytest.mark.parametrize("kind", sorted(TABLES))
def test_sharded_prover_equals_unsharded_and_reference(monkeypatch, unsharded, reference,
                                                       kind, fused, D):
    calls = _spy_split(monkeypatch)
    got = _run(kind, fused, _mesh(D))
    assert calls == [D]  # one split of the stacked tables
    assert got == unsharded(kind, fused)
    assert got == reference(kind)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "looped"])
def test_sharded_phase_one_on_an_fq_sponge(monkeypatch, unsharded, fused):
    """An Fq transcript through Fr tables (the cross-field absorb and squeeze)."""
    calls = _spy_split(monkeypatch)
    assert _run("cubic_tau", fused, _mesh(4), ttr.fq_params) == \
        unsharded("cubic_tau", fused, ttr.fq_params)
    assert calls == [4]


@pytest.mark.parametrize("D,rows,rounds,sharded", [
    (1, 16, 4, False),
    (3, 16, 4, False),  # 16 rows do not split into 3
    (32, 16, 4, False),  # fewer rows than shards
    (2, 16, 3, False),  # a sumcheck that binds some of the variables only
    (2, 16, 4, True),
    (16, 16, 4, True),  # one row a shard: every round on the gathered rows
])
def test_sharded_mesh_for_equals_reference_rule(D, rows, rounds, sharded):
    t = torch.zeros((rows, FR.nlimbs), dtype=torch.int32)
    assert sc._sharded_mesh_for((t, t), rounds) is None
    m = _mesh(D)
    with pmesh.use_mesh(m):
        assert (sc._sharded_mesh_for((t, t), rounds) is m) == sharded


@pytest.mark.parametrize("D", [3, 32])
def test_unsplittable_tables_prove_unsharded(monkeypatch, unsharded, D):
    calls = _spy_split(monkeypatch)
    assert _run("quad", False, _mesh(D)) == unsharded("quad", False)
    assert calls == []


def test_one_row_a_shard_gathers_at_once(monkeypatch, unsharded):
    """16 shards of 16 rows: the remnant is the whole table, every round runs
    on the gathered rows."""
    calls = _spy_split(monkeypatch)
    assert _run("quad", True, _mesh(16)) == unsharded("quad", True)
    assert _run("quad", False, _mesh(16)) == unsharded("quad", False)
    assert calls == [16, 16]


def test_bls12_381_stays_unsharded(monkeypatch):
    calls = _spy_split(monkeypatch)
    params = ttr.fr_params_381
    want = _run("quad", False, None, params, FR381)
    assert _run("quad", False, _mesh(4), params, FR381) == want
    assert calls == []


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "looped"])
def test_prove_cubic_batched_stays_unsharded(monkeypatch, fused):
    calls = _spy_split(monkeypatch)
    rng = np.random.default_rng(95)
    vals = [[int.from_bytes(rng.bytes(40), "little") % R for _ in range(8)] for _ in range(6)]
    t = [dense.encode_table(v, device=CPU) for v in vals]
    coeffs = [3, 5, 7]
    claims = [sum(a * b * c for a, b, c in zip(vals[0], vals[1], vals[4])),
              sum(a * b * c for a, b, c in zip(vals[1], vals[0], vals[4])),
              sum(a * b * c for a, b, c in zip(vals[2], vals[3], vals[5]))]
    claim = sum(cf * c for cf, c in zip(coeffs, claims)) % R

    def run(mesh):
        tp = ttr.PoseidonTranscript(ttr.fr_params())
        with pmesh.use_mesh(mesh):
            proof, rs, cp, cd = sc.prove_cubic_batched(
                claim, 3, ([t[0], t[1]], [t[1], t[0]], t[4]), ([t[2]], [t[3]], [t[5]]), coeffs,
                tp, fused=fused)
        return [p.coeffs for p in proof.polys], rs, cp, cd, list(tp.sponge.state)

    assert run(_mesh(2)) == run(None)
    assert calls == []


def test_looped_on_8_shards_equals_reference_sharded_prover(monkeypatch_module, unsharded):
    """The JAX package's per-round sharded prover on its virtual 8-CPU mesh
    (TESTUDO_PACKED=0 and TESTUDO_PALLAS=0 as tests/test_sharding.py pins)."""
    import jax

    from testudo_tpu.core import sumcheck as jsc
    from testudo_tpu.parallel import mesh as jmesh
    from testudo_tpu.poly import dense as jd
    from testudo_tpu.poseidon import transcript as jtr

    mp = pytest.MonkeyPatch()
    mp.setenv("TESTUDO_PACKED", "0")
    mp.setenv("TESTUDO_PALLAS", "0")
    try:
        vals = _vals("quad")
        cpu0 = jax.devices("cpu")[0]
        jt = [jax.device_put(jd.encode_table(v), cpu0) for v in vals]
        jtp = jtr.PoseidonTranscript(jtr.fr_params())
        with jax.default_device(cpu0):
            proof, rs, finals = jsc._prove_looped_sharded(
                "quad", _claim("quad", vals), LOG2N, jt, jtp,
                jmesh.make_mesh(jax.devices("cpu")[:8]))
    finally:
        mp.undo()
    theirs = (([p.coeffs for p in proof.polys], rs, list(finals)),
              (list(jtp.sponge.state), jtp.sponge.mode, jtp.sponge.index))
    assert _run("quad", False, _mesh(8)) == theirs == unsharded("quad", False)
