"""Spark (testudo_tpu_torch/core/spark.py, core/product_tree.py,
core/polycommit.py) on the CPU: the port's Fr tables on CPU tensors (the
kernels' plain versions), every group operation on the host
(`cprof.bls12_377("cpu", host_groups=True)`).

  - Against the JAX package (its `jnp` code on the CPU), limb for limb:
    `AddrTimestamps`, the dense representation's tables
    (`multi_sparse_to_dense_rep`), `_hash_tables` and every layer of a
    `ProductCircuit`; the row commitments of `polycommit.commit` equal host
    MSMs over the JAX package's generators.
  - The port's own prover and verifier at 16 x 16, nnz 8, batch 3 (the size
    of tests/test_snark.py): the verifier accepts, and rejects the third
    evaluation + 1, another point and a bumped claim of the proof; the
    fused and the looped product-layer provers give the same bytes.
  - Slow-marked: the proof's bytes equal the JAX package's under one seeded
    blind stream, and each package's verifier accepts the other's proof
    (the JAX side compiles XLA on the CPU for many minutes).
Exact: limbs, points, bytes and field elements."""
import random
import types

import numpy as np
import pytest
import torch

from testudo_tpu import proofs as jproofs
from testudo_tpu import serialize as jser
from testudo_tpu.core import nizk as jnizk
from testudo_tpu.core import polycommit as jpc
from testudo_tpu.core import product_tree as jptree
from testudo_tpu.core import r1cs as jr1cs
from testudo_tpu.core import spark as jspark
from testudo_tpu.curves import host_curve as jhc
from testudo_tpu.poly import dense as jdense
from testudo_tpu.poseidon import transcript as jtr
from testudo_tpu_torch import proofs
from testudo_tpu_torch import serialize as ser
from testudo_tpu_torch.core import product_tree, r1cs, spark
from testudo_tpu_torch.curves import profile as cprof
from testudo_tpu_torch.fields.bls12_377 import R
from testudo_tpu_torch.poly import dense
from testudo_tpu_torch.poseidon.transcript import PoseidonTranscript, fr_params

torch.set_num_threads(1)

NX = NY = 4
NNZ = 8
LABEL = b"spark-test"


def _profile():
    return cprof.bls12_377("cpu", host_groups=True)


def _entries(seed=41):
    """Three 16 x 16 matrices of 8 entries each (repeated addresses
    included), then rx, ry: the same draws for both packages."""
    rng = random.Random(seed)
    mats = []
    for _ in range(3):
        mats.append([(rng.randrange(1 << NX), rng.randrange(1 << NY), rng.randrange(R))
                     for _ in range(NNZ)])
    rx = [rng.randrange(R) for _ in range(NX)]
    ry = [rng.randrange(R) for _ in range(NY)]
    return mats, rx, ry


def _mats(mod, mats):
    return [mod.SparseMatPolynomial(NX, NY, np.asarray([e[0] for e in m], np.int32),
                                    np.asarray([e[1] for e in m], np.int32), [e[2] for e in m])
            for m in mats]


def _same(port_t, jax_a):
    assert np.array_equal(port_t.numpy().astype(np.uint32), np.asarray(jax_a))


@pytest.fixture(scope="module")
def inst():
    mats, rx, ry = _entries()
    port = _mats(r1cs, mats)
    gens = spark.SparseMatPolyCommitmentGens.setup(LABEL, NX, NY, NNZ, 3, _profile())
    comm, dense_rep = spark.multi_commit(port, gens)
    evals = [m.evaluate(rx, ry, "cpu") for m in port]
    return dict(mats=mats, port=port, rx=rx, ry=ry, gens=gens, comm=comm, dense=dense_rep,
                evals=evals)


@pytest.fixture(scope="module")
def proved(inst):
    tp = PoseidonTranscript(fr_params())
    proof = spark.prove(inst["dense"], inst["rx"], inst["ry"], inst["evals"], inst["gens"], tp,
                        fused=False, rng=random.Random(9))
    return dict(proof=proof, blob=proofs.ser_spark_proof(proof), state=list(tp.sponge.state))


def _verify(inst, proof, evals=None, rx=None):
    return spark.verify(proof, inst["comm"], rx or inst["rx"], inst["ry"], evals or inst["evals"],
                        inst["gens"], PoseidonTranscript(fr_params()))


def test_addr_timestamps_equal_the_reference():
    rng = np.random.default_rng(3)
    addrs = [rng.integers(0, 16, 8) for _ in range(3)]
    addrs[1][:4] = addrs[0][:4]  # addresses read again across instances
    port = spark.AddrTimestamps.new(16, 8, addrs, "cpu")
    ref = jspark.AddrTimestamps.new(16, 8, addrs)
    for p, j in zip(port.ops_addr + port.read_ts + [port.audit_ts],
                    list(ref.ops_addr) + list(ref.read_ts) + [ref.audit_ts]):
        _same(p, j)
    with pytest.raises(ValueError):
        spark.AddrTimestamps.new(8, 8, addrs, "cpu")


def test_dense_tables_equal_the_reference(inst):
    d = inst["dense"]
    ref = jspark.multi_sparse_to_dense_rep(_mats(jr1cs, inst["mats"]))
    _same(d.comb_ops, ref.comb_ops)
    _same(d.comb_mem, ref.comb_mem)
    for p, j in zip(d.val, ref.val):
        _same(p, j)
    assert (inst["comm"].num_ops, inst["comm"].num_mem_cells, inst["comm"].batch_size) == (8, 16, 3)
    # the values' two encodes: machine ints and big ones
    big = [R - 1, 5, 1 << 70]
    _same(spark._encode_values(big, 4, "cpu"), jdense.encode_table(big + [0]))
    _same(spark._encode_values([1, 2, 3], 4, "cpu"), jdense.encode_table([1, 2, 3, 0]))


def test_row_commitments_equal_host_msms(inst):
    """Each row commitment of comb_mem is the JAX package's host MSM of its
    row over the JAX package's generators."""
    jgens = jpc.PolyCommitmentGens.setup(inst["gens"].gens_mem.num_vars, LABEL)
    assert jgens.gens.gens_n.G == inst["gens"].gens_mem.gens.gens_n.G
    table = dense.decode_table(inst["dense"].comb_mem)
    cols = jgens.gens.gens_n.n
    rows = [table[i:i + cols] for i in range(0, len(table), cols)]
    assert inst["comm"].comm_comb_mem.C == [jhc.g1_msm(jgens.gens.gens_n.G, r) for r in rows]


def test_hash_tables_and_product_layers_equal_the_reference(inst):
    d = inst["dense"]
    mem = dense.eq_evals(inst["rx"], device="cpu")
    derefs = d.row.deref(mem)
    r_hash, r_ms = 12345678901234567890, 98765432109876543210
    port = spark._hash_tables(mem, d.row.ops_addr, derefs, d.row.read_ts, d.row.audit_ts,
                              r_hash, r_ms)
    j = lambda t: np.asarray(t.numpy(), np.uint32)
    ref = jspark._hash_tables(j(mem), [j(t) for t in d.row.ops_addr], [j(t) for t in derefs],
                              [j(t) for t in d.row.read_ts], j(d.row.audit_ts), r_hash, r_ms)
    init, reads, writes, audit = port
    jinit, jreads, jwrites, jaudit = ref
    for p, q in zip([init, audit, *reads, *writes], [jinit, jaudit, *jreads, *jwrites]):
        _same(p, q)
    for table in (init, reads[0]):
        pc, jc = product_tree.ProductCircuit(table), jptree.ProductCircuit(j(table))
        assert len(pc.left_vec) == len(jc.left_vec) == table.shape[0].bit_length() - 1
        for a, b in zip(pc.left_vec + pc.right_vec, jc.left_vec + jc.right_vec):
            _same(a, b)
        assert pc.evaluate() == jc.evaluate()
    dp = product_tree.DotProductCircuit(derefs[0], d.col.deref(mem)[1], d.val[2])
    jdp = jptree.DotProductCircuit(j(derefs[0]), j(d.col.deref(mem)[1]), j(d.val[2]))
    assert dp.evaluate() == jdp.evaluate()
    assert sum(h.evaluate() for h in dp.split()) % R == dp.evaluate()


def test_prove_verify_accept_and_reject(inst, proved):
    proof = proved["proof"]
    assert _verify(inst, proof) is True
    bad = list(inst["evals"])
    bad[2] = (bad[2] + 1) % R
    assert _verify(inst, proof, evals=bad) is False
    assert _verify(inst, proof, rx=[(inst["rx"][0] + 1) % R] + inst["rx"][1:]) is False
    # a product-layer claim bumped in a copy of the proof
    copy = proofs.de_spark_proof(ser.Reader(proved["blob"]))
    layer = copy.proof_prod_layer.proof_ops.proof[1]
    layer.claims_prod_left[0] = (layer.claims_prod_left[0] + 1) % R
    assert _verify(inst, copy) is False
    assert _verify(inst, proof) is True


def test_fused_prover_gives_the_looped_bytes(inst, proved):
    tp = PoseidonTranscript(fr_params())
    proof = spark.prove(inst["dense"], inst["rx"], inst["ry"], inst["evals"], inst["gens"], tp,
                        fused=True, rng=random.Random(9))
    assert proofs.ser_spark_proof(proof) == proved["blob"]
    assert list(tp.sponge.state) == proved["state"]


@pytest.fixture(scope="module")
def reference(inst):
    """The same instance proved by the JAX package (its groups on the host,
    its looped product sumchecks) under the same blind stream."""
    mp = pytest.MonkeyPatch()
    mp.setenv("TESTUDO_HOST_CURVE", "1")
    mp.setenv("TESTUDO_FUSED_SPARK", "0")
    stream = random.Random(9)
    mp.setattr(jnizk, "secrets", types.SimpleNamespace(randbelow=stream.randrange))
    try:
        jmats = _mats(jr1cs, inst["mats"])
        jgens = jspark.SparseMatPolyCommitmentGens.setup(LABEL, NX, NY, NNZ, 3)
        jcomm, jdense_rep = jspark.multi_commit(jmats, jgens)
        tp = jtr.PoseidonTranscript(jtr.fr_params())
        jproof = jspark.prove(jdense_rep, inst["rx"], inst["ry"], inst["evals"], jgens, tp)
        yield dict(gens=jgens, comm=jcomm, proof=jproof, blob=jproofs.ser_spark_proof(jproof),
                   state=list(tp.sponge.state))
    finally:
        mp.undo()


@pytest.mark.slow  # the JAX package's Spark compiles XLA on the CPU (many minutes)
def test_proof_bytes_equal_the_reference_and_cross_verify(inst, proved, reference):
    assert proved["blob"] == reference["blob"]
    assert proved["state"] == reference["state"]
    assert inst["comm"].comm_comb_ops.C == list(reference["comm"].comm_comb_ops.C)
    # the JAX package's proof, read by the port's codec, in the port's verifier,
    # and the port's, read by the JAX package's codec, in the JAX package's
    assert _verify(inst, proofs.de_spark_proof(ser.Reader(reference["blob"]))) is True
    ref_proof = jproofs.de_spark_proof(jser.Reader(proved["blob"]))
    tv = jtr.PoseidonTranscript(jtr.fr_params())
    assert jspark.verify(ref_proof, reference["comm"], inst["rx"], inst["ry"], inst["evals"],
                         reference["gens"], tv) is True
