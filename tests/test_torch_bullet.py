"""Pedersen generators and the log-size dot-product argument of the port
(testudo_tpu_torch/core/commitments.py, core/nizk.py) on the CPU with the host
group backends (`cprof.bls12_377("cpu", host_groups=True)`).

  - `MultiCommitGens.new(2, b"test-gens")` equals tests/fixtures/vectors.json,
    and the gens at n = 8 equal the JAX package's, point for point.
  - `dotproduct_prove` / `dotproduct_verify` at n = 8 (and n = 1, no reduction
    round): the verifier accepts, and rejects a wrong y, a wrong vector and a
    bumped z1.
  - Slow-marked: the proof's bytes equal the JAX package's under one seeded
    blind stream (the port takes it as `rng`; the JAX package's `secrets`
    attribute is patched with the same stream from here).  The JAX side
    compiles XLA on the CPU for about two minutes.
Exact: points, bytes and field elements."""
import json
import os
import random
import types

import pytest
import torch

from testudo_tpu import proofs as jproofs
from testudo_tpu.core import commitments as jcom
from testudo_tpu.core import nizk as jnizk
from testudo_tpu.poseidon import transcript as jtr
from testudo_tpu_torch import proofs
from testudo_tpu_torch.core import commitments as com
from testudo_tpu_torch.core import nizk
from testudo_tpu_torch.curves import profile as cprof
from testudo_tpu_torch.fields.bls12_377 import R
from testudo_tpu_torch.poseidon.transcript import PoseidonTranscript, fr_params

torch.set_num_threads(1)

VECTORS = os.path.join(os.path.dirname(__file__), "fixtures", "vectors.json")


def _profile():
    return cprof.bls12_377("cpu", host_groups=True)


def _instance(n: int, seed: int = 3):
    rng = random.Random(seed)
    x = [rng.randrange(R) for _ in range(n)]
    a = [rng.randrange(R) for _ in range(n)]
    y = sum(u * v for u, v in zip(x, a)) % R
    return x, a, y, rng.randrange(R), rng.randrange(R)


def _prove(gens, n, blind_seed=5):
    x, a, y, bx, by = _instance(n)
    proof, Cx, Cy = nizk.dotproduct_prove(gens, PoseidonTranscript(fr_params()), x, bx, a, y,
                                          by, random.Random(blind_seed))
    return dict(proof=proof, Cx=Cx, Cy=Cy, a=a, y=y, by=by)


def _verify(gens, n, run, a=None, Cy=None, proof=None):
    return nizk.dotproduct_verify(proof or run["proof"], n, gens, PoseidonTranscript(fr_params()),
                                  a or run["a"], run["Cx"], Cy or run["Cy"])


@pytest.fixture(scope="module")
def gens8():
    return nizk.DotProductProofGens.new(8, b"test-dot", _profile())


def test_gens_equal_the_fixture():
    with open(VECTORS) as f:
        want = json.load(f)["pedersen_gens_test-gens_2"]
    gens = com.MultiCommitGens.new(2, b"test-gens", _profile())
    assert [[hex(p[0]), hex(p[1])] for p in gens.G + [gens.h]] == want


def test_gens_equal_the_reference():
    port = com.MultiCommitGens.new(8, b"gens_r1cs_eval", _profile())
    ref = jcom.MultiCommitGens.new(8, b"gens_r1cs_eval")
    assert port.G == list(ref.G) and port.h == ref.h
    left, right = port.split_at(5)
    assert (left.n, right.n, left.G + right.G, right.h) == (5, 3, port.G, port.h)


def test_commit_helpers_against_host_sums(gens8):
    pf = _profile()
    x, _, _, bx, _ = _instance(8)
    gn, g1 = gens8.gens_n, gens8.gens_1
    want = None
    for p, s in zip(gn.G + [gn.h], x + [bx]):
        want = pf.g1_add(want, pf.g1_mul(p, s))
    assert com.commit_slice_dev(x, bx, gn) == want
    assert com.commit_scalar(7, 9, g1) == pf.g1_add(pf.g1_mul(g1.G[0], 7), pf.g1_mul(g1.h, 9))
    with pytest.raises(ValueError):
        com.commit_scalar(7, 9, gn)


@pytest.mark.parametrize("n", [1, 8])
def test_dotproduct_accepts_and_rejects(gens8, n):
    gens = gens8 if n == 8 else nizk.DotProductProofGens.new(1, b"test-dot", _profile())
    run = _prove(gens, n)
    assert len(run["proof"].bullet_reduction_proof.L_vec) == n.bit_length() - 1
    assert _verify(gens, n, run) is True
    wrong_y = com.commit_scalar((run["y"] + 1) % R, run["by"], gens.gens_1)
    assert _verify(gens, n, run, Cy=wrong_y) is False
    assert _verify(gens, n, run, a=[(run["a"][0] + 1) % R] + run["a"][1:]) is False
    p = run["proof"]
    bumped = nizk.DotProductProofLog(p.bullet_reduction_proof, p.delta, p.beta, (p.z1 + 1) % R,
                                     p.z2)
    assert _verify(gens, n, run, proof=bumped) is False


def test_dotproduct_codec_round_trip(gens8):
    from testudo_tpu_torch import serialize as ser

    run = _prove(gens8, 8)
    blob = proofs._ser_dotproduct_log(run["proof"])
    # 3 L and 3 R points, delta, beta (48 B compressed each), z1, z2, two lengths
    assert len(blob) == 2 * 8 + 8 * 48 + 2 * 32
    back = proofs._de_dotproduct_log(ser.Reader(blob))
    assert proofs._ser_dotproduct_log(back) == blob
    assert _verify(gens8, 8, run, proof=back) is True


@pytest.mark.slow  # the JAX package's MSMs compile XLA on the CPU (about two minutes)
def test_dotproduct_bytes_equal_the_reference(gens8, monkeypatch):
    run = _prove(gens8, 8, blind_seed=5)
    stream = random.Random(5)
    monkeypatch.setattr(jnizk, "secrets", types.SimpleNamespace(randbelow=stream.randrange))
    jgens = jnizk.DotProductProofGens.new(8, b"test-dot")
    x, a, y, bx, by = _instance(8)
    jproof, jCx, jCy = jnizk.dotproduct_prove(jgens, jtr.PoseidonTranscript(jtr.fr_params()), x,
                                              bx, a, y, by)
    assert proofs._ser_dotproduct_log(run["proof"]) == jproofs._ser_dotproduct_log(jproof)
    assert (run["Cx"], run["Cy"]) == (jCx, jCy)
