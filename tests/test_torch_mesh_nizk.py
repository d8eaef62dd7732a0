"""The slice as a whole on the CPU: TestudoNIZK under the port's mesh
(testudo_tpu_torch/parallel/mesh.py) and the multi-device dry run.

  - The golden instance of tests/fixtures/golden_nizk.json (16 x 16 x 2, seed
    7), proved under a mesh of 4 CPU shards with the host group backends
    (`cprof.bls12_377("cpu", host_groups=True)`: the sumchecks' Fr tables are
    what shards), with the fused and the looped sumcheck: the fixture's bytes
    and both final sponge states, each sumcheck split over the shards.
  - `dryrun_multichip(8, device="cpu")` runs to its end.
Exact: bytes and field elements."""
import json
import os

import pytest
import torch

from testudo_tpu_torch import proofs
from testudo_tpu_torch.core import r1cs, snark
from testudo_tpu_torch.curves import profile as cprof
from testudo_tpu_torch.parallel import dryrun
from testudo_tpu_torch.parallel import mesh as pmesh
from testudo_tpu_torch.poseidon.transcript import PoseidonTranscript, fr_params

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

FIX_PATH = os.path.join(os.path.dirname(__file__), "fixtures", "golden_nizk.json")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "looped"])
def test_golden_proof_under_a_mesh_equals_the_fixture(monkeypatch, fused):
    with open(FIX_PATH) as f:
        fix = json.load(f)
    p = fix["params"]
    splits = []
    real = pmesh.cyclic_split
    monkeypatch.setattr(pmesh, "cyclic_split",
                        lambda mesh, t: splits.append(t.shape[-2]) or real(mesh, t))
    inst, vars_, inputs = r1cs.Instance.produce_synthetic_r1cs(
        p["num_cons"], p["num_vars"], p["num_inputs"], seed=p["seed"])
    gens = snark.TestudoNizkGens.setup(p["num_cons"], p["num_vars"], p["num_inputs"],
                                       profile=cprof.bls12_377("cpu", host_groups=True))
    tp = PoseidonTranscript(fr_params())
    with pmesh.use_mesh(pmesh.make_mesh(["cpu"] * 4)):
        proof = snark.nizk_prove(inst, vars_, inputs, gens, tp, fused=fused)
    assert splits == [p["num_cons"], 32]  # phase one's tables, phase two's z
    blob = proofs.ser_r1cs_proof(proof.r1cs_sat_proof)
    assert blob.hex() == fix["sat_proof_hex"]
    assert [hex(v) for v in tp.sponge.state] == fix["prover_final_sponge_state"]
    tv = PoseidonTranscript(fr_params())
    assert snark.nizk_verify(proof, gens, inst, inputs, tv) is True
    assert [hex(v) for v in tv.sponge.state] == fix["verifier_final_sponge_state"]


def test_dryrun_multichip_runs_on_8_cpu_shards():
    timings = dryrun.dryrun_multichip(8, device="cpu")
    assert set(timings) >= {"prove_single", "prove_sharded", "verify", "msm_sharded_warm",
                            "msm_one_shard_warm", "total"}


def test_dryrun_multichip_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    import inspect

    sig = inspect.signature(dryrun.dryrun_multichip)
    assert sig.parameters["device"].default == torch.device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)
