"""The multi-device dry run: one sharded prover step on a mesh of n shards.

Counterpart of `dryrun_multichip` (__graft_entry__.py:43-247):

  1. a complete small TestudoNIZK prove under `parallel.mesh.use_mesh`
     (the sumchecks' cyclic shards, a round's sums added on the first
     device, local folds; its MSMs and commit are below the sharding
     thresholds), whose sat proof bytes and final sponge state must equal
     the unsharded run's, and which must verify; then warm re-proves of
     both;
  2. the sharded `msm_g1` of 16 n points with 32-bit scalars (one
     pipeline a shard, driven round-robin), equal to `host_curve.g1_msm`,
     and its warm wall beside one shard's.

The phase timings go to standard error, and come back as a dict.  Left out:
the JAX package's environment pins and its write of `vm.max_map_count`
(:69-100), which serve its compiler; this reads and writes nothing outside
its process.

On the card the profile is BLS12-377 on the device (`shard_mesh`: the first
n cards where the machine has them, else the card listed n times).  On the
CPU the profile's groups are the host's, as the JAX package's dry run pins
them (TESTUDO_HOST_CURVE=1), so the sharded work there is the sumchecks'.

    python3 -m testudo_tpu_torch.parallel.dryrun [n_shards]   # on the card
"""
from __future__ import annotations

import random
import sys
import time

import numpy as np
import torch

from .. import proofs
from ..core import r1cs, snark
from ..curves import host_curve as hc
from ..curves import profile as cprof
from ..device import curve as tc
from ..device import msm
from ..fields.bls12_377 import R
from ..poseidon.transcript import PoseidonTranscript, fr_params
from . import mesh as pmesh


def dryrun_multichip(n_shards: int, device=torch.device("cuda")) -> dict:
    """Run the dry run on `n_shards` shards of `device` (see the module's
    docstring); raises on any disagreement.  Returns the timings (s)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device; pass device='cpu' for the CPU")
    mesh = pmesh.shard_mesh(n_shards, device)
    profile = cprof.bls12_377(device, host_groups=device.type != "cuda")
    t_start = time.time()
    timings = {}

    def mark(label, key=None, since=None):
        now = time.time()
        if key is not None:
            timings[key] = now - (t_start if since is None else since)
        print(f"[dryrun +{now - t_start:7.1f}s] {label}", file=sys.stderr, flush=True)
        return now

    # -- 1. the sharded NIZK prove, byte-compared ---------------------------
    ncons = max(16, 2 * n_shards)
    inst, vars_, inputs = r1cs.Instance.produce_synthetic_r1cs(ncons, ncons, 2, seed=7)
    gens = snark.TestudoNizkGens.setup(ncons, ncons, 2, profile=profile)
    t = mark("setup done", "setup")

    def prove(sharded: bool):
        tp = PoseidonTranscript(fr_params())
        with pmesh.use_mesh(mesh if sharded else None):
            proof = snark.nizk_prove(inst, vars_, inputs, gens, tp)
        return proof, proofs.ser_r1cs_proof(proof.r1cs_sat_proof), list(tp.sponge.state)

    _, bytes1, state1 = prove(False)
    t = mark("single-device prove done", "prove_single", t)
    proof2, bytes2, state2 = prove(True)
    if bytes2 != bytes1:
        raise AssertionError("the sharded proof's bytes differ from the single-device proof's")
    if state2 != state1:
        raise AssertionError("the sharded prover ends in another sponge state")
    t = mark(f"sharded prove done on {mesh.size} shards (bytes equal)", "prove_sharded", t)
    if snark.nizk_verify(proof2, gens, inst, inputs, PoseidonTranscript(fr_params())) is not True:
        raise AssertionError("the sharded NIZK proof failed verification")
    t = mark("verify done", "verify", t)
    for key, sharded in (("prove_single_warm", False), ("prove_sharded_warm", True)):
        t0 = time.time()
        prove(sharded)
        timings[key] = time.time() - t0
    mark("warm re-proves done")

    # -- 2. the sharded MSM --------------------------------------------------
    rng = random.Random(5)
    npts = 16 * n_shards
    pts_h = [hc.g1_mul(hc.g1_generator(), rng.randrange(1, R)) for _ in range(npts)]
    scal = [rng.randrange(1 << 32) for _ in range(npts)]
    expected = hc.g1_msm(pts_h, scal)
    pts = tc.g1_from_affine_host(pts_h, device=device)
    # 32-bit scalars as two limbs: the ladder runs 32 bit steps, not 256
    limbs = torch.as_tensor(np.array([[s & 0xFFFF, s >> 16] for s in scal], dtype=np.int32),
                            device=device)

    def sharded_msm():
        with pmesh.use_mesh(mesh):
            return msm.msm_g1(pts, limbs, c=4, device=device)

    t = time.time()
    if sharded_msm() != expected:
        raise AssertionError("the sharded MSM differs from the host MSM")
    t = mark("sharded MSM done (cold, equals the host MSM)", "msm_sharded_cold", t)
    shard_n = npts // n_shards
    pts_s = msm._map_coords(lambda coord: coord[:shard_n], pts)
    msm.msm_g1(pts_s, limbs[:shard_n], c=4, device=device)  # the shape warm
    t0 = time.time()
    msm.msm_g1(pts_s, limbs[:shard_n], c=4, device=device)
    timings["msm_one_shard_warm"] = time.time() - t0
    t0 = time.time()
    if sharded_msm() != expected:
        raise AssertionError("a warm sharded MSM differs from the host MSM")
    timings["msm_sharded_warm"] = time.time() - t0
    mark("warm MSM timing done")

    timings["total"] = time.time() - t_start
    print(f"[dryrun] phase timings (s), {mesh.size} shards on "
          f"{[str(d) for d in mesh.devices]}:", file=sys.stderr)
    for k, v in timings.items():
        print(f"[dryrun]   {k:22s} {v:8.2f}", file=sys.stderr)
    ratio = timings["msm_sharded_warm"] / max(timings["msm_one_shard_warm"], 1e-9)
    print(f"[dryrun] {mesh.size}-shard MSM wall = {ratio:.2f}x one shard's wall", file=sys.stderr,
          flush=True)
    return timings


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
    print("dryrun OK")
