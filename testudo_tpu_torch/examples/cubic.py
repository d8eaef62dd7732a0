"""The canonical cubic-equation example on the port: prove knowledge of x
such that x^3 + x + 5 = y, with TestudoSNARK and its Groth16-compressed
verifier (config #1).

Counterpart of examples/cubic.py (itself of Testudo's examples/cubic.rs):
four constraints over (Z0..Z3, I0):

    Z0 * Z0 - Z1 = 0        (Z1 = x^2)
    Z1 * Z0 - Z2 = 0        (Z2 = x^3)
    (Z2 + Z0) * 1 - Z3 = 0  (Z3 = x^3 + x)
    (Z3 + 5) * 1 - I0 = 0   (I0 = y)

Run on the GPU: python3 -m testudo_tpu_torch.examples.cubic
"""
from __future__ import annotations

import random
import sys
import time

import torch

from .. import proofs
from .. import serialize as ser
from ..core import r1cs, snark
from ..curves import profile as cprof
from ..fields.bls12_377 import R
from ..poseidon.transcript import PoseidonTranscript, fr_params

NUM_CONS, NUM_VARS, NUM_INPUTS, NUM_NZ = 4, 4, 1, 8


def produce_cubic_r1cs(x: int = 3):
    """(instance, variables, inputs) of the cubic circuit at x."""
    one = ser.fr_to_bytes(1)
    five = ser.fr_to_bytes(5)
    # (row, col, value bytes); columns: vars 0..3, ONE at num_vars, inputs after it
    A = [(0, 0, one), (1, 1, one), (2, 2, one), (2, 0, one), (3, 3, one), (3, 4, five)]
    B = [(0, 0, one), (1, 0, one), (2, 4, one), (3, 4, one)]
    C = [(0, 1, one), (1, 2, one), (2, 3, one), (3, 5, one)]
    inst = r1cs.Instance.new(NUM_CONS, NUM_VARS, NUM_INPUTS, A, B, C)
    z1 = x * x % R
    z2 = z1 * x % R
    z3 = (z2 + x) % R
    y = (z3 + 5) % R
    vars_ = r1cs.Assignment([x, z1, z2, z3])
    inputs = r1cs.Assignment([y])
    if not inst.is_sat(vars_, inputs):
        raise AssertionError("the cubic instance is not satisfied")
    return inst, vars_, inputs


def run(profile, rng=None, say=print) -> dict:
    """Setup (with the Groth16 keys), encode, prove, verify on `profile`;
    the verifier must accept the proof and its bytes read back, and reject
    a wrong public input.  Returns the parts and the seconds of each step."""
    inst, vars_, inputs = produce_cubic_r1cs()
    times = {}
    t0 = time.perf_counter()
    gens = snark.TestudoSnarkGens.setup(NUM_CONS, NUM_VARS, NUM_INPUTS, NUM_NZ,
                                        with_groth16=True, profile=profile)
    times["setup"] = time.perf_counter() - t0
    comm, decomm = snark.snark_encode(inst, gens)
    t0 = time.perf_counter()
    proof = snark.snark_prove(inst, comm, decomm, vars_, inputs, gens,
                              PoseidonTranscript(fr_params()), rng=rng)
    times["prove"] = time.perf_counter() - t0
    blob = proofs.ser_testudo_snark(proof)

    def verify(p, ins):
        return snark.snark_verify(p, gens, comm, ins, PoseidonTranscript(fr_params()))

    t0 = time.perf_counter()
    ok = verify(proof, inputs)
    times["verify"] = time.perf_counter() - t0
    if ok is not True or proof.r1cs_verifier_proof is None:
        raise AssertionError("the cubic proof was rejected")
    if verify(proofs.parse_testudo_snark(blob), inputs) is not True:
        raise AssertionError("the cubic proof read back from its bytes was rejected")
    wrong = r1cs.Assignment([(inputs.assignment[0] + 1) % R])
    if verify(proof, wrong) is not False:
        raise AssertionError("the cubic proof was accepted for y + 1")
    gk = gens.gens_gc.pk
    say(f"cubic (x^3 + x + 5 = y at x = 3): Groth16 circuit of {gk.num_vars} variables, "
        f"domain 2^{gk.domain_log}; proof {len(blob)} B, verified, y + 1 rejected; setup "
        f"{times['setup']:.2f} s, prove {times['prove']:.2f} s, verify {times['verify']:.2f} s")
    return dict(gens=gens, comm=comm, inputs=inputs, proof=proof, blob=blob, times=times)


def main() -> int:
    if not torch.cuda.is_available():
        print("cubic: no CUDA device; this example runs on the GPU", file=sys.stderr)
        return 1
    run(cprof.bls12_377("cuda"), random.Random(1))
    print("cubic SNARK verified")
    return 0


if __name__ == "__main__":
    sys.exit(main())
