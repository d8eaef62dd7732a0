"""TestudoNIZK: the public proving API for R1CS satisfiability.

Counterpart of the NIZK half of testudo_tpu/core/snark.py (itself of
Testudo's src/testudo_nizk.rs): the proof is the Spartan R1CS proof
(core/r1csproof.py), and the verifier evaluates A~, B~, C~(rx, ry) itself
(suitable for uniform circuits).  The SNARK half (Spark's computation
commitment, TestudoSNARK) and the Groth16-compressed verifier are not
ported yet.

Transcript: the Fr sponge (`PoseidonTranscript(fr_params())`), as in
Testudo's pipeline.  The generators carry the curve profile, and with it
the device every table of a prove lives on (default: CUDA).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from ..poseidon.transcript import PoseidonTranscript
from ..utils.timer import Timer
from . import r1cs, r1csproof


@dataclass
class TestudoNizkGens:
    gens_r1cs_sat: r1csproof.R1CSGens

    @staticmethod
    def setup(num_cons: int, num_vars: int, num_inputs: int,
              with_groth16: bool = False, profile=None) -> "TestudoNizkGens":
        """The sqrt-PST key for the padded instance's witness, on `profile`
        (default: BLS12-377 with the CUDA device backends)."""
        if with_groth16:
            raise NotImplementedError(
                "the Groth16-compressed verifier is not ported yet (ROADMAP A.3, the SNARK)")
        _, nv = r1cs.pad_params(num_cons, num_vars, num_inputs)
        return TestudoNizkGens(r1csproof.R1CSGens.setup(nv, profile=profile))


@dataclass
class TestudoNizk:
    r1cs_sat_proof: r1csproof.R1CSProof
    r: Tuple[List[int], List[int]]


def _rekey_with_digest(inst: r1cs.Instance, gens: TestudoNizkGens,
                       transcript: PoseidonTranscript) -> None:
    transcript.append_bytes(inst.digest)
    c = transcript.challenge_scalar(gens.gens_r1cs_sat.ck.profile.R)
    transcript.new_from_state(c)


def nizk_prove(inst: r1cs.Instance, vars_: r1cs.Assignment,
               inputs: r1cs.Assignment, gens: TestudoNizkGens,
               transcript: PoseidonTranscript) -> TestudoNizk:
    """testudo_nizk.rs:80-130 (with the native proof in place of the
    Groth16-wrapped R1CSVerifierProof)."""
    _rekey_with_digest(inst, gens, transcript)
    padded = (
        vars_.pad(inst.inst.num_vars)
        if inst.inst.num_vars > len(vars_.assignment)
        else vars_
    )
    proof, rx, ry = r1csproof.prove(
        inst.inst, padded.assignment, inputs.assignment, gens.gens_r1cs_sat,
        transcript,
    )
    return TestudoNizk(proof, (rx, ry))


def nizk_verify(proof: TestudoNizk, gens: TestudoNizkGens, inst: r1cs.Instance,
                inputs: r1cs.Assignment, transcript: PoseidonTranscript) -> bool:
    """testudo_nizk.rs:136-157: the verifier evaluates A, B, C itself, on
    the device of the generators' profile."""
    _rekey_with_digest(inst, gens, transcript)
    rx, ry = proof.r
    tev = Timer("nizk_verify::evaluate A,B,C")
    inst_evals = inst.inst.evaluate(rx, ry, gens.gens_r1cs_sat.ck.profile.device)
    tev.stop()
    return r1csproof.verify_native(
        proof.r1cs_sat_proof, inst_evals, inst.inst.num_cons,
        inst.inst.num_vars, inputs.assignment, gens.gens_r1cs_sat, transcript,
    )
