"""TestudoNIZK and TestudoSNARK: the public proving API.

Counterpart of testudo_tpu/core/snark.py (itself of Testudo's
src/testudo_nizk.rs and src/testudo_snark.rs):

  - TestudoNIZK: R1CS satisfiability only; the proof is the Spartan R1CS
    proof (core/r1csproof.py) and the verifier evaluates A~, B~, C~(rx, ry)
    itself (suitable for uniform circuits).  `with_groth16=True` also builds
    the verifier circuit's Groth16 keys (`gens_gc`), which the NIZK prover
    never uses, as in the reference.
  - TestudoSNARK: the Spark computation commitment to (A, B, C)
    (`snark_encode`, core/spark.py) and, beside the R1CS proof, Spark's
    proof of A~, B~, C~(rx, ry) (`R1CSEvalProof`), so the verifier checks
    those evaluations instead of computing them.  With `with_groth16=True`
    (the default, as in the reference) the prover also Groth16-proves the
    sumcheck verifier circuit (`r1csproof.prove_verifier`) and the verifier
    checks that proof and the PST + MIPP opening in place of replaying the
    sumchecks; with False, or a proof without its Groth16 part, the verifier
    takes the native branch (full transcript replay, the opening, Spark).

Transcript: the Fr sponge (`PoseidonTranscript(fr_params())`), as in
Testudo's pipeline.  The generators carry the curve profile, and with it
the device every table of a prove lives on (default: CUDA).  The provers
take `fused` (the sumcheck provers, fused by default; looped with False)
and `snark_prove` takes `rng` (the blinds of Spark's dot-product arguments,
then Groth16's r and s, drawn in the reference's order; default
`secrets.SystemRandom()`).  The Timer labels `r1csproof::prove`,
`snark_prove::evaluate A,B,C`, spark.py's and `snark_prove::prove_verifier`
(groth16.py's inside) split a SNARK prove; `snark_verify::sat proof` (the
native branch), `snark_verify::groth16` and `snark_verify::sqrt-PST check`
(the Groth16 branch) and `snark_verify::spark` a verify.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..poseidon.transcript import PoseidonTranscript
from ..utils.timer import Timer
from . import r1cs, r1csproof, spark


@dataclass
class TestudoNizkGens:
    gens_r1cs_sat: r1csproof.R1CSGens
    gens_gc: Optional[r1csproof.CircuitGens] = None

    @staticmethod
    def setup(num_cons: int, num_vars: int, num_inputs: int,
              with_groth16: bool = False, profile=None) -> "TestudoNizkGens":
        """The sqrt-PST key for the padded instance's witness, and with
        `with_groth16` the verifier circuit's Groth16 keys, on `profile`
        (default: BLS12-377 with the CUDA device backends)."""
        nc, nv = r1cs.pad_params(num_cons, num_vars, num_inputs)
        gc = r1csproof.CircuitGens.setup(nc, nv, num_inputs, profile) if with_groth16 else None
        return TestudoNizkGens(r1csproof.R1CSGens.setup(nv, profile=profile), gc)


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
               transcript: PoseidonTranscript, fused: bool = True) -> TestudoNizk:
    """testudo_nizk.rs:80-130 (with the native proof in place of the
    Groth16-wrapped R1CSVerifierProof).  `fused`: the sumcheck provers
    (fused by default, as the reference; looped with False)."""
    _rekey_with_digest(inst, gens, transcript)
    padded = (
        vars_.pad(inst.inst.num_vars)
        if inst.inst.num_vars > len(vars_.assignment)
        else vars_
    )
    proof, rx, ry = r1csproof.prove(
        inst.inst, padded.assignment, inputs.assignment, gens.gens_r1cs_sat,
        transcript, fused,
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


# ---------------------------------------------------------------------------
# TestudoSNARK
# ---------------------------------------------------------------------------


@dataclass
class ComputationCommitment:
    """Spark commitment to (A, B, C) (lib.rs:54-56, r1csinstance.rs:55-88)."""

    num_cons: int
    num_vars: int
    num_inputs: int
    comm: spark.SparseMatPolyCommitment

    def write_to_transcript(self, transcript) -> None:
        transcript.append_u64(self.num_cons)
        transcript.append_u64(self.num_vars)
        transcript.append_u64(self.num_inputs)
        self.comm.write_to_transcript(transcript)


@dataclass
class ComputationDecommitment:
    dense: spark.MultiSparseMatPolynomialAsDense


@dataclass
class R1CSCommitmentGens:
    gens: spark.SparseMatPolyCommitmentGens

    @staticmethod
    def setup(label: bytes, num_cons: int, num_vars: int, num_inputs: int,
              num_nz_entries: int, profile=None) -> "R1CSCommitmentGens":
        if num_inputs >= num_vars:
            raise ValueError(f"{num_inputs} inputs need more than {num_vars} variables")
        num_poly_vars_x = num_cons.bit_length() - 1
        num_poly_vars_y = (2 * num_vars).bit_length() - 1
        return R1CSCommitmentGens(spark.SparseMatPolyCommitmentGens.setup(
            label, num_poly_vars_x, num_poly_vars_y, num_nz_entries, 3, profile))


@dataclass
class R1CSEvalProof:
    proof: spark.SparseMatPolyEvalProof


def r1cs_commit(inst: r1cs.R1CSInstance, gens: R1CSCommitmentGens):
    comm, dense_rep = spark.multi_commit([inst.A, inst.B, inst.C], gens.gens)
    return (
        ComputationCommitment(inst.num_cons, inst.num_vars, inst.num_inputs, comm),
        ComputationDecommitment(dense_rep),
    )


def r1cs_eval_prove(decomm: ComputationDecommitment, rx, ry, evals, gens: R1CSCommitmentGens,
                    transcript, fused: bool = True, rng=None) -> R1CSEvalProof:
    return R1CSEvalProof(
        spark.prove(decomm.dense, rx, ry, list(evals), gens.gens, transcript, fused, rng))


def r1cs_eval_verify(proof: R1CSEvalProof, comm: ComputationCommitment, rx, ry, evals,
                     gens: R1CSCommitmentGens, transcript) -> bool:
    return spark.verify(proof.proof, comm.comm, rx, ry, list(evals), gens.gens, transcript)


@dataclass
class TestudoSnarkGens:
    gens_r1cs_sat: r1csproof.R1CSGens
    gens_r1cs_eval: R1CSCommitmentGens
    gens_gc: Optional[r1csproof.CircuitGens] = None

    @staticmethod
    def setup(num_cons: int, num_vars: int, num_inputs: int, num_nz_entries: int,
              with_groth16: bool = True, profile=None) -> "TestudoSnarkGens":
        """TestudoSnarkGens::setup (testudo_snark.rs:41-90): the sqrt-PST
        key of the padded witness, Spark's generators and, with
        `with_groth16` (the default, as in the reference), the verifier
        circuit's Groth16 keys, on `profile` (default: BLS12-377 on CUDA)."""
        nc, nv = r1cs.pad_params(num_cons, num_vars, num_inputs)
        gc = r1csproof.CircuitGens.setup(nc, nv, num_inputs, profile) if with_groth16 else None
        return TestudoSnarkGens(
            r1csproof.R1CSGens.setup(nv, profile=profile),
            R1CSCommitmentGens.setup(b"gens_r1cs_eval", nc, nv, num_inputs, num_nz_entries,
                                     profile),
            gc,
        )


@dataclass
class TestudoSnark:
    """testudo_snark.rs:23-33: the R1CS proof, Spark's evaluation proof and,
    when the generators hold Groth16 keys, the Groth16-compressed verifier
    proof (None otherwise: the codec writes the empty Option)."""

    r1cs_sat_proof: r1csproof.R1CSProof
    r1cs_eval_proof: R1CSEvalProof
    inst_evals: Tuple[int, int, int]
    r: Tuple[List[int], List[int]]
    r1cs_verifier_proof: Optional[r1csproof.R1CSVerifierProof] = None


def snark_encode(inst: r1cs.Instance, gens: TestudoSnarkGens):
    """TestudoSnark::encode (testudo_snark.rs:100-114): (commitment,
    decommitment), the decommitment's tables on the generators' device."""
    return r1cs_commit(inst.inst, gens.gens_r1cs_eval)


def snark_prove(inst: r1cs.Instance, comm: ComputationCommitment,
                decomm: ComputationDecommitment, vars_: r1cs.Assignment,
                inputs: r1cs.Assignment, gens: TestudoSnarkGens,
                transcript: PoseidonTranscript, fused: bool = True, rng=None) -> TestudoSnark:
    """testudo_snark.rs:120-196."""
    R = gens.gens_r1cs_sat.ck.profile.R  # noqa: N806
    comm.write_to_transcript(transcript)
    c = transcript.challenge_scalar(R)
    transcript.new_from_state(c)

    padded = (
        vars_.pad(inst.inst.num_vars)
        if inst.inst.num_vars > len(vars_.assignment)
        else vars_
    )
    sat_proof, rx, ry = r1csproof.prove(
        inst.inst, padded.assignment, inputs.assignment, gens.gens_r1cs_sat, transcript, fused)

    tev = Timer("snark_prove::evaluate A,B,C")
    Ar, Br, Cr = inst.inst.evaluate(rx, ry, gens.gens_r1cs_sat.ck.profile.device)
    tev.stop()
    transcript.append_scalar(Ar, R)
    transcript.append_scalar(Br, R)
    transcript.append_scalar(Cr, R)

    eval_proof = r1cs_eval_prove(decomm, rx, ry, (Ar, Br, Cr), gens.gens_r1cs_eval, transcript,
                                 fused, rng)

    verifier_proof = None
    if gens.gens_gc is not None:
        # re-key and Groth16-prove the verifier circuit (testudo_snark.rs:176-190)
        transcript.new_from_state(c)
        tgc = Timer("snark_prove::prove_verifier")
        verifier_proof = r1csproof.prove_verifier(
            sat_proof, inst.inst.num_vars, inst.inst.num_cons, inputs.assignment,
            (Ar, Br, Cr), transcript, gens.gens_gc, rng)
        tgc.stop()
    return TestudoSnark(sat_proof, eval_proof, (Ar, Br, Cr), (rx, ry), verifier_proof)


def snark_verify(proof: TestudoSnark, gens: TestudoSnarkGens, comm: ComputationCommitment,
                 inputs: r1cs.Assignment, transcript: PoseidonTranscript) -> bool:
    """testudo_snark.rs:198-235: the Groth16 branch when both the
    generators and the proof have their Groth16 part, the native branch
    otherwise.  The point Spark's proof is checked at must be the sat
    proof's (rx, ry)."""
    R = gens.gens_r1cs_sat.ck.profile.R  # noqa: N806
    comm.write_to_transcript(transcript)
    c = transcript.challenge_scalar(R)
    transcript.new_from_state(c)

    rx, ry = proof.r
    sat = proof.r1cs_sat_proof
    if list(rx) != list(sat.rx) or list(ry) != list(sat.ry):
        return False
    if gens.gens_gc is not None and proof.r1cs_verifier_proof is not None:
        # the Groth16 proof, then the PST + MIPP opening; the transcript is
        # re-keyed at sat_state and advanced through the MIPP absorbs as
        # the prover's was (testudo_snark.rs:209-216)
        sat_ok = r1csproof.verifier_proof_verify(
            proof.r1cs_verifier_proof, (rx, ry), inputs.assignment, proof.inst_evals,
            transcript, gens.gens_gc, gens.gens_r1cs_sat)
    else:
        tsat = Timer("snark_verify::sat proof")
        sat_ok = r1csproof.verify_native(sat, proof.inst_evals, comm.num_cons, comm.num_vars,
                                         inputs.assignment, gens.gens_r1cs_sat, transcript)
        tsat.stop()
    if not sat_ok:
        return False

    Ar, Br, Cr = proof.inst_evals
    transcript.append_scalar(Ar, R)
    transcript.append_scalar(Br, R)
    transcript.append_scalar(Cr, R)
    tev = Timer("snark_verify::spark")
    ok = r1cs_eval_verify(proof.r1cs_eval_proof, comm, rx, ry, proof.inst_evals,
                          gens.gens_r1cs_eval, transcript)
    tev.stop()
    return ok
