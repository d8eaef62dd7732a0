"""Spartan R1CS satisfiability proof (two-phase sumcheck + sqrt-PST).

Counterpart of testudo_tpu/core/r1csproof.py (itself of Testudo's
src/r1csproof.rs).  The prover flow mirrors R1CSProof::prove
(r1csproof.rs:237-370):

  commit witness (sqrt-PST)  -> absorb T           (:255-257)
  initial_state challenge + transcript re-key      (:261-262)
  absorb inputs                                    (:264)
  z = vars || 1 || inputs || 0-pad                 (:269-277)
  tau challenges, phase-1 cubic sumcheck           (:281-299)
  r_A/r_B/r_C, ABC eval table, phase-2 quad        (:311-336)
  transcript_sat_state checkpoint + re-key         (:338-339)
  sqrt-PST open at ry[1..]                         (:343-344)

The transcript is re-keyed with `new_from_state` everywhere, as the JAX
package resolves Testudo's inconsistent new_from_state2 at r1csproof.rs:262
(its RECORDED DIVERGENCE, core/r1csproof.py there).

`verify_native` is the full native verification with the PST + MIPP
opening check enabled (the snapshot's R1CSVerifierProof::verify has it
commented out, r1csproof.rs:465-485; the JAX package does not reproduce
that, nor does this one).

The prover's tables live on the device of the generators' curve profile;
both sumcheck phases take the provers the profile names
(`CurveProfile.fused_sumcheck`: fused over BLS12-377, looped over
BLS12-381, as the JAX package), unless `prove(..., fused=...)` asks for
the other kind (core/sumcheck.py); the transcript is re-keyed with the
profile's scalar modulus; the `Timer` labels (`polycommit (sqrt-PST)`, `prove_sc_phase_one`,
`prove_sc_phase_two`, `polyeval (sqrt-PST open)`) split a prove.

The Groth16 half (r1csproof.rs:67-152, 374-487): `CircuitGens` holds the
Groth16 keys of the verifier circuit (core/circuit.py) for an instance's
shape; `prove_verifier` proves that circuit on an honest R1CS proof's
values (`R1CSVerifierProof`), and `verifier_proof_verify` checks the
Groth16 proof, then the sqrt-PST opening, which the Rust snapshot comments
out and the JAX package keeps.  Timer labels: `groth16::circuit build`
(the circuit and its satisfiability check), `snark_verify::groth16`,
`snark_verify::sqrt-PST check`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..device import field as tf
from ..fields.host import Fq12
from ..poly import dense
from ..utils.timer import Timer
from . import groth16, pst, sqrt_pst, sumcheck
from .circuit import VerifierConfig, build_verifier_circuit
from .mipp import MippProof
from .r1cs import R1CSInstance


@dataclass
class R1CSProof:
    comm_U: object  # host affine G1 (the opening commitment U)
    sc_proof_phase1: sumcheck.SumcheckInstanceProof
    claims_phase2: Tuple[int, int, int, int]  # Az, Bz, Cz, Az*Bz
    sc_proof_phase2: sumcheck.SumcheckInstanceProof
    eval_vars_at_ry: int
    proof_eval_vars_at_ry: List  # PST proofs
    rx: List[int]
    ry: List[int]
    transcript_sat_state: int
    initial_state: int
    t: Fq12
    mipp_proof: MippProof


@dataclass
class R1CSGens:
    ck: pst.CommitterKey
    vk: pst.VerifierKey

    @staticmethod
    def setup(num_vars: int, profile=None) -> "R1CSGens":
        """PolyCommitmentGens::setup equivalent: SRS over num_vars/2 + odd
        variables (dense_mlpoly.rs:185-198), on `profile` (default: the
        BLS12-377 profile on the CUDA device)."""
        nv = num_vars.bit_length() - 1
        ck, vk = pst.setup(nv // 2 + (nv % 2), profile=profile)
        return R1CSGens(ck, vk)


def prove(
    inst: R1CSInstance,
    vars_: List[int],
    inputs: List[int],
    gens: R1CSGens,
    transcript,
    fused: Optional[bool] = None,
) -> Tuple[R1CSProof, List[int], List[int]]:
    """R1CSProof::prove; `fused` picks the sumcheck provers (fused or
    looped: the same proof; None, the default, takes the profile's)."""
    if len(inputs) >= len(vars_):
        raise ValueError(f"{len(inputs)} inputs need more than {len(vars_)} variables")
    profile = gens.ck.profile
    spec = profile.fr_spec
    R = profile.R  # noqa: N806 — scalar modulus of the active curve
    dev = profile.device
    if fused is None:
        fused = profile.fused_sumcheck

    tm = Timer("r1csproof::prove")
    t_c = Timer("polycommit (sqrt-PST)")
    vars_table = dense.encode_table(vars_, spec, dev)
    pl = sqrt_pst.Polynomial.from_evaluations(vars_table, profile)
    comm_dev, t = pl.commit(gens.ck)
    t_c.stop()
    transcript.append_bytes(profile.ser_gt(t))

    initial_state = transcript.challenge_scalar(R)
    transcript.new_from_state(initial_state, R)
    transcript.append_scalar_vector(inputs, R)

    z = inst.z_vector(vars_, inputs)
    z_dev = dense.encode_table(z, spec, dev)

    num_rounds_x = inst.num_cons.bit_length() - 1
    num_rounds_y = len(z).bit_length() - 1

    tau = transcript.challenge_scalar_vec(R, num_rounds_x)
    poly_tau = dense.eq_evals(tau, spec, dev)
    poly_Az, poly_Bz, poly_Cz = inst.multiply_vec_dev(z_dev)

    t_p1 = Timer("prove_sc_phase_one")
    sc1, rx, claims1 = sumcheck.prove_cubic_with_additive_term(
        0, num_rounds_x, poly_tau, poly_Az, poly_Bz, poly_Cz, transcript, spec, fused=fused,
    )
    t_p1.stop()
    _tau_claim, Az_claim, Bz_claim, Cz_claim = claims1
    prod_Az_Bz = Az_claim * Bz_claim % R

    r_A = transcript.challenge_scalar(R)
    r_B = transcript.challenge_scalar(R)
    r_C = transcript.challenge_scalar(R)
    claim_phase2 = (r_A * Az_claim + r_B * Bz_claim + r_C * Cz_claim) % R

    evals_rx = dense.eq_evals(rx, spec, dev)
    eA, eB, eC = inst.compute_eval_table_sparse(evals_rx, len(z))
    rA_d, rB_d, rC_d = (dense.encode_scalar(r, spec, dev) for r in (r_A, r_B, r_C))
    evals_ABC = tf.add(
        spec,
        tf.add(spec, tf.mont_mul(spec, eA, rA_d), tf.mont_mul(spec, eB, rB_d)),
        tf.mont_mul(spec, eC, rC_d),
    )

    t_p2 = Timer("prove_sc_phase_two")
    sc2, ry, _claims2 = sumcheck.prove_quad(
        claim_phase2, num_rounds_y, z_dev, evals_ABC, transcript, spec, fused=fused
    )
    t_p2.stop()

    transcript_sat_state = transcript.challenge_scalar(R)
    transcript.new_from_state(transcript_sat_state, R)

    t_o = Timer("polyeval (sqrt-PST open)")
    comm_U, pst_proof, mipp_proof = pl.open(transcript, comm_dev, gens.ck, ry[1:], t)
    eval_vars_at_ry = pl.eval(ry[1:])
    t_o.stop()

    proof = R1CSProof(
        comm_U=comm_U,
        sc_proof_phase1=sc1,
        claims_phase2=(Az_claim, Bz_claim, Cz_claim, prod_Az_Bz),
        sc_proof_phase2=sc2,
        eval_vars_at_ry=eval_vars_at_ry,
        proof_eval_vars_at_ry=pst_proof,
        rx=rx,
        ry=ry,
        transcript_sat_state=transcript_sat_state,
        initial_state=initial_state,
        t=t,
        mipp_proof=mipp_proof,
    )
    tm.stop()
    return proof, rx, ry


def _sparse_input_poly_eval(inputs: List[int], ry_rest: List[int],
                            num_vars_log: int, modulus: int) -> int:
    """Evaluate the sparse input polynomial (const 1 at index 0, inputs at
    1..) at ry[1:] (r1csproof.rs:390-398, constraints.rs:144-215)."""
    entries = [(0, 1)] + [(i + 1, v) for i, v in enumerate(inputs)]
    acc = 0
    for i, val in entries:
        chi = 1
        for j in range(num_vars_log):
            bit = (i >> (num_vars_log - j - 1)) & 1
            chi = chi * (ry_rest[j] if bit else (1 - ry_rest[j])) % modulus
        acc = (acc + val * chi) % modulus
    return acc


def verify_native(
    proof: R1CSProof,
    inst_evals: Tuple[int, int, int],
    num_cons: int,
    num_vars: int,
    inputs: List[int],
    gens: R1CSGens,
    transcript,
) -> bool:
    """Full native verification: transcript replay of both sumcheck phases,
    the final Z(ry) identity, and the sqrt-PST/MIPP opening check
    (the protocol checks that R1CSVerificationCircuit + Polynomial::verify
    perform; constraints.rs:262-397 and sqrt_pst.rs:232-264).  A sumcheck
    that fails a round check or its degree bound makes it return False."""
    profile = gens.ck.profile
    R = profile.R  # noqa: N806
    transcript.append_bytes(profile.ser_gt(proof.t))
    initial_state = transcript.challenge_scalar(R)
    if initial_state != proof.initial_state:
        return False
    transcript.new_from_state(initial_state, R)
    transcript.append_scalar_vector(inputs, R)

    num_rounds_x = num_cons.bit_length() - 1
    num_rounds_y = (2 * num_vars).bit_length() - 1

    tau = transcript.challenge_scalar_vec(R, num_rounds_x)

    try:
        # phase 1: claim 0, degree 3
        e1, rx = proof.sc_proof_phase1.verify(0, num_rounds_x, 3, transcript)
        if rx != proof.rx:
            return False
        Az, Bz, Cz, prod = proof.claims_phase2
        if prod != Az * Bz % R:
            return False
        taus_bound_rx = dense.eq_evaluate(tau, rx, R)
        if (Az * Bz - Cz) % R * taus_bound_rx % R != e1 % R:
            return False

        r_A = transcript.challenge_scalar(R)
        r_B = transcript.challenge_scalar(R)
        r_C = transcript.challenge_scalar(R)
        claim_phase2 = (r_A * Az + r_B * Bz + r_C * Cz) % R

        e2, ry = proof.sc_proof_phase2.verify(claim_phase2, num_rounds_y, 2, transcript)
    except sumcheck.SumcheckError:
        return False
    if ry != proof.ry:
        return False

    # Z~(ry) = (1 - ry0) * eval_vars + ry0 * input_poly(ry[1:])
    nv_log = num_vars.bit_length() - 1
    input_eval = _sparse_input_poly_eval(inputs, ry[1:], nv_log, R)
    z_eval = ((1 - ry[0]) * proof.eval_vars_at_ry + ry[0] * input_eval) % R
    Ar, Br, Cr = inst_evals
    if (r_A * Ar + r_B * Br + r_C * Cr) % R * z_eval % R != e2 % R:
        return False

    sat_state = transcript.challenge_scalar(R)
    if sat_state != proof.transcript_sat_state:
        return False
    transcript.new_from_state(sat_state)

    # sqrt-PST / MIPP opening check (enabled, unlike the gutted fork verify)
    return sqrt_pst.verify(
        transcript,
        gens.vk,
        proof.comm_U,
        proof.ry[1:],
        proof.eval_vars_at_ry,
        proof.proof_eval_vars_at_ry,
        proof.mipp_proof,
        proof.t,
    )


# ---------------------------------------------------------------------------
# Groth16-compressed verification (CircuitGens / prove_verifier /
# R1CSVerifierProof: r1csproof.rs:67-152, 374-487)
# ---------------------------------------------------------------------------


@dataclass
class CircuitGens:
    """Groth16 keys for the Spartan verifier circuit, from a dummy circuit
    of the right shape (CircuitGens::setup, r1csproof.rs:80-151: the
    constraint matrices depend only on dimensions, not on values)."""

    pk: groth16.ProvingKey
    vk: groth16.VerifyingKey

    @staticmethod
    def setup(num_cons: int, num_vars: int, num_inputs: int, profile=None) -> "CircuitGens":
        """Keys on `profile` (default: BLS12-377 on the CUDA device)."""
        tb = Timer("groth16::circuit build")
        cs = build_verifier_circuit(dummy_verifier_config(num_cons, num_vars, num_inputs))
        tb.stop()
        pk, vk = groth16.setup(cs, profile=profile)
        return CircuitGens(pk, vk)


def dummy_verifier_config(num_cons: int, num_vars: int, num_inputs: int) -> VerifierConfig:
    """All-ones values in the shape of an instance's proof: the circuit
    CircuitGens keys (r1csproof.rs:80-151)."""
    nx = num_cons.bit_length() - 1
    ny = (2 * num_vars).bit_length() - 1
    return VerifierConfig(
        num_vars=num_vars,
        num_cons=num_cons,
        inputs=[1] * num_inputs,
        evals=(1, 1, 1),
        prev_challenge=1,
        claims_phase2=(1, 1, 1, 1),
        eval_vars_at_ry=1,
        polys_sc1=[[1, 1, 1, 1] for _ in range(nx)],
        polys_sc2=[[1, 1, 1] for _ in range(ny)],
        rx=[1] * nx,
        ry=[1] * ny,
        transcript_sat_state=1,
    )


def verifier_config(proof: R1CSProof, num_vars: int, num_cons: int, inputs: List[int],
                    evals: Tuple[int, int, int]) -> VerifierConfig:
    """The circuit's values for an R1CS proof (r1csproof.rs:400-422)."""
    return VerifierConfig(
        num_vars=num_vars,
        num_cons=num_cons,
        inputs=list(inputs),
        evals=tuple(evals),
        prev_challenge=proof.initial_state,
        claims_phase2=proof.claims_phase2,
        eval_vars_at_ry=proof.eval_vars_at_ry,
        polys_sc1=[p.coeffs for p in proof.sc_proof_phase1.polys],
        polys_sc2=[p.coeffs for p in proof.sc_proof_phase2.polys],
        rx=proof.rx,
        ry=proof.ry,
        transcript_sat_state=proof.transcript_sat_state,
    )


@dataclass
class R1CSVerifierProof:
    """r1csproof.rs:55-65."""

    comm_U: object
    circuit_proof: groth16.Proof
    initial_state: int
    transcript_sat_state: int
    eval_vars_at_ry: int
    proof_eval_vars_at_ry: List
    t: Fq12
    mipp_proof: MippProof


def prove_verifier(
    proof: R1CSProof,
    num_vars: int,
    num_cons: int,
    inputs: List[int],
    evals: Tuple[int, int, int],
    transcript,
    circuit_gens: CircuitGens,
    rng=None,
) -> R1CSVerifierProof:
    """Groth16-prove the sumcheck verifier circuit (r1csproof.rs:374-434).
    `transcript` stands where `prove` took it up (re-keyed at the SNARK's
    challenge): it re-derives the initial state, which must be the proof's.
    `rng`: Groth16's r and s (default `secrets.SystemRandom()`)."""
    pf = circuit_gens.pk.profile
    transcript.append_bytes(pf.ser_gt(proof.t))
    initial_state = transcript.challenge_scalar(pf.R)
    if initial_state != proof.initial_state:
        raise ValueError("the transcript re-derives another initial state than the proof's")
    transcript.new_from_state(initial_state)

    config = verifier_config(proof, num_vars, num_cons, inputs, evals)
    tb = Timer("groth16::circuit build")
    cs = build_verifier_circuit(config)
    satisfied = cs.is_satisfied()
    tb.stop()
    if not satisfied:
        raise ValueError("the verifier circuit is not satisfied by the proof's values")
    circuit_proof = groth16.prove(circuit_gens.pk, cs, rng)
    return R1CSVerifierProof(
        comm_U=proof.comm_U,
        circuit_proof=circuit_proof,
        initial_state=proof.initial_state,
        transcript_sat_state=proof.transcript_sat_state,
        eval_vars_at_ry=proof.eval_vars_at_ry,
        proof_eval_vars_at_ry=proof.proof_eval_vars_at_ry,
        t=proof.t,
        mipp_proof=proof.mipp_proof,
    )


def verifier_proof_verify(
    vproof: R1CSVerifierProof,
    r: Tuple[List[int], List[int]],
    inputs: List[int],
    evals: Tuple[int, int, int],
    transcript,
    circuit_gens: CircuitGens,
    gens: R1CSGens,
) -> bool:
    """R1CSVerifierProof::verify with the PST + MIPP opening check enabled
    (r1csproof.rs:443-487; the snapshot comments the opening check out and
    returns Ok(true), which is not reproduced)."""
    rx, ry = r
    Ar, Br, Cr = evals
    pubs = [vproof.initial_state, *inputs, *rx, *ry,
            vproof.eval_vars_at_ry, Ar, Br, Cr, vproof.transcript_sat_state]
    tg = Timer("snark_verify::groth16")
    ok = groth16.verify(circuit_gens.vk, pubs, vproof.circuit_proof)
    tg.stop()
    if not ok:
        return False

    transcript.new_from_state(vproof.transcript_sat_state)
    tp = Timer("snark_verify::sqrt-PST check")
    ok = sqrt_pst.verify(
        transcript,
        gens.vk,
        vproof.comm_U,
        ry[1:],
        vproof.eval_vars_at_ry,
        vproof.proof_eval_vars_at_ry,
        vproof.mipp_proof,
        vproof.t,
    )
    tp.stop()
    return ok
