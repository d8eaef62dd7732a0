"""R1CS constraint-system builder and the Spartan verifier circuit.

Counterpart of testudo_tpu/core/circuit.py (itself of Testudo's
src/constraints.rs); host Python, no device.  A small gadget framework
(linear combinations over Fr, one constraint per multiplication) that
synthesizes the R1CSVerificationCircuit: the circuit that replays both
sumcheck phases and the Poseidon transcript, and that core/groth16.py
proves.

The circuit is the reference's constraint for constraint: the same order,
the same linear-combination dicts and values, the same `num_pub`.  The QAP,
and so the Groth16 keys, depend on that order.  The Poseidon gadget mirrors
poseidon/sponge.py operation for operation (the same duplex index machine
and rounds), so in-circuit challenges equal the host Fr transcript's.

Public input order (r1csproof.rs:453-463):
  [initial_state, input..., rx..., ry..., eval_vars_at_ry, Ar, Br, Cr,
   transcript_sat_state].
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from ..fields.bls12_377 import R
from ..poseidon import constants_377 as C


class ConstraintSystem:
    """Groth16-style R1CS: z = [1, public..., witness...], over Fr unless
    `modulus` says otherwise."""

    def __init__(self, modulus: int = R):
        self.modulus = modulus
        self.num_pub = 1  # var 0 == ONE
        self.values: List[int] = [1]
        self.witness_start: int | None = None
        self.constraints: List[Tuple[Dict[int, int], Dict[int, int], Dict[int, int]]] = []

    # -- allocation ---------------------------------------------------------

    def alloc_input(self, value: int) -> "FVar":
        if self.witness_start is not None:
            raise ValueError("inputs must precede witnesses")
        idx = len(self.values)
        self.values.append(value % self.modulus)
        self.num_pub += 1
        return FVar(self, {idx: 1}, value % self.modulus)

    def alloc_witness(self, value: int) -> "FVar":
        if self.witness_start is None:
            self.witness_start = len(self.values)
        idx = len(self.values)
        self.values.append(value % self.modulus)
        return FVar(self, {idx: 1}, value % self.modulus)

    def constant(self, value: int) -> "FVar":
        return FVar(self, {0: value % self.modulus}, value % self.modulus)

    # -- constraints --------------------------------------------------------

    def enforce(self, a: "FVar", b: "FVar", c: "FVar") -> None:
        self.constraints.append((dict(a.lc), dict(b.lc), dict(c.lc)))

    def lincomb(self, terms, const: int = 0) -> "FVar":
        """n-ary linear combination sum(coef * fv) + const, merging all the
        lc dicts in one pass."""
        mod = self.modulus
        lc: Dict[int, int] = {0: const % mod} if const else {}
        val = const
        for coef, fv in terms:
            val += coef * fv.value
            for i, co in fv.lc.items():
                lc[i] = (lc.get(i, 0) + coef * co) % mod
        return FVar(self, lc, val % mod)

    def mul(self, a: "FVar", b: "FVar") -> "FVar":
        out = self.alloc_witness(a.value * b.value % self.modulus)
        self.enforce(a, b, out)
        return out

    def enforce_equal(self, a: "FVar", b: "FVar") -> None:
        # (a - b) * 1 = 0
        self.enforce(a - b, self.constant(1), self.constant(0))

    def is_satisfied(self) -> bool:
        z = self.values
        mod = self.modulus

        def ev(lc):
            return sum(co * z[i] for i, co in lc.items()) % mod

        return all(ev(a) * ev(b) % mod == ev(c) for a, b, c in self.constraints)

    def public_inputs(self) -> List[int]:
        return self.values[1: self.num_pub]


@dataclass
class FVar:
    cs: ConstraintSystem
    lc: Dict[int, int]
    value: int

    def _combine(self, other: "FVar", sign: int) -> "FVar":
        mod = self.cs.modulus
        lc = dict(self.lc)
        for i, co in other.lc.items():
            lc[i] = (lc.get(i, 0) + sign * co) % mod
        return FVar(self.cs, lc, (self.value + sign * other.value) % mod)

    def __add__(self, other):
        if isinstance(other, int):
            other = self.cs.constant(other)
        return self._combine(other, 1)

    def __sub__(self, other):
        if isinstance(other, int):
            other = self.cs.constant(other)
        return self._combine(other, -1)

    def __rsub__(self, other: int):
        return self.cs.constant(other) - self

    def __mul__(self, other):
        if isinstance(other, int):
            mod = self.cs.modulus
            lc = {i: co * other % mod for i, co in self.lc.items()}
            return FVar(self.cs, lc, self.value * other % mod)
        return self.cs.mul(self, other)

    __radd__ = __add__
    __rmul__ = __mul__


# ---------------------------------------------------------------------------
# Poseidon sponge gadget (mirrors poseidon/sponge.py exactly)
# ---------------------------------------------------------------------------


class PoseidonSpongeGadget:
    def __init__(self, cs: ConstraintSystem):
        self.cs = cs
        self.state = [cs.constant(0) for _ in range(C.RATE + C.CAPACITY)]
        self.mode_absorbing = True
        self.index = 0

    def _sbox(self, x: FVar) -> FVar:
        # x^17 = (((x^2)^2)^2)^2 * x  (alpha = 17)
        x2 = self.cs.mul(x, x)
        x4 = self.cs.mul(x2, x2)
        x8 = self.cs.mul(x4, x4)
        x16 = self.cs.mul(x8, x8)
        return self.cs.mul(x16, x)

    def permute(self) -> None:
        mod = self.cs.modulus
        state = list(self.state)
        half = C.FULL_ROUNDS // 2
        total = C.FULL_ROUNDS + C.PARTIAL_ROUNDS
        for rnd in range(total):
            state = [s + (C.ARK[rnd][i] % mod) for i, s in enumerate(state)]
            if rnd < half or rnd >= half + C.PARTIAL_ROUNDS:
                state = [self._sbox(s) for s in state]
            else:
                state[0] = self._sbox(state[0])
            state = [
                self.cs.lincomb([(C.MDS[i][j] % mod, s) for j, s in enumerate(state)])
                for i in range(len(state))
            ]
        self.state = state

    def absorb(self, elems: List[FVar]) -> None:
        if not elems:
            return
        if not self.mode_absorbing or self.index == C.RATE:
            self.permute()
            self.index = 0
        self.mode_absorbing = True
        i = self.index
        for e in elems:
            if i == C.RATE:
                self.permute()
                i = 0
            self.state[C.CAPACITY + i] = self.state[C.CAPACITY + i] + e
            i += 1
        self.index = i

    def squeeze(self, n: int) -> List[FVar]:
        out = []
        if self.mode_absorbing or self.index == C.RATE:
            self.permute()
            self.index = 0
        self.mode_absorbing = False
        i = self.index
        for _ in range(n):
            if i == C.RATE:
                self.permute()
                i = 0
            out.append(self.state[C.CAPACITY + i])
            i += 1
        self.index = i
        return out


class TranscriptGadget:
    """PoseidonTranscripVar (constraints.rs:23-62): a fresh sponge re-keyed
    by absorbing the previous challenge as one element."""

    def __init__(self, cs: ConstraintSystem, c_var: FVar):
        self.sponge = PoseidonSpongeGadget(cs)
        self.sponge.absorb([c_var])

    def append(self, v: FVar) -> None:
        self.sponge.absorb([v])

    def append_vector(self, vs: List[FVar]) -> None:
        for v in vs:
            self.append(v)

    def challenge(self) -> FVar:
        return self.sponge.squeeze(1)[0]

    def challenge_vec(self, n: int) -> List[FVar]:
        return self.sponge.squeeze(n)


# ---------------------------------------------------------------------------
# The Spartan verifier circuit (constraints.rs:262-397)
# ---------------------------------------------------------------------------


def _unipoly_eval(cs: ConstraintSystem, coeffs: List[FVar], r: FVar) -> FVar:
    ev = coeffs[0]
    power = r
    for c in coeffs[1:]:
        ev = ev + cs.mul(power, c)
        power = cs.mul(power, r)
    return ev


def _verify_sumcheck_gadget(cs, transcript: TranscriptGadget,
                            poly_vars: List[List[FVar]], claim: FVar):
    e = claim
    r_vars = []
    for coeffs in poly_vars:
        at_01 = coeffs[0]
        for c in coeffs:
            at_01 = at_01 + c
        cs.enforce_equal(at_01, e)  # G(0) + G(1) == e
        transcript.append_vector(coeffs)
        r_i = transcript.challenge()
        r_vars.append(r_i)
        e = _unipoly_eval(cs, coeffs, r_i)
    return e, r_vars


@dataclass
class VerifierConfig:
    """constraints.rs:400-422: the host values that feed the circuit."""

    num_vars: int
    num_cons: int
    inputs: List[int]
    evals: Tuple[int, int, int]
    prev_challenge: int
    claims_phase2: Tuple[int, int, int, int]
    eval_vars_at_ry: int
    polys_sc1: List[List[int]]  # coefficient lists
    polys_sc2: List[List[int]]
    rx: List[int]
    ry: List[int]
    transcript_sat_state: int


def build_verifier_circuit(config: VerifierConfig) -> ConstraintSystem:
    """Synthesize R1CSVerificationCircuit (generate_constraints,
    constraints.rs:262-397, plus the JAX package's explicit Az * Bz == prod
    constraint); satisfied when the config holds an honest proof's values."""
    cs = ConstraintSystem()

    # inputs, in the verifier's public-input order
    initial = cs.alloc_input(config.prev_challenge)
    input_vars = [cs.alloc_input(v) for v in config.inputs]
    rx_vars = [cs.alloc_input(v) for v in config.rx]
    ry_vars = [cs.alloc_input(v) for v in config.ry]
    eval_vars_at_ry = cs.alloc_input(config.eval_vars_at_ry)
    eA = cs.alloc_input(config.evals[0])
    eB = cs.alloc_input(config.evals[1])
    eC = cs.alloc_input(config.evals[2])
    claimed_state = cs.alloc_input(config.transcript_sat_state)

    transcript = TranscriptGadget(cs, initial)

    poly_sc1 = [[cs.alloc_witness(c) for c in p] for p in config.polys_sc1]
    poly_sc2 = [[cs.alloc_witness(c) for c in p] for p in config.polys_sc2]

    transcript.append_vector(input_vars)

    num_rounds_x = config.num_cons.bit_length() - 1
    tau_vars = transcript.challenge_vec(num_rounds_x)

    claim_phase1 = cs.alloc_witness(0)
    post1, rx_derived = _verify_sumcheck_gadget(cs, transcript, poly_sc1, claim_phase1)
    for rv, claimed in zip(rx_derived, rx_vars):
        cs.enforce_equal(rv, claimed)

    Az, Bz, Cz, prod = config.claims_phase2
    Az_v = cs.alloc_witness(Az)
    Bz_v = cs.alloc_witness(Bz)
    Cz_v = cs.alloc_witness(Cz)
    prod_v = cs.alloc_witness(prod)
    cs.enforce(Az_v, Bz_v, prod_v)

    taus_bound = cs.constant(1)
    for rv, tv in zip(rx_derived, tau_vars):
        term = cs.mul(rv, tv) + cs.mul(1 - rv, 1 - tv)
        taus_bound = cs.mul(taus_bound, term)
    expected_post1 = cs.mul(prod_v - Cz_v, taus_bound)
    cs.enforce_equal(post1, expected_post1)

    r_A = transcript.challenge()
    r_B = transcript.challenge()
    r_C = transcript.challenge()
    claim_phase2 = cs.mul(r_A, Az_v) + cs.mul(r_B, Bz_v) + cs.mul(r_C, Cz_v)

    post2, ry_derived = _verify_sumcheck_gadget(cs, transcript, poly_sc2, claim_phase2)
    for rv, claimed in zip(ry_derived, ry_vars):
        cs.enforce_equal(rv, claimed)

    # the sparse input polynomial at ry[1:] (constraints.rs:366-372)
    nv_log = config.num_vars.bit_length() - 1
    entries = [(0, cs.constant(1))] + [(i + 1, iv) for i, iv in enumerate(input_vars)]
    poly_input_eval = cs.constant(0)
    for idx, val_var in entries:
        chi = cs.constant(1)
        for j in range(nv_log):
            bit = (idx >> (nv_log - j - 1)) & 1
            term = ry_derived[1 + j] if bit else (1 - ry_derived[1 + j])
            chi = cs.mul(chi, term)
        poly_input_eval = poly_input_eval + cs.mul(chi, val_var)

    eval_Z = cs.mul(1 - ry_derived[0], eval_vars_at_ry) + cs.mul(ry_derived[0], poly_input_eval)
    scalar = cs.mul(r_A, eA) + cs.mul(r_B, eB) + cs.mul(r_C, eC)
    expected_post2 = cs.mul(eval_Z, scalar)
    cs.enforce_equal(post2, expected_post2)

    expected_state = transcript.challenge()
    cs.enforce_equal(expected_state, claimed_state)
    return cs
