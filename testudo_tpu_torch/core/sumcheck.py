"""Sumcheck protocol: fused and looped provers over device tables + host
verifier.

Counterpart of testudo_tpu/core/sumcheck.py (itself of Testudo's
src/sumcheck.rs).  Tables are `(n, nlimbs)` int32 Montgomery limb tensors.

The fused provers (`_prove_fused`, `_prove_cubic_batched_fused`; the
reference's `_fused_prover_fn` :222-267 and `_fused_batched_fn` :534-594)
are the default, as in the reference: the whole sumcheck stays on the
device and ends in ONE copy to the host (coefficients, challenges, final
claims and sponge state).  Per round, one launch of the round kernel (the
fold of every table by the previous challenge and the round's sums,
csrc/sumcheck_round.cu), one of the Poseidon kernel where the absorb starts
with a permutation of the state alone (csrc/poseidon.cu), and one of the
tail kernel (sums, coefficients, transcript, next claim,
csrc/sumcheck_tail.cu); the sponge's mode machine is replayed in Python
(`_simulate_schedule`).  On CPU tensors the same code runs the kernels'
plain versions (device/sumcheck_kernels.py, which also holds the
reference's `_unipoly_coeffs_dev` and `_horner_dev`; device/sponge.py).

The fused provers exist over BLS12-377's Fr only (the sponge's kernels hold
that curve's Poseidon constants; the round kernel is built for its Fr): a
prover asked to fuse over another field raises.  BLS12-381's R1CS proof
takes the looped provers, as its profile says (curves/profile.py).

The looped provers (`fused=False`, and `num_rounds = 0`) compute each
round's evaluations on the device, pull them to the host in one copy,
absorb the coefficients into the host transcript, squeeze one challenge,
upload it and fold every table with `poly.dense.bound_top`.  Every product
goes through `device.field.mont_mul` (the row-major kernel on CUDA).

Transcript behaviour matches the reference: every round polynomial
coefficient is absorbed with append_scalar (sumcheck.rs:127-129, 423-425)
and one challenge is squeezed per round; every prover works with an Fr- or
an Fq-sponge transcript.  There is no environment switch: the prover is
chosen by the keyword `fused`.

Under a mesh (parallel/mesh.py `use_mesh`) `prove_cubic_with_additive_term`,
`prove_quad` and `prove_cubic` shard their Fr tables cyclically over the
mesh's devices, as the reference does at :643-760 (`_sharded_mesh_for`,
:399-410): `_prove_fused` with a mesh is the reference's
`_prove_fused_sharded` (:293-396) on the same three kernels (a round launch
a shard; the shards' partials concatenated along the blocks axis on the
mesh's first device, where the permutation and the tail run), and
`_prove_looped` with a mesh its `_prove_looped_sharded` (:466-520: each
shard's evaluations, summed on the first device; the transcript on the
host).  Once a shard holds one row, the D rows are gathered on the first
device for the last log2 D rounds.  Proofs, challenges, final values and
sponge states are the unsharded prover's.  Tables over BLS12-381's Fr and
`prove_cubic_batched` stay unsharded, as in the reference.

`prove_cubic_batched` is Spark's prover: every layer of its product trees
(core/product_tree.py) is one batched cubic sumcheck, fused (the round
kernel's `cubic` kind) unless `fused=False`; `prove_cubic` is its
single-instance form, on no path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..device import field as tf
from ..device import sponge as dsponge
from ..device import sumcheck_kernels as sk
from ..device.field import FR
from ..parallel import mesh as pmesh
from ..poly import dense
from ..poly.unipoly import UniPoly
from ..poseidon import constants_377 as PC


class SumcheckError(ValueError):
    """A sumcheck proof failed a round check or the degree bound."""


@dataclass
class SumcheckInstanceProof:
    polys: List[UniPoly]

    def verify(self, claim: int, num_rounds: int, degree_bound: int, transcript):
        """Host verifier (sumcheck.rs:29-63).  Returns (final_eval, r);
        raises SumcheckError on a wrong number of rounds, a round polynomial
        of another degree, or a failed round check."""
        m = self.polys[0].modulus if self.polys else FR.modulus
        e = claim % m
        r: List[int] = []
        if len(self.polys) != num_rounds:
            raise SumcheckError(f"{len(self.polys)} round polynomials, expected {num_rounds}")
        for poly in self.polys:
            if poly.degree() != degree_bound:
                raise SumcheckError(f"round polynomial of degree {poly.degree()}, "
                                    f"expected {degree_bound}")
            if (poly.eval_at_zero() + poly.eval_at_one()) % m != e:
                raise SumcheckError("sumcheck round check failed")
            poly.write_to_transcript(transcript)
            r_i = transcript.challenge_scalar(m)
            r.append(r_i)
            e = poly.evaluate(r_i)
        return e, r


# -- round evaluations ------------------------------------------------------


def _halves(tables: Sequence[torch.Tensor]):
    n = tables[0].shape[0] // 2
    return [x[:n] for x in tables], [x[n:] for x in tables]


def _at_two_three(spec, los, his, three: bool):
    """The tables' lines through (lo, hi) at X = 2 (2 hi - lo) and X = 3
    (the X = 2 value plus hi - lo)."""
    p2 = [tf.sub(spec, tf.add(spec, h, h), l) for l, h in zip(los, his)]
    if not three:
        return p2, None
    p3 = [tf.add(spec, x2, tf.sub(spec, h, l)) for x2, l, h in zip(p2, los, his)]
    return p2, p3


def _round_evals_cubic_tau_s(spec, tau, A, B, C) -> torch.Tensor:
    """Evals at {0, 2, 3} of sum_i tau(X, i) (A(X, i) B(X, i) - C(X, i)),
    stacked (3, nlimbs)."""

    def comb(t, a, b, c):
        return tf.mont_mul(spec, t, tf.sub(spec, tf.mont_mul(spec, a, b), c))

    los, his = _halves((tau, A, B, C))
    p2, p3 = _at_two_three(spec, los, his, True)
    return torch.stack([tf.reduce_sum(spec, comb(*x)) for x in (los, p2, p3)])


def _round_evals_cubic_prod_s(spec, A, B, C) -> torch.Tensor:
    """Evals at {0, 2, 3} of sum_i A B C (Spark's product layers)."""

    def comb(a, b, c):
        return tf.mont_mul(spec, tf.mont_mul(spec, a, b), c)

    los, his = _halves((A, B, C))
    p2, p3 = _at_two_three(spec, los, his, True)
    return torch.stack([tf.reduce_sum(spec, comb(*x)) for x in (los, p2, p3)])


def _round_evals_quad_s(spec, A, B) -> torch.Tensor:
    """Evals at {0, 2} of sum_i A B."""
    los, his = _halves((A, B))
    p2, _ = _at_two_three(spec, los, his, False)
    return torch.stack([tf.reduce_sum(spec, tf.mont_mul(spec, *x)) for x in (los, p2)])


def _pull(evals_dev: torch.Tensor, spec=FR) -> List[int]:
    """The round's evaluations as host ints: one device-to-host copy."""
    return spec.decode(evals_dev)


def _finals(tables: Sequence[torch.Tensor], spec=FR) -> List[int]:
    """Row 0 of every folded table, as host ints, in one copy."""
    return spec.decode(torch.stack([x[0] for x in tables]))


def _round(e: int, evals: List[int], transcript, m: int):
    """The round polynomial from its evaluations (e1 from the claim),
    absorbed coefficient by coefficient; returns (poly, r_j)."""
    poly = UniPoly.from_evals([evals[0], (e - evals[0]) % m] + evals[1:], m)
    poly.write_to_transcript(transcript)
    return poly, transcript.challenge_scalar(m)


def _split_tables(mesh, tables) -> List[List[torch.Tensor]]:
    """The tables as one list a shard (cyclic layout), or as one list."""
    if mesh is None:
        return [list(tables)]
    return [list(shard) for shard in pmesh.cyclic_split(mesh, torch.stack(list(tables)))]


def _join_tables(parts, device) -> List[List[torch.Tensor]]:
    """The shards' tables gathered in natural order on `device`, as one list."""
    return [list(pmesh.cyclic_join([torch.stack(p) for p in parts], device))]


def _prove_looped(round_evals, claim: int, num_rounds: int, tables, transcript, spec,
                  mesh=None):
    """The looped prover; with a mesh, over the tables' cyclic shards (each
    shard's evaluations summed on the mesh's first device, one fold a shard)
    until a shard holds one row, then over the gathered D rows there."""
    m = spec.modulus
    e = claim % m
    dev = tables[0].device if mesh is None else mesh.devices[0]
    parts = _split_tables(mesh, tables)
    rs: List[int] = []
    polys: List[UniPoly] = []
    for _ in range(num_rounds):
        if len(parts) > 1 and parts[0][0].shape[0] == 1:
            parts = _join_tables(parts, dev)
        evals = [round_evals(spec, *p) for p in parts]
        if len(evals) > 1:  # the shards' sums: one fold of the wide sum
            evals = [tf.reduce_sum(spec, torch.stack([x.to(dev) for x in evals]))]
        poly, r_j = _round(e, _pull(evals[0], spec), transcript, m)
        rs.append(r_j)
        rdev = dense.encode_scalar(r_j, spec, dev)
        parts = [[dense.bound_top(x, rdev.to(x.device), spec) for x in p] for p in parts]
        e = poly.evaluate(r_j)
        polys.append(poly)
    if len(parts) > 1:
        parts = _join_tables(parts, dev)
    return SumcheckInstanceProof(polys), rs, _finals(parts[0], spec)


# -- fused provers ------------------------------------------------------------


def _simulate_schedule(mode: int, index: int, num_rounds: int, ncoeffs: int):
    """Static replay of the sponge's mode machine for the sumcheck schedule
    (absorb ncoeffs elements, then squeeze one, per round)."""
    for _ in range(num_rounds):
        if mode == dsponge._SQUEEZING or index == PC.RATE:
            index = 0
        mode = dsponge._ABSORBING
        for _ in range(ncoeffs):
            if index == PC.RATE:
                index = 0
            index += 1
        if mode == dsponge._ABSORBING or index == PC.RATE:
            index = 0
        mode = dsponge._SQUEEZING
        index += 1
    return mode, index


class _Rounds:
    """The round launches of a fused sumcheck over one stack of tables."""

    def __init__(self, kind: str, src: torch.Tensor, k_par: int, k_seq: int):
        self.kind, self.src, self.k_par, self.k_seq = kind, src, k_par, k_seq
        self.device = src.device

    def step(self, r):
        """Fold by r (when given), then the round's partials."""
        self.src, partials = sk.sumcheck_round(self.kind, self.src, r, self.k_par, self.k_seq)
        return partials


class _ShardedRounds(_Rounds):
    """The round launches over the stack's cyclic shards: a launch a shard,
    the partials concatenated along the blocks axis on the mesh's first
    device (the tail's modular sum does not depend on their order), until a
    shard's fold leaves one row; then that fold alone on each shard (its
    partials are 0), the D rows gathered in natural order on the first
    device, and the single-stack launches there."""

    def __init__(self, kind: str, src: torch.Tensor, mesh):
        self.kind, self.src, self.k_par, self.k_seq = kind, None, 1, 0
        self.device = mesh.devices[0]
        self.shards = pmesh.cyclic_split(mesh, src)

    def step(self, r):
        if self.shards is not None:
            if self.shards[0].shape[1] > (1 if r is None else 2):
                outs = [sk.sumcheck_round(self.kind, s, None if r is None else r.to(s.device))
                        for s in self.shards]
                self.shards = [s for s, _ in outs]
                return torch.cat([p.to(self.device) for _, p in outs], dim=1)
            if r is not None:
                self.shards = [sk.sumcheck_round(self.kind, s, r.to(s.device))[0]
                               for s in self.shards]
            self.src, self.shards, r = pmesh.cyclic_join(self.shards, self.device), None, None
        return super().step(r)


def _prove_fused(kind: str, claim: int, num_rounds: int, tables, transcript,
                 k_par: int = 1, k_seq: int = 0, inst_coeffs=None, mesh=None):
    """The whole sumcheck on the device (see the module's docstring):
    returns (proof, r, the tables' final values in stack order) and leaves
    the host transcript in the final state, mode and index.  With a mesh,
    the rounds run over the tables' cyclic shards (`_ShardedRounds`) and
    the transcript on the mesh's first device."""
    host = transcript.sponge
    spec_s = dsponge._spec_of(transcript.params.modulus)
    src = torch.stack(list(tables))
    n = src.shape[1]
    if n & (n - 1) or n < 1 << num_rounds:
        raise ValueError(f"fused sumcheck: {num_rounds} rounds on tables of {n} rows")
    rounds = _Rounds(kind, src, k_par, k_seq) if mesh is None else _ShardedRounds(kind, src, mesh)
    del src  # sharded, the shards hold their own copies
    dev = rounds.device
    inst_coeffs = [1] if inst_coeffs is None else list(inst_coeffs)
    # one upload: the sponge state, the claim, the instances' coefficients
    up = torch.as_tensor(np.concatenate([
        spec_s.encode(list(host.state)).reshape(-1), FR.encode(claim % FR.modulus),
        FR.encode([c % FR.modulus for c in inst_coeffs]).reshape(-1)]), device=dev)
    ns = 3 * spec_s.nlimbs
    state = up[:ns].reshape(3, spec_s.nlimbs)
    e = up[ns: ns + FR.nlimbs]
    coeffs = up[ns + FR.nlimbs:].reshape(len(inst_coeffs), FR.nlimbs)
    ncoeffs = sk.POINTS[kind] + 1
    mode, index = host.mode, host.index
    polys_d, rs_d, r = [], [], None
    for _ in range(num_rounds):
        partials = rounds.step(r)
        if mode == dsponge._SQUEEZING or index == PC.RATE:
            # the absorb's leading permutation depends on the state alone
            state = dsponge.permute(spec_s, state)
            mode, index = dsponge._ABSORBING, 0
        c, r, e, state = sk.sumcheck_tail(kind, partials, coeffs, e, state, spec_s, mode, index)
        mode, index = _simulate_schedule(mode, index, 1, ncoeffs)
        polys_d.append(c)
        rs_d.append(r)
    rounds.step(r)  # the last fold: the final values
    finals = rounds.src[:, 0]
    flat = torch.cat([torch.stack(polys_d).reshape(-1), torch.stack(rs_d).reshape(-1),
                      finals.reshape(-1), state.reshape(-1)]).cpu()
    nc = num_rounds * ncoeffs * FR.nlimbs
    nr = num_rounds * FR.nlimbs
    nf = finals.numel()
    cs = FR.decode(flat[:nc])
    polys = [UniPoly(cs[i * ncoeffs: (i + 1) * ncoeffs]) for i in range(num_rounds)]
    rs = FR.decode(flat[nc: nc + nr])
    finals = FR.decode(flat[nc + nr: nc + nr + nf])
    host.state = spec_s.decode(flat[nc + nr + nf:])
    host.mode, host.index = mode, index
    return SumcheckInstanceProof(polys), rs, finals


def _prove_cubic_batched_fused(claim, num_rounds, poly_vec_par, poly_vec_seq, coeffs,
                               transcript):
    """The batched product sumcheck fused (the reference's
    `_prove_cubic_batched_fused`, :597-644): the instances' tables stacked
    as A_par, B_par, C_par, A_seq, B_seq, C_seq and combined on the device
    by `coeffs`."""
    A_par, B_par, C_par = poly_vec_par
    A_seq, B_seq, C_seq = poly_vec_seq
    k_par, k_seq = len(A_par), len(A_seq)
    tables = [*A_par, *B_par, C_par, *A_seq, *B_seq, *C_seq]
    proof, rs, finals = _prove_fused("cubic", claim, num_rounds, tables, transcript, k_par,
                                     k_seq, list(coeffs)[: k_par + k_seq])
    return proof, rs, *_batched_claims(finals, k_par, k_seq)


def _batched_claims(finals: List[int], k_par: int, k_seq: int):
    """(claims_prod, claims_dotp) from the final values in stack order."""
    s = 2 * k_par + 1
    claims_prod = (finals[:k_par], finals[k_par: 2 * k_par], finals[2 * k_par])
    claims_dotp = (finals[s: s + k_seq], finals[s + k_seq: s + 2 * k_seq],
                   finals[s + 2 * k_seq: s + 3 * k_seq])
    return claims_prod, claims_dotp


# -- provers ----------------------------------------------------------------


def _sharded_mesh_for(tables, num_rounds: int):
    """The ambient mesh, if the tables split evenly across it and the
    sumcheck binds every variable (the reference's :399-410)."""
    mesh = pmesh.active_mesh()
    if mesh is None:
        return None
    D, n = mesh.size, tables[0].shape[0]
    if D < 2 or n < D or n % D or (1 << num_rounds) != n:
        return None
    return mesh


def _fuse(fused: bool, num_rounds: int, spec) -> bool:
    """Whether a prover fuses: asked to, with rounds to prove; raises when
    asked to over a field the fused kernels are not built for."""
    if not fused or num_rounds == 0:
        return False
    if spec != FR:
        raise ValueError(f"the fused sumcheck runs over BLS12-377's Fr only, not {spec.name}: "
                         "pass fused=False")
    return True


def prove_cubic_with_additive_term(
    claim: int,
    num_rounds: int,
    tau: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    transcript,
    spec=FR,
    fused: bool = True,
) -> Tuple[SumcheckInstanceProof, List[int], List[int]]:
    """Phase-1 Spartan sumcheck over tau * (A*B - C) (sumcheck.rs:67-148).
    Returns (proof, r, [tau, A, B, C] bound at r).  Fused when `fused` and
    there are rounds to prove (BLS12-377's Fr tables only); sharded under a
    mesh over BLS12-377's Fr."""
    tables = (tau, A, B, C)
    mesh = _sharded_mesh_for(tables, num_rounds) if spec == FR else None
    if _fuse(fused, num_rounds, spec):
        return _prove_fused("cubic_tau", claim, num_rounds, tables, transcript, mesh=mesh)
    return _prove_looped(_round_evals_cubic_tau_s, claim, num_rounds, tables, transcript, spec,
                         mesh)


def prove_quad(
    claim: int,
    num_rounds: int,
    A: torch.Tensor,
    B: torch.Tensor,
    transcript,
    spec=FR,
    fused: bool = True,
) -> Tuple[SumcheckInstanceProof, List[int], List[int]]:
    """Phase-2 Spartan sumcheck over A*B (sumcheck.rs:387-443); sharded under
    a mesh over BLS12-377's Fr."""
    mesh = _sharded_mesh_for((A, B), num_rounds) if spec == FR else None
    if _fuse(fused, num_rounds, spec):
        return _prove_fused("quad", claim, num_rounds, (A, B), transcript, mesh=mesh)
    return _prove_looped(_round_evals_quad_s, claim, num_rounds, (A, B), transcript, spec, mesh)


def prove_cubic(
    claim: int,
    num_rounds: int,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    transcript,
    fused: bool = True,
) -> Tuple[SumcheckInstanceProof, List[int], List[int]]:
    """Product sumcheck over A*B*C (sumcheck.rs:149-218), over Fr; sharded
    under a mesh."""
    mesh = _sharded_mesh_for((A, B, C), num_rounds)
    if fused and num_rounds > 0:
        return _prove_fused("cubic", claim, num_rounds, (A, B, C), transcript, mesh=mesh)
    return _prove_looped(_round_evals_cubic_prod_s, claim, num_rounds, (A, B, C),
                         transcript, FR, mesh)


def prove_cubic_batched(
    claim: int,
    num_rounds: int,
    poly_vec_par,  # (list[A], list[B], shared C) device tables
    poly_vec_seq,  # (list[A], list[B], list[C]) device tables
    coeffs: List[int],
    transcript,
    fused: bool = True,
):
    """Batched product sumcheck (sumcheck.rs:220-385): `par` instances share
    poly_C (the eq polynomial); `seq` instances carry their own weights.
    Instances are random-linear-combined by `coeffs`.

    Returns (proof, r, claims_prod, claims_dotp) with
    claims_prod = (A_finals, B_finals, C_final) and claims_dotp the seq
    finals.
    """
    if fused and num_rounds > 0:
        return _prove_cubic_batched_fused(claim, num_rounds, poly_vec_par, poly_vec_seq,
                                          coeffs, transcript)
    m = FR.modulus
    A_par, B_par, C_par = poly_vec_par
    A_seq, B_seq, C_seq = poly_vec_seq
    A_par, B_par = list(A_par), list(B_par)
    A_seq, B_seq, C_seq = list(A_seq), list(B_seq), list(C_seq)
    n_par, n_seq = len(A_par), len(A_seq)
    dev = C_par.device

    e = claim % m
    rs: List[int] = []
    polys: List[UniPoly] = []
    for _ in range(num_rounds):
        triples = [(a, b, C_par) for a, b in zip(A_par, B_par)] + list(zip(A_seq, B_seq, C_seq))
        # every instance's three evaluations in one copy
        flat = _pull(torch.cat([_round_evals_cubic_prod_s(FR, *t) for t in triples]))
        evals = [flat[3 * i: 3 * i + 3] for i in range(len(triples))]
        comb = [sum(ev[k] * cf for ev, cf in zip(evals, coeffs)) % m for k in range(3)]
        poly, r_j = _round(e, comb, transcript, m)
        rs.append(r_j)
        rdev = dense.encode_scalar(r_j, FR, dev)
        A_par = [dense.bound_top(x, rdev) for x in A_par]
        B_par = [dense.bound_top(x, rdev) for x in B_par]
        C_par = dense.bound_top(C_par, rdev)
        A_seq = [dense.bound_top(x, rdev) for x in A_seq]
        B_seq = [dense.bound_top(x, rdev) for x in B_seq]
        C_seq = [dense.bound_top(x, rdev) for x in C_seq]
        e = poly.evaluate(r_j)
        polys.append(poly)

    finals = _finals(A_par + B_par + [C_par] + A_seq + B_seq + C_seq)
    return (SumcheckInstanceProof(polys), rs, *_batched_claims(finals, n_par, n_seq))
