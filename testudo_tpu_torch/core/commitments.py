"""Pedersen commitment generators and commit helpers.

Counterpart of testudo_tpu/core/commitments.py (itself of Testudo's
src/commitments.rs).  Generator derivation follows MultiCommitGens::new
exactly (commitments.rs:17-39): a Poseidon sponge over Fr absorbs the label
bytes and the compressed group generator, then each of the n + 1 generators
is `G1Affine::rand(StdRng::from_seed(sponge.squeeze_bytes(32)))` (the
ChaCha12 stream and ark's rejection sampling are in utils/ark_rng.py; the
cofactor clearing goes through the native library where it is built).

The generators carry the curve profile: their batch on the profile's group
backend (`batch()`, built once) is what the MSMs take, so the CPU tests run
them on host groups and the card on the MSM kernels.  Single points and the
few-term sums of the provers and verifiers are host work (`lincomb`: one
native MSM on BLS12-377).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

from .. import serialize as ser
from ..curves import host_curve as hc
from ..curves import profile as cprof
from ..poseidon.sponge import PoseidonSponge
from ..poseidon.transcript import fr_params
from ..utils import ark_rng
from .mipp import _g1_lincomb


def lincomb(pf: "cprof.CurveProfile", pts: Sequence, scalars: Sequence[int]):
    """sum_i scalars[i] pts[i] of host affine G1 points, on the host."""
    return _g1_lincomb(pf, list(pts), [int(s) for s in scalars])


def _host_mul(pt, e: int):
    from .. import native

    if native.available():
        return native.g1_mul(pt, e)
    return hc.g1_mul(pt, e)


@dataclass
class MultiCommitGens:
    n: int
    G: List  # host affine G1 points
    h: object  # host affine G1
    profile: "cprof.CurveProfile"
    _batch: object = field(default=None, repr=False, compare=False)

    def batch(self):
        """G on the profile's G1 backend (built at the first call)."""
        if self._batch is None:
            self._batch = self.profile.g1b.from_affine(self.G)
        return self._batch

    @staticmethod
    def new(n: int, label: bytes, profile=None) -> "MultiCommitGens":
        profile = profile or cprof.bls12_377()
        sponge = PoseidonSponge(fr_params())
        sponge.absorb_bytes(bytes(label))
        sponge.absorb_bytes(ser.g1_to_bytes(hc.g1_generator(), compress=True))
        pts = []
        while len(pts) < n + 1:
            seed = sponge.squeeze_bytes(32)
            pts.append(ark_rng.g1_affine_rand(ark_rng.std_rng_from_seed(seed), _host_mul))
        return MultiCommitGens(n, pts[:n], pts[n], profile)

    def split_at(self, mid: int):
        return (
            MultiCommitGens(mid, self.G[:mid], self.h, self.profile),
            MultiCommitGens(self.n - mid, self.G[mid:], self.h, self.profile),
        )


def commit_scalar(scalar: int, blind: int, gens_1: MultiCommitGens):
    """2-term Pedersen commitment (commitments.rs:70-77)."""
    if gens_1.n != 1:
        raise ValueError(f"commit_scalar needs gens of one point, got {gens_1.n}")
    return lincomb(gens_1.profile, [gens_1.G[0], gens_1.h], [scalar, blind])


def commit_slice_dev(scalars: Sequence[int], blind: int, gens_n: MultiCommitGens):
    """MSM commitment of a vector plus its blind (commitments.rs:79-86): the
    MSM on the profile's G1 backend, the blind term on the host."""
    if len(scalars) != gens_n.n:
        raise ValueError(f"{len(scalars)} scalars for gens of {gens_n.n} points")
    base = gens_n.profile.g1b.msm(gens_n.batch(), scalars)
    return lincomb(gens_n.profile, [base, gens_n.h], [1, blind])
