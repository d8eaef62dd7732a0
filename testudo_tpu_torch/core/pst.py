"""PST (Papamanthou-Shi-Tamassia) multilinear polynomial commitment.

Counterpart of testudo_tpu/core/pst.py (itself of the patched
ark-poly-commit `MultilinearPC` Testudo uses: setup/trim/commit/open/check
plus the G2-side variants commit_g2/open_g1/check_2 consumed by MIPP,
Testudo src/sqrt_pst.rs:124-261, mipp.rs:133-144, 307).

Scheme (commitments in G1, masks in G2; the G2 variant mirrors it):
  - SRS: secrets t_1..t_nv; powers_of_g[i][b] = g^{prod_{j>=i} eq(t_j, b_j)}
    for b in {0,1}^(nv-i): Lagrange bases over suffixes of t.
  - commit(p) = MSM(powers_of_g[0], evals(p)) = g^{p(t)}.
  - open at a: bind variables MSB-first (identical to Spartan's
    bound_poly_var_top order, so: unlike the reference, which had to
    reverse the point to bridge to ark-poly-commit's LSB-first binding,
    sqrt_pst.rs:221-225: no reversal is needed anywhere): round i yields
    quotient q_i = hi - lo committed with powers_of_g[i+1].
  - check: e(C - g^v, h) == prod_i e(pi_i, h^{t_i - a_i}).

All group work routes through a curves.profile.CurveProfile (default
BLS12-377 with the CUDA device backends; the tests pass a profile on the
CPU).  Fr tables are `(n, 16)` int32 Montgomery limb tensors on the
profile's device; a table times one scalar goes to the row-major Montgomery
kernel with the scalar as a single element.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from ..curves import profile as cprof
from ..device import field as tf
from ..poly import dense
from ..utils.timer import Timer


def _default_profile() -> "cprof.CurveProfile":
    return cprof.bls12_377()


@dataclass
class CommitterKey:
    nv: int
    powers_of_g: List  # backend reprs, level i has 2^(nv-i) points
    powers_of_h: List
    g: Tuple  # host affine G1 generator
    h: Tuple  # host affine G2 generator
    profile: object = None

    def __post_init__(self):
        if self.profile is None:
            self.profile = _default_profile()

    def trim(self, nv: int) -> "CommitterKey":
        cut = self.nv - nv
        if cut < 0:
            raise ValueError(f"cannot trim a key of {self.nv} variables to {nv}")
        return CommitterKey(
            nv, self.powers_of_g[cut:], self.powers_of_h[cut:], self.g,
            self.h, self.profile,
        )


@dataclass
class VerifierKey:
    nv: int
    g: Tuple
    h: Tuple
    g_mask: List  # [g^{t_i}] host affine
    h_mask: List  # [h^{t_i}] host affine
    profile: object = None

    def __post_init__(self):
        if self.profile is None:
            self.profile = _default_profile()

    def trim(self, nv: int) -> "VerifierKey":
        cut = self.nv - nv
        if cut < 0:
            raise ValueError(f"cannot trim a key of {self.nv} variables to {nv}")
        return VerifierKey(
            nv, self.g, self.h, self.g_mask[cut:], self.h_mask[cut:],
            self.profile,
        )


def _seed_scalars(seed: bytes, n: int, modulus: int) -> List[int]:
    out = []
    ctr = 0
    while len(out) < n:
        h = hashlib.shake_256(seed + ctr.to_bytes(8, "little")).digest(40)
        v = int.from_bytes(h, "little") % modulus
        if v != 0:
            out.append(v)
        ctr += 1
    return out


def ark_setup_draws(nv: int) -> Tuple[Tuple, Tuple, List[int]]:
    """The (g, h, t) draws of `MultilinearPC::setup(nv, ark_std::test_rng())`
    (Testudo dense_mlpoly.rs:193-195 -> ark-poly-commit multilinear_pc setup):
    g = G1::rand, h = G2::rand, then nv Fr::rand, all from the fixed-seed
    ChaCha12 StdRng (utils/ark_rng.py).  BLS12-377 only.

    The returned t vector is REVERSED: ark binds variables LSB-first while
    this package binds MSB-first (module docstring), and the reference
    bridges the orders by reversing the opening point (sqrt_pst.rs:221-225).
    Evaluating an eval table with LSB-first chi at t equals evaluating it
    with MSB-first chi at reversed t, so using reversed draws makes this
    package's commitments/openings equal the reference's group elements
    with no reversal at the call sites."""
    from ..utils import ark_rng

    if nv < 0:
        raise ValueError(f"ark_setup_draws: nv must not be negative, got {nv}")
    rng = ark_rng.test_rng()
    g = ark_rng.g1_projective_rand(rng)
    h = ark_rng.g2_projective_rand(rng)
    ts = [ark_rng.fr_rand(rng) for _ in range(nv)]
    return g, h, list(reversed(ts))


_SETUP_CACHE: dict = {}


def setup(
    nv: int,
    seed: Optional[bytes] = None,
    profile: Optional["cprof.CurveProfile"] = None,
) -> Tuple[CommitterKey, VerifierKey]:
    """Deterministic trusted setup.

    Default (seed=None, BLS12-377): the reference's derivation: ark
    test_rng draws (dense_mlpoly.rs:193-195), so the SRS group elements
    match the Rust snapshot's.  With an explicit seed (or any other
    curve): a Shake256-derived stream over the fixed generators.

    Results are memoized per (nv, seed, profile): the derivation is
    deterministic and keys are read-only, so repeated setups reuse the
    first derivation."""
    profile = profile or _default_profile()
    # keyed on what identifies a profile (curve, device, kind of backend),
    # not on id(): ids are reused after garbage collection
    ck_key = (nv, seed, profile.name, str(profile.device), type(profile.g1b).__name__)
    hit = _SETUP_CACHE.get(ck_key)
    if hit is not None:
        return hit
    spec = profile.fr_spec
    if seed is None and profile.name == "bls12_377":
        g, h, ts = ark_setup_draws(nv)
    else:
        ts = _seed_scalars(seed or b"testudo-tpu-pst-srs", nv, profile.R)
        g = profile.g1_generator()
        h = profile.g2_generator()
    # eq tables for every suffix level (level nv is the empty product = 1),
    # concatenated so the backend's fixed-base pass runs ONCE.
    dev = profile.device
    teq = Timer("pst::setup eq tables to ints")
    tables = [dense.eq_evals(ts[i:], spec, dev) for i in range(nv)]
    tables.append(torch.as_tensor(spec.encode(1), device=dev).reshape(1, spec.nlimbs))
    sizes = [t.shape[0] for t in tables]
    scalars = spec.decode(torch.cat(tables, dim=0))
    teq.stop()
    all_g = profile.g1b.fixed_base_mul(g, scalars)
    all_h = profile.g2b.fixed_base_mul(h, scalars)
    powers_of_g, powers_of_h = [], []
    off = 0
    for s in sizes:
        powers_of_g.append(profile.g1b.slice(all_g, off, off + s))
        powers_of_h.append(profile.g2b.slice(all_h, off, off + s))
        off += s
    tmask = Timer("pst::setup g_mask h_mask")
    g_mask = [profile.g1_mul(g, t) for t in ts]
    h_mask = [profile.g2_mul(h, t) for t in ts]
    tmask.stop()
    ck = CommitterKey(nv, powers_of_g, powers_of_h, g, h, profile)
    vk = VerifierKey(nv, g, h, g_mask, h_mask, profile)
    _SETUP_CACHE[ck_key] = (ck, vk)
    return ck, vk


# -- conversion helpers -----------------------------------------------------


def _to_canon_scalars(evals_mont: torch.Tensor, spec=None) -> torch.Tensor:
    """Montgomery table -> canonical limbs: x R * 1 * R^{-1} = x.  The 1 is
    a single element, read by every lane of the kernel."""
    spec = spec or tf.FR
    one = torch.as_tensor(tf._int_to_limbs(1, spec.nlimbs), device=evals_mont.device)
    return tf.mont_mul(spec, evals_mont, one)


def _msm_table(profile, backend, repr_, table_mont: torch.Tensor):
    """Backend MSM with a Montgomery device table as scalars."""
    spec = profile.fr_spec
    if isinstance(backend, cprof.HostGroupBackend):
        return backend.msm(repr_, spec.decode(table_mont))
    from ..device import msm

    canon = _to_canon_scalars(table_mont, spec)
    fn = msm.msm_g1 if backend.group == "g1" else msm.msm_g2
    return fn(repr_, canon, device=backend.device)


# -- G1 commitments ---------------------------------------------------------


def commit(ck: CommitterKey, evals_mont: torch.Tensor):
    """Commit to a poly given its (2^nv, nlimbs) Montgomery eval table."""
    n = evals_mont.shape[0]
    nv = n.bit_length() - 1
    level = ck.nv - nv
    return _msm_table(ck.profile, ck.profile.g1b, ck.powers_of_g[level], evals_mont)


def _open_quotient_msms(ck: CommitterKey, evals_mont, point, powers, backend):
    """Shared PST opening skeleton: per-variable quotient tables (all
    device ops, no sync), then the nv proof MSMs, fused into ONE ladder
    launch on the device backend (the sizes halve, so the whole batch is
    less than twice the first)."""
    spec = ck.profile.fr_spec
    n = evals_mont.shape[0]
    nv = n.bit_length() - 1
    if len(point) != nv:
        raise ValueError(f"PST open: {nv} variables but a point of {len(point)}")
    level = ck.nv - nv
    r = evals_mont
    pairs = []
    for i in range(nv):
        half = r.shape[0] // 2
        q = tf.sub(spec, r[half:], r[:half])
        rdev = dense.encode_scalar(point[i], spec, r.device)
        r = dense.bound_top(r, rdev, spec)
        pairs.append((powers[level + i + 1], q))
    if isinstance(backend, cprof.HostGroupBackend):
        return [
            _msm_table(ck.profile, backend, base, q) for base, q in pairs
        ]
    from ..device import msm

    parts = [
        (base, _to_canon_scalars(q, spec)) for base, q in pairs
    ]
    return msm.msm_multi_small(backend.group, parts, device=backend.device)


def open_(ck: CommitterKey, evals_mont: torch.Tensor, point: List[int]) -> List:
    """Open at `point` (MSB-first, Spartan order).  Returns [pi_i] G1 affine."""
    return _open_quotient_msms(
        ck, evals_mont, point, ck.powers_of_g, ck.profile.g1b
    )


def check(
    vk: VerifierKey,
    commitment,
    point: List[int],
    value: int,
    proofs: List,
) -> bool:
    """e(C - g^v, h) == prod e(pi_i, h^{t_i - a_i})."""
    pf = vk.profile
    nv = len(point)
    if len(proofs) != nv:
        return False
    vkt = vk.trim(nv) if vk.nv != nv else vk
    left_pt = pf.g1_add(commitment, pf.g1_neg(pf.g1_mul(vk.g, value % pf.R)))
    g1s = [left_pt]
    g2s = [pf.g2_neg(vk.h)]
    for i in range(nv):
        h_term = pf.g2_add(
            vkt.h_mask[i], pf.g2_neg(pf.g2_mul(vk.h, point[i] % pf.R))
        )
        g1s.append(proofs[i])
        g2s.append(h_term)
    # e(C - g^v, -h) * prod e(pi_i, h^{t_i - a_i}) == 1
    return pf.multi_pairing(g1s, g2s) == pf.fq12_one()


# -- G2 commitments (for MIPP's p_h) ---------------------------------------


def commit_g2(ck: CommitterKey, evals_mont: torch.Tensor):
    """h^{p(t)}: MSM over powers_of_h (mirrors patched commit_g2)."""
    n = evals_mont.shape[0]
    nv = n.bit_length() - 1
    level = ck.nv - nv
    return _msm_table(ck.profile, ck.profile.g2b, ck.powers_of_h[level], evals_mont)


def open_g2(ck: CommitterKey, evals_mont: torch.Tensor, point: List[int]) -> List:
    """Open a G2-side commitment: proofs live in G2."""
    return _open_quotient_msms(
        ck, evals_mont, point, ck.powers_of_h, ck.profile.g2b
    )


def check_g2(
    vk: VerifierKey,
    commitment_h,
    point: List[int],
    value: int,
    proofs: List,
) -> bool:
    """e(g, C_h - h^v) == prod e(g^{t_i - a_i}, pi_i)  (mirrors check_2)."""
    pf = vk.profile
    nv = len(point)
    if len(proofs) != nv:
        return False
    vkt = vk.trim(nv) if vk.nv != nv else vk
    right_pt = pf.g2_add(commitment_h, pf.g2_neg(pf.g2_mul(vk.h, value % pf.R)))
    g1s = [pf.g1_neg(vk.g)]
    g2s = [right_pt]
    for i in range(nv):
        g_term = pf.g1_add(
            vkt.g_mask[i], pf.g1_neg(pf.g1_mul(vk.g, point[i] % pf.R))
        )
        g1s.append(g_term)
        g2s.append(proofs[i])
    return pf.multi_pairing(g1s, g2s) == pf.fq12_one()