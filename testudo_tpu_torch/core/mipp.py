"""MIPP: multi-inner-product-pairing argument (GIPA/TIPP-style).

Counterpart of testudo_tpu/core/mipp.py (itself of Testudo's src/mipp.rs).  Proves that
U = sum_i y_i * A_i opens the pairing commitment T = prod_i e(A_i, h_i).

Per halving round (mipp.rs:58-120):
  - cross commitments u_l = MSM(a_l, y_r), u_r = MSM(a_r, y_l): device
    Pippenger MSMs (or the profile's host backend);
  - cross pairings t_l = prod e(a_l, h_r), t_r = prod e(a_r, h_l);
  - absorb u_l, u_r, t_l, t_r (generic/uncompressed append, mipp.rs:97-100)
    into the Fq transcript, squeeze c_inv (an Fr challenge), set
    c = c_inv^-1 (mipp.rs:101-106);
  - compress a <- a_l + c * a_r, y <- y_l + c_inv * y_r,
    h <- h_l + c_inv * h_r: batched single-scalar ladders on device.

Final step: the structured polynomial p_h with evals
prod-over-set-bits cs_inv[m-1-bit] (mipp.rs:159-180) is committed in G2
(must equal final_h; asserted in tests/test_spark_scale.py) and opened at
transcript challenges rs via the PST G2 side.  Note on indexing: this
implementation's PST binds variables MSB-first (see core/pst.py), so the
verifier computes p_h(rs) = prod_i (1 - rs_i + cs_inv[i] * rs_i): the
same polynomial the reference evaluates with reversed coefficient order
against ark's LSB-first binding (mipp.rs:294-297).

The curve profile rides on the CommitterKey.  On the device backend the two
cross MSMs of a round are ONE ladder launch (`msm_segmented`), the folds of
a and h one ladder launch and one complete add each, and the fold of y one
launch of the row-major Montgomery kernel with the challenge as a single
element; the pairing products run on the host, in two worker threads beside
the device work.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch

from ..device import field as tf
from ..poly import dense
from ..utils.timer import Timer
from . import pst


def _dev_backend(pf) -> bool:
    """True when the profile's G1 backend is the BLS12-377 device backend
    (the fused segmented ladder only exists there)."""
    from ..curves import profile as cprof

    return not isinstance(pf.g1b, cprof.HostGroupBackend)


@dataclass
class MippProof:
    comms_t: List[Tuple[object, object]]  # pairs of GT elements
    comms_u: List[Tuple[object, object]]  # pairs of host affine G1
    final_a: object  # host affine G1
    final_h: object  # host affine G2
    pst_proof_h: List  # G2 proofs


def prove(
    transcript,
    ck: pst.CommitterKey,
    a_repr,  # backend G1 batch (the column commitments)
    y_mont: torch.Tensor,  # device Montgomery Fr scalars (chi(b))
    h_repr,  # backend G2 batch (ck.powers_of_h[odd])
    U,  # host affine G1
    T,
) -> MippProof:
    pf = ck.profile
    spec = pf.fr_spec
    n = y_mont.shape[0]
    m = n.bit_length() - 1
    comms_t, comms_u, xs, xs_inv = [], [], [], []

    transcript.append_bytes(pf.ser_g1_uncompressed(U))  # mipp.rs:56

    m_a, m_y, m_h = a_repr, y_mont, h_repr
    trounds = Timer("mipp::halving rounds")
    # Testudo fork-joins the (u_l, u_r) / (t_l, t_r) cross-terms
    # (mipp.rs:77-94 par!/try_par!).  Here the two pairing products run in
    # worker threads (the native multi-pairing releases the GIL) while the
    # main thread drives the two device MSMs: the same fork-join shape.
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=2)
    try:
        while pf.g1b.size(m_a) > 1:
            na = pf.g1b.size(m_a)
            half = na // 2
            a_l = pf.g1b.slice(m_a, 0, half)
            a_r = pf.g1b.slice(m_a, half, na)
            y_l, y_r = m_y[:half], m_y[half:]
            h_l = pf.g2b.slice(m_h, 0, half)
            h_r = pf.g2b.slice(m_h, half, na)

            a_l_aff = pf.g1b.to_affine(a_l)
            a_r_aff = pf.g1b.to_affine(a_r)
            h_l_aff = pf.g2b.to_affine(h_l)
            h_r_aff = pf.g2b.to_affine(h_r)
            fut_t_l = pool.submit(pf.multi_pairing, a_l_aff, h_r_aff)
            fut_t_r = pool.submit(pf.multi_pairing, a_r_aff, h_l_aff)
            if _dev_backend(pf):
                # one fused ladder computes BOTH cross-MSMs: u_l = (a_l,
                # y_r), u_r = (a_r, y_l) share the full a vector with the
                # y halves swapped (mipp.rs:77-85)
                from ..device import msm

                y_swapped = torch.cat([y_r, y_l], dim=0)
                comm_u_l, comm_u_r = msm.msm_segmented(
                    "g1", m_a, pst._to_canon_scalars(y_swapped, spec), 2,
                    device=pf.g1b.device,
                )
            else:
                comm_u_l = pst._msm_table(pf, pf.g1b, a_l, y_r)
                comm_u_r = pst._msm_table(pf, pf.g1b, a_r, y_l)
            comm_t_l = fut_t_l.result()
            comm_t_r = fut_t_r.result()

            transcript.append_bytes(pf.ser_g1_uncompressed(comm_u_l))
            transcript.append_bytes(pf.ser_g1_uncompressed(comm_u_r))
            transcript.append_bytes(pf.ser_gt(comm_t_l))
            transcript.append_bytes(pf.ser_gt(comm_t_r))
            c_inv = transcript.challenge_scalar(pf.R)
            c = pow(c_inv, -1, pf.R)

            m_a = pf.g1b.fold(a_l, a_r, c)
            m_y = tf.add(
                spec, y_l,
                tf.mont_mul(spec, y_r, dense.encode_scalar(c_inv, spec, y_r.device)),
            )
            m_h = pf.g2b.fold(h_l, h_r, c_inv)

            comms_t.append((comm_t_l, comm_t_r))
            comms_u.append((comm_u_l, comm_u_r))
            xs.append(c)
            xs_inv.append(c_inv)
    finally:
        pool.shutdown(wait=True)

    trounds.stop()
    final_a = pf.g1b.to_affine(m_a)[0]
    final_h = pf.g2b.to_affine(m_h)[0]

    # structured polynomial p_h (mipp.rs:159-180)
    evals = _ph_evals(xs_inv, pf.R)
    table = dense.encode_table(evals, spec, y_mont.device)
    # (commit_g2(table) == final_h by construction; asserted in tests)

    rs = [transcript.challenge_scalar(pf.R) for _ in range(m)]
    tph = Timer("mipp::p_h open (PST G2)")
    pst_proof_h = pst.open_g2(ck, table, rs)
    tph.stop()

    return MippProof(comms_t, comms_u, final_a, final_h, pst_proof_h)


def _ph_evals(cs_inv: List[int], modulus: int) -> List[int]:
    """Evals of prod_i (1 - z_i + cs_inv[m-1-i] z_i) over the hypercube
    (mipp.rs:159-180: bit j (lsb) set -> factor cs_inv[m-1-j])."""
    m = len(cs_inv)
    out = []
    for i in range(1 << m):
        acc = 1
        for j in range(m):
            if (i >> j) & 1:
                acc = acc * cs_inv[m - j - 1] % modulus
        out.append(acc)
    return out


def _gt_batch_pow(pf, gts: List, es: List[int]) -> List:
    """out[i] = gts[i]^es[i]; native threaded batch on BLS12-377
    (tn_gt_batch_pow), per-element fallback elsewhere."""
    if pf.name == "bls12_377":
        from .. import native

        if native.available():
            return native.gt_batch_pow(gts, [e % pf.R for e in es])
    return [pf.gt_pow(g, e) for g, e in zip(gts, es)]


def _g1_lincomb(pf, pts: List, es: List[int]):
    """sum_i es[i] * pts[i] as one host MSM (native Pippenger on 377)."""
    live = [(p_, e) for p_, e in zip(pts, es) if p_ is not None]
    if not live:
        return None
    if pf.name == "bls12_377":
        from .. import native

        if native.available():
            return native.g1_msm(
                [p_ for p_, _ in live], [e % pf.R for _, e in live]
            )
    acc = None
    for p_, e in live:
        acc = pf.g1_add(acc, pf.g1_mul(p_, e))
    return acc


def verify(
    vk: pst.VerifierKey,
    transcript,
    proof: MippProof,
    point_b: List[int],
    U,  # host affine G1
    T,
) -> bool:
    pf = vk.profile
    xs, xs_inv = [], []
    final_y = 1

    transcript.append_bytes(pf.ser_g1_uncompressed(U))

    for i, ((u_l, u_r), (t_l, t_r)) in enumerate(
        zip(proof.comms_u, proof.comms_t)
    ):
        transcript.append_bytes(pf.ser_g1_uncompressed(u_l))
        transcript.append_bytes(pf.ser_g1_uncompressed(u_r))
        transcript.append_bytes(pf.ser_gt(t_l))
        transcript.append_bytes(pf.ser_gt(t_r))
        c_inv = transcript.challenge_scalar(pf.R)
        c = pow(c_inv, -1, pf.R)
        xs.append(c)
        xs_inv.append(c_inv)
        final_y = final_y * (1 + c_inv * point_b[i] - point_b[i]) % pf.R

    # fold T and U with the challenges (mipp.rs:240-277).  The reference
    # par_iters these; here the 2m GT exponentiations run as ONE threaded
    # native batch and the U fold is ONE 2m-point host MSM.
    tfold = Timer("mipp::verify T/U folds (batched)")
    gts, g1s, exps_inv_first = [], [], []
    for (u_l, u_r), (t_l, t_r), c, c_inv in zip(
        proof.comms_u, proof.comms_t, xs, xs_inv
    ):
        gts += [t_l, t_r]
        g1s += [u_l, u_r]
        exps_inv_first += [c_inv, c]
    tc = T
    for p_ in _gt_batch_pow(pf, gts, exps_inv_first):
        tc = tc * p_
    uc = pf.g1_add(U, _g1_lincomb(pf, g1s, exps_inv_first))
    tfold.stop()

    m = len(xs_inv)
    rs = [transcript.challenge_scalar(pf.R) for _ in range(m)]
    # p_h(rs) in O(m) -- MSB-first binding means cs_inv in forward order
    v = 1
    for i in range(m):
        v = v * (1 - rs[i] + xs_inv[i] * rs[i]) % pf.R

    tch = Timer("mipp::verify check_g2 (PST p_h)")
    check_h = pst.check_g2(vk, proof.final_h, rs, v, proof.pst_proof_h)
    tch.stop()
    if not check_h:
        return False

    tfp = Timer("mipp::verify final pairing")
    final_t = pf.pairing(proof.final_a, proof.final_h)
    tfp.stop()
    if tc != final_t:
        return False

    final_u = pf.g1_mul(proof.final_a, final_y)
    if uc != final_u:
        return False
    return True
