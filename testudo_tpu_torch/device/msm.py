"""Multi-scalar multiplication (Pippenger) over G1 and G2 on the packed kernels.

Counterpart of the packed path of testudo_tpu/tpu/msm.py (`msm_g1` :1206,
`msm_g2` :1226 -> `msm_pipeline` :1175 -> `_msm_packed_gen` :772 and the
stage functions it calls, `msm_segmented` :893, `msm_multi_small` :963,
`_multi_msm_device` :283 -> `_multi_msm_packed` :1113).  Every stage takes
the `PackedGroup` as an argument, so G1 and G2 share one pipeline.  The
legacy XLA Pippenger and `msm_fp` (generic prime-field groups) wait for
later slices.

Algorithm (signed c-bit windows by default):
  1. signed digits of every scalar per window; stable sort of the point
     indices by |digit| per window; the sign picks the half of a [P | -P]
     table;
  2. host-side plan: every (window, bucket) run is cut into segments of at
     most T_cap points, one kernel lane each;
  3. bucket kernel: each lane sums its segment, gathering the points by
     index inside the kernel (mixed adds when the bases are affine);
  4. segment reduce: the consecutive segment lanes of a bucket are summed
     by the same kernel (general add);
  5. weighted bucket sum per window: a suffix scan over groups of 32
     buckets (`scan2b`), a shared double-and-add chain for the group
     offsets (`step`), pairwise folds (`add2`);
  6. Horner combine of the window sums: one ladder launch by 2^(c w) and a
     tree reduction; the result goes to the host as an affine point.

The stage boundaries, segment plan and association of the sums follow the
JAX package, so intermediate bucket and window sums agree with it limb for
limb.  What is not carried over: the materialised `(T, rows, lanes)` run
tensor, its memory budget and lane chunking (`_plan_lanes`, `lax.map`), the
lane paddings to TPU tiles, and the environment switches (`c` and
`signed_c` are arguments).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..fields.bls12_377 import R
from . import curve as tc
from . import field as tf
from .field import FQ, FR
from .packed_curve import G1P, G2P, PackedGroup

_SMALL_N = 64  # at or below this a plain ladder + tree beats Pippenger
_LADDER_MAX = 1024  # above this many points per part Pippenger beats the ladder
_SIGNED_C = 13  # default signed window width (W = 20 for 253-bit Fr)
_LANE_CLASS = 1024  # lane rounding inside the T_cap cost model

PhaseHook = Optional[Callable[[str], None]]


def _prep_scalars(scalars, device) -> torch.Tensor:
    """Host ints -> canonical (non-Montgomery) Fr limbs; tensors pass through."""
    if isinstance(scalars, (list, tuple)):
        return torch.as_tensor(FR.to_limbs([s % R for s in scalars]), device=device)
    return scalars.to(device)


def _map_coords(fn, *points):
    """Apply `fn` to every limb tensor of point batches of one shape: (X, Y,
    Z) tensors for G1, (c0, c1) pairs of them for G2."""
    first = points[0]
    if isinstance(first, torch.Tensor):
        return fn(*points)
    return tuple(_map_coords(fn, *parts) for parts in zip(*points))


def _pad_to(points, scal: torch.Tensor, target: int):
    """Pad the batch with all-zero rows (scalar 0) up to `target`."""
    padn = target - scal.shape[0]
    if padn == 0:
        return points, scal
    scal = F.pad(scal, (0, 0, 0, padn))
    return _map_coords(lambda coord: F.pad(coord, (0, 0, 0, padn)), points), scal


def _pad_pow2(points, scal: torch.Tensor):
    """Pad the batch to the next power of two.  Padding scalars are 0, so
    the extra rows land in bucket 0, which has weight zero and no lane; the
    padding points are all-zero rows and are never read."""
    n = scal.shape[0]
    return _pad_to(points, scal, 1 << max(1, (n - 1).bit_length()))


def _digits_from_scalars(scal: torch.Tensor, c: int) -> torch.Tensor:
    """(N, nlimbs) canonical 16-bit-limb scalars -> (W, N) int32 unsigned
    digits, c in {4, 8, 16}."""
    if c not in (4, 8, 16):
        raise ValueError(f"unsigned windows need c in (4, 8, 16), got {c}")
    nbits = 16 * scal.shape[1]
    per = 16 // c
    outs = []
    for wi in range(nbits // c):
        outs.append((scal[:, wi // per] >> ((wi % per) * c)) & ((1 << c) - 1))
    return torch.stack(outs, dim=0)


def _sorted_runs(keys: torch.Tensor, nbuckets: int):
    """keys (W, N) -> (order, sorted keys, starts, counts): stable sort per
    window and the [start, start + count) run of every bucket value."""
    sd, order = torch.sort(keys, dim=1, stable=True)
    rng = torch.arange(nbuckets, dtype=sd.dtype, device=sd.device).expand(sd.shape[0], -1)
    starts = torch.searchsorted(sd, rng.contiguous())
    ends = torch.searchsorted(sd, rng.contiguous(), right=True)
    counts = ends - starts
    counts[:, 0] = 0  # bucket 0 has weight 0
    return order.to(torch.int32), starts.to(torch.int32), counts.to(torch.int32)


def _digit_counts(scal: torch.Tensor, c: int):
    digits = _digits_from_scalars(scal, c)  # (W, N)
    return _sorted_runs(digits, 1 << c)


# -- signed digits ----------------------------------------------------------
#
# Signed c-bit windows: digits land in [-(2^(c-1)-1), 2^(c-1)], so c = 13
# covers a 253-bit scalar in 20 windows of 2^12 magnitude buckets; the sign
# rides on the POINT (a second table half with y negated).


def _signed_digits(scal: torch.Tensor, c: int) -> torch.Tensor:
    """(N, nlimbs) canonical 16-bit limbs -> (W, N) int32 signed digits with
    borrow propagation; W = ceil(16 * nlimbs / c).

    Requires the top window's raw digit + borrow <= 2^(c-1), which holds
    whenever the scalar bit-length is at least 2 below W*c."""
    if not 2 <= c <= 16:
        raise ValueError(
            f"signed windows support 2 <= c <= 16 (a digit reads at most two "
            f"16-bit limbs), got {c}"
        )
    nl = scal.shape[1]
    W = -(-(16 * nl) // c)
    mask = (1 << c) - 1
    raws = []
    for w in range(W):
        lo, sh = (w * c) // 16, (w * c) % 16
        v = scal[:, lo] >> sh
        if lo + 1 < nl and sh + c > 16:
            v = v | (scal[:, lo + 1] << (16 - sh))
        raws.append(v & mask)
    half = 1 << (c - 1)
    digs = []
    borrow = torch.zeros_like(raws[0])
    for w in range(W):
        d = raws[w] + borrow
        hi = (d > half).to(torch.int32)
        digs.append(d - (hi << c))
        borrow = hi
    return torch.stack(digs, dim=0)


def _digit_counts_signed(scal: torch.Tensor, c: int):
    """Signed-window bucket plan: sort |digit| per window, carry the sign
    through the sort as a table offset (0 -> P, 1 -> -P)."""
    d = _signed_digits(scal, c)  # (W, N)
    sign = (d < 0).to(torch.int32)
    order, starts, counts = _sorted_runs(d.abs(), (1 << (c - 1)) + 1)
    sgn_sorted = torch.gather(sign, 1, order.to(torch.int64))
    return order, sgn_sorted, starts, counts


def _with_neg_y_table(ptcat: torch.Tensor, ncomp: int = 1) -> torch.Tensor:
    """(N, rows) point-major rows -> (2N, rows) table [P..., -P...]: row N+i
    holds P_i with y negated, Fq component by component (p - y, and a
    component that is 0 stays 0).  The second half is written in place, one
    24-limb component at a time, so no second table-sized copy is made."""
    n = FQ.nlimbs
    N = ptcat.shape[0]
    table = torch.cat([ptcat, ptcat], dim=0)
    for comp in range(ncomp):
        lo = (ncomp + comp) * n
        table[N:, lo : lo + n] = tf.neg(FQ, ptcat[:, lo : lo + n])
    return table


# -- bucket splitting -------------------------------------------------------
#
# One overloaded bucket would keep a single lane busy long after the rest
# have finished (253-bit scalars leave the top signed window with few
# distinct digits).  Each (window, bucket) run is therefore cut into
# ceil(count / T_cap) segment lanes, whose partial sums the segment reduce
# folds back per bucket.


def _round_T(t: int) -> int:
    """Round a run length up: a power of two (at least 16) up to 512, then
    multiples of 512."""
    if t <= 512:
        return max(16, 1 << max(0, (t - 1).bit_length()))
    return -(-t // 512) * 512


def _plan_segments(starts_np: np.ndarray, counts_np: np.ndarray, T_cap: int):
    """Host-side split of (window, bucket) runs into <= T_cap segments.

    Returns (wnd, seg_start, seg_count, lane_off, nseg, L) numpy arrays:
    lane l sums points order[wnd[l], seg_start[l] : seg_start[l]+seg_count[l]];
    bucket j's segments are the CONSECUTIVE lanes [lane_off[j],
    lane_off[j]+nseg[j]).  Empty buckets get no lanes (nseg 0)."""
    W, B = counts_np.shape
    nseg = (-(-counts_np.astype(np.int64) // T_cap)).reshape(-1)
    lane_off = np.concatenate([[0], np.cumsum(nseg)])
    L = int(lane_off[-1])
    flat_ids = np.repeat(np.arange(W * B), nseg)
    seg_in_bucket = (np.arange(L) - lane_off[flat_ids]).astype(np.int64)
    wnd = (flat_ids // B).astype(np.int32)
    b = flat_ids % B
    seg_start = (starts_np[wnd, b] + seg_in_bucket * T_cap).astype(np.int32)
    seg_count = np.clip(
        counts_np[wnd, b] - seg_in_bucket * T_cap, 0, T_cap
    ).astype(np.int32)
    return (
        wnd,
        seg_start,
        seg_count,
        lane_off[:-1].astype(np.int32),
        nseg.astype(np.int32),
        L,
    )


def _pick_t_cap(counts_np: np.ndarray, W: int, B: int) -> int:
    """Segment length from the same cost model as the JAX package
    (T * rounded lanes + W * B * padded segments per bucket, over rounded T
    classes), so both packages cut the runs at the same places."""
    best, best_cost = None, None
    nz = max(1, int(np.count_nonzero(counts_np)))
    mean = max(1, int(counts_np.sum()) // nz)
    cands = {_round_T(mean), _round_T(2 * mean), _round_T(4 * mean),
             _round_T(8 * mean), _round_T(max(16, mean // 2)),
             _round_T(int(counts_np.max()))}
    nseg_all = counts_np.astype(np.int64)
    for T in sorted(cands):
        nseg = -(-nseg_all // T)
        lanes = -(-int(nseg.sum()) // _LANE_CLASS) * _LANE_CLASS
        s_max = max(1, int(nseg.max()))
        s_pad = 1 << (s_max - 1).bit_length()
        cost = T * lanes + W * B * s_pad
        if best_cost is None or cost < best_cost:
            best, best_cost = T, cost
    return best


def _msm_seg_buckets(Gp: PackedGroup, table, order_flat, wnd, seg_start,
                     seg_count, n_sorted: int, mixed: bool):
    """Segment-lane bucket accumulation: lane l sums the `seg_count[l]`
    points table[order_flat[wnd[l] * n_sorted + seg_start[l] + t]].
    wnd / seg_start / seg_count are host (numpy) plans; returns (rows, L)."""
    start = wnd.astype(np.int64) * n_sorted + seg_start
    # the kernel takes int32 positions: with the table below 2^31 entries
    # and no segment past its end, every start + count fits
    if order_flat.shape[0] >= 1 << 31:
        raise ValueError("segment plan: the sorted index table has 2^31 entries or more")
    if len(start) and int((start + seg_count).max()) > order_flat.shape[0]:
        raise ValueError("segment plan reads past the sorted index table")
    dev = table.device
    return Gp.bucket_phase(
        table,
        order_flat,
        torch.as_tensor(start.astype(np.int32), device=dev),
        torch.as_tensor(seg_count, device=dev),
        mixed=mixed,
    )


def _seg_reduce(Gp: PackedGroup, seg_sums, lane_off, nseg, S_cap: int):
    """Fold segment partial sums (rows, L) back into (rows, W*B) bucket sums.

    A bucket's segments are consecutive lanes, so this is a second run
    accumulation: the bucket kernel over the point-major transpose of
    seg_sums with start = lane_off, count = nseg, general add.  With at most
    one segment per bucket (S_cap == 1) the sums are copied instead, and an
    empty bucket takes the identity."""
    dev = seg_sums.device
    L = seg_sums.shape[1]
    if len(nseg) and int((lane_off.astype(np.int64) + nseg).max()) > L:
        raise ValueError("segment plan reads past the segment sums")
    if S_cap == 1:
        ext = torch.cat([seg_sums, Gp.identity_packed(1, device=dev)], dim=1)
        idx = np.where(nseg > 0, lane_off, L).astype(np.int64)
        return ext[:, torch.as_tensor(idx, device=dev)].contiguous()
    return Gp.bucket_phase(
        seg_sums.T.contiguous(),
        None,
        torch.as_tensor(lane_off, device=dev),
        torch.as_tensor(nseg, device=dev),
    )


def _weighted_sum_packed(Gp: PackedGroup, buckets, W: int, c: int,
                         plus_one: bool = False):
    """sum_j w(j)*B_j per window on packed buckets (rows, W*2^c) ->
    (rows, W); w(j) = j, or j+1 when plus_one (signed windows store
    magnitude m at slot m-1)."""
    dev = buckets.device
    B = 1 << c
    h = min(B, 32)
    groups = B // h
    lanes = W * groups
    bg = buckets.reshape(Gp.rows, W, groups, h)

    run = Gp.identity_packed(lanes, device=dev)
    tot = Gp.identity_packed(lanes, device=dev)
    # scan l = h-1..0 with tot-before-run update => tot = sum_l l*B_l
    for l in range(h - 1, -1, -1):
        run, tot = Gp.scan2b(run, tot, bg[:, :, :, l].reshape(Gp.rows, lanes).contiguous())

    # acc = (g*h) * run_g via a shared double-and-add chain (static masks)
    weights = np.tile(np.arange(groups, dtype=np.int64) * h, W)
    maxbits = max(1, int((groups - 1) * h).bit_length())
    acc = Gp.identity_packed(lanes, device=dev)
    run0 = run  # step() doubles its base operand; keep sum_l B_l per group
    for bit in range(maxbits):
        sel = torch.as_tensor(((weights >> bit) & 1).astype(np.int32), device=dev)
        acc, run = Gp.step(acc, run, sel)
    res = Gp.add2(acc, tot)
    if plus_one:  # + sum_l B_l per group shifts every weight by one
        res = Gp.add2(res, run0)

    # fold groups per window
    res = res.reshape(Gp.rows, W, groups)
    while groups > 1:
        half = groups // 2
        a = res[:, :, :half].reshape(Gp.rows, W * half).contiguous()
        b = res[:, :, half:].reshape(Gp.rows, W * half).contiguous()
        res = Gp.add2(a, b).reshape(Gp.rows, W, half)
        groups = half
    return res.reshape(Gp.rows, W)


def _drop_mag0(buckets, rows: int, W: int, B: int):
    return buckets.reshape(rows, W, B)[:, :, 1:].reshape(rows, W * (B - 1))


def _horner_ladder_packed(Gp: PackedGroup, wins, c: int):
    """sum_w 2^{c w} S_w via one ladder launch + tree reduction."""
    W = wins.shape[1]
    if c * (W - 1) >= 16 * FR.nlimbs:
        raise ValueError("window weights 2^(c w) must fit an Fr-width scalar")
    pows = np.zeros((W, FR.nlimbs), dtype=np.int32)
    for w in range(W):
        pows[w, (c * w) // 16] = 1 << ((c * w) % 16)
    scal = torch.as_tensor(pows.T.copy(), device=wins.device)
    return Gp.tree_reduce(Gp.ladder(wins.contiguous(), scal))


def _cat_points(points) -> torch.Tensor:
    """(X, Y, Z) of (N, 24) tensors, or of (c0, c1) pairs of them for G2 ->
    (N, 72) or (N, 144) point-major rows."""
    if isinstance(points[0], torch.Tensor):
        return torch.cat(points, dim=1).contiguous()
    return torch.cat([comp for coord in points for comp in coord], dim=1).contiguous()


def _drive_one(gen):
    """Run a pipeline generator to completion, returning its value."""
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            return stop.value


def _msm_packed(Gp: PackedGroup, points, scal: torch.Tensor, c: Optional[int],
                affine: bool = False, signed_c: int = _SIGNED_C,
                on_phase: PhaseHook = None):
    """Packed-kernel Pippenger, run to its end (see `_msm_packed_gen`)."""
    return _drive_one(_msm_packed_gen(Gp, points, scal, c, affine, signed_c, on_phase))


def _msm_packed_gen(Gp: PackedGroup, points, scal: torch.Tensor, c: Optional[int],
                    affine: bool = False, signed_c: int = _SIGNED_C,
                    on_phase: PhaseHook = None):
    """Generator form of the packed Pippenger.  c=None (the default) uses
    signed windows of width `signed_c`; an explicit c keeps the unsigned
    plan.

    Yields at the two places where the host waits for the device (after the
    digit sort is enqueued, before its counts are copied to the host for the
    segment plan; and after the heavy kernels are enqueued, before the
    caller copies the result), so a caller that drives several pipelines,
    one per device, can enqueue a stage everywhere before any wait.

    affine=True asserts every input point has Z = mont(1) (fresh lifts of
    affine bases, never the identity; nothing checks it): the bucket phase
    then runs complete MIXED adds.  The [P, -P] table only negates Y, so it
    preserves the property.

    `on_phase(name)` is called when a stage's work has been enqueued
    (measurement hook; the caller synchronises).  Returns the projective
    (X, Y, Z) sum, one lane."""
    phase = on_phase or (lambda name: None)
    ptcat = _cat_points(points)
    N = ptcat.shape[0]
    signed = c is None
    if signed:
        c = signed_c
        order, sgn_sorted, starts, counts = _digit_counts_signed(scal, c)
        # table row N+i = -P_i; the sorted sign picks the half
        table = _with_neg_y_table(ptcat, Gp.ncomp)
        order_flat = (order + sgn_sorted * N).reshape(-1)
    else:
        order, starts, counts = _digit_counts(scal, c)
        table = ptcat
        order_flat = order.reshape(-1)
    W, B = starts.shape
    phase("digits_sort")

    yield  # digit and sort work enqueued; the copy below waits for it

    # host-side segment plan: starts/counts are (W, B) int32, a small copy
    # that waits for the device
    starts_np = starts.cpu().numpy()
    counts_np = counts.cpu().numpy()
    T_cap = _pick_t_cap(counts_np, W, B)
    wnd, seg_start, seg_count, lane_off, nseg, L = _plan_segments(
        starts_np, counts_np, T_cap
    )
    s_max = max(1, int(nseg.max()) if nseg.size else 1)
    S_cap = 1 << (s_max - 1).bit_length()
    phase(f"plan_host T_cap={T_cap} S_cap={S_cap} lanes={L}")

    seg_sums = _msm_seg_buckets(
        Gp, table, order_flat.contiguous(), wnd, seg_start, seg_count, N, affine
    )
    phase("bucket")
    buckets = _seg_reduce(Gp, seg_sums, lane_off, nseg, S_cap)
    phase("segment_reduce")
    if signed:
        # drop the magnitude-0 slot: slot m-1 holds magnitude m, weight m
        wins = _weighted_sum_packed(
            Gp, _drop_mag0(buckets, Gp.rows, W, B), W, c - 1, True
        )
    else:
        wins = _weighted_sum_packed(Gp, buckets, W, c)
    phase("weighted_sum")
    out = _horner_ladder_packed(Gp, wins, c)
    phase("horner")

    yield  # heavy kernels enqueued; the caller's copy of the result waits

    return Gp.unpack(out)


def _msm_small_packed(Gp: PackedGroup, points, scal: torch.Tensor):
    """Small MSM: one ladder launch + log tree reduction."""
    acc = Gp.ladder(Gp.pack(points), scal.T.contiguous())
    return Gp.unpack(Gp.tree_reduce(acc))


def msm_pipeline(group_name: str, points, scal: torch.Tensor, c: Optional[int] = None,
                 affine: bool = False, signed_c: int = _SIGNED_C,
                 on_phase: PhaseHook = None):
    """One MSM as a resumable pipeline (generator) over tensors that lie on
    one device already.  Yields where the host would wait for the device;
    the generator's return value is the host affine result."""
    Gp, to_affine, _ = _group(group_name)
    npoints = (points[0] if Gp.ncomp == 1 else points[0][0]).shape[0]
    if scal.shape[0] != npoints:
        raise ValueError(f"msm_{Gp.name}: points and scalars differ in length")
    if scal.shape[0] <= _SMALL_N:
        res = _msm_small_packed(Gp, points, scal)
        yield
    else:
        points, scal = _pad_pow2(points, scal)
        res = yield from _msm_packed_gen(Gp, points, scal, c, affine, signed_c, on_phase)
    out = to_affine(res)[0]
    if on_phase:
        on_phase("to_affine")
    return out


def _msm_entry(group_name: str, points, scalars, c, affine, signed_c, device, on_phase):
    """The body `msm_g1` and `msm_g2` share: move the batch to `device` and
    run its pipeline (the ladder for small batches, Pippenger otherwise) to
    the end; the sum comes back as a host affine point."""
    device = torch.device(device)
    points = _map_coords(lambda coord: coord.to(device), points)
    scal = _prep_scalars(scalars, device)
    return _drive_one(msm_pipeline(group_name, points, scal, c, affine, signed_c, on_phase))


def msm_g1(points, scalars: Sequence[int] | torch.Tensor, c: Optional[int] = None,
           affine: bool = False, signed_c: int = _SIGNED_C,
           device=torch.device("cuda"), on_phase: PhaseHook = None):
    """MSM over G1: projective point batch x scalars -> host affine point
    (`(x, y)` ints, or None for the identity).

    `points` is an (X, Y, Z) tuple of (N, 24) int32 Montgomery limb tensors,
    `scalars` host ints or (N, 16) canonical (non-Montgomery) Fr limbs; both
    are moved to `device`, where the whole computation runs (the CUDA
    kernels on a CUDA device, their plain versions on the CPU).
    `affine=True` asserts every point has Z = mont(1) and enables mixed adds
    in the bucket phase.  c=None uses signed windows of `signed_c` bits."""
    return _msm_entry("g1", points, scalars, c, affine, signed_c, device, on_phase)


def msm_g2(points, scalars: Sequence[int] | torch.Tensor, c: Optional[int] = None,
           affine: bool = False, signed_c: int = _SIGNED_C,
           device=torch.device("cuda"), on_phase: PhaseHook = None):
    """MSM over G2: as `msm_g1` with every coordinate a (c0, c1) pair of
    (N, 24) tensors; returns a host affine point over host `Fq2`, or None.
    `affine=True` asserts every point is an affine lift, Z = (mont(1), 0),
    and none is the identity: a base that may be the identity (a fixed-base
    multiple of a scalar that may be 0) needs `affine=False`."""
    return _msm_entry("g2", points, scalars, c, affine, signed_c, device, on_phase)


# -- many small MSMs in one ladder launch -------------------------------------------


def _group(group_name: str):
    if group_name == "g1":
        return G1P, tc.g1_to_affine_host, msm_g1
    if group_name == "g2":
        return G2P, tc.g2_to_affine_host, msm_g2
    raise ValueError(f"unknown group {group_name!r}: expected 'g1' or 'g2'")


def _ladder_parts(Gp: PackedGroup, to_affine, points, scal: torch.Tensor, bounds):
    """One ladder launch over all lanes, then one tree reduction per
    [lo, hi) part; returns the parts' host affine sums."""
    acc = Gp.ladder(Gp.pack(points), scal.T.contiguous())
    return [
        to_affine(Gp.unpack(Gp.tree_reduce(acc[:, lo:hi].contiguous())))[0]
        if hi > lo else None  # an empty part sums to the identity
        for lo, hi in bounds
    ]


def msm_segmented(group_name: str, points, scalars, n_segments: int,
                  device=torch.device("cuda")):
    """`n_segments` equal-length MSMs over contiguous slices of one batch, in
    one ladder launch; returns the list of host affine sums.  (MIPP's
    per-round cross MSMs are the caller in mind.)  Above 1024 points per
    segment each slice goes through the full Pippenger instead.  No lane is
    padded: the JAX package pads segments to 128 lanes for its tiles, which
    changes only the projective representative of a sum."""
    Gp, to_affine, msm_fn = _group(group_name)
    device = torch.device(device)
    points = _map_coords(lambda coord: coord.to(device), points)
    scal = _prep_scalars(scalars, device)
    n = scal.shape[0]
    if n_segments < 1 or n % n_segments:
        raise ValueError(f"msm_segmented: {n} points do not split into {n_segments} equal segments")
    seg = n // n_segments
    bounds = [(s * seg, (s + 1) * seg) for s in range(n_segments)]
    if seg > _LADDER_MAX:
        return [
            msm_fn(_map_coords(lambda coord: coord[lo:hi], points), scal[lo:hi], device=device)
            for lo, hi in bounds
        ]
    return _ladder_parts(Gp, to_affine, points, scal, bounds)


def msm_multi_small(group_name: str, parts, device=torch.device("cuda")):
    """Many small MSMs of differing lengths in one ladder launch.  `parts`
    is a list of (points, scalars) pairs; returns their host affine sums.
    (The PST opening's per-variable quotient commitments are the caller in
    mind.)  If any part has more than 1024 points every part goes through
    `msm_g1`/`msm_g2`, as in the JAX package."""
    Gp, to_affine, msm_fn = _group(group_name)
    device = torch.device(device)
    parts = [
        (_map_coords(lambda coord: coord.to(device), pts), _prep_scalars(scal, device))
        for pts, scal in parts
    ]
    if not parts:
        return []
    if any(scal.shape[0] > _LADDER_MAX for _, scal in parts):
        return [msm_fn(pts, scal, device=device) for pts, scal in parts]
    bounds, off = [], 0
    for _, scal in parts:
        bounds.append((off, off + scal.shape[0]))
        off += scal.shape[0]
    cat_pts = _map_coords(lambda *coords: torch.cat(coords, dim=0), *[pts for pts, _ in parts])
    cat_scal = torch.cat([scal for _, scal in parts], dim=0)
    return _ladder_parts(Gp, to_affine, cat_pts, cat_scal, bounds)


# -- many MSMs over one shared basis: fixed-base shared-table design ---------------
#
# sqrt-PST commits K column polynomials against ONE basis of N points.
# Pippenger per column would sort and bucket K times over few points.
# Instead tab[j * B + d] = d * G_j for d < 2^c is built once (B - 1 fused adds
# over N lanes, shared by all columns); the sum of (column k, window w) is
# then a straight run of N general adds over gathered table rows: W * N adds
# per column, no sort, and a digit 0 lands on the stored identity row.


def _pick_window(n: int) -> int:
    """Window width of the shared-table multi-MSM, as the JAX package picks
    it, so both build the same table."""
    if n <= 1 << 6:
        return 4
    return 8


def _multi_msm_small(Gp: PackedGroup, points, scal: torch.Tensor):
    """K MSMs over N <= 64 shared points: ONE ladder launch over K * N
    lanes, then log2 N folds of every column at once."""
    K, N, nl = scal.shape
    base = Gp.pack(points)  # (rows, N)
    acc = Gp.ladder(base.repeat(1, K), scal.reshape(K * N, nl).T.contiguous())
    acc = acc.reshape(Gp.rows, K, N)
    while N > 1:
        half = N // 2
        a = acc[:, :, :half].reshape(Gp.rows, K * half).contiguous()
        b = acc[:, :, half : 2 * half].reshape(Gp.rows, K * half).contiguous()
        s = Gp.add2(a, b).reshape(Gp.rows, K, half)
        if N % 2:
            s = torch.cat([s, acc[:, :, -1:]], dim=2)
            half += 1
        acc, N = s, half
    return acc.reshape(Gp.rows, K)


def _multi_msm_table(Gp: PackedGroup, ptcat: torch.Tensor, c: int) -> torch.Tensor:
    """(N, rows) point-major bases -> (N * B, rows) table, row j * B + d =
    d * G_j: B - 1 `add2` launches over N lanes; row d = 0 is the identity
    and every other row the running sum (identity + G + ... + G), the
    projective representative the JAX package's scan stores."""
    N = ptcat.shape[0]
    B = 1 << c
    base = ptcat.T.contiguous()  # (rows, N)
    cur = Gp.identity_packed(N, device=ptcat.device)
    tab = [cur]
    for _ in range(B - 1):
        cur = Gp.add2(cur, base)
        tab.append(cur)
    return torch.stack(tab, dim=0).permute(2, 0, 1).reshape(N * B, Gp.rows).contiguous()


def _multi_msm_index(scal: torch.Tensor, c: int):
    """The bucket kernel's arguments for the window sums of every column:
    (idx, start, count) with lanes k-major, lane (k, w) reading the N entries
    idx[(k W + w) N + t] = t * B + digit_w(scal[k, t]), t = 0..N-1."""
    K, N, nl = scal.shape
    B = 1 << c
    dev = scal.device
    digits = _digits_from_scalars(scal.reshape(K * N, nl), c)  # (W, K * N)
    W = digits.shape[0]
    if N * B >= 1 << 31 or K * W * N >= 1 << 31:
        raise ValueError("multi-MSM: the table or the index list passes 2^31 entries")
    offs = torch.arange(N, dtype=torch.int32, device=dev) * B
    idx = (digits.reshape(W, K, N).permute(1, 0, 2) + offs).reshape(-1).contiguous()
    lanes = K * W
    start = torch.arange(lanes, dtype=torch.int32, device=dev) * N
    count = torch.full((lanes,), N, dtype=torch.int32, device=dev)
    return idx, start, count


def _multi_msm_windows(Gp: PackedGroup, table: torch.Tensor, scal: torch.Tensor, c: int):
    """Window sums of every column: (rows, K * W), lanes k-major.  ONE launch
    of the general bucket kernel: lane (k, w) adds its N table rows in order
    onto the identity; the kernel gathers, so no run tensor is materialised."""
    return Gp.bucket_phase(table, *_multi_msm_index(scal, c))


def _multi_horner_packed(Gp: PackedGroup, wins: torch.Tensor, K: int, c: int) -> torch.Tensor:
    """wins (rows, K * W), lanes k-major -> (rows, K): one ladder launch by
    2^(c w), then folds over W (`acc[..., :half] + acc[..., half:]`)."""
    W = wins.shape[1] // K
    if W & (W - 1):
        raise ValueError(f"multi-MSM: the window count {W} must be a power of two")
    pows = np.zeros((W, FR.nlimbs), dtype=np.int32)
    for w in range(W):
        pows[w, (c * w) // 16] = 1 << ((c * w) % 16)
    scal = torch.as_tensor(np.tile(pows, (K, 1)).T.copy(), device=wins.device)
    acc = Gp.ladder(wins.contiguous(), scal).reshape(Gp.rows, K, W)
    while W > 1:
        half = W // 2
        a = acc[:, :, :half].reshape(Gp.rows, K * half).contiguous()
        b = acc[:, :, half:].reshape(Gp.rows, K * half).contiguous()
        acc = Gp.add2(a, b).reshape(Gp.rows, K, half)
        W = half
    return acc.reshape(Gp.rows, K)


def _multi_msm_packed(Gp: PackedGroup, points, scal: torch.Tensor, c: int = 8,
                      on_phase: PhaseHook = None):
    """K MSMs over one shared basis on the packed kernels -> a projective
    batch of K points.  scal: (K, N, nlimbs) canonical scalars."""
    phase = on_phase or (lambda name: None)
    K = scal.shape[0]
    table = _multi_msm_table(Gp, _cat_points(points), c)
    phase("table")
    wins = _multi_msm_windows(Gp, table, scal, c)
    phase("bucket")
    out = _multi_horner_packed(Gp, wins, K, c)
    phase("horner")
    return Gp.unpack(out)


def _multi_msm_device(group_name: str, points, scalars_canon: torch.Tensor, c: int,
                      on_phase: PhaseHook = None):
    """Many MSMs over one shared basis: canonical scalars (K, N, nlimbs) -> a
    projective batch of K points, on the device the scalars lie on (the
    sqrt-PST column commitments).  At most 64 points take the ladder; more
    take the shared-table design with c-bit windows (c in 4, 8, 16)."""
    Gp, _, _ = _group(group_name)
    if scalars_canon.dim() != 3 or scalars_canon.shape[2] != FR.nlimbs:
        raise ValueError(
            f"multi-MSM: scalars must be (K, N, {FR.nlimbs}), got {tuple(scalars_canon.shape)}"
        )
    device = scalars_canon.device
    points = _map_coords(lambda coord: coord.to(device), points)
    npoints = (points[0] if Gp.ncomp == 1 else points[0][0]).shape[0]
    if npoints != scalars_canon.shape[1]:
        raise ValueError("multi-MSM: the basis and the scalar columns differ in length")
    if npoints <= _SMALL_N:
        return Gp.unpack(_multi_msm_small(Gp, points, scalars_canon))
    return _multi_msm_packed(Gp, points, scalars_canon, c, on_phase)
