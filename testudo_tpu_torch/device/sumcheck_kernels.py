"""The fused sumcheck's kernels: a round and its tail, wrappers and plain
versions.

No Pallas counterpart: in the reference a fused sumcheck is one jit of XLA
ops (testudo_tpu/core/sumcheck.py:222-267, :534-594) whose products over 512
rows or more reach the Pallas Montgomery product.  Here a round is two
launches and no copy to the host (core/sumcheck.py `_prove_fused`):

  - `sumcheck_round` (csrc/sumcheck_round.cu): for a stack of Fr tables
    `(T, n, 16)`, optionally fold every table by the previous challenge r
    (`dense.bound_top`), then each instance's sums of the kind's
    combination at X = 0, 2 (and 3) over the half-tables
    (`_round_evals_*`), one partial sum a block: returns the folded stack
    and the partials `(k, blocks, points, 16)`.  A block works tiles of P
    pairs (2P without the fold): a thread a (table, pair) reads its rows
    and folds, a thread a (pair, point) sums; large rounds without the fold
    take a thread a pair; the grid is at most the blocks the card keeps
    resident (`round_blocks`).
  - `sumcheck_tail` (csrc/sumcheck_tail.cu): sum the partials, combine the
    instances by their coefficients, form the round polynomial's
    coefficients (`unipoly_coeffs_dev`), absorb them into the device sponge
    and squeeze the challenge (device/sponge.py's rules), and the next claim
    by Horner (`horner_dev`): returns (coefficients, r, claim, state).

Kinds: "quad" (tables A, B: sum A B), "cubic_tau" (tau, A, B, C: sum tau (A B
- C)) and "cubic" (the batched product layout: A_par (k_par), B_par
(k_par), one shared C, A_seq, B_seq, C_seq (k_seq each); sum over the
instances of A_i B_i C_i, each instance's sums apart).  Every value is a
canonical Montgomery Fr element and every sum exact, so the kernels and the
plain versions agree limb for limb whatever their order of operations.

On CUDA tensors a wrapper launches its kernel or raises; on CPU tensors it
runs the plain version beside it.
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import torch

from . import build, packed_field
from . import field as tf
from . import sponge as dsponge
from .field import FR, FieldSpec

KINDS = {"quad": 0, "cubic_tau": 1, "cubic": 2}  # SC_QUAD, SC_CUBIC_TAU, SC_CUBIC
POINTS = {"quad": 2, "cubic_tau": 3, "cubic": 3}


def instance_tables(kind: str, k_par: int = 1, k_seq: int = 0) -> List[Tuple[int, ...]]:
    """Each instance's tables, as indexes into the stack."""
    if kind == "quad":
        return [(0, 1)]
    if kind == "cubic_tau":
        return [(0, 1, 2, 3)]
    base = 2 * k_par + 1
    return ([(i, k_par + i, 2 * k_par) for i in range(k_par)]
            + [(base + j, base + k_seq + j, base + 2 * k_seq + j) for j in range(k_seq)])


def stack_size(kind: str, k_par: int = 1, k_seq: int = 0) -> int:
    return {"quad": 2, "cubic_tau": 4}.get(kind, 2 * k_par + 1 + 3 * k_seq)


@functools.lru_cache(maxsize=None)
def _grid(kind: str, n: int, fold: bool, k_par: int, k_seq: int, device_index: int) -> int:
    with torch.cuda.device(device_index):
        nb = build.query("sumcheck_round_grid", KINDS[kind], n, int(fold), k_par, k_seq)
    if nb <= 0:
        raise RuntimeError(f"sumcheck_round ({kind}): the occupancy query failed ({nb})")
    return nb


def round_blocks(kind: str, n: int, fold: bool, device, k_par: int = 1, k_seq: int = 0) -> int:
    """Blocks a row of a round launch on the card in the form the launcher
    takes for the shape: the tiles (or, in the straight form, blocks of
    128 or 256 pairs), at most the kernel's resident blocks shared by the
    rows (csrc/sumcheck_round.cu `round_grid`; the blocks then loop).  CUDA
    only."""
    return _grid(kind, n, bool(fold), k_par, k_seq, torch.device(device).index or 0)


def _check_round(kind: str, src: torch.Tensor, r, k_par: int, k_seq: int) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown sumcheck kind {kind!r}")
    if k_par < 0 or k_seq < 0 or (kind == "cubic" and k_par + k_seq < 1):
        raise ValueError(f"the batched layout needs an instance, got ({k_par}, {k_seq})")
    T = stack_size(kind, k_par, k_seq)
    if src.dim() != 3 or src.shape[0] != T or src.shape[2] != FR.nlimbs:
        raise ValueError(f"sumcheck_round ({kind}): expected a ({T}, n, {FR.nlimbs}) stack, got "
                         f"{tuple(src.shape)}")
    n = src.shape[1]
    if n < 2 or n & (n - 1):
        raise ValueError(f"sumcheck_round: tables of {n} rows, expected a power of two >= 2")
    if r is not None and tuple(r.shape) != (FR.nlimbs,):
        raise ValueError(f"sumcheck_round: r is one Fr element, got {tuple(r.shape)}")


def _comb(kind: str, x: torch.Tensor) -> torch.Tensor:
    """The kind's combination of (k, tables, h, 16) values -> (k, h, 16)."""
    mul = lambda a, b: tf.mont_mul_plain(FR, a, b)
    if kind == "quad":
        return mul(x[:, 0], x[:, 1])
    if kind == "cubic_tau":
        return mul(x[:, 0], tf.sub(FR, mul(x[:, 1], x[:, 2]), x[:, 3]))
    return mul(mul(x[:, 0], x[:, 1]), x[:, 2])


def sumcheck_round_plain(kind: str, src: torch.Tensor, r=None, k_par: int = 1, k_seq: int = 0):
    """Plain version of the round kernel: (the stack folded by r, or src
    itself; the sums as one block's partials `(k, 1, points, 16)`).  The
    last fold (to one row) sums nothing: its partials are 0."""
    _check_round(kind, src, r, k_par, k_seq)
    if r is not None:
        s = src.shape[1] // 2
        lo, hi = src[:, :s], src[:, s:]
        src = tf.add(FR, lo, tf.mont_mul_plain(FR, tf.sub(FR, hi, lo), r))
    idx = instance_tables(kind, k_par, k_seq)
    h = src.shape[1] // 2
    if h == 0:
        return src, torch.zeros((len(idx), 1, POINTS[kind], FR.nlimbs), dtype=torch.int32,
                                device=src.device)
    x = src[torch.as_tensor(idx, device=src.device)]  # (k, tables, n, 16)
    lo, hi = x[:, :, :h], x[:, :, h:]
    slope = tf.sub(FR, hi, lo)
    at2 = tf.add(FR, hi, slope)
    pts = [lo, at2, tf.add(FR, at2, slope)][: POINTS[kind]]
    sums = [tf.reduce_sum(FR, _comb(kind, p), axis=1, mul=tf.mont_mul_plain) for p in pts]
    return src, torch.stack(sums, dim=1)[:, None]


def sumcheck_round(kind: str, src: torch.Tensor, r=None, k_par: int = 1, k_seq: int = 0):
    """One round over the stack `src` (T, n, 16), folded first by r (one Fr
    element) when given: (the folded stack `(T, n / 2, 16)`, or src; the
    partial sums `(k, blocks, points, 16)`)."""
    _check_round(kind, src, r, k_par, k_seq)
    if not src.is_cuda:
        return sumcheck_round_plain(kind, src, r, k_par, k_seq)
    T, n, nl = src.shape
    fold = r is not None
    k = len(instance_tables(kind, k_par, k_seq))
    nb = round_blocks(kind, n, fold, src.device, k_par, k_seq)
    src = src.contiguous()
    dst = torch.empty((T, n // 2, nl), dtype=torch.int32, device=src.device) if fold else src
    partials = torch.empty((k, nb, POINTS[kind], nl), dtype=torch.int32, device=src.device)
    if fold:
        r = r.contiguous()
        build.require_cuda_int32("sumcheck_round", src=src, r=r)
        build.require_aligned("sumcheck_round", 16, src=src, r=r)
    else:
        build.require_cuda_int32("sumcheck_round", src=src)
        build.require_aligned("sumcheck_round", 16, src=src)
    with torch.cuda.device(src.device):
        build.launch("sumcheck_round", src.data_ptr(), dst.data_ptr() if fold else None,
                     r.data_ptr() if fold else None, partials.data_ptr(), KINDS[kind], n,
                     int(fold), k_par, k_seq, nb)
    return dst, partials


# -- the round polynomial on the device ------------------------------------------

_TWO_INV = pow(2, -1, FR.modulus)
_SIX_INV = pow(6, -1, FR.modulus)


def _const(x: int, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(FR.encode(x), device=like.device)


def unipoly_coeffs_dev(evals: Sequence[torch.Tensor], mul=tf.mont_mul) -> List[torch.Tensor]:
    """Device mirror of UniPoly.from_evals (unipoly.rs:26-49): the
    coefficients, low to high, of the polynomial through (0, e0), (1, e1),
    (2, e2)(, (3, e3)), Montgomery Fr elements.  `mul` is the product."""
    fadd = lambda a, b: tf.add(FR, a, b)
    fsub = lambda a, b: tf.sub(FR, a, b)
    if len(evals) == 3:
        e0, e1, e2 = evals
        a = mul(FR, _const(_TWO_INV, e0), fsub(fadd(fsub(e2, e1), e0), e1))
        return [e0, fsub(fsub(e1, e0), a), a]
    e0, e1, e2, e3 = evals
    t3 = lambda x: fadd(fadd(x, x), x)
    a = mul(FR, _const(_SIX_INV, e0), fsub(fadd(t3(e1), e3), fadd(t3(e2), e0)))
    b = mul(FR, _const(_TWO_INV, e0),
            fsub(fadd(fadd(e0, e0), fadd(t3(e2), e2)), fadd(fadd(t3(e1), fadd(e1, e1)), e3)))
    return [e0, fsub(fsub(fsub(e1, e0), a), b), b, a]


def horner_dev(coeffs: Sequence[torch.Tensor], r: torch.Tensor, mul=tf.mont_mul) -> torch.Tensor:
    """The polynomial with these coefficients at r (Montgomery Fr)."""
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = tf.add(FR, mul(FR, acc, r), c)
    return acc


def _check_tail(kind: str, partials, inst_coeffs, e, state, sponge: FieldSpec, mode, index):
    if kind not in KINDS:
        raise ValueError(f"unknown sumcheck kind {kind!r}")
    if partials.dim() != 4 or tuple(partials.shape[2:]) != (POINTS[kind], FR.nlimbs):
        raise ValueError(f"sumcheck_tail ({kind}): partials are (k, blocks, {POINTS[kind]}, "
                         f"{FR.nlimbs}), got {tuple(partials.shape)}")
    if tuple(inst_coeffs.shape) != (partials.shape[0], FR.nlimbs):
        raise ValueError(f"sumcheck_tail: one coefficient an instance, got "
                         f"{tuple(inst_coeffs.shape)} for {partials.shape[0]}")
    if tuple(e.shape) != (FR.nlimbs,) or tuple(state.shape) != (3, sponge.nlimbs):
        raise ValueError(f"sumcheck_tail: claim {tuple(e.shape)}, state {tuple(state.shape)}")
    if mode not in (dsponge._ABSORBING, dsponge._SQUEEZING) or not 0 <= index <= 2:
        raise ValueError(f"sumcheck_tail: sponge mode {mode}, index {index}")


def sumcheck_tail_plain(kind: str, partials: torch.Tensor, inst_coeffs: torch.Tensor,
                        e: torch.Tensor, state: torch.Tensor, sponge: FieldSpec, mode: int,
                        index: int):
    """Plain version of the tail kernel, in tensor ops on the plain product
    and permutation."""
    _check_tail(kind, partials, inst_coeffs, e, state, sponge, mode, index)
    mul = tf.mont_mul_plain
    sums = tf.reduce_sum(FR, partials, axis=1, mul=mul)  # (k, points, 16)
    ev = tf.reduce_sum(FR, mul(FR, inst_coeffs[:, None, :], sums), axis=0, mul=mul)
    coeffs = unipoly_coeffs_dev([ev[0], tf.sub(FR, e, ev[0])] + list(ev[1:]), mul)
    dt = dsponge.DeviceTranscript(dsponge.DeviceSponge(sponge, state, mode, index, plain=True))
    for c in coeffs:
        dt.append_fr_mont(c)
    r = dt.challenge_fr_mont()
    return torch.stack(coeffs), r, horner_dev(coeffs, r, mul), dt.sponge.state


def sumcheck_tail(kind: str, partials: torch.Tensor, inst_coeffs: torch.Tensor, e: torch.Tensor,
                  state: torch.Tensor, sponge: FieldSpec, mode: int, index: int):
    """The tail of a round from the round kernel's partials, the instances'
    coefficients `(k, 16)`, the claim e, and the sponge's state `(3,
    nlimbs)` with its (mode, index) before the round's first absorb:
    (coefficients `(points + 1, 16)`, challenge r, next claim, new state)."""
    _check_tail(kind, partials, inst_coeffs, e, state, sponge, mode, index)
    fid = packed_field.field_id(sponge, "sumcheck_tail", dsponge.SPONGE_FIELDS)
    if not partials.is_cuda:
        return sumcheck_tail_plain(kind, partials, inst_coeffs, e, state, sponge, mode, index)
    ins = [t.contiguous() for t in (partials, inst_coeffs, e, state)]
    build.require_cuda_int32("sumcheck_tail", partials=ins[0], inst_coeffs=ins[1], e=ins[2],
                             state=ins[3])
    build.require_aligned("sumcheck_tail", 16, partials=ins[0], inst_coeffs=ins[1], e=ins[2],
                          state=ins[3])
    dev = partials.device
    coeffs = torch.empty((POINTS[kind] + 1, FR.nlimbs), dtype=torch.int32, device=dev)
    r = torch.empty(FR.nlimbs, dtype=torch.int32, device=dev)
    e_out = torch.empty_like(r)
    state_out = torch.empty_like(ins[3])
    k, nb = partials.shape[:2]
    with torch.cuda.device(dev):
        build.launch("sumcheck_tail", *(t.data_ptr() for t in ins), coeffs.data_ptr(),
                     r.data_ptr(), e_out.data_ptr(), state_out.data_ptr(), POINTS[kind], k, nb,
                     fid, mode, index)
    return coeffs, r, e_out, state_out
