"""Packed-layout G1 and G2 group operations: kernel wrappers and plain versions.

Counterpart of testudo_tpu/tpu/pallas_curve.py:606-760 (`PackedGroup`,
`G1P`, `G2P`).  A batch of L points is one `(3 * ncomp * 24, L)` int32
tensor: coordinate-major (X, Y, Z), within a coordinate component-major
(c0, c1 for G2), 24 rows of 16-bit Montgomery limbs per component, batch
along L.  The row of coordinate c, component comp, limb k is
`(c * ncomp + comp) * 24 + k`: 72 rows for G1 (ncomp 1), 144 for G2.

Every fused op has a wrapper that, on CUDA tensors, checks its arguments,
launches the hand-written kernel (csrc/ec_ops.cu, ladder_team.cu,
ladder_wide.cu or ladder.cu by width, bucket.cu, wsum_team.cu, chain_team.cu, fold_team.cu,
fixed_base_team.cu)
on the current stream and raises on failure;
on CPU tensors it runs the plain
PyTorch version defined beside it (`*_plain`), which evaluates the same
RCB16 formulas (device/curve.py) in int64 tensor ops.  The plain versions
also run on CUDA tensors when called directly, which is how a kernel is
held against its plain version on the card; they never launch a kernel.

What differs from the JAX package: `ladder` is one launch (not one `step`
launch per bit), and a wide one runs its lanes in the caller's order and
stops each after its scalar's top bit; so is `weighted_sum` (not a `scan2b`
launch per bucket of a group and a `step` launch per weight bit); so are
`chain`, the commit's
table (not an `add2` launch per multiple), and `fold`, every tree of
pairwise sums of a batch (not an `add2` launch per level), and
`fixed_base`, the fixed-base multiplication (not an `add_mask` launch per
scalar bit); `bucket_phase`
gathers by index inside the kernel from a point-major table instead of
streaming a materialised run tensor, and runs its lanes longest first on a
grid that stays resident; masks are one int per lane; `add_mask` also takes ONE point for all lanes (a single
column: the fixed-base ladder's table entry); no lane padding to tiles
anywhere.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build
from . import curve as tc
from .field import FQ, FieldSpec, LIMB_BITS


def longest_first(count: torch.Tensor) -> torch.Tensor:
    """The bucket kernel's lane order: lane indices by `count`, longest
    first, equal counts in lane order (int32, on count's device; empty for
    no lanes)."""
    return torch.argsort(count, descending=True, stable=True).to(torch.int32)


# The widest launch the team ladder (csrc/ladder_team.cu) takes, per group
# (ncomp); wider ones go to the wide ladder (csrc/ladder_wide.cu).  Measured on
# an H100 with tools/exp_ladder.py (PERF.md section 6, the ladder crossover
# table), with the wide kernel in place: on random scalars (the open's folds)
# the team kernel wins at 1,024 lanes (G1 1.52 against 3.34 ms, G2 4.12
# against 6.40) and loses at 4,096 (G1 3.88 against 3.34) and 2,048 (G2 7.32
# against 6.71); on Horner scalars the wide kernel wins for G1 at every width
# (20 lanes: 1.35 against 1.48 ms) and for G2 from 1,024 lanes on.  Every
# path's ladder of 1,024 lanes or fewer is the MSM's 20-lane Horner or a
# fold of random scalars.  The wider ones are the commit's Horner (lanes
# longest first) and, at nv = 11-12, `_multi_msm_small`'s 2,048-4,096 lanes
# of random scalars in no order.
TEAM_LADDER_MAX_LANES = {1: 1024, 2: 1024}

# The widest launch given in no order that the wide ladder takes, per group;
# wider ones go to one thread a lane over all bits (csrc/ladder.cu).  A launch
# given its lanes longest first takes the wide ladder at any width.  Measured
# on an H100 with tools/exp_ladder.py (PERF.md section 6): on random scalars
# the wide ladder beats the one-thread ladder up to 8,192 lanes (G1 4.83
# against 8.77 ms, G2 17.98 against 32.35) and loses at 32,768 (17.19 against
# 14.05, 65.89 against 64.77); on the commit's scalars, longest first, it
# wins at 8,192 and 32,768 lanes (G1 1.55 against 4.09 ms, 3.24 against
# 6.20).  With --forms no launch split between teams and one thread a lane
# beat the better of the two.  No path makes an unordered launch wider than
# 4,096 lanes.
WIDE_LADDER_MAX_UNORDERED = {1: 8192, 2: 8192}


def lane_order(order, L: int) -> np.ndarray:
    """`order` (host integers) as int32 (L,), checked to be a permutation of
    the L lanes: the wide ladder reads lane order[i] with no check of its
    own.  ValueError otherwise."""
    o = np.asarray(order)
    if o.shape != (L,) or o.dtype.kind not in "iu":
        raise ValueError(f"ladder: order must be ({L},) host integers, got {o.dtype} {o.shape}")
    if L and (o.min() < 0 or o.max() >= L or (np.bincount(o, minlength=L) != 1).any()):
        raise ValueError(f"ladder: order must be a permutation of the {L} lanes")
    return o.astype(np.int32)


# The widest fixed-base launch the team kernel (csrc/fixed_base_team.cu,
# `k_fixed_base_team`) takes, per group (ncomp); wider ones go to one thread
# per lane (`k_fixed_base_one`, same source).  Measured on an H100 with
# tools/exp_fixed_base.py (PERF.md section 6): at 8,192 lanes the team kernel
# wins (G1 3.48 against 6.15 ms, G2 11.96 against 19.53), at 2^16 one thread
# does (18.21 against 25.09 ms, 73.95 against 86.58); `pst.setup` gives at
# most 2,047 lanes (nv = 20), chip_smoke.py's fixed-base phase 2^16.
FIXED_TEAM_MAX_LANES = {1: 8192, 2: 8192}


class PackedGroup:
    """One EC group in packed-rows layout (G1: ncomp = 1, G2: ncomp = 2).
    `b3_k` is the Montgomery form of (3 b).c1 for G2 (the kernels carry it as
    a constant table), None for G1."""

    def __init__(self, name: str, spec: FieldSpec, ncomp: int, b3_k: int | None):
        if ncomp not in (1, 2):
            raise ValueError(f"ncomp must be 1 or 2, got {ncomp}")
        self.name = name
        self.spec = spec
        self.ncomp = ncomp
        self.b3_k = b3_k
        self.rows = 3 * ncomp * spec.nlimbs
        # group law of the plain versions, never a kernel
        self._plain = tc._G1PlainOps if ncomp == 1 else tc._G2PlainOps

    def _counter(self, kernel: str) -> str:
        """Name of this group's launch counter for `kernel`."""
        return kernel if self.ncomp == 1 else kernel + "_g2"

    # -- layout ------------------------------------------------------------

    def pack(self, p) -> torch.Tensor:
        """Point batch (X, Y, Z), each a (batch, nlimbs) tensor or for G2 a
        (c0, c1) pair of them -> (rows, L) packed tensor."""
        n = self.spec.nlimbs
        comps = p if self.ncomp == 1 else [comp for coord in p for comp in coord]
        return torch.cat([c.reshape(-1, n).T for c in comps], dim=0).contiguous()

    def unpack(self, a: torch.Tensor):
        n = self.spec.nlimbs
        comps = [a[i * n : (i + 1) * n].T.contiguous() for i in range(3 * self.ncomp)]
        if self.ncomp == 1:
            return tuple(comps)
        return tuple((comps[2 * c], comps[2 * c + 1]) for c in range(3))

    def identity_packed(self, L: int, device=torch.device("cuda")) -> torch.Tensor:
        n = self.spec.nlimbs
        a = np.zeros((self.rows, L), dtype=np.int32)
        ybase = self.ncomp * n  # Y (component c0) rows
        a[ybase : ybase + n] = self.spec.to_limbs(self.spec.r_mod_p)[:, None]
        return torch.as_tensor(a, device=device)

    def _select(self, mask, s, acc):
        return tuple(self._plain.select(mask, s[c], acc[c]) for c in range(3))

    # -- argument checks -----------------------------------------------------

    def _check_points(self, op: str, *arrays: torch.Tensor) -> int:
        L = arrays[0].shape[-1]
        for a in arrays:
            if a.dim() != 2 or a.shape != (self.rows, L):
                raise ValueError(
                    f"{op}: expected ({self.rows}, {L}) packed points, got {tuple(a.shape)}"
                )
        return L

    @staticmethod
    def _on_cuda(*tensors) -> bool:
        return any(t is not None and t.is_cuda for t in tensors)

    # -- add2 ------------------------------------------------------------------

    def add2_plain(self, a, b):
        return self.pack(tc._complete_add(self._plain, self.unpack(a), self.unpack(b)))

    def add2(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a + b, complete add, lane by lane."""
        L = self._check_points("add2", a, b)
        if not self._on_cuda(a, b):
            return self.add2_plain(a, b)
        build.require_cuda_int32("add2", a=a, b=b)
        out = torch.empty_like(a)
        with torch.cuda.device(a.device):
            build.launch("add2", a.data_ptr(), b.data_ptr(), out.data_ptr(), L,
                         self.ncomp, counted_as=self._counter("add2"))
        return out

    # -- add_mask --------------------------------------------------------------

    def add_mask_plain(self, acc, pts, mask):
        A = self.unpack(acc)
        P = self.unpack(pts.expand(-1, acc.shape[1]))
        return self.pack(self._select(mask != 0, tc._complete_add(self._plain, A, P), A))

    def add_mask(self, acc: torch.Tensor, pts: torch.Tensor, mask: torch.Tensor):
        """mask ? acc + pts : acc.  `pts` is (rows, L), or (rows, 1): one
        point that every lane adds (the kernel reads the one column; nothing
        is broadcast in memory).  mask is one int32 per lane."""
        L = self._check_points("add_mask", acc)
        if pts.dim() != 2 or pts.shape not in ((self.rows, L), (self.rows, 1)):
            raise ValueError(
                f"add_mask: pts must be ({self.rows}, {L}) or ({self.rows}, 1), "
                f"got {tuple(pts.shape)}"
            )
        if mask.shape != (L,):
            raise ValueError(f"add_mask: mask must have shape ({L},), got {tuple(mask.shape)}")
        if not self._on_cuda(acc, pts, mask):
            return self.add_mask_plain(acc, pts, mask)
        build.require_cuda_int32("add_mask", acc=acc, pts=pts, mask=mask)
        out = torch.empty_like(acc)
        shared = int(pts.shape[1] == 1 and L != 1)
        with torch.cuda.device(acc.device):
            build.launch(
                "add_mask", acc.data_ptr(), pts.data_ptr(), mask.data_ptr(),
                out.data_ptr(), L, shared, self.ncomp,
                counted_as=self._counter("add_mask"),
            )
        return out

    # -- fixed-base multiplication ----------------------------------------------

    def fixed_base_steps(self, table, scal, add_mask):
        """[s_i] B as a sequence of `add_mask` calls (the one given: the plain
        version, or the kernel, one launch per bit): acc = O, then for each
        column k of the table of doublings acc = bit k of s_i ? acc + T_k :
        acc, bit k of every scalar sliced out on the host side of the call.
        Returns (rows, N)."""
        acc = self.identity_packed(scal.shape[0], device=scal.device)
        for k in range(table.shape[1]):
            bit = ((scal[:, k // LIMB_BITS] >> (k % LIMB_BITS)) & 1).contiguous()
            acc = add_mask(acc, table[:, k : k + 1].contiguous(), bit)
        return acc

    def fixed_base_plain(self, table, scal):
        return self.fixed_base_steps(table, scal, self.add_mask_plain)

    def fixed_base_kernel(self, N: int) -> str:
        """The kernel `fixed_base` launches for N lanes: the team kernel up to
        FIXED_TEAM_MAX_LANES of this group, one thread per lane above."""
        return "fixed_base" if N <= FIXED_TEAM_MAX_LANES[self.ncomp] else "fixed_base_one"

    def fixed_base(self, table: torch.Tensor, scal: torch.Tensor) -> torch.Tensor:
        """[s_i] B for the packed (rows, 16 nl) table of doublings T_k = 2^k B
        and (N, nl) canonical 16-bit scalar limbs -> (rows, N): the adds and
        selects of `fixed_base_steps` in their order.  On the card one
        launch (csrc/fixed_base_team.cu, a team of threads per lane or, wide,
        one thread: `fixed_base_kernel`) that reads the scalar bits itself."""
        if scal.dim() != 2 or not 1 <= scal.shape[1] <= 16:
            raise ValueError(f"fixed_base: scalars must be (N, nl), 1 <= nl <= 16, "
                             f"got {tuple(scal.shape)}")
        nb = LIMB_BITS * scal.shape[1]
        if table.dim() != 2 or table.shape != (self.rows, nb):
            raise ValueError(f"fixed_base: table must be ({self.rows}, {nb}), "
                             f"got {tuple(table.shape)}")
        for name, t in (("table", table), ("scalars", scal)):
            if t.dtype != torch.int32:
                raise TypeError(f"fixed_base: {name} must be int32, got {t.dtype}")
        if not self._on_cuda(table, scal):
            return self.fixed_base_plain(table, scal)
        return self.fixed_base_launch(self.fixed_base_kernel(scal.shape[0]), table, scal)

    def fixed_base_launch(self, kernel: str, table: torch.Tensor,
                          scal: torch.Tensor) -> torch.Tensor:
        """Launch fixed-base kernel `kernel` ("fixed_base" or "fixed_base_one")
        on checked CUDA tensors: what `fixed_base` calls, and what a
        measurement calls to time either kernel at any width."""
        build.require_cuda_int32(kernel, table=table, scal=scal)
        N, nl = scal.shape
        out = torch.empty((self.rows, N), dtype=torch.int32, device=table.device)
        with torch.cuda.device(table.device):
            build.launch(kernel, table.data_ptr(), scal.data_ptr(), out.data_ptr(), N, nl,
                         self.ncomp, counted_as=self._counter(kernel))
        return out

    # -- step ------------------------------------------------------------------

    def step_plain(self, acc, base, mask):
        A, B = self.unpack(acc), self.unpack(base)
        s = tc._complete_add(self._plain, A, B)
        return (self.pack(self._select(mask != 0, s, A)),
                self.pack(tc._complete_double(self._plain, B)))

    def step(self, acc: torch.Tensor, base: torch.Tensor, mask: torch.Tensor):
        """(mask ? acc + base : acc, 2 base); mask is one int32 per lane."""
        L = self._check_points("step", acc, base)
        if mask.shape != (L,):
            raise ValueError(f"step: mask must have shape ({L},), got {tuple(mask.shape)}")
        if not self._on_cuda(acc, base, mask):
            return self.step_plain(acc, base, mask)
        build.require_cuda_int32("step", acc=acc, base=base, mask=mask)
        out_acc, out_base = torch.empty_like(acc), torch.empty_like(base)
        with torch.cuda.device(acc.device):
            build.launch(
                "step", acc.data_ptr(), base.data_ptr(), mask.data_ptr(),
                out_acc.data_ptr(), out_base.data_ptr(), L, self.ncomp,
                counted_as=self._counter("step"),
            )
        return out_acc, out_base

    # -- scan2 -----------------------------------------------------------------

    def scan2_plain(self, run, tot, bl):
        run2 = tc._complete_add(self._plain, self.unpack(run), self.unpack(bl))
        return (
            self.pack(run2),
            self.pack(tc._complete_add(self._plain, self.unpack(tot), run2)),
        )

    def scan2(self, run: torch.Tensor, tot: torch.Tensor, bl: torch.Tensor):
        """(run + bl, tot + (run + bl)): two dependent adds."""
        return self._scan("scan2", self.scan2_plain, run, tot, bl)

    # -- scan2b ----------------------------------------------------------------

    def scan2b_plain(self, run, tot, bl):
        R, T, B = self.unpack(run), self.unpack(tot), self.unpack(bl)
        return (
            self.pack(tc._complete_add(self._plain, R, B)),
            self.pack(tc._complete_add(self._plain, T, R)),
        )

    def scan2b(self, run: torch.Tensor, tot: torch.Tensor, bl: torch.Tensor):
        """(run + bl, tot + run): two independent adds on the old run."""
        return self._scan("scan2b", self.scan2b_plain, run, tot, bl)

    def _scan(self, kernel: str, plain, run, tot, bl):
        L = self._check_points(kernel, run, tot, bl)
        if not self._on_cuda(run, tot, bl):
            return plain(run, tot, bl)
        build.require_cuda_int32(kernel, run=run, tot=tot, bl=bl)
        out_run, out_tot = torch.empty_like(run), torch.empty_like(tot)
        with torch.cuda.device(run.device):
            build.launch(
                kernel, run.data_ptr(), tot.data_ptr(), bl.data_ptr(),
                out_run.data_ptr(), out_tot.data_ptr(), L, self.ncomp,
                counted_as=self._counter(kernel),
            )
        return out_run, out_tot

    # -- ladder ----------------------------------------------------------------

    def ladder_plain(self, pts, scal_rows):
        nl, L = scal_rows.shape
        acc = self.unpack(self.identity_packed(L, device=pts.device))
        base = self.unpack(pts)
        for k in range(nl):
            for b in range(LIMB_BITS):
                m = ((scal_rows[k] >> b) & 1) != 0
                s = tc._complete_add(self._plain, acc, base)
                acc = self._select(m, s, acc)
                base = tc._complete_double(self._plain, base)
        return self.pack(acc)

    def ladder_kernel(self, L: int, ordered: bool = False) -> str:
        """The kernel `ladder` launches for L lanes: the team ladder up to
        TEAM_LADDER_MAX_LANES of this group; above, the wide ladder when the
        lanes come longest first (`ordered`) or number at most
        WIDE_LADDER_MAX_UNORDERED, else one thread a lane over all bits."""
        if L <= TEAM_LADDER_MAX_LANES[self.ncomp]:
            return "ladder_team"
        if ordered or L <= WIDE_LADDER_MAX_UNORDERED[self.ncomp]:
            return "ladder_wide"
        return "ladder"

    def ladder(self, pts: torch.Tensor, scal_rows: torch.Tensor, order=None) -> torch.Tensor:
        """pts (rows, L) x canonical scalars (nscal_limbs, L) int32 ->
        [s_l] P_l: LSB-first double-and-add over all 16 * nscal_limbs bits.
        On the card the kernel by width (`ladder_kernel`): a narrow batch a
        team of threads a lane, a wide one the wide kernel, which stops
        each lane after its scalar's top bit and runs the lanes in `order`
        (host integers (L,), a permutation of the lanes, checked: longest
        scalars first, from a caller that knows its scalars' lengths; None:
        index order).  The order changes when a lane runs, never its
        result: every form gives the plain version's limbs."""
        L = self._check_points("ladder", pts)
        if scal_rows.dim() != 2 or scal_rows.shape[1] != L:
            raise ValueError(
                f"ladder: scalars must be (nlimbs, {L}), got {tuple(scal_rows.shape)}"
            )
        if order is not None:
            order = lane_order(order, L)
        if not self._on_cuda(pts, scal_rows):
            return self.ladder_plain(pts, scal_rows)
        kernel = self.ladder_kernel(L, order is not None)
        if kernel == "ladder_wide":
            return self.ladder_wide_launch(
                pts, scal_rows, None if order is None else torch.as_tensor(order, device=pts.device))
        return self.ladder_launch(kernel, pts, scal_rows)

    def ladder_launch(self, kernel: str, pts: torch.Tensor,
                      scal_rows: torch.Tensor) -> torch.Tensor:
        """Launch ladder kernel `kernel` ("ladder", one thread a lane over
        all bits, or "ladder_team") on checked CUDA tensors: what `ladder`
        calls at narrow widths, and what a measurement calls to time either
        kernel at any width."""
        build.require_cuda_int32(kernel, pts=pts, scal_rows=scal_rows)
        out = torch.empty_like(pts)
        with torch.cuda.device(pts.device):
            build.launch(
                kernel, pts.data_ptr(), scal_rows.data_ptr(), out.data_ptr(),
                scal_rows.shape[0], pts.shape[1], self.ncomp,
                counted_as=self._counter(kernel),
            )
        return out

    def ladder_wide_launch(self, pts: torch.Tensor, scal_rows: torch.Tensor,
                           order: torch.Tensor | None) -> torch.Tensor:
        """Launch the wide ladder (csrc/ladder_wide.cu) on checked CUDA
        tensors, its lanes in `order` (an int32 CUDA tensor that must be a
        permutation of the lanes, which `ladder` checks and this launcher
        does not; None: index order): what `ladder` calls at wide widths,
        and what a measurement calls to time the kernel at any width."""
        tensors = dict(pts=pts, scal_rows=scal_rows)
        if order is not None:
            tensors["order"] = order
        build.require_cuda_int32("ladder_wide", **tensors)
        out = torch.empty_like(pts)
        with torch.cuda.device(pts.device):
            build.launch(
                "ladder_wide", pts.data_ptr(), scal_rows.data_ptr(),
                order.data_ptr() if order is not None else None, out.data_ptr(),
                scal_rows.shape[0], pts.shape[1], self.ncomp,
                counted_as=self._counter("ladder_wide"),
            )
        return out

    # -- bucket ----------------------------------------------------------------

    def bucket_phase_plain(self, table, idx, start, count, mixed=False):
        L = start.shape[0]
        acc = self.unpack(self.identity_packed(L, device=table.device))
        steps = int(count.max()) if L else 0
        last = (idx.shape[0] if idx is not None else table.shape[0]) - 1
        start64, count64 = start.to(torch.int64), count.to(torch.int64)
        for t in range(steps):
            pos = (start64 + t).clamp(max=last)
            src = idx[pos].to(torch.int64) if idx is not None else pos
            X, Y, Z = self.unpack(table[src].T)  # the gathered rows are (L, rows)
            if mixed:
                s = tc._complete_add_mixed(self._plain, acc, (X, Y))
            else:
                s = tc._complete_add(self._plain, acc, (X, Y, Z))
            live = t < count64
            acc = self._select(live, s, acc)
        return self.pack(acc)

    def bucket_phase(self, table, idx, start, count, mixed: bool = False):
        """Per-lane run sums.  Lane l adds, in order onto the identity, the
        `count[l]` points table[idx[start[l] + t]] (idx given) or
        table[start[l] + t] (idx None), t = 0 .. count[l] - 1.  The kernel
        starts the longest lanes first (`longest_first`); that changes
        when a lane runs, never its sum.

        table: (npoints, rows) int32, POINT-major; idx: (m,) int32 or None;
        start, count: (L,) int32.  Returns (rows, L).  A lane with count 0
        returns the identity.  mixed=True: the table rows are affine lifts
        (Z = mont(1), never the identity), only X and Y are read and the
        complete mixed add runs."""
        if table.dim() != 2 or table.shape[1] != self.rows:
            raise ValueError(
                f"bucket_phase: table must be (npoints, {self.rows}), got {tuple(table.shape)}"
            )
        if start.dim() != 1 or start.shape != count.shape:
            raise ValueError("bucket_phase: start and count must be (L,) tensors")
        if idx is not None and idx.dim() != 1:
            raise ValueError("bucket_phase: idx must be a 1-D tensor")
        if not self._on_cuda(table, idx, start, count):
            return self.bucket_phase_plain(table, idx, start, count, mixed)
        tensors = dict(table=table, start=start, count=count)
        if idx is not None:
            tensors["idx"] = idx
        build.require_cuda_int32("bucket_phase", **tensors)
        build.require_aligned("bucket_phase", 16, table=table)
        L = start.shape[0]
        if L > 1 << 30:
            raise ValueError(f"bucket_phase: {L} lanes, at most 2^30")
        with torch.cuda.device(table.device):
            out = torch.empty((self.rows, L), dtype=torch.int32, device=table.device)
            # the kernel takes lanes in this order, 32 per warp, from `nxt`
            perm = longest_first(count)
            nxt = torch.zeros(1, dtype=torch.int32, device=table.device)
            build.launch(
                "bucket", table.data_ptr(), idx.data_ptr() if idx is not None else None,
                start.data_ptr(), count.data_ptr(), perm.data_ptr(), nxt.data_ptr(),
                out.data_ptr(), L, int(mixed), self.ncomp,
                counted_as=self._counter("bucket_mixed" if mixed else "bucket"),
            )
        return out

    def bucket_capacity(self, mixed: bool) -> int:
        """Blocks of 64 threads the bucket kernel keeps resident on the
        current card (its grid is the smaller of this and one thread per
        lane).  Builds the kernels if needed; CUDA only."""
        n = build.query("bucket_capacity", int(mixed), self.ncomp)
        if n <= 0:
            raise RuntimeError(f"bucket_capacity: the occupancy query failed ({n})")
        return n

    # -- weighted sum --------------------------------------------------------------

    @staticmethod
    def wsum_plan(c: int) -> tuple[int, int, int]:
        """(h, groups, maxbits) of the per-group weighted sum at window bits
        c: groups of h = min(2^c, 32) buckets, 2^c / h groups a window, and
        maxbits bits of the largest group weight (groups - 1) h, at least 1."""
        h = min(1 << c, 32)
        groups = (1 << c) // h
        return h, groups, max(1, ((groups - 1) * h).bit_length())

    def weighted_sum_steps(self, buckets, W: int, c: int, plus_one: bool, scan2b, step, add2):
        """The per-group weighted sum as a sequence of `scan2b`, `step` and
        `add2` calls (the ones given: the plain versions, or the kernels,
        one launch per call).  For lane (w, g) over its group's buckets
        B_l = buckets[:, w 2^c + g h + l], l < h: a scan from l = h - 1 down
        that leaves run = sum_l B_l and tot = sum_l l B_l, then acc = (g h)
        run by a double-and-add chain of `step`s, then acc + tot (+ run when
        plus_one).  Returns (rows, W groups)."""
        dev = buckets.device
        h, groups, maxbits = self.wsum_plan(c)
        lanes = W * groups
        bg = buckets.reshape(self.rows, W, groups, h)
        run = self.identity_packed(lanes, device=dev)
        tot = self.identity_packed(lanes, device=dev)
        # scan l = h-1..0 with tot-before-run update => tot = sum_l l*B_l
        for l in range(h - 1, -1, -1):
            run, tot = scan2b(run, tot, bg[:, :, :, l].reshape(self.rows, lanes).contiguous())
        # acc = (g*h) * run_g via a shared double-and-add chain (static masks)
        weights = np.tile(np.arange(groups, dtype=np.int64) * h, W)
        acc = self.identity_packed(lanes, device=dev)
        run0 = run  # step() doubles its base operand; keep sum_l B_l per group
        for bit in range(maxbits):
            sel = torch.as_tensor(((weights >> bit) & 1).astype(np.int32), device=dev)
            acc, run = step(acc, run, sel)
        res = add2(acc, tot)
        if plus_one:  # + sum_l B_l per group shifts every weight by one
            res = add2(res, run0)
        return res

    def weighted_sum_plain(self, buckets, W: int, c: int, plus_one: bool = False):
        return self.weighted_sum_steps(buckets, W, c, plus_one, self.scan2b_plain,
                                       self.step_plain, self.add2_plain)

    def weighted_sum(self, buckets: torch.Tensor, W: int, c: int,
                     plus_one: bool = False) -> torch.Tensor:
        """Per-group weighted bucket sums: buckets (rows, W 2^c), W windows of
        2^c buckets, -> (rows, W groups), lane w groups + g holding
        sum_l w(g h + l) B_(g h + l) over its group, w(j) = j, or j + 1 when
        plus_one (see `weighted_sum_steps`, the same adds in the same order).
        On the card one launch of the team kernel (csrc/wsum_team.cu)."""
        if W < 1 or not 0 <= c <= 24:
            raise ValueError(f"weighted_sum: W = {W}, c = {c}; need W >= 1 and 0 <= c <= 24")
        if buckets.dim() != 2 or buckets.shape != (self.rows, W << c):
            raise ValueError(
                f"weighted_sum: expected ({self.rows}, {W << c}) packed buckets, "
                f"got {tuple(buckets.shape)}"
            )
        if buckets.dtype != torch.int32:
            raise TypeError(f"weighted_sum: buckets must be int32, got {buckets.dtype}")
        if not self._on_cuda(buckets):
            return self.weighted_sum_plain(buckets, W, c, plus_one)
        build.require_cuda_int32("weighted_sum", buckets=buckets)
        _, groups, _ = self.wsum_plan(c)
        out = torch.empty((self.rows, W * groups), dtype=torch.int32, device=buckets.device)
        with torch.cuda.device(buckets.device):
            build.launch("wsum", buckets.data_ptr(), out.data_ptr(), W, c, int(plus_one),
                         self.ncomp, counted_as=self._counter("wsum"))
        return out

    # -- the commit's table: a chain of adds per base ------------------------------

    def chain_steps(self, ptcat: torch.Tensor, B: int, add2) -> torch.Tensor:
        """The table as a sequence of `add2` calls (the one given: the plain
        version, or the kernel, one launch per step) over all N bases, then
        a stack and transpose into point-major rows."""
        cur = self.identity_packed(ptcat.shape[0], device=ptcat.device)
        base = ptcat.T.contiguous()  # (rows, N)
        tab = [cur]
        for _ in range(B - 1):
            cur = add2(cur, base)
            tab.append(cur)
        return torch.stack(tab, dim=0).permute(2, 0, 1).reshape(-1, self.rows).contiguous()

    def chain_plain(self, ptcat, B: int):
        return self.chain_steps(ptcat, B, self.add2_plain)

    def chain(self, ptcat: torch.Tensor, B: int) -> torch.Tensor:
        """Point-major bases (N, rows) -> point-major table (N B, rows) whose
        row j B + d is d G_j as the chain cur = O, cur = cur + G_j leaves it
        (row j B the identity): the adds of `chain_steps` in their order.
        On the card one launch of the team kernel (csrc/chain_team.cu)."""
        if ptcat.dim() != 2 or ptcat.shape[1] != self.rows:
            raise ValueError(f"chain: bases must be (N, {self.rows}), got {tuple(ptcat.shape)}")
        if not 1 <= B <= 1 << 16:
            raise ValueError(f"chain: B = {B}, need 1 <= B <= 2^16")
        if not self._on_cuda(ptcat):
            return self.chain_plain(ptcat, B)
        build.require_cuda_int32("chain", ptcat=ptcat)
        N = ptcat.shape[0]
        out = torch.empty((N * B, self.rows), dtype=torch.int32, device=ptcat.device)
        with torch.cuda.device(ptcat.device):
            build.launch("chain_team", ptcat.data_ptr(), out.data_ptr(), N, B, self.ncomp,
                         counted_as=self._counter("chain_team"))
        return out

    # -- pairwise folds ---------------------------------------------------------------

    @staticmethod
    def _segments(L: int, seg_off, seg_len):
        """Segment offsets and lengths as int64 numpy arrays, checked: at
        least one segment, each of >= 1 of the L columns."""
        off = np.asarray(seg_off, dtype=np.int64).reshape(-1)
        ln = np.asarray(seg_len, dtype=np.int64).reshape(-1)
        if off.size == 0 or off.shape != ln.shape:
            raise ValueError("fold: need one offset and one length for each of >= 1 segments")
        if (ln < 1).any() or (off < 0).any() or (off + ln > L).any():
            raise ValueError(f"fold: every segment needs >= 1 columns inside the {L} given")
        return off, ln

    def fold_steps(self, a: torch.Tensor, seg_off, seg_len, add2) -> torch.Tensor:
        """The folds as a sequence of `add2` calls (the one given: the plain
        version, or the kernel, one launch per level), segments of one
        length batched together.  Segment s, the columns seg_off[s] ..
        seg_off[s] + seg_len[s] - 1 of a, halves as `tree_reduce` always
        has: point i + point i + half for i < half, an odd level's last
        point carried to slot half.  Returns (rows, S)."""
        off, ln = self._segments(a.shape[1], seg_off, seg_len)
        out = torch.empty((self.rows, ln.size), dtype=a.dtype, device=a.device)
        for n in np.unique(ln):
            ids = np.flatnonzero(ln == n)
            cols = torch.as_tensor(off[ids][:, None] + np.arange(n), device=a.device)
            x = a[:, cols]  # (rows, len(ids), n)
            m = int(n)
            while m > 1:
                half = m // 2
                lo = x[:, :, :half].reshape(self.rows, -1).contiguous()
                hi = x[:, :, half : 2 * half].reshape(self.rows, -1).contiguous()
                y = add2(lo, hi).reshape(self.rows, len(ids), half)
                if m % 2:
                    y = torch.cat([y, x[:, :, m - 1 : m]], dim=2)
                    half += 1
                x, m = y, half
            out[:, torch.as_tensor(ids, device=a.device)] = x[:, :, 0]
        return out

    def fold_plain(self, a, seg_off, seg_len):
        return self.fold_steps(a, seg_off, seg_len, self.add2_plain)

    @staticmethod
    def uniform_segments(seg_off, seg_len) -> bool:
        """Whether the segments are S of one length n from column 0 on
        (segment s at column s n): the fold kernel then takes no table."""
        off, ln = np.asarray(seg_off), np.asarray(seg_len)
        return bool((ln == ln[0]).all() and (off == np.arange(ln.size) * ln[0]).all())

    def fold(self, a: torch.Tensor, seg_off, seg_len) -> torch.Tensor:
        """Pairwise sums of S segments of a packed (rows, L) batch -> (rows,
        S): segment s is the seg_len[s] >= 1 columns from seg_off[s] (host
        integers: sequences or numpy arrays), folded as `fold_steps` says.
        On the card one launch of the team kernel (csrc/fold_team.cu, a
        block a segment), with the plain version's limbs; uniform segments
        (`uniform_segments`) reach it as their count and length, others as
        a table copied to the card."""
        L = self._check_points("fold", a)
        off, ln = self._segments(L, seg_off, seg_len)
        if not self._on_cuda(a):
            return self.fold_plain(a, off, ln)
        build.require_cuda_int32("fold", a=a)
        max_len = int(ln.max())
        S = ln.size
        half_max = (max_len + 1) // 2
        dev = a.device
        with torch.cuda.device(dev):
            seg, seg_ptr = None, None  # uniform: the kernel computes the segments
            if not self.uniform_segments(off, ln):
                # pinned and asynchronous: the copy does not wait for the queue
                seg = torch.from_numpy(np.stack([off, ln]).astype(np.int32)).pin_memory()
                seg = seg.to(dev, non_blocking=True)
                seg_ptr = seg.data_ptr()
            scratch = torch.empty(S * 2 * half_max * self.rows if max_len > 2 else 1,
                                  dtype=torch.int32, device=dev)
            out = torch.empty((self.rows, S), dtype=torch.int32, device=dev)
            build.launch("fold_team", a.data_ptr(), L, seg_ptr, S, max_len,
                         scratch.data_ptr(), out.data_ptr(), self.ncomp,
                         counted_as=self._counter("fold_team"))
        return out

    def tree_reduce(self, a: torch.Tensor) -> torch.Tensor:
        """Fold (rows, L) down to (rows, 1): one segment of `fold`."""
        return self.fold(a, [0], [a.shape[1]])

G1P = PackedGroup("g1", FQ, 1, None)
G2P = PackedGroup("g2", FQ, 2, FQ.to_mont_int(tc._B3_K))
