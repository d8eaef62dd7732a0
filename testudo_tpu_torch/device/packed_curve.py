"""Packed-layout G1 and G2 group operations: kernel wrappers and plain versions.

Counterpart of testudo_tpu/tpu/pallas_curve.py:606-760 (`PackedGroup`,
`G1P`, `G2P`).  A batch of L points is one `(3 * ncomp * 24, L)` int32
tensor: coordinate-major (X, Y, Z), within a coordinate component-major
(c0, c1 for G2), 24 rows of 16-bit Montgomery limbs per component, batch
along L.  The row of coordinate c, component comp, limb k is
`(c * ncomp + comp) * 24 + k`: 72 rows for G1 (ncomp 1), 144 for G2.

Every fused op has a wrapper that, on CUDA tensors, checks its arguments,
launches the hand-written kernel (csrc/ec_ops.cu, ladder_team.cu or
ladder.cu by width, bucket.cu) on the current stream and raises on failure;
on CPU tensors it runs the plain
PyTorch version defined beside it (`*_plain`), which evaluates the same
RCB16 formulas (device/curve.py) in int64 tensor ops.  The plain versions
also run on CUDA tensors when called directly, which is how a kernel is
held against its plain version on the card; they never launch a kernel.

What differs from the JAX package: `ladder` is one launch (not one `step`
launch per bit); `bucket_phase` gathers by index inside the kernel from a
point-major table instead of streaming a materialised run tensor, and runs
its lanes longest first on a grid that stays resident; masks are
one int per lane; `add_mask` also takes ONE point for all lanes (a single
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
# (ncomp); wider ones go to one thread per lane (csrc/ladder.cu).  Measured on
# an H100 with tools/exp_ladder.py (PERF.md section 6, the ladder crossover
# table): at 1,024 lanes the team kernel beats one thread for Horner and
# random scalars alike (G1 1.58 against 3.82 ms on Horner scalars, G2 4.18
# against 14.07 ms); at 4,096 it loses for G1 (3.93 against 3.82 ms) and
# wins G2 by 2% only (13.78 against 14.08 ms).  Every path's G2 ladder is
# 1,024 lanes or fewer.
TEAM_LADDER_MAX_LANES = {1: 1024, 2: 1024}


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

    def ladder_kernel(self, L: int) -> str:
        """The kernel `ladder` launches for L lanes: the team ladder up to
        TEAM_LADDER_MAX_LANES of this group, the one-thread ladder above."""
        return "ladder_team" if L <= TEAM_LADDER_MAX_LANES[self.ncomp] else "ladder"

    def ladder(self, pts: torch.Tensor, scal_rows: torch.Tensor) -> torch.Tensor:
        """pts (rows, L) x canonical scalars (nscal_limbs, L) int32 ->
        [s_l] P_l: LSB-first double-and-add over all 16 * nscal_limbs bits.
        On the card a narrow batch goes to the team kernel (a team of
        threads per lane), a wide one to one thread per lane
        (`ladder_kernel`); both give the plain version's limbs."""
        L = self._check_points("ladder", pts)
        if scal_rows.dim() != 2 or scal_rows.shape[1] != L:
            raise ValueError(
                f"ladder: scalars must be (nlimbs, {L}), got {tuple(scal_rows.shape)}"
            )
        if not self._on_cuda(pts, scal_rows):
            return self.ladder_plain(pts, scal_rows)
        return self.ladder_launch(self.ladder_kernel(L), pts, scal_rows)

    def ladder_launch(self, kernel: str, pts: torch.Tensor,
                      scal_rows: torch.Tensor) -> torch.Tensor:
        """Launch ladder kernel `kernel` ("ladder" or "ladder_team") on
        checked CUDA tensors: what `ladder` calls, and what a measurement
        calls to time either kernel at any width."""
        build.require_cuda_int32(kernel, pts=pts, scal_rows=scal_rows)
        out = torch.empty_like(pts)
        with torch.cuda.device(pts.device):
            build.launch(
                kernel, pts.data_ptr(), scal_rows.data_ptr(), out.data_ptr(),
                scal_rows.shape[0], pts.shape[1], self.ncomp,
                counted_as=self._counter(kernel),
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

    # -- reductions built on add2 ------------------------------------------------

    def tree_reduce(self, a: torch.Tensor) -> torch.Tensor:
        """Fold (rows, L) down to (rows, 1) with log2(L) fused adds."""
        L = a.shape[1]
        while L > 1:
            half = L // 2
            s = self.add2(a[:, :half].contiguous(), a[:, half : 2 * half].contiguous())
            if L % 2:
                s = torch.cat([s, a[:, -1:]], dim=1)
                half += 1
            a = s
            L = half
        return a


G1P = PackedGroup("g1", FQ, 1, None)
G2P = PackedGroup("g2", FQ, 2, FQ.to_mont_int(tc._B3_K))
