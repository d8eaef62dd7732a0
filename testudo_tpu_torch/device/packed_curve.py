"""Packed-layout G1 group operations: kernel wrappers and plain versions.

Counterpart of testudo_tpu/tpu/pallas_curve.py:606-760 (`PackedGroup`,
`G1P`).  A batch of L points is one `(72, L)` int32 tensor: coordinate-major
(X, Y, Z), 24 rows of 16-bit Montgomery limbs each, batch along L.

Every fused op has a wrapper that, on CUDA tensors, checks its arguments,
launches the hand-written kernel (csrc/ec_ops.cu, ladder.cu, bucket.cu) on
the current stream and raises on failure; on CPU tensors it runs the plain
PyTorch version defined beside it (`*_plain`), which evaluates the same
RCB16 formulas (device/curve.py) in int64 tensor ops.  The plain versions
also run on CUDA tensors when called directly, which is how a kernel is
held against its plain version on the card; they never launch a kernel.

What differs from the JAX package: `ladder` is one launch (not one `step`
launch per bit); `bucket_phase` gathers by index inside the kernel from a
point-major table instead of streaming a materialised run tensor; masks are
one int per lane; no lane padding to tiles anywhere.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build
from . import curve as tc
from .field import FQ, FieldSpec, LIMB_BITS

_PLAIN = tc._G1PlainOps


class PackedGroup:
    """One EC group in packed-rows layout (G1 over Fq; G2 is a later slice)."""

    def __init__(self, name: str, spec: FieldSpec):
        self.name = name
        self.spec = spec
        self.rows = 3 * spec.nlimbs

    # -- layout ------------------------------------------------------------

    def pack(self, p) -> torch.Tensor:
        """(X, Y, Z) of (batch, nlimbs) tensors -> (rows, L) packed tensor."""
        n = self.spec.nlimbs
        return torch.cat([c.reshape(-1, n).T for c in p], dim=0).contiguous()

    def unpack(self, a: torch.Tensor):
        n = self.spec.nlimbs
        return tuple(a[c * n : (c + 1) * n].T.contiguous() for c in range(3))

    def identity_packed(self, L: int, device=torch.device("cuda")) -> torch.Tensor:
        n = self.spec.nlimbs
        a = np.zeros((self.rows, L), dtype=np.int32)
        a[n : 2 * n] = self.spec.to_limbs(self.spec.r_mod_p)[:, None]
        return torch.as_tensor(a, device=device)

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
        return self.pack(tc._complete_add(_PLAIN, self.unpack(a), self.unpack(b)))

    def add2(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a + b, complete add, lane by lane."""
        L = self._check_points("add2", a, b)
        if not self._on_cuda(a, b):
            return self.add2_plain(a, b)
        build.require_cuda_int32("add2", a=a, b=b)
        out = torch.empty_like(a)
        with torch.cuda.device(a.device):
            build.launch("add2", a.data_ptr(), b.data_ptr(), out.data_ptr(), L)
        return out

    # -- step ------------------------------------------------------------------

    def step_plain(self, acc, base, mask):
        A, B = self.unpack(acc), self.unpack(base)
        s = tc._complete_add(_PLAIN, A, B)
        out = tuple(_PLAIN.select(mask != 0, s[c], A[c]) for c in range(3))
        return self.pack(out), self.pack(tc._complete_double(_PLAIN, B))

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
                out_acc.data_ptr(), out_base.data_ptr(), L,
            )
        return out_acc, out_base

    # -- scan2b ----------------------------------------------------------------

    def scan2b_plain(self, run, tot, bl):
        R, T, B = self.unpack(run), self.unpack(tot), self.unpack(bl)
        return (
            self.pack(tc._complete_add(_PLAIN, R, B)),
            self.pack(tc._complete_add(_PLAIN, T, R)),
        )

    def scan2b(self, run: torch.Tensor, tot: torch.Tensor, bl: torch.Tensor):
        """(run + bl, tot + run): two independent adds on the old run."""
        L = self._check_points("scan2b", run, tot, bl)
        if not self._on_cuda(run, tot, bl):
            return self.scan2b_plain(run, tot, bl)
        build.require_cuda_int32("scan2b", run=run, tot=tot, bl=bl)
        out_run, out_tot = torch.empty_like(run), torch.empty_like(tot)
        with torch.cuda.device(run.device):
            build.launch(
                "scan2b", run.data_ptr(), tot.data_ptr(), bl.data_ptr(),
                out_run.data_ptr(), out_tot.data_ptr(), L,
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
                s = tc._complete_add(_PLAIN, acc, base)
                acc = tuple(_PLAIN.select(m, s[c], acc[c]) for c in range(3))
                base = tc._complete_double(_PLAIN, base)
        return self.pack(acc)

    def ladder(self, pts: torch.Tensor, scal_rows: torch.Tensor) -> torch.Tensor:
        """pts (rows, L) x canonical scalars (nscal_limbs, L) int32 ->
        [s_l] P_l: LSB-first double-and-add over all 16 * nscal_limbs bits."""
        L = self._check_points("ladder", pts)
        if scal_rows.dim() != 2 or scal_rows.shape[1] != L:
            raise ValueError(
                f"ladder: scalars must be (nlimbs, {L}), got {tuple(scal_rows.shape)}"
            )
        if not self._on_cuda(pts, scal_rows):
            return self.ladder_plain(pts, scal_rows)
        build.require_cuda_int32("ladder", pts=pts, scal_rows=scal_rows)
        out = torch.empty_like(pts)
        with torch.cuda.device(pts.device):
            build.launch(
                "ladder", pts.data_ptr(), scal_rows.data_ptr(), out.data_ptr(),
                scal_rows.shape[0], L,
            )
        return out

    # -- bucket ----------------------------------------------------------------

    def bucket_phase_plain(self, table, idx, start, count, mixed=False):
        n = self.spec.nlimbs
        L = start.shape[0]
        acc = self.unpack(self.identity_packed(L, device=table.device))
        steps = int(count.max()) if L else 0
        last = (idx.shape[0] if idx is not None else table.shape[0]) - 1
        start64, count64 = start.to(torch.int64), count.to(torch.int64)
        for t in range(steps):
            pos = (start64 + t).clamp(max=last)
            src = idx[pos].to(torch.int64) if idx is not None else pos
            pts = table[src]  # (L, rows)
            X, Y, Z = (pts[:, c * n : (c + 1) * n] for c in range(3))
            if mixed:
                s = tc._complete_add_mixed(_PLAIN, acc, (X, Y))
            else:
                s = tc._complete_add(_PLAIN, acc, (X, Y, Z))
            live = t < count64
            acc = tuple(_PLAIN.select(live, s[c], acc[c]) for c in range(3))
        return self.pack(acc)

    def bucket_phase(self, table, idx, start, count, mixed: bool = False):
        """Per-lane run sums.  Lane l adds, in order onto the identity, the
        `count[l]` points table[idx[start[l] + t]] (idx given) or
        table[start[l] + t] (idx None), t = 0 .. count[l] - 1.

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
        L = start.shape[0]
        out = torch.empty((self.rows, L), dtype=torch.int32, device=table.device)
        with torch.cuda.device(table.device):
            build.launch(
                "bucket", table.data_ptr(), idx.data_ptr() if idx is not None else None,
                start.data_ptr(), count.data_ptr(), out.data_ptr(), L, int(mixed),
                counted_as="bucket_mixed" if mixed else "bucket",
            )
        return out

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


G1P = PackedGroup("g1", FQ)
