"""Plain versions of the packed kernels at ncomp = 2 (G2 over Fq2,
testudo_tpu_torch/device/packed_curve.py `G2P`) against the JAX kernel BODIES
run as plain functions: (RV, RV) limb-row pairs built from the packed array,
curve._complete_add / _complete_add_mixed / _complete_double over
pallas_curve._make_ops(P, 24, 2, _B3_K_INT), then F.fq.finalize: what the
Pallas kernels trace, evaluated eagerly on the CPU without pallas_call.
`add_mask` and `scan2`, new for both groups, are held against their bodies
(pallas_curve.py:405-411, :439-446) for G1 and G2.  Also against the host
curve.  Integers: exact equality, limb for limb."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from testudo_tpu.fields import host as jhf
from testudo_tpu.tpu import curve as jc
from testudo_tpu.tpu import pallas_curve as pcu
from testudo_tpu_torch.curves import host_curve as hc
from testudo_tpu_torch.device import build
from testudo_tpu_torch.device import curve as tc
from testudo_tpu_torch.device.field import FR
from testudo_tpu_torch.device.packed_curve import G1P, G2P, PackedGroup
from testudo_tpu_torch.fields.bls12_377 import P, R

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

RNG = np.random.default_rng(43)
N = 24
L = 7  # no multiple of 32


class Ref:
    """The JAX kernel bodies of one group as plain functions on numpy packed
    arrays (as tests/test_torch_packed_curve.py does for G1)."""

    def __init__(self, ncomp):
        self.ncomp = ncomp
        self.F = pcu._make_ops(P, N, ncomp, None if ncomp == 1 else pcu._B3_K_INT)
        self.fq = self.F if ncomp == 1 else self.F.fq
        self.Gp = G1P if ncomp == 1 else G2P

    def point(self, packed: np.ndarray):
        a = jnp.asarray(packed.astype(np.uint32))
        rv = lambda c, comp: pcu.RV(
            [a[(c * self.ncomp + comp) * N + k] for k in range(N)], 1)
        if self.ncomp == 1:
            return tuple(rv(c, 0) for c in range(3))
        return tuple((rv(c, 0), rv(c, 1)) for c in range(3))

    def finalize(self, pt) -> np.ndarray:
        comps = pt if self.ncomp == 1 else [comp for coord in pt for comp in coord]
        rows = [r for comp in comps for r in self.fq.finalize(comp)]
        return np.stack([np.asarray(r) for r in rows]).astype(np.int32)

    def add2(self, a, b):
        return self.finalize(jc._complete_add(self.F, self.point(a), self.point(b)))

    def double(self, a):
        return self.finalize(jc._complete_double(self.F, self.point(a)))

    def bucket(self, runs, counts, mixed):
        """pallas_curve.py:498-518: identity accumulator, masked adds."""
        T, _, lanes = runs.shape
        acc = self.Gp.identity_packed(lanes, device="cpu").numpy()
        for t in range(T):
            p1, p2 = self.point(acc), self.point(runs[t])
            if mixed:
                s = jc._complete_add_mixed(self.F, p1, (p2[0], p2[1]))
            else:
                s = jc._complete_add(self.F, p1, p2)
            acc = select(t < counts, self.finalize(s), acc)
        return acc


def select(mask, s, acc):
    return np.where(np.asarray(mask)[None, :] != 0, s, acc)


REF1, REF2 = Ref(1), Ref(2)


def _host_points(n):
    G = hc.g2_generator()
    return [hc.g2_mul(G, int(k)) for k in RNG.integers(1, 1 << 62, size=n)]


def _pack(points) -> torch.Tensor:
    return G2P.pack(tc.g2_from_affine_host(points, device="cpu"))


def _affine(packed: torch.Tensor):
    return tc.g2_to_affine_host(G2P.unpack(packed))


# lanes: P+Q, P+P, P+(-P), P+O, O+Q, O+O, P+Q
A_H = _host_points(L)
B_H = _host_points(L)
B_H[1] = A_H[1]
B_H[2] = hc.g2_neg(A_H[2])
B_H[3] = None
A_H[4] = None
A_H[5] = None
B_H[5] = None
A, B = _pack(A_H), _pack(B_H)
SUM = REF2.add2(A.numpy(), B.numpy())  # projective (Z != 1) points for later tests
MASK = torch.tensor([1, 0, 1, 1, 0, 1, 0], dtype=torch.int32)


def _g1_batches():
    G = hc.g1_generator()
    pts = [[hc.g1_mul(G, int(k)) for k in RNG.integers(1, 1 << 62, size=L)] for _ in range(2)]
    pts[1][1] = pts[0][1]
    pts[1][2] = hc.g1_neg(pts[0][2])
    pts[1][3] = pts[0][4] = pts[0][5] = pts[1][5] = None
    a, b = (G1P.pack(tc.g1_from_affine_host(p, device="cpu")) for p in pts)
    return a, b, torch.from_numpy(REF1.add2(a.numpy(), b.numpy()))


def _batches(ncomp):
    """(group, reference bodies, a, b, projective sum) for one group."""
    if ncomp == 1:
        return (G1P, REF1) + _g1_batches()
    return G2P, REF2, A, B, torch.from_numpy(SUM)


def test_pack_unpack_identity_match_reference():
    to_ref = lambda p: None if p is None else (jhf.Fq2(p[0].c0, p[0].c1), jhf.Fq2(p[1].c0, p[1].c1))
    dev = tc.g2_from_affine_host(A_H, device="cpu")
    ref = pcu.G2P.pack(jc.g2_from_affine_host([to_ref(p) for p in A_H]))
    assert A.dtype == torch.int32 and A.shape == (144, L) and G2P.rows == 144
    assert np.array_equal(A.numpy(), np.asarray(ref).astype(np.int32))
    for got, want in zip(G2P.unpack(A), dev):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # row of coordinate c, component comp, limb k: (c * 2 + comp) * 24 + k
    assert torch.equal(A[(1 * 2 + 1) * N : (1 * 2 + 2) * N].T, dev[1][1])
    ident = G2P.identity_packed(5, device="cpu")
    assert np.array_equal(ident.numpy(), np.asarray(pcu.G2P.identity_packed(5)).astype(np.int32))
    assert _affine(ident) == [None] * 5
    assert G2P.b3_k == pcu._B3_K_INT and G2P.ncomp == 2 and G1P.ncomp == 1
    with pytest.raises(ValueError):
        PackedGroup("g3", G2P.spec, 3, None)


def test_add2_equals_kernel_body_and_host():
    got = G2P.add2(A, B)
    assert np.array_equal(got.numpy(), SUM)
    assert _affine(got) == [hc.g2_add(a, b) for a, b in zip(A_H, B_H)]
    # projective + affine lift, and the sum doubled
    assert np.array_equal(G2P.add2(got, A).numpy(), REF2.add2(SUM, A.numpy()))
    assert np.array_equal(G2P.add2(got, got).numpy(), REF2.add2(SUM, SUM))


def test_step_equals_kernel_body():
    acc = torch.from_numpy(SUM)
    out_acc, out_base = G2P.step(acc, A, MASK)
    want_acc = select(MASK.numpy(), REF2.add2(SUM, A.numpy()), SUM)
    assert np.array_equal(out_acc.numpy(), want_acc)
    assert np.array_equal(out_base.numpy(), REF2.double(A.numpy()))
    assert _affine(out_base) == [hc.g2_double(a) for a in A_H]
    assert np.array_equal(G2P.step(A, acc, MASK)[1].numpy(), REF2.double(SUM))


def test_scan2b_equals_kernel_body():
    run, tot = torch.from_numpy(SUM), B
    out_run, out_tot = G2P.scan2b(run, tot, A)
    assert np.array_equal(out_run.numpy(), REF2.add2(SUM, A.numpy()))
    assert np.array_equal(out_tot.numpy(), REF2.add2(B.numpy(), SUM))


@pytest.mark.parametrize("ncomp", [1, 2], ids=["g1", "g2"])
def test_scan2_equals_kernel_body(ncomp):
    """pallas_curve.py:439-446: run' = run + bl, tot' = tot + run'."""
    Gp, ref, a, b, s = _batches(ncomp)
    out_run, out_tot = Gp.scan2(s, b, a)
    run2 = ref.add2(s.numpy(), a.numpy())
    assert np.array_equal(out_run.numpy(), run2)
    assert np.array_equal(out_tot.numpy(), ref.add2(b.numpy(), run2))


@pytest.mark.parametrize("ncomp", [1, 2], ids=["g1", "g2"])
def test_add_mask_equals_kernel_body(ncomp):
    """pallas_curve.py:405-411: mask ? acc + pts : acc; and one shared point
    for all lanes equals the same point in every lane."""
    Gp, ref, a, b, s = _batches(ncomp)
    got = Gp.add_mask(s, a, MASK)
    assert np.array_equal(got.numpy(), select(MASK.numpy(), ref.add2(s.numpy(), a.numpy()), s.numpy()))
    col = s[:, 6:7].contiguous()
    assert torch.equal(Gp.add_mask(b, col, MASK), Gp.add_mask(b, col.expand(-1, L).contiguous(), MASK))


def test_ladder_equals_chain_of_step_bodies():
    """8 scalar bits in one limb row, so the eager reference stays short."""
    pts = torch.from_numpy(SUM)
    scal = torch.tensor([[0, 1, 0xFF, 0x81, 2, 0x34, 0xF0]], dtype=torch.int32)
    got = G2P.ladder(pts, scal)
    acc = G2P.identity_packed(L, device="cpu").numpy()
    base = SUM
    for b in range(8):
        m = (scal[0].numpy() >> b) & 1
        acc = select(m, REF2.add2(acc, base), acc)
        base = REF2.double(base)
    assert np.array_equal(got.numpy(), acc)  # the 8 high bits are 0: acc no longer changes


def test_ladder_full_width_against_host():
    ks = [0, 1, R - 1, 2, 3, int.from_bytes(RNG.bytes(40), "little") % R, 7]
    pts_h = _affine(torch.from_numpy(SUM))
    scal = torch.from_numpy(FR.to_limbs(ks).T.copy())
    got = G2P.ladder(torch.from_numpy(SUM), scal)
    assert _affine(got) == [hc.g2_mul(p, k) for p, k in zip(pts_h, ks)]


@pytest.mark.parametrize("mixed", [False, True], ids=["general", "mixed"])
def test_bucket_phase_equals_kernel_body(mixed):
    """Ragged counts, a count-0 lane, a doubling lane (the same point twice)
    and, in every lane, the identity accumulator at the first step."""
    pts_h = _host_points(6)
    table = _pack(pts_h).T.contiguous()  # point-major (6, 144), affine lifts
    idx = torch.tensor([0, 1, 2, 3, 4, 2, 2, 5, 1], dtype=torch.int32)
    start = torch.tensor([0, 2, 5, 5, 7], dtype=torch.int32)
    count = torch.tensor([2, 3, 0, 2, 1], dtype=torch.int32)
    got = G2P.bucket_phase(table, idx, start, count, mixed=mixed)
    T, lanes = int(count.max()), len(count)
    runs = np.zeros((T, 144, lanes), dtype=np.int32)
    for lane in range(lanes):
        for t in range(T):
            src = int(idx[min(int(start[lane]) + t, len(idx) - 1)])
            runs[t, :, lane] = table[src].numpy()
    assert np.array_equal(got.numpy(), REF2.bucket(runs, count.numpy(), mixed))
    aff = _affine(got)
    assert aff[0] == hc.g2_add(pts_h[0], pts_h[1])
    assert aff[1] == hc.g2_add(hc.g2_add(pts_h[2], pts_h[3]), pts_h[4])
    assert aff[2] is None
    assert aff[3] == hc.g2_double(pts_h[2])
    assert aff[4] == pts_h[5]


def test_bucket_phase_consecutive_rows_general():
    """idx=None: lane l sums table rows start[l] .. start[l]+count[l]-1 (the
    segment reduce), projective rows with identities among them."""
    table = torch.cat([torch.from_numpy(SUM), A], dim=1).T.contiguous()  # (14, 144)
    start = torch.tensor([0, 3, 9, 14], dtype=torch.int32)
    count = torch.tensor([3, 2, 5, 0], dtype=torch.int32)
    got = G2P.bucket_phase(table, None, start, count)
    T, lanes = 5, 4
    runs = np.zeros((T, 144, lanes), dtype=np.int32)
    for lane in range(lanes):
        for t in range(T):
            runs[t, :, lane] = table[min(int(start[lane]) + t, 13)].numpy()
    assert np.array_equal(got.numpy(), REF2.bucket(runs, count.numpy(), False))
    assert _affine(got)[3] is None


def test_tree_reduce_against_host():
    got = G2P.tree_reduce(torch.from_numpy(SUM[:, :5].copy()))  # 5 -> 3 -> 2 -> 1
    want = None
    for p in _affine(torch.from_numpy(SUM[:, :5].copy())):
        want = hc.g2_add(want, p)
    assert got.shape == (144, 1) and _affine(got) == [want]


# -- wrappers: argument checks and launch counters ------------------------------


def test_cpu_path_launches_no_kernel():
    build.reset_launches()
    for Gp, a, b in ((G2P, A, B), (G1P,) + _g1_batches()[:2]):
        ones = torch.ones(L, dtype=torch.int32)
        Gp.add2(a, b)
        Gp.add_mask(a, b, ones)
        Gp.add_mask(a, b[:, :1].contiguous(), ones)
        Gp.step(a, b, ones)
        Gp.scan2(a, b, a)
        Gp.scan2b(a, b, a)
        Gp.ladder(a, torch.ones((1, L), dtype=torch.int32))
        Gp.bucket_phase(a.T.contiguous(), None, torch.zeros(2, dtype=torch.int32),
                        torch.ones(2, dtype=torch.int32))
    assert all(v == 0 for v in build.LAUNCHES.values()), build.LAUNCHES
    assert G2P._counter("add2") == "add2_g2" and G1P._counter("add2") == "add2"


@pytest.mark.parametrize("op", ["add2", "add_mask", "step", "scan2", "scan2b", "ladder",
                                "bucket_phase"])
def test_wrappers_reject_bad_shapes(op):
    g1 = torch.zeros((72, L), dtype=torch.int32)  # a G1 batch is no G2 batch
    with pytest.raises(ValueError):
        if op == "add2":
            G2P.add2(A, g1)
        elif op == "add_mask":
            G2P.add_mask(A, B[:, :2].contiguous(), MASK)
        elif op == "step":
            G2P.step(A, B, MASK[:-1])
        elif op == "scan2":
            G2P.scan2(A, g1, B)
        elif op == "scan2b":
            G2P.scan2b(A, B, g1)
        elif op == "ladder":
            G2P.ladder(A, torch.ones((16, L + 1), dtype=torch.int32))
        else:
            G2P.bucket_phase(g1.T.contiguous(), None, MASK, MASK)
