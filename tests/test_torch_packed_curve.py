"""Plain versions of the packed G1 kernels (testudo_tpu_torch/device/
packed_curve.py) against the JAX kernel BODIES run as plain functions: RV
limb rows built from the packed array, curve._complete_add /
_complete_add_mixed / _complete_double over pallas_curve._make_ops(P, 24, 1,
None), then F.finalize: what the Pallas kernels trace, evaluated eagerly on
the CPU without pallas_call.  Also against the host curve.  Integers: exact
equality, limb for limb."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from testudo_tpu.tpu import curve as jc
from testudo_tpu.tpu import pallas_curve as pcu
from testudo_tpu_torch.curves import host_curve as hc
from testudo_tpu_torch.device import build
from testudo_tpu_torch.device import curve as tc
from testudo_tpu_torch.device.field import FR
from testudo_tpu_torch.device.packed_curve import G1P, longest_first
from testudo_tpu_torch.fields.bls12_377 import P, R

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

RNG = np.random.default_rng(41)
N = 24
F = pcu._make_ops(P, N, 1, None)
L = 7  # no multiple of 32


def _host_points(n):
    G = hc.g1_generator()
    return [hc.g1_mul(G, int(k)) for k in RNG.integers(1, 1 << 62, size=n)]


def _pack(points) -> torch.Tensor:
    return G1P.pack(tc.g1_from_affine_host(points, device="cpu"))


def _affine(packed: torch.Tensor):
    return tc.g1_to_affine_host(G1P.unpack(packed))


# -- the JAX kernel bodies as plain functions ---------------------------------


def _rv_point(packed: np.ndarray):
    a = jnp.asarray(packed.astype(np.uint32))
    return tuple(pcu.RV([a[c * N + k] for k in range(N)], 1) for c in range(3))


def _finalize(pt) -> np.ndarray:
    rows = [r for c in range(3) for r in F.finalize(pt[c])]
    return np.stack([np.asarray(r) for r in rows]).astype(np.int32)


def ref_add2(a, b):
    return _finalize(jc._complete_add(F, _rv_point(a), _rv_point(b)))


def ref_double(a):
    return _finalize(jc._complete_double(F, _rv_point(a)))


def ref_select(mask, s, acc):
    return np.where(np.asarray(mask)[None, :] != 0, s, acc)


def ref_bucket(runs, counts, mixed):
    """pallas_curve.py:498-518: identity accumulator, masked adds."""
    T, _, lanes = runs.shape
    acc = G1P.identity_packed(lanes, device="cpu").numpy()
    for t in range(T):
        p1, p2 = _rv_point(acc), _rv_point(runs[t])
        if mixed:
            s = jc._complete_add_mixed(F, p1, (p2[0], p2[1]))
        else:
            s = jc._complete_add(F, p1, p2)
        acc = ref_select(t < counts, _finalize(s), acc)
    return acc


# lanes: P+Q, P+P, P+(-P), P+O, O+Q, O+O, P+Q
A_H = _host_points(L)
B_H = _host_points(L)
B_H[1] = A_H[1]
B_H[2] = hc.g1_neg(A_H[2])
B_H[3] = None
A_H[4] = None
A_H[5] = None
B_H[5] = None
A, B = _pack(A_H), _pack(B_H)
SUM = ref_add2(A.numpy(), B.numpy())  # projective (Z != 1) points for later tests


def test_pack_unpack_identity_match_reference():
    dev = tc.g1_from_affine_host(A_H, device="cpu")
    ref = pcu.G1P.pack(jc.g1_from_affine_host(A_H))
    assert A.dtype == torch.int32 and A.shape == (72, L)
    assert np.array_equal(A.numpy(), np.asarray(ref).astype(np.int32))
    for got, want in zip(G1P.unpack(A), dev):
        assert torch.equal(got, want)
    ident = G1P.identity_packed(5, device="cpu")
    assert np.array_equal(ident.numpy(), np.asarray(pcu.G1P.identity_packed(5)).astype(np.int32))
    assert _affine(ident) == [None] * 5


def test_add2_equals_kernel_body_and_host():
    got = G1P.add2(A, B)
    assert np.array_equal(got.numpy(), SUM)
    assert _affine(got) == [hc.g1_add(a, b) for a, b in zip(A_H, B_H)]


def test_step_equals_kernel_body():
    acc = torch.from_numpy(SUM)
    mask = torch.tensor([1, 0, 1, 1, 0, 1, 0], dtype=torch.int32)
    out_acc, out_base = G1P.step(acc, A, mask)
    want_acc = ref_select(mask.numpy(), ref_add2(SUM, A.numpy()), SUM)
    assert np.array_equal(out_acc.numpy(), want_acc)
    assert np.array_equal(out_base.numpy(), ref_double(A.numpy()))
    assert _affine(out_base) == [hc.g1_double(a) for a in A_H]


def test_scan2b_equals_kernel_body():
    run, tot = torch.from_numpy(SUM), B
    out_run, out_tot = G1P.scan2b(run, tot, A)
    assert np.array_equal(out_run.numpy(), ref_add2(SUM, A.numpy()))
    assert np.array_equal(out_tot.numpy(), ref_add2(B.numpy(), SUM))


def test_ladder_equals_chain_of_step_bodies():
    """16 scalar bits (one limb row) so the eager reference stays short."""
    pts = torch.from_numpy(SUM)
    scal = torch.tensor([[0, 1, 0xFFFF, 0x8001, 2, 0x1234, 0x00F0]], dtype=torch.int32)
    got = G1P.ladder(pts, scal)
    acc = G1P.identity_packed(L, device="cpu").numpy()
    base = SUM
    for b in range(16):
        m = (scal[0].numpy() >> b) & 1
        acc = ref_select(m, ref_add2(acc, base), acc)
        base = ref_double(base)
    assert np.array_equal(got.numpy(), acc)


def test_ladder_full_width_against_host():
    ks = [0, 1, R - 1, 2, 3, int.from_bytes(RNG.bytes(40), "little") % R, 7]
    pts_h = _affine(torch.from_numpy(SUM))
    scal = torch.from_numpy(FR.to_limbs(ks).T.copy())
    got = G1P.ladder(torch.from_numpy(SUM), scal)
    assert _affine(got) == [hc.g1_mul(p, k) for p, k in zip(pts_h, ks)]


@pytest.mark.parametrize("mixed", [False, True], ids=["general", "mixed"])
def test_bucket_phase_equals_kernel_body(mixed):
    """Ragged counts, a count-0 lane, a doubling lane (the same point twice)
    and, in every lane, the identity accumulator at the first step."""
    pts_h = _host_points(6)
    table = _pack(pts_h).T.contiguous()  # point-major (6, 72), affine lifts
    idx = torch.tensor([0, 1, 2, 3, 4, 2, 2, 5, 1], dtype=torch.int32)
    start = torch.tensor([0, 2, 5, 5, 7], dtype=torch.int32)
    count = torch.tensor([2, 3, 0, 2, 1], dtype=torch.int32)
    got = G1P.bucket_phase(table, idx, start, count, mixed=mixed)
    # the reference streams run-aligned points: runs[t, :, lane]
    T, lanes = int(count.max()), len(count)
    runs = np.zeros((T, 72, lanes), dtype=np.int32)
    for lane in range(lanes):
        for t in range(T):
            src = int(idx[min(int(start[lane]) + t, len(idx) - 1)])
            runs[t, :, lane] = table[src].numpy()
    want = ref_bucket(runs, count.numpy(), mixed)
    assert np.array_equal(got.numpy(), want)
    aff = _affine(got)
    assert aff[0] == hc.g1_add(pts_h[0], pts_h[1])
    assert aff[1] == hc.g1_add(hc.g1_add(pts_h[2], pts_h[3]), pts_h[4])
    assert aff[2] is None
    assert aff[3] == hc.g1_double(pts_h[2])
    assert aff[4] == pts_h[5]


def test_bucket_phase_consecutive_rows_general():
    """idx=None: lane l sums table rows start[l] .. start[l]+count[l]-1 (the
    segment reduce), projective rows, general add."""
    table = torch.cat([torch.from_numpy(SUM), A], dim=1).T.contiguous()  # (14, 72)
    start = torch.tensor([0, 3, 9, 14], dtype=torch.int32)
    count = torch.tensor([3, 2, 5, 0], dtype=torch.int32)
    got = G1P.bucket_phase(table, None, start, count)
    T, lanes = 5, 4
    runs = np.zeros((T, 72, lanes), dtype=np.int32)
    for lane in range(lanes):
        for t in range(T):
            runs[t, :, lane] = table[min(int(start[lane]) + t, 13)].numpy()
    assert np.array_equal(got.numpy(), ref_bucket(runs, count.numpy(), False))
    assert _affine(got)[3] is None


def test_bucket_phase_all_zero_counts_returns_identity():
    table = A.T.contiguous()
    zeros = torch.zeros(3, dtype=torch.int32)
    got = G1P.bucket_phase(table, None, zeros, zeros, mixed=True)
    assert torch.equal(got, G1P.identity_packed(3, device="cpu"))


@pytest.mark.parametrize("counts", [
    [], [5], [0, 0, 0], [3, 7, 7, 0, 7, 1, 512, 3],
    [int(v) for v in np.random.default_rng(42).integers(0, 4, size=97)],
], ids=["empty", "one", "all-zero", "ties", "random"])
def test_longest_first_is_a_stable_descending_permutation(counts):
    """The bucket kernel's lane order: every lane once, longest first, equal
    counts in lane order."""
    perm = longest_first(torch.tensor(counts, dtype=torch.int32))
    assert perm.dtype == torch.int32 and perm.shape == (len(counts),)
    assert perm.tolist() == sorted(range(len(counts)), key=lambda lane: (-counts[lane], lane))


def test_tree_reduce_equals_halving_of_kernel_bodies():
    a = SUM[:, :5]  # odd lane counts on the way down: 5 -> 3 -> 2 -> 1
    got = G1P.tree_reduce(torch.from_numpy(a.copy()))
    lanes = a.shape[1]
    while lanes > 1:  # pallas_curve.py:717-730
        half = lanes // 2
        s = ref_add2(a[:, :half], a[:, half : 2 * half])
        if lanes % 2:
            s = np.concatenate([s, a[:, -1:]], axis=1)
            half += 1
        a, lanes = s, half
    assert np.array_equal(got.numpy(), a)
    want = None
    for p in _affine(torch.from_numpy(SUM[:, :5].copy())):
        want = hc.g1_add(want, p)
    assert _affine(got) == [want]


# -- wrappers: argument checks and launch counters ------------------------------


def test_cpu_path_launches_no_kernel():
    build.reset_launches()
    G1P.add2(A, B)
    G1P.step(A, B, torch.ones(L, dtype=torch.int32))
    G1P.scan2b(A, B, A)
    G1P.ladder(A, torch.ones((1, L), dtype=torch.int32))
    G1P.bucket_phase(A.T.contiguous(), None, torch.zeros(2, dtype=torch.int32),
                     torch.ones(2, dtype=torch.int32))
    G1P.chain(A.T[:2].contiguous(), 3)
    G1P.fold(A, [0, 3], [3, 4])
    assert all(v == 0 for v in build.LAUNCHES.values()), build.LAUNCHES
    ec = {"add2", "add_mask", "step", "scan2", "scan2b", "ladder", "ladder_team", "bucket",
          "bucket_mixed", "wsum", "chain_team", "fold_team", "fixed_base", "fixed_base_one"}
    field = {"mont_mul", "mont_mul_rm_fq", "mont_mul_rm_fr", "mont_chain", "mont_chain_seq",
             "mont_chain_wide"}
    assert set(build.LAUNCHES) == field | ec | {k + "_g2" for k in ec}


@pytest.mark.parametrize("op", ["add2", "step", "scan2b", "ladder", "bucket_phase"])
def test_wrappers_reject_bad_shapes(op):
    bad = torch.zeros((71, L), dtype=torch.int32)
    mask = torch.ones(L, dtype=torch.int32)
    with pytest.raises(ValueError):
        if op == "add2":
            G1P.add2(A, bad)
        elif op == "step":
            G1P.step(A, B, mask[:-1])
        elif op == "scan2b":
            G1P.scan2b(A, B, bad)
        elif op == "ladder":
            G1P.ladder(A, torch.ones((16, L + 1), dtype=torch.int32))
        else:
            G1P.bucket_phase(A, None, mask, mask)  # coordinate-major table


@pytest.mark.parametrize("op", ["add2", "step", "scan2b", "ladder", "bucket_phase"])
def test_wrappers_reject_wrong_dtype_on_cpu(op):
    """Limb tensors are int32 on every device: the CPU path raises too."""
    A64, B64 = A.long(), B.long()
    mask = torch.ones(L, dtype=torch.int32)
    with pytest.raises(TypeError):
        if op == "add2":
            G1P.add2(A64, B64)
        elif op == "step":
            G1P.step(A64, B64, mask)
        elif op == "scan2b":
            G1P.scan2b(A64, B64, A64)
        elif op == "ladder":
            G1P.ladder(A64, torch.ones((1, L), dtype=torch.int32))
        else:
            G1P.bucket_phase(A64.T.contiguous(), None, mask[:2] * 0, mask[:2])


def test_cuda_argument_check_rejects_a_misaligned_table():
    """The bucket kernel reads table rows as 16-byte words: its wrapper
    checks that the table starts at a 16-byte aligned address (rows of
    288 and 576 bytes keep every row aligned then)."""
    flat = torch.zeros(2 * 72 + 4, dtype=torch.int32)
    assert flat.data_ptr() % 16 == 0
    build.require_aligned("bucket_phase", 16, table=flat[4:148].view(2, 72))
    for off in (1, 2, 3):
        with pytest.raises(ValueError, match="aligned"):
            build.require_aligned("bucket_phase", 16, table=flat[off:off + 144].view(2, 72))


@pytest.mark.parametrize("fault", ["cpu_tensor", "dtype", "contiguity"])
def test_cuda_argument_check_raises(fault):
    """What a kernel launch insists on (CUDA, int32, contiguous) is checked
    by one function; on CPU tensors of the wrong kind it raises."""
    good = torch.zeros((72, 4), dtype=torch.int32)
    if fault == "cpu_tensor":
        with pytest.raises(ValueError, match="CUDA"):
            build.require_cuda_int32("add2", a=good)
    elif fault == "dtype":
        with pytest.raises((TypeError, ValueError)):
            build.require_cuda_int32("add2", a=good.long())
    else:
        with pytest.raises(ValueError):
            build.require_cuda_int32("add2", a=good.T)
