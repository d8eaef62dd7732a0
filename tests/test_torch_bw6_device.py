"""The generic device group over BW6-761's 761-bit field (device/curve_generic.py)
and `msm_fp` (device/msm.py) on the CPU, held against the host curve
(curves/bw6_761.py, itself equal to the JAX package's: test_torch_bw6.py):
add, double, neg and the identity, `fixed_base_mul`, and `msm_fp` on G1 at
n = 8 and G2 at n = 4 with c = 4 (tests/test_bw6_device.py:33,45: the small
path) and at n = 100 through the window path.  Exact comparisons of affine
points."""
import random

import pytest
import torch

from testudo_tpu_torch.curves import bw6_761 as bw
from testudo_tpu_torch.device import curve_generic as cg
from testudo_tpu_torch.device import msm
from testudo_tpu_torch.device.field import FQ
from testudo_tpu_torch.fields.bw6_761 import R

torch.set_num_threads(1)

CPU = torch.device("cpu")
GROUPS = {
    "g1": (cg.bw6_g1, bw.g1_generator, bw.g1_add, bw.g1_mul, bw.g1_neg),
    "g2": (cg.bw6_g2, bw.g2_generator, bw.g2_add, bw.g2_mul, bw.g2_neg),
}


def _host_msm(add, mul, pts, scl):
    acc = None
    for p, s in zip(pts, scl):
        acc = add(acc, mul(p, s))
    return acc


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_add_double_neg_equal_the_host(name):
    group, gen, add, mul, neg = GROUPS[name]
    G = group()
    rng = random.Random(11)
    g = gen()
    a = [mul(g, rng.randrange(1, R)) for _ in range(4)] + [None, None]
    b = [mul(g, rng.randrange(1, R)) for _ in range(3)] + [a[3], mul(g, 5), None]
    b[2] = neg(a[2])  # P + (-P): the identity
    A, B = G.from_affine_host(a, device=CPU), G.from_affine_host(b, device=CPU)
    assert G.to_affine_host(G.add(A, B)) == [add(x, y) for x, y in zip(a, b)]
    assert G.to_affine_host(G.double(A)) == [add(x, x) for x in a]
    assert G.to_affine_host(G.neg(A)) == [neg(x) for x in a]
    assert G.to_affine_host(G.identity((2,), device=CPU)) == [None, None]
    sel = torch.tensor([True, False, True, False, True, False])
    assert G.to_affine_host(G.select(sel, A, B)) == [x if s else y for s, x, y in
                                                     zip(sel.tolist(), a, b)]


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_fixed_base_mul_equals_the_host(name):
    group, gen, add, mul, _ = GROUPS[name]
    rng = random.Random(12)
    scal = [0, 1, R - 1, 255, 256, 1 << 376] + [rng.randrange(R) for _ in range(3)]
    out = cg.fixed_base_mul(group(), torch.as_tensor(FQ.to_limbs(scal)), gen(), add)
    assert group().to_affine_host(out) == [mul(gen(), s) for s in scal]


@pytest.mark.parametrize("name,n,c", [("g1", 8, 4), ("g2", 4, 4)])
def test_msm_fp_small_path_equals_the_host(name, n, c):
    group, gen, add, mul, _ = GROUPS[name]
    rng = random.Random(13)
    g = gen()
    pts = [mul(g, rng.randrange(1, R)) for _ in range(n)]
    scl = [rng.randrange(R) for _ in range(n)]
    G = group()
    got = msm.msm_fp(G, add, G.from_affine_host(pts, device=CPU),
                     torch.as_tensor(FQ.to_limbs(scl)), c=c)
    assert got == _host_msm(add, mul, pts, scl)


def test_msm_fp_window_path_equals_the_host():
    """n = 100 > 64: 8-bit windows, bucket sums by pairwise halving, the
    weighted sum and the host Horner.  Runs of one bucket: 40 of the scalars
    are 0 or 1 (a witness's booleans), one base is the identity and two
    scalars are 0 and r - 1."""
    rng = random.Random(14)
    g = bw.g1_generator()
    pts = [bw.g1_mul(g, rng.randrange(1, R)) for _ in range(100)]
    pts[7] = None
    scl = [rng.randrange(2) for _ in range(40)] + [rng.randrange(R) for _ in range(60)]
    scl[50], scl[51] = 0, R - 1
    G = cg.bw6_g1()
    got = msm.msm_fp(G, bw.g1_add, G.from_affine_host(pts, device=CPU),
                     torch.as_tensor(FQ.to_limbs(scl)))
    assert got == _host_msm(bw.g1_add, bw.g1_mul, pts, scl)


def test_segment_sums_cover_empty_odd_and_long_runs(monkeypatch):
    """_segment_sums on runs of 0, 1, 2, 3 and 9 entries, with the lanes of
    one batched add cut into slices of 2."""
    monkeypatch.setattr(msm, "_FP_LANES", 2)
    rng = random.Random(15)
    g = bw.g1_generator()
    ks = [rng.randrange(1, R) for _ in range(6)]
    G = cg.bw6_g1()
    points = G.from_affine_host([bw.g1_mul(g, k) for k in ks], device=CPU)
    counts = [0, 1, 2, 0, 3, 9]
    idx = [rng.randrange(6) for _ in range(sum(counts))]
    got = G.to_affine_host(msm._segment_sums(G, points, torch.tensor(idx), torch.tensor(counts)))
    want, at = [], 0
    for cnt in counts:
        want.append(bw.g1_mul(g, sum(ks[i] for i in idx[at: at + cnt]) % R) if cnt else None)
        at += cnt
    assert got == want
