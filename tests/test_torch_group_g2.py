"""The group-layer entry points a commitment backend calls, for G1 and G2:
`fixed_base_mul_g1/g2` (testudo_tpu_torch/device/curve.py) against the host
curve and, limb for limb, against testudo_tpu.tpu.curve; `msm_segmented` and
`msm_multi_small` (device/msm.py) against the host MSM.  All on the CPU, where
the wrappers take the kernels' plain versions.  Integers: exact equality."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from testudo_tpu.fields import host as jhf
from testudo_tpu.tpu import curve as jc
from testudo_tpu_torch.curves import host_curve as hc
from testudo_tpu_torch.device import build
from testudo_tpu_torch.device import curve as tc
from testudo_tpu_torch.device import msm as tmsm
from testudo_tpu_torch.device.field import FR
from testudo_tpu_torch.fields.bls12_377 import R

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

RNG = np.random.default_rng(91)
_PRNG = __import__("random").Random(91)

GROUPS = {
    "g1": dict(gen=hc.g1_generator, mul=hc.g1_mul, msm=hc.g1_msm, frm=tc.g1_from_affine_host,
               to=tc.g1_to_affine_host, fixed=tc.fixed_base_mul_g1),
    "g2": dict(gen=hc.g2_generator, mul=hc.g2_mul, msm=hc.g2_msm, frm=tc.g2_from_affine_host,
               to=tc.g2_to_affine_host, fixed=tc.fixed_base_mul_g2),
}


def _points(group, n):
    g = GROUPS[group]
    return [g["mul"](g["gen"](), int(k)) for k in RNG.integers(1, 1 << 62, size=n)]


def _scalars(n):
    return [_PRNG.randrange(R) for _ in range(n)]


def _leaves(p):
    return [c for coord in p for c in (coord if isinstance(coord, tuple) else (coord,))]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_fixed_base_mul_against_host_and_reference(group):
    """Scalars 0, 1, r - 1 among random ones; a base that is not the
    generator.  The projective limbs equal the JAX package's (the same adds
    and selects in the same order), the points equal the host's."""
    g = GROUPS[group]
    base = g["mul"](g["gen"](), 0xABCDEF)
    ks = [0, 1, R - 1, 2] + _scalars(2)
    limbs = FR.to_limbs(ks)
    build.reset_launches()
    got = g["fixed"](torch.from_numpy(limbs), base, device="cpu")
    assert all(v == 0 for v in build.LAUNCHES.values())
    assert g["to"](got) == [g["mul"](base, k) for k in ks]
    if group == "g1":
        ref = jc.fixed_base_mul_g1(jnp.asarray(limbs.astype(np.uint32)), base)
    else:
        jbase = (jhf.Fq2(base[0].c0, base[0].c1), jhf.Fq2(base[1].c0, base[1].c1))
        ref = jc.fixed_base_mul_g2(jnp.asarray(limbs.astype(np.uint32)), jbase)
    for t, j in zip(_leaves(got), _leaves(ref)):
        assert t.dtype == torch.int32 and t.shape == (len(ks), 24)
        assert np.array_equal(t.numpy(), np.asarray(j).astype(np.int32))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_segmented_against_host(group):
    g = GROUPS[group]
    n_seg, seg = 3, 3
    pts_h = _points(group, n_seg * seg)
    ks = _scalars(n_seg * seg)
    ks[0], ks[4] = 0, R - 1
    got = tmsm.msm_segmented(group, g["frm"](pts_h, device="cpu"), ks, n_seg, device="cpu")
    want = [g["msm"](pts_h[s * seg:(s + 1) * seg], ks[s * seg:(s + 1) * seg]) for s in range(n_seg)]
    assert got == want
    with pytest.raises(ValueError):
        tmsm.msm_segmented(group, g["frm"](pts_h, device="cpu"), ks, 2, device="cpu")


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_multi_small_against_host(group):
    """Parts of differing lengths (4, 1, 2), limb and int scalars mixed, and
    an empty part, which sums to the identity."""
    g = GROUPS[group]
    sizes = (4, 1, 0, 2)
    parts, want = [], []
    for i, n in enumerate(sizes):
        pts_h, ks = _points(group, n), _scalars(n)
        scal = torch.from_numpy(FR.to_limbs(ks)) if i % 2 == 0 and n else ks
        if n == 0:
            scal = torch.zeros((0, 16), dtype=torch.int32)
        parts.append((g["frm"](pts_h, device="cpu"), scal))
        want.append(g["msm"](pts_h, ks))
    assert tmsm.msm_multi_small(group, parts, device="cpu") == want
    assert want[2] is None and tmsm.msm_multi_small(group, [], device="cpu") == []


def test_large_parts_fall_through_to_the_full_msm(monkeypatch):
    """Above `_LADDER_MAX` points per part both functions hand each part to
    `msm_g1` (here with the limit lowered, so the parts stay small)."""
    monkeypatch.setattr(tmsm, "_LADDER_MAX", 2)
    calls = []
    real = tmsm.msm_g1

    def spy(points, scalars, **kw):
        calls.append(scalars.shape[0])
        return real(points, scalars, **kw)

    monkeypatch.setattr(tmsm, "msm_g1", spy)
    g = GROUPS["g1"]
    pts_h, ks = _points("g1", 6), _scalars(6)
    dev = g["frm"](pts_h, device="cpu")
    got = tmsm.msm_segmented("g1", dev, ks, 2, device="cpu")
    assert got == [hc.g1_msm(pts_h[:3], ks[:3]), hc.g1_msm(pts_h[3:], ks[3:])]
    assert calls == [3, 3]
    parts = [(g["frm"](pts_h[:3], device="cpu"), ks[:3]), (g["frm"](pts_h[3:4], device="cpu"), ks[3:4])]
    assert tmsm.msm_multi_small("g1", parts, device="cpu") == [
        hc.g1_msm(pts_h[:3], ks[:3]), hc.g1_mul(pts_h[3], ks[3])]
    assert calls == [3, 3, 3, 1]
