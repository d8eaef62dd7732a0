"""The port's BLS12-381 host copies (fields/tower.py, fields/bls12_381.py,
curves/bls12_381.py, poseidon/constants_381.py, the 381 half of
poseidon/transcript.py, curves/profile.py's serializers) on their own and
against the JAX package's.

The first five tests are tests/test_bls12_381.py's checks run on the port's
copies (tower axioms, generators and subgroup, bilinearity, the 381 Poseidon
transcript, `params_for_curve`), the next the 381 half of
tests/test_external_fixtures.py (the published moduli and the IETF
generators).  The rest hold the copies against the JAX package's on the
same seeded inputs: equal constants, an equal `g1_msm` / `g2_msm`, an equal
pairing through `ser_gt`, equal transcript challenges.  All of it is host
Python on both sides: no JAX graph is compiled."""
import random

import pytest
import torch

from testudo_tpu.curves import bls12_381 as jc381
from testudo_tpu.curves import profile as jprof
from testudo_tpu.fields import bls12_381 as jf381
from testudo_tpu.poseidon import transcript as jtr
from testudo_tpu_torch.curves import bls12_381 as c381
from testudo_tpu_torch.curves import profile as cprof
from testudo_tpu_torch.fields import bls12_381 as f381
from testudo_tpu_torch.fields import tower
from testudo_tpu_torch.poseidon.transcript import (PoseidonTranscript, fr_params, fr_params_381,
                                                   params_for_curve)

torch.set_num_threads(1)

P, R = f381.P, f381.R

# published constants (tests/test_external_fixtures.py: the IETF / zcash
# BLS12-381 parameter set), not derived here
BLS12_381_P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
BLS12_381_R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
G1_381_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_381_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
G2_381_X_C0 = 0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8
G2_381_X_C1 = 0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E
G2_381_Y_C0 = 0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801
G2_381_Y_C1 = 0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE


def _fq12(rng, cls):
    Fq2, Fq6, Fq12 = cls.Fq2, cls.Fq6, cls.Fq12
    return Fq12(*(Fq6(*(Fq2(rng.randrange(P), rng.randrange(P)) for _ in range(3)))
                  for _ in range(2)))


def test_tower_field_axioms():
    rng = random.Random(17)
    a, b = _fq12(rng, c381), _fq12(rng, c381)
    Fq12 = c381.Fq12
    assert a * a.inv() == Fq12.one()
    assert a * b == b * a
    assert a.square() == a * a
    f = a
    for _ in range(12):  # the p-power map has order 12
        f = f.frobenius(1)
    assert f == a
    assert a.frobenius(1).frobenius(1) == a.frobenius(2)
    x = c381.Fq2(rng.randrange(P), rng.randrange(P))
    assert x.sqrt() is None or x.sqrt().square() == x
    assert (x.square()).sqrt() in (x, -x)


def test_generators_and_subgroup():
    g1, g2 = c381.g1_generator(), c381.g2_generator()
    assert c381.g1_is_on_curve(g1) and c381.g2_is_on_curve(g2)
    assert c381.g1_mul(g1, R) is None
    assert c381.g2_mul(g2, R) is None
    assert f381.G1_ORDER == f381.H1 * R and f381.G2_ORDER == f381.H2 * R


def test_pairing_bilinearity():
    rng = random.Random(18)
    g1, g2 = c381.g1_generator(), c381.g2_generator()
    a, b = rng.randrange(1, R), rng.randrange(1, R)
    e = c381.pairing(g1, g2)
    assert e != c381.Fq12.one()
    assert c381.pairing(c381.g1_mul(g1, a), c381.g2_mul(g2, b)) == e.pow(a * b % R)
    prod = c381.multi_pairing([c381.g1_mul(g1, a), c381.g1_neg(c381.g1_mul(g1, a))], [g2, g2])
    assert prod == c381.Fq12.one()


def test_poseidon_381_transcript():
    """The rate-1 t = 2 alpha = 5 sponge runs, is deterministic and
    depends on what it absorbed."""
    params = fr_params_381()
    assert (params.rate, params.capacity, params.alpha) == (1, 1, 5)
    assert params.modulus == R and len(params.ark) == 64 and len(params.mds) == 2
    t1 = PoseidonTranscript(params)
    t1.append_scalar(42, R)
    c1 = t1.challenge_scalar(R)
    t2 = PoseidonTranscript(params)
    t2.append_scalar(42, R)
    assert t2.challenge_scalar(R) == c1
    t3 = PoseidonTranscript(params)
    t3.append_scalar(43, R)
    assert t3.challenge_scalar(R) != c1
    assert 0 < c1 < R


def test_params_for_curve_dispatch():
    assert params_for_curve("bls12-377") is fr_params()
    assert params_for_curve("bls12-377").modulus != params_for_curve("bls12-381").modulus
    assert params_for_curve("blst") is params_for_curve("bls12_381") is fr_params_381()
    with pytest.raises(ValueError):
        params_for_curve("bn254")


def test_published_moduli_and_generators():
    """The seed formulas land on the published moduli; the IETF generators
    are on the curve and its twist, of order r, and pair bilinearly."""
    assert (P, R) == (BLS12_381_P, BLS12_381_R)
    g1 = (G1_381_X, G1_381_Y)
    g2 = (c381.Fq2(G2_381_X_C0, G2_381_X_C1), c381.Fq2(G2_381_Y_C0, G2_381_Y_C1))
    assert c381.g1_is_on_curve(g1) and c381.g1_mul(g1, R) is None
    assert c381.g2_is_on_curve(g2) and c381.g2_mul(g2, R) is None
    e = c381.pairing(g1, g2)
    assert e != e.one()
    assert c381.pairing(c381.g1_mul(g1, 3), g2) == e * e * e


# -- against the JAX package ---------------------------------------------------------


def test_constants_equal_the_jax_package():
    for name in ("X_SEED", "R", "P", "TRACE", "H1", "H2", "G1_ORDER", "G2_ORDER", "B1",
                 "FQ2_NONRESIDUE", "XI", "FR_BYTES", "FQ_BYTES"):
        assert getattr(f381, name) == getattr(jf381, name), name
    from testudo_tpu.poseidon import constants_381 as jC
    from testudo_tpu_torch.poseidon import constants_381 as C

    for name in ("ARK", "MDS", "FULL_ROUNDS", "PARTIAL_ROUNDS", "ALPHA", "RATE", "CAPACITY"):
        assert getattr(C, name) == getattr(jC, name), name


def _coeffs(x):
    """An Fq12 element of either package as its twelve Fq ints."""
    return [c for c6 in (x.c0, x.c1) for c2 in (c6.c0, c6.c1, c6.c2) for c in (c2.c0, c2.c1)]


def test_tower_and_generators_equal_the_jax_package():
    rng = random.Random(19)
    seed = rng.getrandbits(64)
    a, b = _fq12(random.Random(seed), c381), _fq12(random.Random(seed), jc381)
    assert _coeffs(a) == _coeffs(b)
    for got, want in ((a * a, b * b), (a.inv(), b.inv()), (a.frobenius(3), b.frobenius(3)),
                      (a.conj().square(), b.conj().square())):
        assert _coeffs(got) == _coeffs(want)
    assert c381.g1_generator() == jc381.g1_generator()
    g2, jg2 = c381.g2_generator(), jc381.g2_generator()
    assert [(c.c0, c.c1) for c in g2] == [(c.c0, c.c1) for c in jg2]
    Fq2, _, _ = tower.make_tower(P, f381.FQ2_NONRESIDUE, f381.XI)
    assert Fq2(3, 4) * Fq2(5, 6) == Fq2(3 * 5 - 4 * 6, 3 * 6 + 4 * 5)  # u^2 = -1


def test_msm_equals_the_jax_package():
    """g1_msm and g2_msm of the port's copy equal the JAX package's on the
    same seeded points and scalars, and equal the sum of single products."""
    rng = random.Random(20)
    ks = [rng.randrange(1, R) for _ in range(6)]
    ss = [rng.randrange(R) for _ in range(6)]
    g1 = c381.g1_generator()
    pts = [c381.g1_mul(g1, k) for k in ks]
    got = c381.g1_msm(pts, ss)
    assert got == jc381.g1_msm([jc381.g1_mul(jc381.g1_generator(), k) for k in ks], ss)
    assert got == c381.g1_mul(g1, sum(k * s for k, s in zip(ks, ss)) % R)
    g2 = c381.g2_generator()
    got2 = c381.g2_msm([c381.g2_mul(g2, k) for k in ks[:3]], ss[:3])
    want2 = jc381.g2_msm([jc381.g2_mul(jc381.g2_generator(), k) for k in ks[:3]], ss[:3])
    assert [(c.c0, c.c1) for c in got2] == [(c.c0, c.c1) for c in want2]


def test_pairing_equals_the_jax_package_through_ser_gt():
    rng = random.Random(21)
    a, b = rng.randrange(1, R), rng.randrange(1, R)
    port = cprof.bls12_381(torch.device("cpu"))
    ref = jprof.bls12_381()
    e = port.pairing(c381.g1_mul(c381.g1_generator(), a), c381.g2_mul(c381.g2_generator(), b))
    je = ref.pairing(jc381.g1_mul(jc381.g1_generator(), a),
                     jc381.g2_mul(jc381.g2_generator(), b))
    assert port.ser_gt(e) == ref.ser_gt(je)
    assert len(port.ser_gt(e)) == 12 * 48
    assert port.ser_gt(port.gt_pow(e, a)) == ref.ser_gt(ref.gt_pow(je, a))


def test_serializers_equal_the_jax_package():
    port = cprof.bls12_381(torch.device("cpu"))
    ref = jprof.bls12_381()
    g1 = c381.g1_mul(c381.g1_generator(), 5)
    g2 = c381.g2_mul(c381.g2_generator(), 7)
    jg2 = jc381.g2_mul(jc381.g2_generator(), 7)
    assert port.ser_g1_uncompressed(g1) == ref.ser_g1_uncompressed(g1)
    assert port.ser_g2_uncompressed(g2) == ref.ser_g2_uncompressed(jg2)
    assert port.ser_g1_uncompressed(None) == ref.ser_g1_uncompressed(None) == \
        b"\x00" * 95 + b"\x40"
    assert port.ser_g2_uncompressed(None) == ref.ser_g2_uncompressed(None)


def test_transcript_challenges_equal_the_jax_package():
    """The same absorbs (scalars, bytes, a GT element's encoding, a re-key)
    give the same challenges from both packages' 381 transcripts."""
    rng = random.Random(22)
    port = cprof.bls12_381(torch.device("cpu"))
    e = port.pairing(c381.g1_generator(), c381.g2_generator())
    ours, theirs = PoseidonTranscript(fr_params_381()), jtr.PoseidonTranscript(jtr.fr_params_381())
    for t in (ours, theirs):
        t.append_bytes(port.ser_gt(e))
    for _ in range(3):
        vals = [rng.randrange(R) for _ in range(3)]
        for t in (ours, theirs):
            t.append_scalar_vector(vals, R)
        c = ours.challenge_scalar(R)
        assert c == theirs.challenge_scalar(R)
        ours.new_from_state(c, R)
        theirs.new_from_state(c)  # the JAX package's default names the 377 modulus: same value
    assert ours.challenge_scalar_vec(R, 4) == theirs.challenge_scalar_vec(R, 4)
    assert ours.sponge.state == theirs.sponge.state
