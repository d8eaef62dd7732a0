"""The port's sumcheck (testudo_tpu_torch/core/sumcheck.py) against the JAX
package's core/sumcheck.py, in its looped form: each round-evaluation function
on tables of 2^3 and 2^6 rows, and each of the four provers on tables of 2^3 to
2^5 rows, on the same inputs made from a numpy seed.  The JAX side runs with
TESTUDO_FUSED_SUMCHECK=0 (and TESTUDO_FUSED_SPARK=0), so its looped provers run
without the fused jit.  Equal round polynomials, challenges, final claims and
sponge states (exact: these are field elements).  The host verifier accepts a
proof, and rejects a changed coefficient, a wrong degree and a missing round."""
import numpy as np
import pytest
import torch

from testudo_tpu.core import sumcheck as jsc
from testudo_tpu.poly import dense as jd
from testudo_tpu.poseidon import transcript as jtr
from testudo_tpu.tpu.field import FR as JFR
from testudo_tpu_torch.core import sumcheck as sc
from testudo_tpu_torch.device import build
from testudo_tpu_torch.device.field import FR
from testudo_tpu_torch.fields.bls12_377 import R
from testudo_tpu_torch.poly import dense
from testudo_tpu_torch.poly.unipoly import UniPoly
from testudo_tpu_torch.poseidon import transcript as ttr

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def looped_reference(monkeypatch):
    monkeypatch.setenv("TESTUDO_FUSED_SUMCHECK", "0")
    monkeypatch.setenv("TESTUDO_FUSED_SPARK", "0")


def _ints(rng, n):
    """n scalars with 0, 1 and r - 1 first."""
    return ([0, 1, R - 1] + [int.from_bytes(rng.bytes(40), "little") % R for _ in range(n)])[:n]


def _tables(seed, n, k):
    """k tables of n scalars: host ints, the port's tensors, the JAX arrays."""
    rng = np.random.default_rng(seed)
    vals = [_ints(rng, n) for _ in range(k)]
    ours = [dense.encode_table(v, device=CPU) for v in vals]
    theirs = [jd.encode_table(v) for v in vals]
    for o, t in zip(ours, theirs):
        assert np.array_equal(o.numpy(), np.asarray(t).astype(np.int32))
    return vals, ours, theirs


def _transcripts(sponge):
    params = {"fr": (ttr.fr_params, jtr.fr_params), "fq": (ttr.fq_params, jtr.fq_params)}[sponge]
    return ttr.PoseidonTranscript(params[0]()), jtr.PoseidonTranscript(params[1]())


def _coeffs(proof):
    return [p.coeffs for p in proof.polys]


ROUND_FNS = {
    "cubic_tau": (sc._round_evals_cubic_tau_s, jsc._round_evals_cubic_tau_s, 4),
    "cubic_prod": (sc._round_evals_cubic_prod_s, jsc._round_evals_cubic_prod_s, 3),
    "quad": (sc._round_evals_quad_s, jsc._round_evals_quad_s, 2),
}


@pytest.mark.parametrize("log2n", [3, 6])
@pytest.mark.parametrize("kind", sorted(ROUND_FNS))
def test_round_evals_equal_reference(kind, log2n):
    ours_fn, theirs_fn, k = ROUND_FNS[kind]
    vals, ours, theirs = _tables(10 + log2n, 1 << log2n, k)
    got = ours_fn(FR, *ours)
    want = jsc._pull(theirs_fn(JFR, *theirs))
    assert got.shape == (len(want), FR.nlimbs) and got.dtype == torch.int32
    assert sc._pull(got) == want
    # and against the definition in host ints: sum over the half-tables of
    # the combination at X = 0, 2, 3 of the lines through (lo, hi)
    half = len(vals[0]) // 2

    def comb(xs):
        if kind == "cubic_tau":
            return xs[0] * (xs[1] * xs[2] - xs[3])
        return xs[0] * xs[1] * (xs[2] if kind == "cubic_prod" else 1)

    host = [sum(comb([lo[i] + x * (hi[i] - lo[i]) for lo, hi in ((v[:half], v[half:]) for v in vals)])
                for i in range(half)) % R for x in (0, 2, 3)[: len(want)]]
    assert want == host


def _claim_cubic_tau(vals):
    tau, A, B, C = vals
    return sum(t * (a * b - c) for t, a, b, c in zip(tau, A, B, C)) % R


def _run_provers(kind, sponge):
    """(the port's result, the JAX package's, the port's transcript, the
    JAX transcript, the true claim) of one prover on one input."""
    tp, jtp = _transcripts(sponge)
    if kind == "cubic_tau":
        vals, ours, theirs = _tables(21, 1 << 4, 4)
        claim = _claim_cubic_tau(vals)
        got = sc.prove_cubic_with_additive_term(claim, 4, *ours, tp)
        want = jsc.prove_cubic_with_additive_term(claim, 4, *theirs, jtp)
    elif kind == "quad":
        vals, ours, theirs = _tables(22, 1 << 5, 2)
        claim = sum(a * b for a, b in zip(*vals)) % R
        got = sc.prove_quad(claim, 5, *ours, tp)
        want = jsc.prove_quad(claim, 5, *theirs, jtp)
    elif kind == "cubic":
        vals, ours, theirs = _tables(23, 1 << 3, 3)
        claim = sum(a * b * c for a, b, c in zip(*vals)) % R
        got = sc.prove_cubic(claim, 3, *ours, tp)
        want = jsc.prove_cubic(claim, 3, *theirs, jtp)
    else:  # batched: two instances sharing C, one with its own weights
        vals, ours, theirs = _tables(24, 1 << 3, 6)
        coeffs = _ints(np.random.default_rng(25), 6)[3:6]

        def split(t):
            return ([t[0], t[1]], [t[1], t[0]], t[4]), ([t[2]], [t[3]], [t[5]])

        claims = [sum(a * b * c for a, b, c in zip(vals[0], vals[1], vals[4])),
                  sum(a * b * c for a, b, c in zip(vals[1], vals[0], vals[4])),
                  sum(a * b * c for a, b, c in zip(vals[2], vals[3], vals[5]))]
        claim = sum(cf * c for cf, c in zip(coeffs, claims)) % R
        got = sc.prove_cubic_batched(claim, 3, *split(ours), coeffs, tp)
        want = jsc.prove_cubic_batched(claim, 3, *split(theirs), coeffs, jtp)
    return got, want, tp, jtp, claim


PROVERS = [("cubic_tau", "fr"), ("cubic_tau", "fq"), ("quad", "fr"), ("quad", "fq"),
           ("cubic", "fr"), ("batched", "fr")]


@pytest.mark.parametrize("kind,sponge", PROVERS, ids=[f"{k}-{s}" for k, s in PROVERS])
def test_prover_equals_reference(kind, sponge):
    build.reset_launches()
    got, want, tp, jtp, _ = _run_provers(kind, sponge)
    assert sum(build.LAUNCHES.values()) == 0  # CPU tensors take the plain versions
    assert len(got) == len(want)
    assert _coeffs(got[0]) == _coeffs(want[0])
    assert got[1] == want[1]  # challenges
    for g, w in zip(got[2:], want[2:]):  # final claims
        assert g == (list(w) if isinstance(w, list) else w)
    assert list(tp.sponge.state) == list(jtp.sponge.state)


@pytest.mark.parametrize("kind,sponge", PROVERS[:3] + PROVERS[4:5],
                         ids=[f"{k}-{s}" for k, s in PROVERS[:3] + PROVERS[4:5]])
def test_verifier_accepts_and_rejects(kind, sponge):
    (proof, rs, finals), _, tp, _, claim = _run_provers(kind, sponge)
    degree = 2 if kind == "quad" else 3
    rounds = len(proof.polys)
    tv, _ = _transcripts(sponge)
    e, r = proof.verify(claim, rounds, degree, tv)
    assert r == rs and list(tv.sponge.state) == list(tp.sponge.state)
    # the last claim: the round polynomial at r equals the combination of the finals
    if kind == "cubic_tau":
        assert e == finals[0] * (finals[1] * finals[2] - finals[3]) % R
    elif kind == "quad":
        assert e == finals[0] * finals[1] % R
    else:
        assert e == finals[0] * finals[1] * finals[2] % R
    fresh = lambda: _transcripts(sponge)[0]
    bad = sc.SumcheckInstanceProof([UniPoly(p.coeffs) for p in proof.polys])
    bad.polys[1].coeffs[2] = (bad.polys[1].coeffs[2] + 1) % R
    with pytest.raises(sc.SumcheckError):
        bad.verify(claim, rounds, degree, fresh())
    with pytest.raises(sc.SumcheckError):
        proof.verify((claim + 1) % R, rounds, degree, fresh())
    with pytest.raises(sc.SumcheckError, match="degree"):
        proof.verify(claim, rounds, degree + 1, fresh())
    with pytest.raises(sc.SumcheckError):
        sc.SumcheckInstanceProof(proof.polys[:-1]).verify(claim, rounds, degree, fresh())
    # the JAX package's verifier reads the port's round polynomials the same way
    jproof = jsc.SumcheckInstanceProof([jsc.UniPoly(p.coeffs) for p in proof.polys])
    assert jproof.verify(claim, rounds, degree, _transcripts(sponge)[1]) == (e, r)


def test_unipoly_matches_reference():
    from testudo_tpu.poly.unipoly import UniPoly as JUniPoly

    rng = np.random.default_rng(26)
    for n in (3, 4):
        evals = _ints(rng, n)
        mine, theirs = UniPoly.from_evals(evals), JUniPoly.from_evals(evals)
        assert mine.coeffs == theirs.coeffs and mine.degree() == n - 1
        assert [mine.evaluate(x) for x in range(n)] == [e % R for e in evals]
        assert mine.evaluate(evals[-1]) == theirs.evaluate(evals[-1])
        assert mine.eval_at_one() == evals[1] % R
    with pytest.raises(ValueError):
        UniPoly.from_evals([1, 2])
