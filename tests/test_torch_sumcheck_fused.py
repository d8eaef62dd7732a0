"""The port's fused sumcheck provers (testudo_tpu_torch/core/sumcheck.py
`_prove_fused`, `_prove_cubic_batched_fused`) on the CPU, where the round,
Poseidon and tail kernels' plain versions run in their place.

  - Each of the four provers (the batched one at (k_par, k_seq) = (2, 0) and
    (2, 1)), on an Fr and on an Fq transcript, gives the round polynomials,
    challenges, final claims and final sponge (state, mode, index) of the
    port's looped prover and of the JAX package's looped prover
    (TESTUDO_FUSED_SUMCHECK=0 and TESTUDO_FUSED_SPARK=0 on the JAX side, as
    tests/test_torch_sumcheck.py sets them: its fused jit compiles for
    minutes on a CPU).  Tables of 2^1 .. 2^5 rows: each prover meets all
    five sizes over its two transcripts (the plain permutation costs a
    quarter second on a CPU, three a round), from sponges at different
    (mode, index); the host verifier accepts every fused proof.
  - `num_rounds = 0` takes the looped path, as in the reference.
  - csrc/host_check.cpp (built with the host C++ compiler; skipped where
    there is none) runs the round kernel's body over its blocks and threads
    and is held against `sumcheck_round_plain`: each kind, with and without
    the fold, 2 to 1,024 rows, one block, the launch's blocks and three.
  - Slow-marked: the JAX package's fused jit (`_prove_fused`) for quad and
    cubic_tau at 2 and 3 rounds, on both transcripts, against the port's
    fused prover.
Exact equality throughout: these are field elements."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from testudo_tpu.core import sumcheck as jsc
from testudo_tpu.poly import dense as jd
from testudo_tpu.poseidon import transcript as jtr
from testudo_tpu_torch.core import sumcheck as sc
from testudo_tpu_torch.device import build
from testudo_tpu_torch.device import field as tf
from testudo_tpu_torch.device import sumcheck_kernels as sk
from testudo_tpu_torch.device.field import FR
from testudo_tpu_torch.fields.bls12_377 import R
from testudo_tpu_torch.poly import dense
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
    return ([0, 1, R - 1] + [int.from_bytes(rng.bytes(40), "little") % R for _ in range(n)])[:n]


def _tables(seed, n, k):
    """k tables of n scalars: host ints, the port's tensors, the JAX arrays."""
    rng = np.random.default_rng(seed)
    vals = [_ints(rng, n) for _ in range(k)]
    return vals, [dense.encode_table(v, device=CPU) for v in vals], [jd.encode_table(v) for v in vals]


def _transcripts(sponge, prefix):
    """(port's transcript, a second one, the JAX package's), each after the
    same prefix: a number of appended scalars, then a number of challenges."""
    ours = {"fr": ttr.fr_params, "fq": ttr.fq_params}[sponge]
    theirs = {"fr": jtr.fr_params, "fq": jtr.fq_params}[sponge]
    out = [ttr.PoseidonTranscript(ours()), ttr.PoseidonTranscript(ours()),
           jtr.PoseidonTranscript(theirs())]
    appends, challenges = prefix
    for t in out:
        for v in range(appends):
            t.append_scalar(1000 + v, R)
        for _ in range(challenges):
            t.challenge_scalar(R)
    return out


def _sponge(t):
    return list(t.sponge.state), t.sponge.mode, t.sponge.index


def _host_claim(kind, vals, coeffs):
    if kind == "quad":
        return sum(a * b for a, b in zip(*vals)) % R
    if kind == "cubic_tau":
        return sum(t * (a * b - c) for t, a, b, c in zip(*vals)) % R
    if kind == "cubic":
        return sum(a * b * c for a, b, c in zip(*vals)) % R
    triples = [(vals[a], vals[b], vals[c]) for a, b, c in sk.instance_tables("cubic", *kind)]
    return sum(cf * sum(x * y * z for x, y, z in zip(*t)) for cf, t in zip(coeffs, triples)) % R


def _prove(kind, mod, claim, rounds, tables, transcript, fused=True):
    """One prover of `mod` (the port's or the JAX package's sumcheck module)
    on the stack of tables; returns (proof, r, finals flattened)."""
    if kind in ("quad", "cubic_tau", "cubic"):
        fn = {"quad": mod.prove_quad, "cubic_tau": mod.prove_cubic_with_additive_term,
              "cubic": mod.prove_cubic}[kind]
        extra = {"fused": fused} if mod is sc else {}
        proof, rs, finals = fn(claim, rounds, *tables, transcript, **extra)
        return proof, rs, list(finals)
    kp, ks = kind
    par = (tables[:kp], tables[kp: 2 * kp], tables[2 * kp])
    base = 2 * kp + 1
    seq = (tables[base: base + ks], tables[base + ks: base + 2 * ks], tables[base + 2 * ks:])
    extra = {"fused": fused} if mod is sc else {}
    proof, rs, prod, dotp = mod.prove_cubic_batched(claim, rounds, par, seq, COEFFS, transcript,
                                                    **extra)
    return proof, rs, [*prod[0], *prod[1], prod[2], *dotp[0], *dotp[1], *dotp[2]]


COEFFS = [7, R - 3, 1 << 200]
# (prover, transcript, log2 of the table sizes, the transcript's prefix)
CASES = []
for _kind in ("quad", "cubic_tau", "cubic", (2, 0), (2, 1)):
    CASES.append((_kind, "fr", (1, 3, 5), (0, 1)))
    CASES.append((_kind, "fq", (2, 4), (1, 0)))
_IDS = [f"{k if isinstance(k, str) else 'batched%d%d' % k}-{s}" for k, s, _, _ in CASES]


@pytest.mark.parametrize("kind,sponge,sizes,prefix", CASES, ids=_IDS)
def test_fused_prover_equals_both_looped_provers(kind, sponge, sizes, prefix):
    ntab = sk.stack_size(*((kind, 1, 0) if isinstance(kind, str) else ("cubic", *kind)))
    for log2n in sizes:
        n = 1 << log2n
        vals, ours, theirs = _tables(100 * log2n + ntab, n, ntab)
        claim = _host_claim(kind, vals, COEFFS)
        fused_t, looped_t, jax_t = _transcripts(sponge, prefix)
        build.reset_launches()
        got = _prove(kind, sc, claim, log2n, ours, fused_t)
        assert sum(build.LAUNCHES.values()) == 0  # CPU tensors take the plain versions
        looped = _prove(kind, sc, claim, log2n, ours, looped_t, fused=False)
        want = _prove(kind, jsc, claim, log2n, theirs, jax_t)
        for other in (looped, want):
            assert [p.coeffs for p in got[0].polys] == [p.coeffs for p in other[0].polys]
            assert got[1] == list(other[1])
            assert got[2] == list(other[2])
        assert _sponge(fused_t) == _sponge(looped_t) == _sponge(jax_t)
        # the host verifier accepts the fused proof
        verifier = _transcripts(sponge, prefix)[0]
        degree = 2 if kind == "quad" else 3
        e, r = got[0].verify(claim, log2n, degree, verifier)
        assert r == got[1] and _sponge(verifier) == _sponge(fused_t)


def test_zero_rounds_take_the_looped_path(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the fused path ran with no rounds to prove")

    monkeypatch.setattr(sc, "_prove_fused", refuse)
    vals, ours, _ = _tables(5, 1, 4)
    tp, _, _ = _transcripts("fr", (0, 1))
    before = _sponge(tp)
    proof, rs, finals = sc.prove_cubic_with_additive_term(0, 0, *ours, tp)
    assert proof.polys == [] and rs == [] and finals == [v[0] for v in vals]
    assert _sponge(tp) == before
    proof, rs, prod, dotp = sc.prove_cubic_batched(0, 0, ([ours[0]], [ours[1]], ours[2]),
                                                   ([], [], []), [1], tp)
    assert proof.polys == [] and prod == ([vals[0][0]], [vals[1][0]], vals[2][0])


def test_fused_path_needs_power_of_two_tables():
    _, ours, _ = _tables(6, 4, 2)
    tp, _, _ = _transcripts("fr", (0, 0))
    with pytest.raises(ValueError):
        sc.prove_quad(0, 3, *ours, tp)  # 3 rounds on 4 rows
    with pytest.raises(ValueError):
        sk.sumcheck_round("quad", torch.stack([o[:3] for o in ours]))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler found")
    out = tmp_path_factory.mktemp("host_round") / "libhost_check.so"
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-x", "c++",
         "-I", str(build.CSRC), "-o", str(out), str(build.CSRC / "host_check.cpp")],
        check=True, capture_output=True, text=True, timeout=300,
    )
    lib = ctypes.CDLL(str(out))
    lib.host_sumcheck_round.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_long] + [
        ctypes.c_int] * 4
    return lib


def _ptr(t):
    if t is None:
        return None
    assert t.dtype == torch.int32 and t.is_contiguous()
    return t.data_ptr()


LAYOUTS = [("quad", 1, 0), ("cubic_tau", 1, 0), ("cubic", 1, 0), ("cubic", 2, 1), ("cubic", 0, 2)]


@pytest.mark.parametrize("kind,k_par,k_seq", LAYOUTS, ids=[f"{k}-{p}-{s}" for k, p, s in LAYOUTS])
def test_round_body_equals_plain(host_lib, kind, k_par, k_seq):
    """The round kernel's body, block by block and thread by thread, against
    the plain version: the folded stack and the partials' sums (and the
    plain sums against the definition in host ints at one size)."""
    T = sk.stack_size(kind, k_par, k_seq)
    k = len(sk.instance_tables(kind, k_par, k_seq))
    rng = np.random.default_rng(31 + T)
    for n in (2, 4, 8, 64, 1024):
        vals = [_ints(rng, n) for _ in range(T)]
        src = torch.as_tensor(np.stack([FR.encode(v) for v in vals]))
        r_int = _ints(rng, 4)[3]
        r = torch.as_tensor(FR.encode(r_int))
        for fold in (False, True):
            want_dst, want = sk.sumcheck_round_plain(kind, src, r if fold else None, k_par, k_seq)
            for nb in sorted({1, sk.round_blocks(n, fold), 3}):
                dst = torch.full((T, n // 2, FR.nlimbs), -1, dtype=torch.int32) if fold else None
                part = torch.full((k, nb, sk.POINTS[kind], FR.nlimbs), -1, dtype=torch.int32)
                rc = host_lib.host_sumcheck_round(_ptr(src), _ptr(dst), _ptr(r) if fold else None,
                                                  _ptr(part), sk.KINDS[kind], n, int(fold),
                                                  k_par, k_seq, nb)
                assert rc == 0
                if fold:
                    assert torch.equal(dst, want_dst), (n, nb)
                assert torch.equal(tf.reduce_sum(FR, part, axis=1), want[:, 0]), (n, fold, nb)
            if n == 8 and fold:  # the definition: fold, then the lines at 0, 2, 3
                h = n // 2
                folded = [[(lo + r_int * (hi - lo)) % R for lo, hi in zip(v[:h], v[h:])]
                          for v in vals]
                assert FR.decode(want_dst.reshape(-1, FR.nlimbs)) == sum(folded, [])
                q = h // 2
                for i, idx in enumerate(sk.instance_tables(kind, k_par, k_seq)):
                    sums = []
                    for x in (0, 2, 3)[: sk.POINTS[kind]]:
                        pts = [[(f[j] + x * (f[j + q] - f[j])) % R for j in range(q)]
                               for f in (folded[t] for t in idx)]
                        if kind == "quad":
                            terms = [a * b for a, b in zip(*pts)]
                        elif kind == "cubic_tau":
                            terms = [t * (a * b - c) for t, a, b, c in zip(*pts)]
                        else:
                            terms = [a * b * c for a, b, c in zip(*pts)]
                        sums.append(sum(terms) % R)
                    assert FR.decode(want[i, 0]) == sums
    bad = torch.zeros((T, 3, FR.nlimbs), dtype=torch.int32)
    part = torch.zeros((k, 1, sk.POINTS[kind], FR.nlimbs), dtype=torch.int32)
    assert host_lib.host_sumcheck_round(_ptr(bad), None, None, _ptr(part), sk.KINDS[kind], 3, 0,
                                        k_par, k_seq, 1) == -3


SLOW_CASES = [(kind, sponge, rounds) for kind in ("quad", "cubic_tau") for sponge in ("fr", "fq")
              for rounds in (2, 3)]


@pytest.mark.slow
@pytest.mark.parametrize("kind,sponge,rounds", SLOW_CASES,
                         ids=[f"{k}-{s}-{r}" for k, s, r in SLOW_CASES])
def test_fused_prover_equals_the_reference_fused_jit(kind, sponge, rounds, monkeypatch):
    monkeypatch.setenv("TESTUDO_FUSED_SUMCHECK", "1")
    ntab = 2 if kind == "quad" else 4
    vals, ours, theirs = _tables(7 * rounds + ntab, 1 << rounds, ntab)
    claim = _host_claim(kind, vals, None)
    ours_t, _, jax_t = _transcripts(sponge, (1, 1))
    proof, rs, finals = sc._prove_fused(kind, claim, rounds, ours, ours_t)
    jproof, jrs, jfinals = jsc._prove_fused(kind, claim, rounds, theirs, jax_t)
    assert [p.coeffs for p in proof.polys] == [p.coeffs for p in jproof.polys]
    assert rs == list(jrs) and finals == list(jfinals)
    assert _sponge(ours_t) == _sponge(jax_t)
