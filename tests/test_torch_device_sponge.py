"""The port's device sponge (testudo_tpu_torch/device/sponge.py) and the
bodies of the Poseidon and round-tail kernels, on the CPU.

  - `permute_plain` equals the JAX package's `tpu/sponge.permute` (jitted
    once a field) and the host `PoseidonSponge.permute`, on Fr and Fq states
    (zero, edge values, random ones from a numpy seed);
  - `fr_to_fq_mont` and `fq_squeeze_to_fr_mont` equal the JAX package's, on
    0, 1, r - 1 (and q - 1, values above r) and random values;
  - `DeviceSponge` / `DeviceTranscript` follow the host sponge and transcript
    step by step (state, mode and index) from every (mode, index) a
    sumcheck can start from, and `_simulate_schedule` follows the host's
    mode machine;
  - poseidon.cuh's constant tables equal poseidon/constants_377.py in
    Montgomery form;
  - csrc/host_check.cpp, built with the host C++ compiler (skipped where
    there is none), runs the kernels' bodies (the permutation, the round
    tail) and is held against the plain versions.
Exact equality throughout: these are field elements."""
import ctypes
import re
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from testudo_tpu.tpu import field as jf
from testudo_tpu.tpu import sponge as jsp
from testudo_tpu_torch.core import sumcheck as sc
from testudo_tpu_torch.device import build, packed_field
from testudo_tpu_torch.device import sponge as ds
from testudo_tpu_torch.device import sumcheck_kernels as sk
from testudo_tpu_torch.device.field import FQ, FR
from testudo_tpu_torch.fields.bls12_377 import P, R
from testudo_tpu_torch.poseidon import constants_377 as C
from testudo_tpu_torch.poseidon import transcript as ttr
from testudo_tpu_torch.poseidon.sponge import PoseidonParams, PoseidonSponge

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")
SPECS = {"fr": (FR, jf.FR, R), "fq": (FQ, jf.FQ, P)}
# every (mode, index) a sumcheck's sponge can start from: fresh, after one or
# two absorbs, after one or two squeezes
STARTS = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2)]


def _values(modulus, n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(56), "little") % modulus for _ in range(n)]


def _states(modulus):
    """Sponge states as host ints: zero, the edges, random."""
    return [[0, 0, 0], [1, modulus - 1, 0], _values(modulus, 3, 5), _values(modulus, 3, 6)]


@pytest.fixture(scope="module")
def jax_permute():
    """tpu/sponge.permute jitted once a field."""
    return {name: jax.jit(lambda s, spec=jspec: jsp.permute(spec, s))
            for name, (_, jspec, _) in SPECS.items()}


@pytest.mark.parametrize("field", sorted(SPECS))
def test_permute_plain_equals_reference(field, jax_permute):
    spec, jspec, modulus = SPECS[field]
    states = _states(modulus)
    batch = torch.as_tensor(np.stack([spec.encode(s) for s in states]))
    got = ds.permute_plain(spec, batch)
    assert got.shape == batch.shape and got.dtype == torch.int32
    params = PoseidonParams(modulus)
    for i, s in enumerate(states):
        want = np.asarray(jax_permute[field](jspec.encode(s))).astype(np.int32)
        assert np.array_equal(got[i].numpy(), want)
        host = PoseidonSponge(params)
        host.state = list(s)
        host.permute()
        assert spec.decode(got[i]) == host.state
    # the wrapper takes the plain version on a CPU tensor, and launches nothing
    build.reset_launches()
    assert torch.equal(ds.permute(spec, batch[1]), got[1])
    assert build.LAUNCHES["poseidon_permute"] == 0
    with pytest.raises(ValueError):
        ds.permute(spec, batch[1, :2])


def test_cross_field_conversions_equal_reference():
    frs = [0, 1, R - 1, 2, 1 << 252] + _values(R, 6, 7)
    got = ds.fr_to_fq_mont(torch.as_tensor(FR.encode(frs)))
    want = np.stack([np.asarray(jsp.fr_to_fq_mont(jf.FR.encode(v))) for v in frs])
    assert np.array_equal(got.numpy(), want.astype(np.int32))
    assert FQ.decode(got) == frs
    fqs = [0, 1, P - 1, R, R - 1, (1 << 252) - 1, 1 << 252, (1 << 376) + 12345] + _values(P, 6, 8)
    got = ds.fq_squeeze_to_fr_mont(torch.as_tensor(FQ.encode(fqs)))
    want = np.stack([np.asarray(jsp.fq_squeeze_to_fr_mont(jf.FQ.encode(v))) for v in fqs])
    assert np.array_equal(got.numpy(), want.astype(np.int32))
    assert FR.decode(got) == [v % (1 << 252) for v in fqs]


def _host_transcript(field, mode, index, seed):
    """A host transcript whose sponge holds a random state at (mode, index)."""
    tp = ttr.PoseidonTranscript(ttr.fr_params() if field == "fr" else ttr.fq_params())
    tp.sponge.state = _values(tp.params.modulus, 3, seed)
    tp.sponge.mode, tp.sponge.index = mode, index
    return tp


def _same(dsp, host):
    return dsp.spec.decode(dsp.state) == host.state and (dsp.mode, dsp.index) == (
        host.mode, host.index)


@pytest.mark.parametrize("field", sorted(SPECS))
@pytest.mark.parametrize("start", STARTS, ids=[f"{m}-{i}" for m, i in STARTS])
def test_device_sponge_follows_the_host(field, start):
    """absorb 1, squeeze 1, absorb 3, squeeze 2, then as a transcript:
    append_scalar of an Fr value, challenge_scalar(Fr)."""
    spec, _, modulus = SPECS[field]
    assert _same(ds.DeviceSponge.fresh(modulus, CPU), PoseidonSponge(PoseidonParams(modulus)))
    tp = _host_transcript(field, *start, seed=11 + start[1])
    host = tp.sponge
    dsp = ds.DeviceSponge.from_host(host, CPU)
    assert _same(dsp, host)
    vals = _values(modulus, 4, 12)
    dsp.absorb([torch.as_tensor(spec.encode(vals[0]))])
    host._absorb_elems(vals[:1])
    assert _same(dsp, host)
    assert spec.decode(torch.stack(dsp.squeeze(1))) == host.squeeze_native(1)
    assert _same(dsp, host)
    dsp.absorb([torch.as_tensor(spec.encode(v)) for v in vals[1:]])
    host._absorb_elems(vals[1:])
    assert _same(dsp, host)
    assert spec.decode(torch.stack(dsp.squeeze(2))) == host.squeeze_native(2)
    assert _same(dsp, host)
    dt = ds.DeviceTranscript(dsp)
    v = _values(R, 1, 13)[0]
    dt.append_fr_mont(torch.as_tensor(FR.encode(v)))
    tp.append_scalar(v, R)
    assert _same(dsp, host)
    assert FR.decode(dt.challenge_fr_mont()) == [tp.challenge_scalar(R)]
    assert _same(dsp, host)
    back = _host_transcript(field, 0, 0, seed=1)
    dt.export_to_host(back)
    assert (back.sponge.state, back.sponge.mode, back.sponge.index) == (
        host.state, host.mode, host.index)


@pytest.mark.parametrize("start", STARTS, ids=[f"{m}-{i}" for m, i in STARTS])
def test_simulate_schedule_follows_the_host(start):
    for ncoeffs in (3, 4):
        for rounds in (1, 2, 5):
            host = PoseidonSponge(PoseidonParams(R))
            host.mode, host.index = start
            for _ in range(rounds):
                for c in range(ncoeffs):
                    host.absorb_native(c)
                host.squeeze_native(1)
            assert sc._simulate_schedule(*start, rounds, ncoeffs) == (host.mode, host.index)


def _table(name, header="poseidon.cuh"):
    text = (build.CSRC / header).read_text()
    body = re.search(rf"{name}\[[^\]]*\](?:\[\d+\])? = \{{(.*?)\}};", text, re.S).group(1)
    rows = re.findall(r"\{([^{}]*)\}", body) or [body]
    return [sum(int(w.strip().rstrip("u"), 16) << (32 * i) for i, w in enumerate(row.split(",")))
            for row in rows]


def test_poseidon_tables_match_the_constants():
    text = (build.CSRC / "poseidon.cuh").read_text()
    defines = dict(re.findall(r"#define (POS_\w+) (\d+)", text))
    assert (int(defines["POS_T"]), int(defines["POS_RATE"]), int(defines["POS_CAPACITY"]),
            int(defines["POS_FULL"]), int(defines["POS_PARTIAL"])) == (
        C.RATE + C.CAPACITY, C.RATE, C.CAPACITY, C.FULL_ROUNDS, C.PARTIAL_ROUNDS)
    assert "x^17" in text and C.ALPHA == 17
    for tag, spec in (("FR", FR), ("FQ", FQ)):
        m = spec.modulus
        assert _table(f"POS_ARK_{tag}") == [spec.to_mont_int(c % m) for row in C.ARK for c in row]
        assert _table(f"POS_MDS_{tag}") == [spec.to_mont_int(c % m) for row in C.MDS for c in row]
    assert _table("FR_R2") == [FR.r2_mod_p] and _table("FQ_R2") == [FQ.r2_mod_p]
    assert _table("FR_TWO_INV") == [FR.to_mont_int(pow(2, -1, R))]
    assert _table("FR_SIX_INV") == [FR.to_mont_int(pow(6, -1, R))]
    sc_text = (build.CSRC / "sumcheck.cuh").read_text()
    sc_defs = dict(re.findall(r"#define (SC_\w+) (\d+)", sc_text))
    assert {k: int(sc_defs["SC_" + k.upper()]) for k in sk.KINDS} == sk.KINDS


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler found")
    out = tmp_path_factory.mktemp("host_sponge") / "libhost_check.so"
    subprocess.run(
        [cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-x", "c++",
         "-I", str(build.CSRC), "-o", str(out), str(build.CSRC / "host_check.cpp")],
        check=True, capture_output=True, text=True, timeout=300,
    )
    lib = ctypes.CDLL(str(out))
    lib.host_poseidon_permute.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_long]
    lib.host_sumcheck_tail.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
    return lib


def _ptr(t):
    assert t.dtype == torch.int32 and t.is_contiguous()
    return t.data_ptr()


@pytest.mark.parametrize("field", sorted(SPECS))
def test_permutation_body_equals_plain(host_lib, field):
    spec, _, modulus = SPECS[field]
    batch = torch.as_tensor(np.stack([spec.encode(s) for s in _states(modulus)]))
    out = torch.full_like(batch, -1)
    fid = packed_field.field_id(spec)  # the kernels' id of the field, by modulus
    assert host_lib.host_poseidon_permute(_ptr(batch), _ptr(out), fid, len(batch)) == 0
    assert torch.equal(out, ds.permute_plain(spec, batch))
    assert host_lib.host_poseidon_permute(_ptr(batch), _ptr(out), 20, 1) == -1


@pytest.mark.parametrize("field", sorted(SPECS))
@pytest.mark.parametrize("kind", ["quad", "cubic_tau"])
def test_tail_body_equals_plain(host_lib, field, kind):
    """The tail's body from every (mode, index) start, three instances over
    five blocks, against the plain version (and the plain version's sums
    against the combination in host ints)."""
    spec, _, modulus = SPECS[field]
    npts = sk.POINTS[kind]
    k, nb = 3, 5
    enc = lambda vals: torch.as_tensor(FR.encode(vals))
    part_vals = [0, 1, R - 1] + _values(R, k * nb * npts - 3, 21)
    partials = enc(part_vals).reshape(k, nb, npts, FR.nlimbs).contiguous()
    coeff_vals = _values(R, k, 22)
    coeffs = enc(coeff_vals)
    e = enc(_values(R, 1, 23))[0].contiguous()
    state = torch.as_tensor(spec.encode(_values(modulus, 3, 24)))
    for mode, index in STARTS:
        want = sk.sumcheck_tail_plain(kind, partials, coeffs, e, state, spec, mode, index)
        got = [torch.full_like(w, -1) for w in want]
        rc = host_lib.host_sumcheck_tail(_ptr(partials), _ptr(coeffs), _ptr(e), _ptr(state),
                                         *map(_ptr, got), npts, k, nb,
                                         packed_field.field_id(spec), mode, index)
        assert rc == 0
        for g, w in zip(got, want):
            assert torch.equal(g, w), (mode, index)
    # the combined evaluations the coefficients came from, in host ints
    ev = [sum(cf * sum(part_vals[(i * nb + b) * npts + pt] for b in range(nb))
              for i, cf in enumerate(coeff_vals)) % R for pt in range(npts)]
    coeffs_host = sc.UniPoly.from_evals([ev[0], (FR.decode(e.reshape(1, -1))[0] - ev[0]) % R]
                                        + ev[1:]).coeffs
    assert FR.decode(want[0]) == coeffs_host
    assert host_lib.host_sumcheck_tail(_ptr(partials), _ptr(coeffs), _ptr(e), _ptr(state),
                                       *map(_ptr, got), npts, k, nb, 20, 0, 0) == -1
