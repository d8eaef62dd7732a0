"""The port's NTT (testudo_tpu_torch/core/ntt.py) against the JAX package's
(testudo_tpu/core/ntt.py) on the CPU: forward, inverse and both coset
scales, limb for limb, for m = 2^1 .. 2^10 in Fr and a few sizes in Fq, on
tables of random elements drawn from a seeded numpy generator; against a
Python-int DFT at small m; inverse(forward) is the identity.
Exact: limbs and field elements."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from testudo_tpu.core import ntt as jntt
from testudo_tpu.tpu.field import FQ as JFQ, FR as JFR
from testudo_tpu_torch.core import ntt
from testudo_tpu_torch.device.field import FQ, FR

torch.set_num_threads(1)

G = 5  # the coset generator Groth16 uses


def _values(spec, m: int, seed: int):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(48), "little") % spec.modulus for _ in range(m)]


def _both(spec, jspec, log_m: int, seed: int):
    vals = _values(spec, 1 << log_m, seed)
    return vals, torch.as_tensor(spec.encode(vals)), jnp.asarray(jspec.encode(vals))


def _equal(port: torch.Tensor, ref) -> bool:
    return np.array_equal(port.numpy().astype(np.int64), np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("log_m", range(1, 11))
def test_fr_ntt_equals_the_reference(log_m):
    _, x, jx = _both(FR, JFR, log_m, 100 + log_m)
    assert _equal(ntt.ntt(x), jntt.ntt(jx))
    assert _equal(ntt.ntt(x, inverse=True), jntt.ntt(jx, inverse=True))
    assert _equal(ntt.coset_scale(x, G), jntt.coset_scale(jx, G))
    assert _equal(ntt.coset_scale(x, G, inverse=True), jntt.coset_scale(jx, G, inverse=True))


@pytest.mark.parametrize("log_m", [1, 3, 6])
def test_fq_ntt_equals_the_reference(log_m):
    p = FQ.modulus
    _, x, jx = _both(FQ, JFQ, log_m, 200 + log_m)
    assert _equal(ntt.ntt(x, modulus=p), jntt.ntt(jx, modulus=p))
    assert _equal(ntt.ntt(x, inverse=True, modulus=p), jntt.ntt(jx, inverse=True, modulus=p))
    assert _equal(ntt.coset_scale(x, G, modulus=p), jntt.coset_scale(jx, G, modulus=p))


@pytest.mark.parametrize("spec", [FR, FQ], ids=["fr", "fq"])
@pytest.mark.parametrize("log_m", [0, 1, 2, 3, 4])
def test_ntt_equals_a_python_dft(spec, log_m):
    """out[k] = sum_j x[j] w^(j k), w the 2^log_m-th root of unity; the
    inverse with w^-1 and 1/m; coset_scale multiplies x[i] by g^i."""
    p, m = spec.modulus, 1 << log_m
    vals = _values(spec, m, 300 + log_m)
    x = torch.as_tensor(spec.encode(vals))
    w = ntt.root_of_unity(log_m, p)
    assert pow(w, m, p) == 1 and (m == 1 or pow(w, m // 2, p) != 1)
    for inverse, root, scale in ((False, w, 1), (True, pow(w, -1, p), pow(m, -1, p))):
        want = [sum(v * pow(root, j * k, p) for j, v in enumerate(vals)) * scale % p
                for k in range(m)]
        assert spec.decode(ntt.ntt(x, inverse=inverse, modulus=p)) == want
    assert spec.decode(ntt.coset_scale(x, G, modulus=p)) == [
        v * pow(G, i, p) % p for i, v in enumerate(vals)]


@pytest.mark.parametrize("log_m", [5, 11])
def test_inverse_of_forward_is_the_identity(log_m):
    vals = _values(FR, 1 << log_m, 400 + log_m)
    x = torch.as_tensor(FR.encode(vals))
    assert torch.equal(ntt.ntt(ntt.ntt(x), inverse=True), x)
    assert torch.equal(ntt.coset_scale(ntt.coset_scale(x, G), G, inverse=True), x)


def test_bad_shapes_raise():
    with pytest.raises(ValueError):
        ntt.ntt(torch.zeros((3, 16), dtype=torch.int32))
    with pytest.raises(ValueError):
        ntt.ntt(torch.zeros((4, 24), dtype=torch.int32))  # Fq limbs, Fr modulus
    with pytest.raises(ValueError):
        ntt.root_of_unity(48)  # beyond Fr's 2-adicity of 47
