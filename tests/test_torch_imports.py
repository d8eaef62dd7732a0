"""The port stands on torch, numpy and the standard library alone: importing
every module of `testudo_tpu_torch` and `chip_smoke` pulls in neither JAX nor
the JAX package, and the entry points refuse to run without a GPU unless the
caller asks for the CPU."""
import os
import subprocess
import sys

import pytest
import torch

# The suite runs in several worker processes and these limb tensors are tiny:
# more than one intra-op thread per worker only makes the workers fight for cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import testudo_tpu_torch
names = ["testudo_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(testudo_tpu_torch.__path__, "testudo_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "jaxlib"
    or m == "testudo_tpu" or m.startswith("testudo_tpu.")
)
print("MODULES", len(names))
print("BAD", bad)
from testudo_tpu_torch import native
native.available()
libs = [l.split()[-1] for l in open("/proc/self/maps") if "libtestudo_native" in l]
print("NATIVE", sorted(set(libs)))
print("NATIVE_PATH", native.library_path())
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    lines = dict(l.split(" ", 1) for l in out.stdout.strip().splitlines())
    assert int(lines["MODULES"]) >= 38
    assert lines["BAD"] == "[]"
    # the native host library, where one was loaded, is the port's own build
    build_dir = os.path.join(REPO, "testudo_tpu_torch", "_build") + os.sep
    assert lines["NATIVE_PATH"].startswith(build_dir)
    for lib in eval(lines["NATIVE"]):
        assert lib.startswith(build_dir), lib


def test_new_modules_are_all_there():
    import importlib

    for name in ("core.pst", "core.mipp", "core.sqrt_pst", "poly.dense", "curves.profile",
                 "curves.pairing", "poseidon.sponge", "poseidon.transcript",
                 "poseidon.constants_377", "serialize", "proofs", "native", "utils.ark_rng",
                 "utils.timer", "tools.exp_montmul", "poly.unipoly", "core.sumcheck",
                 "core.r1cs", "core.r1csproof", "core.snark"):
        importlib.import_module("testudo_tpu_torch." + name)


def test_protocol_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    import inspect

    from testudo_tpu_torch import convert
    from testudo_tpu_torch.core import pst
    from testudo_tpu_torch.curves import profile as cprof
    from testudo_tpu_torch.tools import exp_montmul

    assert inspect.signature(cprof.bls12_377).parameters["device"].default == torch.device("cuda")
    assert inspect.signature(convert.fr_table_from_reference).parameters["device"].default == \
        torch.device("cuda")
    assert inspect.signature(exp_montmul.run).parameters["device"].default == torch.device("cuda")
    assert cprof.bls12_377().device == torch.device("cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        pst.setup(1)  # the default profile lives on the card
    with pytest.raises(RuntimeError):
        exp_montmul.run("cpu")  # the harness times kernels: no CPU path
    assert exp_montmul.main([]) == 1


def test_nizk_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    import inspect

    from testudo_tpu_torch.core import r1cs, snark

    cuda = torch.device("cuda")
    assert inspect.signature(snark.TestudoNizkGens.setup).parameters["profile"].default is None
    for fn in (r1cs.R1CSInstance.evaluate, r1cs.SparseMatPolynomial.evaluate):
        assert inspect.signature(fn).parameters["device"].default == cuda, fn
    with pytest.raises((RuntimeError, AssertionError)):
        snark.TestudoNizkGens.setup(4, 4, 1)  # the default profile lives on the card
    inst, _, _ = r1cs.R1CSInstance.produce_synthetic_r1cs(4, 4, 1)
    with pytest.raises((RuntimeError, AssertionError)):
        inst.evaluate([0, 1], [0, 1, 1])


def test_no_port_source_mentions_the_jax_imports():
    pkg = os.path.join(REPO, "testudo_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(pkg):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        for line in open(path).read().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax")), path
            assert not stripped.startswith(("import testudo_tpu ", "from testudo_tpu ", "from testudo_tpu.")), path


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    from testudo_tpu_torch.curves import host_curve as hc
    from testudo_tpu_torch.device import curve as tc
    from testudo_tpu_torch.device import msm

    G = hc.g1_generator()
    with pytest.raises((RuntimeError, AssertionError)):
        tc.g1_from_affine_host([G])
    with pytest.raises((RuntimeError, AssertionError)):
        tc.g1_identity((2,))
    pts = tc.g1_from_affine_host([G, G], device="cpu")
    with pytest.raises((RuntimeError, AssertionError)):
        msm.msm_g1(pts, [1, 2])
    assert msm.msm_g1(pts, [1, 2], device="cpu") == hc.g1_mul(G, 3)


def test_g2_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    import inspect

    from testudo_tpu_torch import convert
    from testudo_tpu_torch.curves import host_curve as hc
    from testudo_tpu_torch.device import curve as tc
    from testudo_tpu_torch.device import msm
    from testudo_tpu_torch.device.field import FR
    from testudo_tpu_torch.device.packed_curve import G2P

    for fn in (tc.g2_from_affine_host, tc.g2_identity, tc.fixed_base_mul_g1, tc.fixed_base_mul_g2,
               msm.msm_g2, msm.msm_segmented, msm.msm_multi_small, G2P.identity_packed,
               convert.points_from_reference, convert.packed_from_reference):
        assert inspect.signature(fn).parameters["device"].default == torch.device("cuda"), fn
    G = hc.g2_generator()
    with pytest.raises((RuntimeError, AssertionError)):
        tc.g2_from_affine_host([G])
    pts = tc.g2_from_affine_host([G, G], device="cpu")
    with pytest.raises((RuntimeError, AssertionError)):
        msm.msm_g2(pts, [1, 2])
    with pytest.raises((RuntimeError, AssertionError)):
        msm.msm_multi_small("g2", [(pts, [1, 2])])
    one = torch.from_numpy(FR.to_limbs([1]))
    with pytest.raises((RuntimeError, AssertionError)):
        tc.fixed_base_mul_g2(one, G)
    assert tc.g2_to_affine_host(tc.fixed_base_mul_g2(one, G, device="cpu")) == [G]


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
