"""The row-major Montgomery product by itself, at every shape the paths give
it: the kernel's own device time, the rate of raw launches and the time of
a call through `field.mont_mul`, beside the bound.

`field.mont_mul` runs csrc/mont_mul_rm.cu on every Fr table op of the
protocol: the sumcheck rounds, the R1CS products, eq tables, `_get_q`, and
the Fq products of `g*_add`.  A NIZK prove at 2^16 launches it about 500
times, on tables that halve from 2^15 down to one element, so what a call
costs is three things that this tool separates, for each shape:

  - `kernel_ms`: the kernel's own device time, the mean duration of its
    launches as torch.profiler reads them (CUPTI), over raw launches on
    preallocated tensors, each after a read of FLUSH_BYTES that leaves none
    of the operands in the L2 cache (50 MB on the H100): what the bytes
    bound over HBM's rate is held against;
  - `kernel_l2_ms`: the same over back-to-back raw launches, where operands
    of up to about 50 MB stay in L2 from one launch to the next (as the
    sumcheck's tables of 2^16 elements and below may do in a prove); no
    share of the HBM bound is taken of it;
  - `raw_ms`: CUDA events around back-to-back raw launches
    (`build.launch`, no wrapper): the device time where the device is the
    slower side, the host's launch rate where it is not;
  - `call_ms`: CUDA events around back-to-back calls of `field.mont_mul`, as
    the paths call it (broadcast checks, output allocation, the launch).

`bound_ms` is the bytes bound (each input read once, the output written
once, over 3.35 TB/s), which is the larger one for this kernel at every
shape; `floor_ms` is the least a launch of the kernel can take at any n:
the device time of the cheapest launch (a one-element fill) plus one
dependent Fr product at one warp (tools/exp_montmul.py's latency mode).

With `--forms` it also times each form of the kernel (`kernel_ms`, L2
flushed) at every shape, whatever n the launcher would give it, from a
build of its own (`_build/exp_mont_rm-<hash>/`): the tiled form, the narrow
form at one warp a block (the launcher's), and the narrow body in kernels
of this tool's own at 64 and at 128 threads a block (the grid of the
kernel before the tiled form); this is how the launcher's choice between
the forms was made.

With `--prove` it also proves TestudoNIZK at 2^16 x 2^16 x 10 (BASELINE
config #3, as chip_smoke.py builds it), once warm and once under
torch.profiler, and prints the product's summed device time in that prove,
its launches, and both by size class (the device events in launch order
beside the sizes the launches were given); with `--forms` too, it profiles
one prove more on each form, every product of the prove sent to that form
(the proof's bytes held to the library's), twice in turns: how much each
side of the launcher's choice gains on the path.

Run on a machine with the GPU, from the root of a checkout:

    python3 -m testudo_tpu_torch.tools.exp_mont_rm [--forms] [--prove]

It imports the package by absolute name only, so the same file measures
another checkout's kernel: `cd other && PYTHONPATH=. python3
/path/to/testudo_tpu_torch/tools/exp_mont_rm.py` (how a parent and a change
are compared in one call).  Prints one JSON line last.
"""
from __future__ import annotations

import argparse
import collections
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

from testudo_tpu_torch.device import build
from testudo_tpu_torch.device import field as tf
from testudo_tpu_torch.device.field import FQ, FR, FieldSpec
from testudo_tpu_torch.tools import exp_montmul

HBM_BYTES_PER_S = 3.35e12
FLUSH_BYTES = 256 << 20  # read before a cold launch: over 5x the H100's L2
KERNEL = "mont_mul_rm"  # what the kernel's device events are named after
# (label, field, n, one shared second operand): the wide shapes, then the
# NIZK's sumcheck tables at 2^16 constraints, 2^15 down to one element
SHAPES = (
    ("(2^20, 16) Fr, shared b", FR, 1 << 20, True),
    ("(393216, 24) Fq", FQ, 6 << 16, False),
    ("(2^16, 16) Fr", FR, 1 << 16, False),
    *((f"(2^{k}, 16) Fr", FR, 1 << k, False) for k in (15, 12, 9, 6, 0)),
)
REPS = 50


def operands(spec: FieldSpec, n: int, shared: bool, seed: int, device):
    """(a, b): canonical (n, nlimbs) rows from numpy, edge values in the
    first rows; b is one element when shared."""
    p = spec.modulus
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1 << 16, size=(2, n, spec.nlimbs), dtype=np.int64)
    top_bits = p.bit_length() - 16 * (spec.nlimbs - 1)
    v[..., -1] &= (1 << (top_bits - 1)) - 1  # below p
    edges = np.asarray(spec.to_limbs([0, 1, p - 1, spec.r_mod_p]))[: n]
    v[0, : len(edges)] = edges
    v[1, : len(edges)] = edges[::-1]
    a, b = (torch.as_tensor(x.astype(np.int32), device=device) for x in v)
    return a, (b[n // 2].clone() if shared else b)


def events_ms(fn, reps: int = REPS) -> float:
    """Mean milliseconds of `reps` back-to-back calls between two CUDA
    events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _device_events(prof, match: str):
    """The profiler's CUDA kernel events whose name holds `match`, in the
    order the device ran them."""
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name]
    return sorted(evs, key=lambda e: e.time_range.start)


def l2_flusher(device):
    """A function that reads FLUSH_BYTES on the device (one reduction,
    whose kernel is not named after the row-major product): run before a
    launch, it leaves none of the launch's operands in L2."""
    buf = torch.ones(FLUSH_BYTES // 4, dtype=torch.int32, device=device)
    return lambda: buf.sum()


def profiled_ms(fn, match: str, reps: int = REPS, tries: int = 3, flush=None):
    """Mean device milliseconds of the kernels named `match` over `reps`
    calls of fn under torch.profiler, each call after `flush()` if given;
    None when the profiler sees none of them in `tries` windows (it has
    returned a window without device events now and then)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        evs = _device_events(prof, match)
        if evs:
            return sum(e.time_range.elapsed_us() for e in evs) / len(evs) / 1e3
    return None


def floor_ms(device) -> dict:
    """One launch plus one dependent product: the device time of a
    one-element fill, and one Fr product's latency at one warp."""
    one = torch.zeros(1, dtype=torch.int32, device=device)
    launch = profiled_ms(lambda: one.fill_(1), "")
    product = exp_montmul.measure_latency(FR, device)["inline"]["us_per_product"] / 1e3
    return {"launch_ms": launch, "product_ms": product,
            "floor_ms": None if launch is None else launch + product}


def measure_shape(label: str, spec: FieldSpec, n: int, shared: bool, device, flush=None) -> dict:
    """kernel_ms (cold L2), kernel_l2_ms, raw_ms and call_ms at one shape,
    after checking the kernel's limbs against the plain version there."""
    a, b = operands(spec, n, shared, seed=n % 1000 + 3, device=device)
    out = torch.empty_like(a)
    nl = spec.nlimbs
    counted = "mont_mul_rm_" + spec.name
    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), nl, n, int(shared))
    raw = lambda: build.launch("mont_mul_rm", *args, counted_as=counted)
    raw()
    if not torch.equal(out, tf.mont_mul_plain(spec, a, b)):
        raise AssertionError(f"mont_mul_rm at {label}: the raw launch differs from the plain version")
    if not torch.equal(tf.mont_mul(spec, a, b), out):
        raise AssertionError(f"mont_mul_rm at {label}: field.mont_mul differs from the raw launch")
    nbytes = (2 * n + (1 if shared else n)) * nl * 4
    return {
        "shape": label, "n": n, "field": spec.name, "shared_b": shared,
        "kernel_ms": profiled_ms(raw, KERNEL, flush=flush or l2_flusher(device)),
        "kernel_l2_ms": profiled_ms(raw, KERNEL),
        "raw_ms": events_ms(raw),
        "call_ms": events_ms(lambda: tf.mont_mul(spec, a, b)),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }


# ragged lengths for `check_ragged`: around a tile, the narrow form's limit,
# and the wide shapes plus an odd tail
RAGGED = (1, 3, 127, 129, 8191, 8192, 8193, 9000, (1 << 16) + 37, (1 << 20) + 37)


def check_ragged(device) -> int:
    """field.mont_mul against the plain version at RAGGED lengths, both
    fields, full and shared b; returns the number of cases."""
    cases = 0
    for spec in (FR, FQ):
        for n in RAGGED:
            for shared in (False, True):
                a, b = operands(spec, n, shared, seed=n % 977, device=device)
                if not torch.equal(tf.mont_mul(spec, a, b), tf.mont_mul_plain(spec, a, b)):
                    raise AssertionError(f"mont_mul_rm differs from the plain version at "
                                         f"({n}, {spec.nlimbs}), shared b {shared}")
                cases += 1
    return cases


def host_costs(device, calls: int = 2000) -> dict:
    """Host microseconds a call (perf_counter over `calls` calls) of what a
    product's call is made of: the current stream's handle, the C launcher
    with n = 0 (ctypes only: it returns before launching), `build.launch`
    at n = 1, an output allocation, and the whole `field.mont_mul` at n = 1.
    The device's queue is drained every 500 calls."""
    a, b = operands(FR, 1, False, seed=1, device=device)
    out = torch.empty_like(a)
    fn = getattr(build.library(), build._SIGNATURES["mont_mul_rm"][0])
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (a.data_ptr(), b.data_ptr(), out.data_ptr(), FR.nlimbs)
    parts = {
        "current_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "ctypes_no_launch": lambda: fn(*ptrs, 0, 0, stream),
        "build_launch": lambda: build.launch("mont_mul_rm", *ptrs, 1, 0, counted_as="mont_mul_rm_fr"),
        "empty_like": lambda: torch.empty_like(a),
        "field_mont_mul": lambda: tf.mont_mul(FR, a, b),
    }
    res = {}
    for name, f in parts.items():
        f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(calls):
            f()
            if i % 500 == 499:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        res[name] = (time.perf_counter() - t0) / calls * 1e6
    return res


def ptxas() -> list:
    """The compiler's resource lines of the row-major kernel(s)."""
    return [ln for ln in build.build_report()["ptxas"] if KERNEL in ln]


def run_shapes(device, say=print) -> dict:
    say(f"mont_mul_rm equals the plain version at {check_ragged(device)} ragged shapes")
    flush = l2_flusher(device)
    rows = [measure_shape(*s, device, flush=flush) for s in SHAPES]
    fl = floor_ms(device)
    for r in rows:
        k = r["kernel_ms"]
        r["floor_ms"] = fl["floor_ms"]
        share = "" if k is None else f", {r['bound_ms'] / k:.0%} of the bound"
        say(f"mont_mul_rm {r['shape']:26s}: kernel {k if k is None else round(k, 5)} ms, "
            f"L2-warm {r['kernel_l2_ms'] if r['kernel_l2_ms'] is None else round(r['kernel_l2_ms'], 5)} ms, "
            f"raw {r['raw_ms']:.5f} ms, call {r['call_ms']:.5f} ms, bound {r['bound_ms']:.5f} ms"
            f"{share}")
    say(f"floor (one launch {fl['launch_ms']} ms + one dependent Fr product "
        f"{fl['product_ms']:.5f} ms): {fl['floor_ms']} ms")
    host = host_costs(device)
    say("host us a call: " + ", ".join(f"{k} {v:.2f}" for k, v in host.items()))
    for ln in ptxas():
        say(f"ptxas {ln}")
    return {"shapes": rows, "floor": fl, "host_us": host, "ptxas": ptxas()}


# the forms `--forms` times: C launcher of each, in exp_rm's numbering
FORMS = {"in use": 0, "tiled": 1, "narrow, 32 a block": 2, "narrow, 64 a block": 4,
         "narrow, 128 a block": 3}
# shapes the forms are also timed at: the prove's largest shared-b tables
# and its Fq tables
FORM_SHAPES = SHAPES + (
    ("(2^17, 16) Fr, shared b", FR, 1 << 17, True),
    ("(2^16, 16) Fr, shared b", FR, 1 << 16, True),
    ("(2^15, 16) Fr, shared b", FR, 1 << 15, True),
    ("(2^13, 16) Fr, shared b", FR, 1 << 13, True),
    ("(2^14, 24) Fq", FQ, 1 << 14, False),
    ("(2^13, 24) Fq", FQ, 1 << 13, False),
    ("(2^12, 24) Fq", FQ, 1 << 12, False),
)
_FORMS_CODE = r"""
#include "mont_mul_rm.cu"

// the narrow body at other block sizes than the library's RM_NARROW_TPB
template <class F, bool S, int TPB>
__global__ void __launch_bounds__(TPB)
k_mont_mul_rm_exp_narrow(const int* a, const int* b, int* out, long n) {
  rm_lane<F, S>(a, b, out, n, LANE_INDEX(TPB));
}

template <class F, bool S, int TPB>
static int exp_narrow(const int* a, const int* b, int* out, long n, cudaStream_t st) {
  k_mont_mul_rm_exp_narrow<F, S, TPB><<<GRID_FOR(n, TPB), TPB, 0, st>>>(a, b, out, n);
  return LAUNCH_STATUS();
}

#define EXP_RM(F, S)                                                          \
  switch (form) {                                                             \
    case 0: return launch_rm<F, S>(a, b, out, n, st);                         \
    case 1: return launch_rm_tiled<F, S>(a, b, out, n, st);                   \
    case 2: return launch_rm_narrow<F, S>(a, b, out, n, st);                  \
    case 3: return exp_narrow<F, S, 128>(a, b, out, n, st);                   \
    case 4: return exp_narrow<F, S, 64>(a, b, out, n, st);                    \
    default: return -1;                                                       \
  }

extern "C" int exp_rm(int form, const int* a, const int* b, int* out, int nlimbs, long n,
                      int shared_b, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nlimbs == 24) {
    if (shared_b) EXP_RM(FqParams, true) else EXP_RM(FqParams, false)
  }
  if (shared_b) EXP_RM(FrParams, true) else EXP_RM(FrParams, false)
}
"""


@functools.cache
def forms_library():
    """The --forms build: `exp_rm(form, a, b, out, nlimbs, n, shared_b,
    stream)` launches form `form` (a FORMS value) of the kernel."""
    import ctypes

    lib = ctypes.CDLL(str(build.build_tool("exp_mont_rm", _FORMS_CODE)))
    lib.exp_rm.argtypes = [ctypes.c_int, *[ctypes.c_void_p] * 3, ctypes.c_int, ctypes.c_long,
                           ctypes.c_int, ctypes.c_void_p]
    return lib


def run_forms(device, rounds: int = 3, say=print) -> dict:
    """kernel_ms (L2 flushed before each launch) of every form at every
    shape (each checked against the plain version), `rounds` times in
    turns."""
    flush = l2_flusher(device)
    lib = forms_library()
    rows = []
    for label, spec, n, shared in FORM_SHAPES:
        a, b = operands(spec, n, shared, seed=n % 1000 + 5, device=device)
        want = tf.mont_mul_plain(spec, a, b)
        row = {"shape": label, **{name: [] for name in FORMS}}
        for _ in range(rounds):
            for name, form in FORMS.items():
                out = torch.empty_like(a)
                call = lambda: lib.exp_rm(form, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                          spec.nlimbs, n, int(shared),
                                          torch.cuda.current_stream().cuda_stream)
                if call() != 0 or not torch.equal(out, want):
                    raise AssertionError(f"mont_mul_rm form {name!r} at {label} failed or differs")
                row[name].append(profiled_ms(call, KERNEL, flush=flush))
        rows.append(row)
        say(f"forms {label:26s}: " + "; ".join(
            f"{k} " + ", ".join(f"{v:.5f}" for v in row[k]) for k in FORMS) + " ms")
    return {"forms": rows}


def size_class(n: int) -> str:
    """The power of two at or above n: launches are grouped by it."""
    return f"2^{max(n - 1, 0).bit_length()}"


def prove_profile(prove, form: int | None = None) -> dict:
    """One call of `prove` under torch.profiler with every row-major launch
    recorded: all CUDA kernels (count, device ms, the six largest by name),
    the row-major kernels' device ms and launches, and both by (field, size
    class, shared b).  With `form` (a FORMS value) every row-major launch
    runs that form of the --forms build instead of the library's choice."""
    from torch.profiler import ProfilerActivity, profile

    sizes, orig = [], build.launch
    lib = None if form is None else forms_library()

    def recording(name, *args, counted_as=None):
        if name == "mont_mul_rm":  # (a, b, out, nlimbs, n, shared_b)
            sizes.append(("fq" if args[3] == 24 else "fr", size_class(args[4]), bool(args[5])))
            if lib is not None:
                rc = lib.exp_rm(form, *args, torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"mont_mul_rm form {form} failed with CUDA error {rc}")
                return None
        return orig(name, *args, counted_as=counted_as)

    build.launch = recording
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prove()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        build.launch = orig
    every = _device_events(prof, "")
    rm = _device_events(prof, KERNEL)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in every:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    by_class = collections.defaultdict(lambda: [0, 0.0])
    paired = len(rm) == len(sizes)
    for i, key in enumerate(sizes):
        cell = by_class[" ".join((key[0], key[1], "shared" if key[2] else "full"))]
        cell[0] += 1
        if paired:
            cell[1] += rm[i].time_range.elapsed_us() / 1e3
    return {
        "wall_ms_profiled": wall_ms, "kernels": len(every),
        "device_ms": sum(e.time_range.elapsed_us() for e in every) / 1e3,
        "mont_mul_rm_ms": sum(e.time_range.elapsed_us() for e in rm) / 1e3,
        "mont_mul_rm_launches": len(rm), "host_launches": len(sizes),
        "by_class": {k: {"launches": c, "device_ms": ms if paired else None}
                     for k, (c, ms) in sorted(by_class.items())},
        "largest": sorted(([name, ms, cnt] for name, (ms, cnt) in by_name.items()),
                          key=lambda row: -row[1])[:6],
    }


def nizk_prover(log2n: int, device):
    """prove() of TestudoNIZK on produce_synthetic_r1cs(2^log2n, 2^log2n, 10),
    as chip_smoke.py and benches/testudo.py build BASELINE config #3."""
    from testudo_tpu_torch.core import r1cs, snark
    from testudo_tpu_torch.curves import profile as cprof
    from testudo_tpu_torch.poseidon.transcript import PoseidonTranscript, fr_params

    n = 1 << log2n
    inst, vars_, inputs = r1cs.Instance.produce_synthetic_r1cs(n, n, 10)
    gens = snark.TestudoNizkGens.setup(n, n, 10, profile=cprof.bls12_377(device))
    return lambda: snark.nizk_prove(inst, vars_, inputs, gens, PoseidonTranscript(fr_params()))


def run_prove(device, forms: bool = False, say=print) -> dict:
    """Three warm proves at 2^16 timed, one profiled; with `forms`, one
    profiled prove more for each form of FORMS, in turns, whose row-major
    products are held to the library's by the proof's bytes."""
    prove = nizk_prover(16, device)
    prove()  # cold: builds and loads, fills caches
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prove()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    say(f"three warm NIZK proves at 2^16: {', '.join(f'{w:.4f}' for w in walls)} s")
    p = prove_profile(prove)
    p["warm_s"] = walls
    say(f"one warm NIZK prove at 2^16 under torch.profiler: {p['kernels']} CUDA kernels, "
        f"{p['device_ms']:.3f} ms of device time in {p['wall_ms_profiled']:.1f} ms; "
        f"mont_mul_rm {p['mont_mul_rm_ms']:.4f} ms over {p['mont_mul_rm_launches']} launches")
    for k, c in p["by_class"].items():
        ms = c["device_ms"]
        say(f"  {k:22s} {c['launches']:4d} launches, "
            f"{'not paired' if ms is None else f'{ms:.4f} ms'}")
    if forms:
        from testudo_tpu_torch import proofs

        want = proofs.ser_r1cs_proof(prove().r1cs_sat_proof)
        p["forms"] = {}
        for _ in range(2):
            for name, form in FORMS.items():
                got = {}
                q = prove_profile(lambda: got.setdefault("proof", prove()), form)
                if proofs.ser_r1cs_proof(got["proof"].r1cs_sat_proof) != want:
                    raise AssertionError(f"a prove on mont_mul_rm form {name!r} gave other bytes")
                p["forms"].setdefault(name, []).append(
                    {"mont_mul_rm_ms": q["mont_mul_rm_ms"],
                     "mont_mul_rm_launches": q["mont_mul_rm_launches"],
                     "by_class": {k: c["device_ms"] for k, c in q["by_class"].items()}})
                say(f"one warm prove, every product on form {name!r}: mont_mul_rm "
                    f"{q['mont_mul_rm_ms']:.4f} ms over {q['mont_mul_rm_launches']} device events "
                    f"of {q['host_launches']} launches; " + ", ".join(
                        f"{k} {c['device_ms']:.4f}" for k, c in q["by_class"].items()
                        if c["device_ms"] is not None and int(k.split("^")[1].split()[0]) > 13))
    return p


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--forms", action="store_true",
                    help="also time every form of the kernel at every shape")
    ap.add_argument("--prove", action="store_true",
                    help="also profile one warm TestudoNIZK prove at 2^16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_mont_rm: no CUDA device; this tool times the kernel on the GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip(),
          flush=True)
    res = run_shapes(dev, say=lambda *a: print(*a, flush=True))
    if args.forms:
        res.update(run_forms(dev, say=lambda *a: print(*a, flush=True)))
    if args.prove:
        res["prove"] = run_prove(dev, forms=args.forms, say=lambda *a: print(*a, flush=True))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
