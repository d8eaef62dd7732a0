"""Builds and loads the hand-written CUDA kernels (csrc/*.cu).

No counterpart in the JAX package: Pallas kernels are compiled by JAX.  Here
`nvcc` compiles each source for sm_90a (all sources at once, one process
each), the objects are linked into one shared library with a plain C
interface, and `ctypes` loads it.  The build runs at the first launch of any
kernel, never at import, into `testudo_tpu_torch/_build/<hash of the
sources>/`, which `.gitignore` lists.  A failed build raises; nothing falls
back.

`launch(name, *args)` is the one place a kernel is started: it calls the C
launcher on PyTorch's current stream, raises on a non-zero CUDA error code
and adds one to `LAUNCHES[name]`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("mont_mul.cu", "mont_mul_rm.cu", "mont_chain.cu", "ec_ops.cu", "ladder.cu",
           "ladder_team.cu", "ladder_wide.cu", "bucket.cu", "wsum_team.cu", "chain_team.cu",
           "fold_team.cu", "fixed_base_team.cu", "fixed_base_window.cu", "poseidon.cu",
           "sumcheck_round.cu", "sumcheck_tail.cu", "fp_group.cu")
HEADERS = ("fp.cuh", "fp2.cuh", "lazy.cuh", "ec.cuh", "ec_team.cuh", "launch.cuh", "mont_rm.cuh",
           "poseidon.cuh", "sumcheck.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
# C launcher of each kernel: (symbol, argtypes).  Pointers and the stream are
# c_void_p: without argtypes ctypes would cut them to 32 bits.  The EC
# launchers take `ncomp` (1: G1, 2: G2) just before the stream.
_SIGNATURES = {
    "mont_mul": ("testudo_mont_mul", (_P, _P, _P, _I, _L, _P)),
    "mont_mul_rm": ("testudo_mont_mul_rm", (_P, _P, _P, _I, _L, _I, _P)),
    "mont_chain": ("testudo_mont_chain", (_P, _P, _P, _I, _L, _I, _I, _P)),
    "mont_chain_group": ("testudo_mont_chain_group",
                         (_P, _P, _P, _I, _I, _L, _I, _I, _I, _P)),
    "add2": ("testudo_add2", (_P, _P, _P, _L, _I, _P)),
    "add_mask": ("testudo_add_mask", (_P, _P, _P, _P, _L, _I, _I, _P)),
    "step": ("testudo_step", (_P, _P, _P, _P, _P, _L, _I, _P)),
    "scan2": ("testudo_scan2", (_P, _P, _P, _P, _P, _L, _I, _P)),
    "scan2b": ("testudo_scan2b", (_P, _P, _P, _P, _P, _L, _I, _P)),
    "ladder": ("testudo_ladder", (_P, _P, _P, _I, _L, _I, _P)),
    "ladder_team": ("testudo_ladder_team", (_P, _P, _P, _I, _L, _I, _P)),
    "ladder_wide": ("testudo_ladder_wide", (_P, _P, _P, _P, _I, _L, _I, _P)),
    "bucket": ("testudo_bucket", (_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _P)),
    "wsum": ("testudo_wsum_team", (_P, _P, _I, _I, _I, _I, _P)),
    "chain_team": ("testudo_chain_team", (_P, _P, _L, _I, _I, _P)),
    "fold_team": ("testudo_fold_team", (_P, _L, _P, _I, _I, _P, _P, _I, _P)),
    "fixed_base": ("testudo_fixed_base_team", (_P, _P, _P, _L, _I, _I, _P)),
    "fixed_base_one": ("testudo_fixed_base_one", (_P, _P, _P, _L, _I, _I, _P)),
    "fixed_base_window": ("testudo_fixed_base_window", (_P, _P, _P, _L, _I, _I, _P)),
    "poseidon_permute": ("testudo_poseidon_permute", (_P, _P, _I, _L, _P)),
    "sumcheck_round": ("testudo_sumcheck_round", (_P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _P)),
    "sumcheck_tail": ("testudo_sumcheck_tail", (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                                _I, _I, _P)),
    # BW6-761's group law (fp_group.cu): the field id and the curve constant b
    # just before the stream
    "fp_group_op": ("testudo_fp_group_op", (_P,) * 9 + (_L, _I, _I, _I, _P)),
    "fp_chunk_sums": ("testudo_fp_chunk_sums", (_P,) * 9 + (_L, _I, _I, _P)),
    "fp_fixed_base": ("testudo_fp_fixed_base", (_P,) * 6 + (_L, _I, _I, _I, _P)),
}
# C functions that launch nothing and take no stream: (symbol, argtypes).
_QUERIES = {
    "bucket_capacity": ("testudo_bucket_capacity", (_I, _I)),
    "sumcheck_round_grid": ("testudo_sumcheck_round_grid", (_I, _L, _I, _I, _I)),
}

# Launches per kernel since the last reset_launches().  The mixed and the
# general bucket kernel are two instantiations of one template and are
# counted apart, and so are the G1 and the G2 instantiation of every EC
# kernel: the G1 count keeps the bare name, the G2 count ends in "_g2".  The
# row-major Montgomery product is counted per field, the grouped chain per
# variant; the Poseidon permutation and the sumcheck's kernels once each
# (both fields, every kind); BW6-761's group law per entry point and group
# (G1 the bare name, G2 with "_g2"; the elementwise kernel per formula).
EC_KERNELS = ("add2", "add_mask", "step", "scan2", "scan2b", "ladder", "ladder_team",
              "ladder_wide", "bucket", "bucket_mixed", "wsum", "chain_team", "fold_team",
              "fixed_base", "fixed_base_one", "fixed_base_window")
FIELD_KERNELS = ("mont_mul", "mont_mul_rm_fq", "mont_mul_rm_fr", "mont_mul_rm_bw6fq",
                 "mont_mul_rm_fr381", "mont_chain", "mont_chain_seq", "mont_chain_wide")
SUMCHECK_KERNELS = ("poseidon_permute", "sumcheck_round", "sumcheck_tail")
BW6_KERNELS = ("bw6_add", "bw6_add_mixed", "bw6_double", "bw6_chunk_sum", "bw6_fixed_base")
LAUNCHES = {name: 0 for name in (
    *FIELD_KERNELS, *SUMCHECK_KERNELS, *EC_KERNELS, *(k + "_g2" for k in EC_KERNELS),
    *BW6_KERNELS, *(k + "_g2" for k in BW6_KERNELS))}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (*HEADERS, *SOURCES):
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu (in parallel) and link them; returns the library's
    path.  Reuses a finished build of the same sources."""
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / "libtestudo_kernels.so"
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    procs = []
    for src in SOURCES:
        obj = out_dir / (src + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    # one reader thread per compiler, so that each source's time is its own
    def wait(proc):
        out, _ = proc.communicate()
        return out, time.time() - t0

    with ThreadPoolExecutor(max_workers=len(procs)) as pool:
        done = list(pool.map(wait, [proc for _, _, proc in procs]))
    log, failed = [], []
    for (src, obj, proc), (out, secs) in zip(procs, done):
        log.append(f"== {src} (exit {proc.returncode}, {secs:.1f} s)\n{out}")
        if proc.returncode != 0:
            failed.append(src)
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n" + "\n".join(log))
    tmp = out_dir / f"libtestudo_kernels.{os.getpid()}.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError("linking the kernels failed\n" + link.stdout)
    os.replace(tmp, lib_path)
    (out_dir / "build_seconds.txt").write_text(f"{time.time() - t0:.1f}\n")
    return lib_path


def build_tool(name: str, code: str) -> Path:
    """Compile one more CUDA source, `code`, which may include the kernel
    sources of csrc/, into a library of its own with the kernels' flags:
    `_build/<name>-<hash>/lib<name>.so`, reused while the sources and the
    code stay the same.  For measurement tools that instantiate a kernel
    template at arguments the kernel library does not."""
    digest = hashlib.sha256((_source_hash() + code).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / f"{name}-{digest}"
    lib_path = out_dir / f"lib{name}.so"
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}.cu"
    src.write_text(code)
    tmp = out_dir / f"lib{name}.{os.getpid()}.so"
    done = subprocess.run([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-shared", "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    (out_dir / "build.log").write_text(done.stdout)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}\n{done.stdout}")
    os.replace(tmp, lib_path)
    return lib_path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for symbol, argtypes in (*_SIGNATURES.values(), *_QUERIES.values()):
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def _template_args(mangled: str, pos: int):
    """The template arguments at `pos` (just after an "I") up to their "E":
    (the arguments as text, the position after the "E"), or None for
    anything this library's kernels do not use."""
    args = []
    while pos < len(mangled) and mangled[pos] != "E":
        lit = re.match(r"L([bi])(n?\d+)E", mangled[pos:])
        num = re.match(r"\d+", mangled[pos:])
        if lit:
            kind, value = lit.groups()
            value = value.replace("n", "-")
            args.append(value if kind == "i" else "true" if value == "1" else "false")
            pos += lit.end()
        elif num:
            start = pos + num.end()
            pos = start + int(num.group())
            name = mangled[start:pos]
            if mangled[pos:pos + 1] == "I":  # a template of its own: Fq761Coord<-1>
                inner = _template_args(mangled, pos + 1)
                if inner is None:
                    return None
                name, pos = f"{name}<{', '.join(inner[0])}>", inner[1]
            args.append(name)
        else:
            return None
    return args, pos + 1


def _kernel_name(mangled: str) -> str:
    """`_Z8k_bucketI8Fq2CoordLb1EEv...` -> `k_bucket<Fq2Coord, true>`: enough
    of the Itanium scheme for this library's kernels (a name, then type,
    class template, bool and int template arguments); anything else comes
    back as it is."""
    m = re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled
    pos = m.end() + int(m.group(1))
    name = mangled[m.end():pos]
    if mangled[pos:pos + 1] != "I":
        return name
    inner = _template_args(mangled, pos + 1)
    if inner is None:
        return mangled
    return f"{name}<{', '.join(inner[0])}>"


def build_report() -> dict:
    """Seconds the build took (in all, and until each source's compiler
    ended: they run side by side) and the compiler's resource line for every
    kernel (registers, stack frame, spills), for the finished build of the
    present sources."""
    out_dir = BUILD_ROOT / _source_hash()
    log = (out_dir / "build.log").read_text()
    secs = (out_dir / "build_seconds.txt").read_text().strip()
    usage, entry, frame = [], None, ""
    for ln in log.splitlines():
        ln = ln.strip()
        started = re.search(r"Compiling entry function '(\w+)'", ln)
        if started:
            entry, frame = _kernel_name(started.group(1)), ""
        elif entry and "stack frame" in ln:
            frame = ln
        elif entry and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln)
            usage.append(f"{entry}: {regs.group(1) if regs else '?'} registers, {frame}")
            entry = None
    per_source = {m.group(1): float(m.group(2))
                  for m in re.finditer(r"^== (\S+) \(exit \d+, ([\d.]+) s\)", log, re.M)}
    return {"seconds": float(secs), "per_source": per_source, "ptxas": usage}


def require_cuda_int32(name: str, **tensors: torch.Tensor) -> None:
    """The kernels take contiguous int32 CUDA tensors on one device."""
    device = None
    for arg, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {arg} must be a tensor")
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: tensors lie on different devices")


def require_aligned(name: str, nbytes: int, **tensors: torch.Tensor) -> None:
    """A kernel that reads rows as `nbytes`-byte words needs each tensor's
    data to start at a multiple of `nbytes` (its rows' lengths are)."""
    for arg, t in tensors.items():
        if t.data_ptr() % nbytes:
            raise ValueError(f"{name}: {arg} must start at a {nbytes}-byte aligned address")


def query(name: str, *args) -> int:
    """Call the C query `name` (no launch, no stream) on the current device."""
    symbol, _ = _QUERIES[name]
    return getattr(library(), symbol)(*args)


@functools.lru_cache(maxsize=None)
def _launcher(name: str):
    """The C launcher of kernel `name` in the loaded library."""
    return getattr(library(), _SIGNATURES[name][0])


def launch(name: str, *args, counted_as: str | None = None) -> None:
    """Start kernel `name` on the current stream of the current device."""
    rc = _launcher(name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kernel {name}: launch failed with CUDA error {rc}")
    LAUNCHES[counted_as or name] += 1
