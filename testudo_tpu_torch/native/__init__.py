"""ctypes bindings for the native C++ host library (testudo_native.cpp).

Counterpart of testudo_tpu/native/__init__.py, and the port's own copy of the
library: the source beside this file is compiled with the host `g++` at first
use into `testudo_tpu_torch/_build/native-<hash of the sources>/`, which
`.gitignore` lists; nothing is loaded from anywhere else.  The library
speeds up host-side, latency-bound crypto (multi-pairings, GT exponentiation,
host MSMs) while the throughput-bound MSMs run on the GPU.  Callers fall back
to the pure-Python host implementations when there is no toolchain, so
`lib()` returning None is a supported configuration, not an error;
`build_error()` then says why.

Value parity: the C++ tower/pairing mirrors fields/host.py and
curves/pairing.py exactly (same tower, same digit-decomposed final
exponentiation), so swapping backends never changes a proof or transcript.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Sequence

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ("testudo_native.cpp", "constants_377.h")
BUILD_ROOT = os.path.join(os.path.dirname(_DIR), "_build")
_CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-fno-exceptions")

# every exported call the wrappers below make has one shape
_BYTE_CALLS = ("tn_multi_pairing", "tn_gt_pow", "tn_gt_batch_pow", "tn_g1_msm", "tn_g2_msm",
               "tn_g1_mul", "tn_g2_mul", "tn_g1_batch_mul", "tn_g2_batch_mul")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None


def library_path() -> str:
    """Where the library of the present sources is (or will be) built."""
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, "native-" + h.hexdigest()[:16], "libtestudo_native.so")


def compiler() -> Optional[str]:
    return shutil.which("g++")


def _build() -> Optional[str]:
    """Compile the shared library unless a finished build of the same
    sources exists.  Returns its path, or None (and sets the error)."""
    global _error
    so = library_path()
    if os.path.exists(so):
        return so
    cxx = compiler()
    if cxx is None:
        _error = "no g++ found"
        return None
    try:
        os.makedirs(os.path.dirname(so), exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        res = subprocess.run(
            [cxx, *_CXX_FLAGS, "-o", tmp, os.path.join(_DIR, _SOURCES[0])],
            capture_output=True, text=True, timeout=600,
        )
        if res.returncode != 0:
            _error = "g++ failed:\n" + res.stderr[-2000:]
            return None
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.SubprocessError) as exc:
        _error = f"{type(exc).__name__}: {exc}"
        return None


def lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None if unavailable."""
    global _lib, _tried, _error
    if _lib is not None:
        return _lib
    if _tried:
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("TESTUDO_NO_NATIVE"):
            _error = "TESTUDO_NO_NATIVE is set"
            return None
        so = _build()
        if so is None:
            return None
        try:
            l = ctypes.CDLL(so)
            for name in _BYTE_CALLS:  # (in, in, count or length, out)
                fn = getattr(l, name)
                fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p]
                fn.restype = None
            l.tn_init.restype = None
            l.tn_init()
            _lib = l
        except (OSError, AttributeError) as exc:
            _error = f"loading {so} failed: {exc}"
            _lib = None
    return _lib


def available() -> bool:
    return lib() is not None


def build_error() -> Optional[str]:
    """Why `lib()` returned None (None while it has not been tried or it
    loaded)."""
    return _error


# ---------------------------------------------------------------------------
# Codecs between Python host types and the byte ABI
# ---------------------------------------------------------------------------

from ..fields.bls12_377 import P  # noqa: E402
from ..fields.host import Fq2, Fq6, Fq12  # noqa: E402


def _fq_bytes(x: int) -> bytes:
    return (x % P).to_bytes(48, "little")


def _fq_from(b: bytes) -> int:
    return int.from_bytes(b, "little")


def g1_bytes(p) -> bytes:
    if p is None:
        return b"\x00" * 96
    return _fq_bytes(p[0]) + _fq_bytes(p[1])


def g1_from(b: bytes):
    x = _fq_from(b[:48])
    y = _fq_from(b[48:])
    if x == 0 and y == 0:
        return None
    return (x, y)


def g2_bytes(p) -> bytes:
    if p is None:
        return b"\x00" * 192
    x, y = p
    return _fq_bytes(x.c0) + _fq_bytes(x.c1) + _fq_bytes(y.c0) + _fq_bytes(y.c1)


def g2_from(b: bytes):
    c = [_fq_from(b[48 * i : 48 * (i + 1)]) for i in range(4)]
    if all(v == 0 for v in c):
        return None
    return (Fq2(c[0], c[1]), Fq2(c[2], c[3]))


def fq12_bytes(f: Fq12) -> bytes:
    cs = [f.c0.c0, f.c0.c1, f.c0.c2, f.c1.c0, f.c1.c1, f.c1.c2]
    return b"".join(_fq_bytes(c.c0) + _fq_bytes(c.c1) for c in cs)


def fq12_from(b: bytes) -> Fq12:
    cs = [
        Fq2(_fq_from(b[96 * i : 96 * i + 48]), _fq_from(b[96 * i + 48 : 96 * (i + 1)]))
        for i in range(6)
    ]
    return Fq12(Fq6(cs[0], cs[1], cs[2]), Fq6(cs[3], cs[4], cs[5]))


def _scalar32(s: int) -> bytes:
    return (s % (1 << 256)).to_bytes(32, "little")


# ---------------------------------------------------------------------------
# High-level wrappers (host types in/out); callers check available() first
# ---------------------------------------------------------------------------


def multi_pairing(g1s: Sequence[object], g2s: Sequence[object]) -> Fq12:
    l = lib()
    n = len(g1s)
    assert n == len(g2s)
    p_buf = b"".join(g1_bytes(p) for p in g1s)
    q_buf = b"".join(g2_bytes(q) for q in g2s)
    out = ctypes.create_string_buffer(576)
    l.tn_multi_pairing(p_buf, q_buf, ctypes.c_int64(n), out)
    return fq12_from(out.raw)


def gt_pow(f: Fq12, e: int) -> Fq12:
    l = lib()
    if e < 0:
        f = f.inv()
        e = -e
    eb = e.to_bytes(max(1, (e.bit_length() + 7) // 8), "little")
    out = ctypes.create_string_buffer(576)
    l.tn_gt_pow(fq12_bytes(f), eb, ctypes.c_int64(len(eb)), out)
    return fq12_from(out.raw)


def gt_batch_pow(fs: Sequence[Fq12], es: Sequence[int]) -> List[Fq12]:
    """out[i] = fs[i]^es[i], threaded in native code (the MIPP verifier's
    T-fold exponent batch)."""
    l = lib()
    n = len(fs)
    assert n == len(es)
    f_buf = b"".join(fq12_bytes(f) for f in fs)
    s_buf = b"".join(_scalar32(e) for e in es)
    out = ctypes.create_string_buffer(576 * n)
    l.tn_gt_batch_pow(f_buf, s_buf, ctypes.c_int64(n), out)
    return [fq12_from(out.raw[576 * i : 576 * (i + 1)]) for i in range(n)]


def g1_msm(points: Sequence[object], scalars: Sequence[int]):
    l = lib()
    n = len(points)
    p_buf = b"".join(g1_bytes(p) for p in points)
    s_buf = b"".join(_scalar32(s) for s in scalars)
    out = ctypes.create_string_buffer(96)
    l.tn_g1_msm(p_buf, s_buf, ctypes.c_int64(n), out)
    return g1_from(out.raw)


def g2_msm(points: Sequence[object], scalars: Sequence[int]):
    l = lib()
    n = len(points)
    p_buf = b"".join(g2_bytes(p) for p in points)
    s_buf = b"".join(_scalar32(s) for s in scalars)
    out = ctypes.create_string_buffer(192)
    l.tn_g2_msm(p_buf, s_buf, ctypes.c_int64(n), out)
    return g2_from(out.raw)


def g1_mul(p, e: int):
    l = lib()
    if e < 0:
        p = None if p is None else (p[0], (-p[1]) % P)
        e = -e
    eb = e.to_bytes(max(1, (e.bit_length() + 7) // 8), "little")
    out = ctypes.create_string_buffer(96)
    l.tn_g1_mul(g1_bytes(p), eb, ctypes.c_int64(len(eb)), out)
    return g1_from(out.raw)


def g2_mul(p, e: int):
    l = lib()
    if e < 0:
        p = None if p is None else (p[0], -p[1])
        e = -e
    eb = e.to_bytes(max(1, (e.bit_length() + 7) // 8), "little")
    out = ctypes.create_string_buffer(192)
    l.tn_g2_mul(g2_bytes(p), eb, ctypes.c_int64(len(eb)), out)
    return g2_from(out.raw)


def g1_batch_mul(points: Sequence[object], scalars: Sequence[int]) -> List[object]:
    """out[i] = scalars[i] * points[i] (independent bases, threaded)."""
    l = lib()
    n = len(points)
    p_buf = b"".join(g1_bytes(p) for p in points)
    s_buf = b"".join(_scalar32(s) for s in scalars)
    out = ctypes.create_string_buffer(96 * n)
    l.tn_g1_batch_mul(p_buf, s_buf, ctypes.c_int64(n), out)
    return [g1_from(out.raw[96 * i : 96 * (i + 1)]) for i in range(n)]


def g2_batch_mul(points: Sequence[object], scalars: Sequence[int]) -> List[object]:
    l = lib()
    n = len(points)
    p_buf = b"".join(g2_bytes(p) for p in points)
    s_buf = b"".join(_scalar32(s) for s in scalars)
    out = ctypes.create_string_buffer(192 * n)
    l.tn_g2_batch_mul(p_buf, s_buf, ctypes.c_int64(n), out)
    return [g2_from(out.raw[192 * i : 192 * (i + 1)]) for i in range(n)]
