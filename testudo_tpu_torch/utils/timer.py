"""Hierarchical wall-clock profiler.

Counterpart of testudo_tpu/utils/timer.py (itself of Testudo's timer.rs):
depth-indented start/stop prints gated by TESTUDO_PROFILE=1, plus a
recording hook: while `record()` is active every stopped timer appends
(label, seconds) to the list it yields, which is how a caller reads the
split of one commit or open; and `DeviceTrace`, the device timeline of a
block (torch.profiler in place of the reference's jax.profiler).  PyTorch
launches asynchronously, so a timer around device work measures the enqueue
unless the timed code ends in a host copy or a synchronise (the timed
sections of core/sqrt_pst.py and core/mipp.py do).
"""
from __future__ import annotations

import contextlib
import os
import sys
import time

import torch

_ENABLED = os.environ.get("TESTUDO_PROFILE", "0") == "1"
_DEPTH = 0
_RECORD = None


class Timer:
    def __init__(self, label: str):
        global _DEPTH
        self.label = label
        self.start = time.time()
        if _ENABLED:
            print("  " * _DEPTH + f"* {label}", file=sys.stderr, flush=True)
            _DEPTH += 1

    def stop(self) -> float:
        global _DEPTH
        dt = time.time() - self.start
        if _RECORD is not None:
            _RECORD.append((self.label, dt))
        if _ENABLED:
            _DEPTH = max(0, _DEPTH - 1)
            print(
                "  " * _DEPTH + f"* {self.label} {dt*1000:.1f}ms",
                file=sys.stderr,
                flush=True,
            )
        return dt

    @staticmethod
    def print(msg: str) -> None:
        if _ENABLED:
            print("  " * _DEPTH + f"* {msg}", file=sys.stderr, flush=True)


@contextlib.contextmanager
def record():
    """Collect (label, seconds) of every timer stopped inside the block."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


class DeviceTrace:
    """Context manager that traces the block with torch.profiler (CPU
    activity, and CUDA activity where a CUDA device is present) and, on
    exit, writes the timeline as a Chrome trace file under `logdir` (made if
    missing): `path` names the file, `profile` is the profiler, whose
    `events()` a caller reads.  The counterpart of the reference's
    jax.profiler trace of a block (testudo_tpu/utils/timer.py:45-62).
    Launches are asynchronous: a block that should hold its kernels ends in
    a synchronise."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.path = None
        self.profile = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.profile = profile(activities=activities)
        self.profile.__enter__()
        return self

    def __exit__(self, *exc):
        self.profile.__exit__(*exc)
        os.makedirs(self.logdir, exist_ok=True)
        self.path = os.path.join(self.logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
        self.profile.export_chrome_trace(self.path)
        return False
