"""Hierarchical wall-clock profiler.

Counterpart of testudo_tpu/utils/timer.py (itself of Testudo's timer.rs):
depth-indented start/stop prints gated by TESTUDO_PROFILE=1, plus a
recording hook: while `record()` is active every stopped timer appends
(label, seconds) to the list it yields, which is how a caller reads the
split of one commit or open.  PyTorch launches asynchronously, so a timer
around device work measures the enqueue unless the timed code ends in a
host copy or a synchronise (the timed sections of core/sqrt_pst.py and
core/mipp.py do).
"""
from __future__ import annotations

import contextlib
import os
import sys
import time

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
