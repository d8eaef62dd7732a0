"""The port's last two twins of the JAX package's host helpers:
`utils.timer.DeviceTrace` (testudo_tpu/utils/timer.py:45-62, a jax.profiler
trace there, torch.profiler here) and `fields.host.fr_sqrt`
(testudo_tpu/fields/host.py:70-72).

  - `DeviceTrace` on the CPU: the block's torch ops land in a Chrome trace file
    under `logdir` (made if missing) that parses as JSON and names an `aten::`
    op; its profile's events hold them too; `Timer` and `record()` beside it
    are unchanged.
  - `fr_sqrt` equals the JAX package's on seeded squares, 0, 1, r - 1 and
    non-residues (None), and its roots square back."""
import json
import os
import random

import pytest
import torch

from testudo_tpu.fields import host as jhost
from testudo_tpu_torch.fields import host
from testudo_tpu_torch.fields.bls12_377 import R
from testudo_tpu_torch.utils import timer

torch.set_num_threads(1)


def test_device_trace_writes_a_chrome_trace_of_the_block(tmp_path):
    logdir = tmp_path / "traces" / "nested"
    with timer.DeviceTrace(str(logdir)) as trace:
        x = torch.arange(64, dtype=torch.int64).reshape(8, 8)
        y = (x @ x).sum()
    assert int(y) == int((torch.arange(64).reshape(8, 8) @ torch.arange(64).reshape(8, 8)).sum())
    assert trace.path is not None and os.path.dirname(trace.path) == str(logdir)
    with open(trace.path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert "aten::sum" in names
    assert any(e.name == "aten::sum" for e in trace.profile.events())


def test_device_trace_has_the_reference_signature(tmp_path):
    """DeviceTrace(logdir), entered as itself, never swallows an exception;
    a second trace writes a second file."""
    t = timer.DeviceTrace(str(tmp_path))
    assert t.logdir == str(tmp_path)
    with pytest.raises(KeyError):
        with t as entered:
            assert entered is t
            raise KeyError("through")
    with timer.DeviceTrace(str(tmp_path)) as t2:
        torch.ones(4).add_(1)
    assert os.path.isfile(t.path) and os.path.isfile(t2.path) and t.path != t2.path


def test_timer_and_record_beside_the_trace(tmp_path):
    with timer.record() as rec:
        with timer.DeviceTrace(str(tmp_path)):
            t = timer.Timer("inside a trace")
            t.stop()
    assert [label for label, _ in rec] == ["inside a trace"]


def test_fr_sqrt_equals_reference():
    rng = random.Random(71)
    xs = [rng.randrange(R) for _ in range(24)]
    squares = [x * x % R for x in xs] + [0, 1, R - 1, 4]
    for s in squares:
        got = host.fr_sqrt(s)
        assert got == jhost.fr_sqrt(s)
        if got is not None:
            assert got * got % R == s
    nonres = [x for x in (rng.randrange(1, R) for _ in range(64)) if pow(x, (R - 1) // 2, R) != 1]
    assert len(nonres) > 10
    for x in nonres[:16]:
        assert host.fr_sqrt(x) is None and jhost.fr_sqrt(x) is None
    assert host.fr_sqrt(R + 9) in (3, R - 3)  # reduced mod r first
