"""Spans, traces and finite checks.

  * `span(name)` — a `torch.profiler` range named `name` that also
    appends one `Span` to the in-memory recorder: its name and its start
    and end in Unix-epoch ns (`time.time_ns()`, the clock `torch.profiler`
    reports its events on, so a span and the device operations of a trace
    compare directly).  A span never synchronizes: on a CUDA device it
    ends when the host leaves the block, which is when the device finished
    only where the block waited for it (a copy to the host).  A span that
    an exception leaves is recorded all the same;
  * `spans()` — a snapshot of the recorder: the last `CAPACITY` spans to
    close, in the order they closed (the oldest dropped first, counted in
    `RECORDER.dropped`);
  * `trace_to(logdir)` — a `torch.profiler` trace of the block, written as
    a Chrome trace;
  * `assert_all_finite` — NaN / Inf in a (nested) dict of tensors, named;
  * `debug_nan_mode` — autograd's anomaly detection (the op whose backward
    makes the first NaN), as `jax_debug_nans` is in the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

CAPACITY = 65_536


class Span(NamedTuple):
    name: str
    start_ns: int             # Unix epoch
    end_ns: int


class SpanRecorder:
    """The last `capacity` closed spans; the oldest is dropped first and
    counted in `dropped`."""

    def __init__(self, capacity: int = CAPACITY):
        self.records = collections.deque(maxlen=capacity)
        self.dropped = 0
        self._lock = threading.Lock()

    def add(self, span: Span) -> None:
        with self._lock:
            if len(self.records) == self.records.maxlen:
                self.dropped += 1
            self.records.append(span)

    def snapshot(self) -> list[Span]:
        with self._lock:
            return list(self.records)


RECORDER = SpanRecorder()


class span:
    """`with span("t23d.denoise"):` — a profiler range and a recorded
    `Span` (see the module docstring)."""

    __slots__ = ("name", "_range", "_start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = record_function(self.name)
        self._range.__enter__()
        self._start = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        RECORDER.add(Span(self.name, self._start, time.time_ns()))
        self._range.__exit__(exc_type, exc, tb)
        return False


def spans() -> list[Span]:
    return RECORDER.snapshot()


@contextlib.contextmanager
def trace_to(logdir):
    """Profile the block (CPU, and CUDA where there is a device) and write
    `logdir/trace.json` (Chrome trace format); yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / "trace.json"))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, (*path, i))
    else:
        yield path, tree


def assert_all_finite(tree, name: str = "tree") -> None:
    """Raise FloatingPointError naming every floating tensor of `tree` (a
    state dict or nested dicts / lists of tensors) that holds NaN or Inf."""
    bad = ["/".join(str(p) for p in path) for path, x in _leaves(tree)
           if isinstance(x, torch.Tensor) and x.is_floating_point()
           and not bool(torch.isfinite(x).all())]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:10]}")


def debug_nan_mode(enable: bool = True) -> None:
    """Switch autograd's anomaly detection: a backward that makes a NaN
    raises, naming the forward op."""
    torch.autograd.set_detect_anomaly(enable)
