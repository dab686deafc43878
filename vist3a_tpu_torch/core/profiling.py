"""Timers, memory reports, traces and finite checks.

Port of `vist3a_tpu/core/profiling.py` (AnySplat's `Benchmarker`,
`src/misc/benchmarker.py:11-37`):

  * `Benchmarker.time(tag)` — a wall-clock range that is also a
    `torch.profiler` range named `tag`; on a CUDA device it closes with
    `torch.cuda.synchronize()`, so it times the work, not its enqueue;
  * `dump` / `summarize` — the ranges' times as JSON / their means;
  * `dump_memory` — allocated and peak bytes of each CUDA device;
  * `trace_to(logdir)` — a `torch.profiler` trace of the block, written as
    a Chrome trace;
  * `assert_all_finite` — NaN / Inf in a (nested) dict of tensors, named;
  * `debug_nan_mode` — autograd's anomaly detection (the op whose backward
    makes the first NaN), as `jax_debug_nans` is in the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function


class Benchmarker:
    """Named wall-clock ranges (`benchmarker.py:11-37`) and device memory;
    ranges on a CUDA `device` end with a synchronize."""

    def __init__(self, device: torch.device | str = "cuda"):
        self.execution_times = defaultdict(list)
        self.sync = torch.device(device).type == "cuda"

    @contextlib.contextmanager
    def time(self, tag: str, num_calls: int = 1):
        start = time.perf_counter()
        try:
            with record_function(tag):
                yield
                if self.sync:
                    torch.cuda.synchronize()
        finally:
            elapsed = time.perf_counter() - start
            for _ in range(num_calls):
                self.execution_times[tag].append(elapsed / num_calls)

    def dump(self, path) -> None:
        path = Path(path)
        path.parent.mkdir(exist_ok=True, parents=True)
        path.write_text(json.dumps(dict(self.execution_times)))

    def dump_memory(self, path) -> None:
        """{"cuda:i": {"bytes_in_use", "peak_bytes_in_use"}} of every CUDA
        device (the JAX package's keys) as JSON; {} without one."""
        stats = {f"cuda:{i}": {
            "bytes_in_use": torch.cuda.memory_allocated(i),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(i)}
            for i in range(torch.cuda.device_count())
        } if torch.cuda.is_available() else {}
        path = Path(path)
        path.parent.mkdir(exist_ok=True, parents=True)
        path.write_text(json.dumps(stats))

    def summarize(self) -> dict:
        return {tag: sum(ts) / len(ts)
                for tag, ts in self.execution_times.items()}


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
