"""The run of one cell: set-up, the measured window, the check against the
plain reference, and the result's last line.

`python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` reads `BENCHMARK.json` at the checkout's root for the
cell's configuration, traffic, chips and metrics,
`port_bench/cells/<cell>.json` for its limits,
`port_bench/traffic/<traffic>.json` for the traffic mix's parameters and
driver, `port_bench/configs/<config>.json` for the configuration, and
loads `port_bench/drivers/<driver>.py` and each per-layer metric's
`port_bench/layer_metrics/<metric>.py` by name.

A driver module defines
  setup(run)   build the program with the seed's weights and warm every
               shape the cell's traffic uses;
  window(run)  drive the traffic for `run.seconds`, filling `run.e2e`,
               `run.spans`, `run.trace`, `run.counters`, `run.attempted`
               and `run.failed`;
  free(run)    drop the program's state (after the peak is read);
  check(run)   compare what the window produced with the plain
               reference: a list of (name, value, limit).
A layer-metric module defines read(run) → a number, or None where it
finds nothing to read.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from dataclasses import dataclass, field

from port_bench import common

FORBIDDEN = ("jax", "jaxlib", "flax", "vist3a_tpu")


@dataclass
class Run:
    workload: str
    seed: int
    seconds: float
    trace: bool
    cell: dict
    config: dict
    t_start: float
    device: str = "cuda"
    e2e: dict = field(default_factory=dict)
    spans: list = field(default_factory=list)   # (name, t0, t1, request)
    trace_data: object = None                   # trace.Trace of the run
    counters: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    state: dict = field(default_factory=dict)   # the driver's own


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: the port's name only begins with it)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def correct(run: Run, checks: list) -> bool:
    """A run is correct when it attempted work, none failed, and every
    number compared is finite and within its limit."""
    return (run.attempted > 0 and run.failed == 0
            and all(math.isfinite(v) and v <= lim for _, v, lim in checks))


def benchmark() -> dict:
    return common.load_json(common.ROOT / "BENCHMARK.json")


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics this cell reports: with trace, the per-layer metrics
    listing it (or, without a `workloads` key, moving an end-to-end metric
    it reports); without, its end-to-end metrics."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in names
                                 else [])]


def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = common.ROOT / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_driver(cell: dict):
    name = cell["traffic_params"]["driver"]
    return common.load_module(common.HERE / "drivers" / f"{name}.py",
                              f"port_bench_driver_{name}")


def fail(msg: str, code: int = 2) -> None:
    print(f"port_bench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="port_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        fail("--seed must be non-negative")

    set_cache_dirs()
    bench = benchmark()
    cell = common.cell(args.workload, bench)
    config = common.config_file(cell["config"])

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark measures the card only")
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"the cell asks for {cell['chips']} devices, "
             f"{torch.cuda.device_count()} present")
    try:
        import vist3a_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program is not in this checkout: {e}")

    run = Run(args.workload, args.seed, args.seconds, bool(args.trace),
              cell, config, t_start)
    driver = load_driver(cell)

    driver.setup(run)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    torch.cuda.reset_peak_memory_stats()
    driver.window(run)
    torch.cuda.synchronize()
    run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    run.e2e["setup_s"] = setup_s

    bad = forbidden_modules()
    if bad:
        fail(f"modules of JAX or the JAX package were loaded: {bad}")

    metrics = {}
    for m in cell_metrics(bench, args.workload, run.trace):
        if not run.trace:
            value = run.e2e.get(m["name"])
            if value is None:
                fail(f"the driver gave no {m['name']}")
        else:
            reader = common.load_module(
                common.HERE / "layer_metrics" / f"{m['name']}.py",
                f"port_bench_metric_{m['name']}")
            value = reader.read(run)
            if value is None:
                continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    breakdown = None
    if run.trace:
        tr = run.trace_data
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        breakdown = tr.breakdown()

    driver.free(run)
    checks = driver.check(run)
    ok = correct(run, checks)

    bad = forbidden_modules()
    if bad:
        fail(f"modules of JAX or the JAX package were loaded: {bad}")

    result = {"correct": ok, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # a number that could not be read (not finite) is null in the line
    result["checks"] = {n: {"value": v if math.isfinite(v) else None,
                            "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0
