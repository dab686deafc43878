"""What the per-layer readers share: spans, the traced launches and the
device groups of a run."""

from __future__ import annotations

from port_bench import flopcount
from port_bench import trace as trace_mod


def t23d(run):
    return flopcount.ns(run.config["t23d"])


def span_mean_s(run, name: str):
    """The mean length of span `name` over the requests that ran outside
    the profiler (all of them where the profiler held the only one), or
    None without such a span."""
    spans = [(t1 - t0, i) for n, t0, t1, i in run.spans if n == name]
    if not spans:
        return None
    untraced = [d for d, i in spans if i != 0] if run.trace else []
    use = untraced or [d for d, _ in spans]
    return sum(use) / len(use)


def idle_share(run):
    tr = run.trace_data
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def flash_roofline(run, launches: dict):
    """Σ bound of the predicted launches / Σ device time of the flash
    kernels in the trace, as a share; None where the traced launches are
    not the predicted ones (the program took another path) or the trace
    holds no flash kernel."""
    tr = run.trace_data
    got = run.counters.get("traced_launches")
    if tr is None or got is None:
        return None
    want = {k: sum(c for c, *_ in v) for k, v in launches.items()}
    if any(got.get(k) != n for k, n in want.items()):
        return None
    dev = sum(s for g, s in tr.device_s_by(trace_mod.kernel_group).items()
              if g.startswith(trace_mod.FLASH_GROUP_PREFIX))
    if dev <= 0:
        return None
    return 100.0 * flopcount.launches_bound_s(launches) / dev


def group_share(run, groups) -> float | None:
    tr = run.trace_data
    if tr is None:
        return None
    by = tr.device_s_by(trace_mod.kernel_group)
    total = sum(by.values())
    if total <= 0:
        return None
    return 100.0 * sum(by.get(g, 0.0) for g in groups) / total
