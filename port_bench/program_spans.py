"""The program's own spans beside the device trace of a traced run.

The program records a span around each of its stages
(`vist3a_tpu_torch/core/profiling.py`: `t23d.*`, `unipc.step`,
`dit.forward`, `decode.*`, `export.*`, `render.*`), with its start and end
in Unix-epoch ns, the clock `torch.profiler` reports its events on; in
seconds they compare directly with a `trace.Trace`.  The readers read one
scene in every run, the traced one: the spans inside the trace window,
which leaves out the warm-up before it and the scenes after it (how many of
those fit in the window depends on the host's speed).  A program that
records no spans gives none here, and every reader built on them None.
"""

from __future__ import annotations

import statistics

RENDER_FROM, RENDER_TO = "export.render", "export.frames_to_host"
EXPORT_HOST = ("export.colour_uint8", "export.turbo_uint8",
               "export.mp4_write", "export.ply")
DENOISE, STEP = "t23d.denoise", "unipc.step"
NO_SPAN = "no span"


def recorded() -> list:
    """The program's recorded spans as (name, start_s, end_s), in the
    order they opened; [] where the program records none."""
    try:
        from vist3a_tpu_torch.core.profiling import spans
    except ImportError:
        return []
    return [(s.name, s.start_ns * 1e-9, s.end_ns * 1e-9)
            for s in sorted(spans(), key=lambda s: s.start_ns)]


def traced(run) -> list:
    """The recorded spans inside the trace window: the traced scene's."""
    tr = run.trace_data
    if tr is None:
        return []
    lo, hi = tr.window
    return [sp for sp in recorded() if sp[1] >= lo and sp[2] <= hi]


def _first(spans, name):
    return next((sp for sp in spans if sp[0] == name), None)


def render_s(run):
    """The traced scene from the start of `export.render` to the end of
    `export.frames_to_host`, whose copy to the host waits for the card."""
    sp = traced(run)
    a, b = _first(sp, RENDER_FROM), _first(sp, RENDER_TO)
    return b[2] - a[1] if a and b else None


def export_host_s(run):
    """The traced scene's summed spans of the export's host work:
    colouring, the turbo depth colouring, the mp4 writes and the PLY."""
    parts = [e - s for name, s, e in traced(run) if name in EXPORT_HOST]
    return sum(parts) if parts else None


def denoise_idle_share(run):
    """100 × (1 − the card's busy seconds inside the traced scene's
    `t23d.denoise` / that denoise's length untraced), as a share.  Under
    the profiler every launch costs the host more, which stretches the
    traced span but not the kernels' times; so the span's length untraced
    is taken as its `unipc.step` spans' count times the median step of the
    warm-up scene, which ran before the profiler started."""
    tr = run.trace_data
    spans = traced(run)
    den = _first(spans, DENOISE)
    if den is None:
        return None
    steps = [sp for sp in spans if sp[0] == STEP
             and den[1] <= sp[1] and sp[2] <= den[2]]
    warm = [e - s for name, s, e in recorded()
            if name == STEP and e < tr.window[0]]
    if not steps or not warm:
        return None
    untraced_s = len(steps) * statistics.median(warm)
    busy = den[2] - den[1] - idle_within(tr, den[1], den[2])
    return 100.0 * (1.0 - busy / untraced_s)


def idle_intervals(trace) -> list:
    """The window's intervals in which no device operation ran, from
    `Trace.busy_intervals()`, sorted."""
    lo, hi = trace.window
    out, t = [], lo
    for s, e in trace.busy_intervals():
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def idle_within(trace, t0: float, t1: float) -> float:
    """The card's idle seconds inside [t0, t1]."""
    return sum(max(0.0, min(b, t1) - max(a, t0))
               for a, b in idle_intervals(trace))


def _innermost(spans) -> list:
    """The timeline cut at every span's start and end, as (t0, t1, name of
    the latest-started span covering the piece, or NO_SPAN)."""
    cuts = sorted({t for _, s, e in spans for t in (s, e)})
    by_start = sorted(spans, key=lambda sp: sp[1])
    out = []
    for lo, hi in zip(cuts, cuts[1:]):
        label = NO_SPAN
        for name, s, e in by_start:
            if s > lo:
                break
            if e >= hi:
                label = name
        out.append((lo, hi, label))
    return out


def idle_by_span(trace, spans) -> dict:
    """{span name: idle seconds}: each idle gap of the trace's window split
    across the innermost spans (name, start_s, end_s) it overlaps, the
    parts outside every span under NO_SPAN."""
    pieces = _innermost(spans)
    out, i = {}, 0
    for a, b in idle_intervals(trace):
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        covered, j = 0.0, i
        while j < len(pieces) and pieces[j][0] < b:
            lo, hi, label = pieces[j]
            d = min(b, hi) - max(a, lo)
            if d > 0:
                out[label] = out.get(label, 0.0) + d
                covered += d
            j += 1
        if b - a - covered > 1e-9:
            out[NO_SPAN] = out.get(NO_SPAN, 0.0) + (b - a - covered)
    return out
