"""The readers of the program's own spans (`program_spans.py` and the
metrics `render_s.scene`, `export_host_s.scene`,
`denoise_idle_share.scene`) on a synthetic run: spans put in the program's
recorder by hand beside a `trace.Trace`, values worked out by hand."""

import sys
import types

import pytest

from port_bench import common, program_spans
from port_bench import trace as trace_mod
from vist3a_tpu_torch.core import profiling as tprof

T = 1_800_000_000.0          # an epoch second, as the clocks give them
METRICS = ("render_s.scene", "export_host_s.scene",
           "denoise_idle_share.scene")


def reader(name):
    return common.load_module(common.HERE / "layer_metrics" / f"{name}.py",
                              f"test_program_spans_{name}")


class Run:
    def __init__(self, trace_data):
        self.trace_data = trace_data


def scene(t0, render=(1.0, 0.4), host=(0.2, 0.5, 0.3, 0.1),
          steps=(1.0,) * 5):
    """One scene's program spans from t0 (seconds after T): embed 0.1 s,
    the denoise over its UniPC steps, the render and its copy to the host,
    the host steps."""
    out = [("t23d.embed", t0, t0 + 0.1),
           ("t23d.denoise", t0 + 0.1, t0 + 0.1 + sum(steps))]
    t = t0 + 0.1
    for d in steps:
        out.append(("unipc.step", t, t + d))
        t += d
    t += 0.4
    out += [("export.render", t, t + render[0]),
            ("export.frames_to_host", t + render[0], t + sum(render))]
    t += sum(render)
    for name, d in zip(program_spans.EXPORT_HOST, host):
        out.append((name, t, t + d))
        t += d
    return out


@pytest.fixture
def recorded(monkeypatch):
    """Puts (name, start_s, end_s) spans, seconds after T, in a recorder of
    the program's own."""
    rec = tprof.SpanRecorder()
    monkeypatch.setattr(tprof, "RECORDER", rec)

    def put(spans):
        for name, s, e in spans:
            rec.add(tprof.Span(name, int((T + s) * 1e9), int((T + e) * 1e9)))
    return put


def traced_run():
    # the window holds the traced scene (from 0); the card is busy over
    # [0.1, 2.1], [3.1, 4.1] and the render, so the denoise [0.1, 5.1] is
    # busy 3 s of its 5
    return Run(trace_mod.Trace(
        ops=[("k", T + 0.1, T + 2.1), ("k", T + 3.1, T + 4.1),
             ("k", T + 5.5, T + 6.5)],
        window=(T, T + 12.0)))


def test_readers_read_the_traced_scene(recorded):
    """The traced scene alone, whether or not scenes follow it; its
    denoise's 5 steps against the warm-up's median step, 0.8 s (the first
    warm step, 3 s, is the first call's): busy 3 s of 4 untraced."""
    recorded(scene(-60.0, render=(9.0, 9.0), steps=(3.0,) + (0.8,) * 4)
             + scene(0.0, render=(2.0, 0.5), host=(1, 1, 1, 1)))
    run = traced_run()
    want = [2.5, 4.0, 25.0]
    assert [reader(m).read(run) for m in METRICS] == pytest.approx(
        want, abs=1e-4)
    recorded(scene(13.0, render=(1.0, 0.4), steps=(0.5,) * 5)
             + scene(30.0, render=(1.2, 0.6), host=(0.4, 0.5, 0.5, 0.1)))
    assert [reader(m).read(run) for m in METRICS] == pytest.approx(
        want, abs=1e-4)


def test_idle_share_needs_the_warm_up_steps(recorded):
    """Without a warm-up scene before the window there is nothing untraced
    to hold the traced denoise against."""
    recorded(scene(0.0))
    run = traced_run()
    assert reader("denoise_idle_share.scene").read(run) is None
    assert reader("render_s.scene").read(run) == pytest.approx(1.4,
                                                               abs=1e-6)


def test_none_without_spans(recorded, monkeypatch):
    run = traced_run()
    assert [reader(m).read(run) for m in METRICS] == [None] * 3
    assert [reader(m).read(Run(None)) for m in METRICS] == [None] * 3
    # a program without the recorder
    monkeypatch.setitem(sys.modules, "vist3a_tpu_torch.core.profiling",
                        types.ModuleType("vist3a_tpu_torch.core.profiling"))
    assert program_spans.recorded() == []
    assert [reader(m).read(run) for m in METRICS] == [None] * 3


def test_idle_by_span_splits_a_gap_across_spans():
    spans = [("bench.export", 0.0, 5.0), ("export.colour_uint8", 1.0, 2.0),
             ("export.turbo_uint8", 2.0, 4.0)]
    tr = trace_mod.Trace(ops=[("a", 0.0, 1.5), ("b", 3.0, 5.0)],
                         ranges=spans, window=(0.0, 6.0))
    got = program_spans.idle_by_span(tr, spans)
    assert got == {"export.colour_uint8": pytest.approx(0.5),
                   "export.turbo_uint8": pytest.approx(1.0),
                   program_spans.NO_SPAN: pytest.approx(1.0)}
    assert program_spans.idle_within(tr, 1.0, 3.5) == pytest.approx(1.5)
    # the breakdown's label: the whole gap to the range at its midpoint
    assert tr.idle_gaps()[0] == ("export.turbo_uint8", pytest.approx(1.5))
