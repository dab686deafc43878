"""The port's spans (`vist3a_tpu_torch/core/profiling.py`): what a span
records (its name, its start and end in Unix-epoch ns, the spans an
exception leaves), the recorder's capacity and threads, the profiler's
clock, and the spans the sampler, the DiT and the rasterizer open, each a
profiler range of its name.  Each test records into a recorder of its
own."""

import threading
import time

import numpy as np
import pytest
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile

from vist3a_tpu_torch.core import profiling as tprof
from vist3a_tpu_torch.diffusion import unipc
from vist3a_tpu_torch.kernels import rasterizer as tr
from vist3a_tpu_torch.nn import wan_dit

RENDER_SPANS = ("render.project_sh_table", "render.pairs",
                "render.composite", "render.background")


@pytest.fixture
def recorder(monkeypatch):
    rec = tprof.SpanRecorder()
    monkeypatch.setattr(tprof, "RECORDER", rec)
    return rec


def _by_name(spans):
    return {s.name: s for s in spans}


def _names(spans):
    return [s.name for s in spans]


def test_nested_spans_record_in_closing_order(recorder):
    t0 = time.time_ns()
    with tprof.span("outer"):
        with tprof.span("inner"):
            with tprof.span("leaf"):
                pass
        with tprof.span("sibling"):
            pass
    t1 = time.time_ns()
    got = tprof.spans()
    assert _names(got) == ["leaf", "inner", "sibling", "outer"]
    assert all(isinstance(s, tprof.Span) for s in got)
    by = _by_name(got)
    assert t0 <= by["outer"].start_ns <= by["inner"].start_ns \
        <= by["leaf"].start_ns <= by["leaf"].end_ns <= by["inner"].end_ns \
        <= by["sibling"].start_ns <= by["sibling"].end_ns \
        <= by["outer"].end_ns <= t1
    assert recorder.dropped == 0


def test_exception_closes_and_records_the_spans(recorder):
    with pytest.raises(KeyError):
        with tprof.span("outer"):
            with tprof.span("inner"):
                raise KeyError("x")
    with tprof.span("after"):
        pass
    got = tprof.spans()
    assert _names(got) == ["inner", "outer", "after"]
    assert got[1].end_ns <= got[2].start_ns


def test_spans_of_every_thread_are_recorded(recorder):
    def other(k):
        for i in range(50):
            with tprof.span(f"thread{k}"):
                pass

    threads = [threading.Thread(target=other, args=(k,)) for k in range(4)]
    with tprof.span("main"):
        for th in threads:
            th.start()
        for th in threads:
            th.join(5)
    assert not any(th.is_alive() for th in threads)
    names = _names(tprof.spans())
    assert sorted(set(names)) == ["main", "thread0", "thread1", "thread2",
                                  "thread3"]
    assert len(names) == 201 and recorder.dropped == 0


def test_capacity_drops_the_oldest_and_counts(monkeypatch):
    rec = tprof.SpanRecorder(capacity=3)
    monkeypatch.setattr(tprof, "RECORDER", rec)
    for i in range(5):
        with tprof.span(f"s{i}"):
            pass
    assert _names(tprof.spans()) == ["s2", "s3", "s4"]
    assert rec.dropped == 2
    assert tprof.SpanRecorder().records.maxlen == tprof.CAPACITY == 65_536


def test_spans_lie_on_the_profilers_clock(recorder):
    with tprof.span("clock.warm"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with tprof.span(f"clock.{i}"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation()}
    got = [s for s in tprof.spans() if s.name != "clock.warm"]
    assert len(got) == 5
    for s in got:
        ev = events[s.name]
        assert abs(ev.start_ns() - s.start_ns) < 1_000_000
        assert abs(ev.start_ns() + ev.duration_ns() - s.end_ns) < 1_000_000


def test_span_never_synchronizes(recorder, monkeypatch):
    def synchronize(*args, **kwargs):
        raise AssertionError("a span synchronized")

    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    with tprof.span("no_sync"):
        torch.ones(8).sum()
    assert _names(tprof.spans()) == ["no_sync"]


@pytest.mark.parametrize("sampler", ["sample_scan", "sample_scan_record"])
def test_sampler_opens_a_span_per_step(recorder, sampler):
    """One `unipc.step` span a step, each a profiler range of that name
    around the step's model call."""
    cfg = unipc.UniPCConfig(num_steps=4)
    x0 = torch.randn(1, 2, 3)
    calls = []

    def model(x, t):
        calls.append(time.time_ns())
        return 0.1 * x + t

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = getattr(unipc, sampler)(model, x0, cfg)
    assert torch.isfinite(out if sampler == "sample_scan" else out[0]).all()
    steps = tprof.spans()
    assert _names(steps) == ["unipc.step"] * 4
    assert all(s.start_ns <= c <= s.end_ns for s, c in zip(steps, calls))
    ranges = [e for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation() and e.name() == "unipc.step"]
    assert len(ranges) == 4


class _ToyDiT(wan_dit.WanDiT):
    """`WanDiT.forward` (and its span) over `_toy_forward` in place of the
    DiT's computation (patched in by the test)."""

    def __init__(self):
        nn.Module.__init__(self)


def _toy_forward(model, latent, timestep, text, remat, lora, lora_cfg):
    return latent * 0.5 + text.mean()


class _Stop(Exception):
    pass


def test_prehook_exception_leaves_every_span_closed(recorder, monkeypatch):
    """A DiT pre-hook that raises at the third call, as the denoise
    benchmark's window does: every span open closes and is recorded, the
    third step's without a `dit.forward` (the hook runs before the
    module's forward), and a span after it records as usual."""
    monkeypatch.setattr(wan_dit, "_forward", _toy_forward)
    dit = _ToyDiT()
    calls, seen = [], []

    def pre(module, args):
        calls.append(1)
        if len(calls) == 3:
            raise _Stop

    def post(module, args, out):
        # the module's span is closed before its forward hooks run
        seen.append(_names(tprof.spans())[-1])

    dit.register_forward_pre_hook(pre)
    dit.register_forward_hook(post)
    text = torch.ones(1, 2, 4)
    with pytest.raises(_Stop):
        with tprof.span("t23d.denoise"):
            unipc.sample_scan(
                lambda x, t: wan_dit.forward(dit, x, t[None], text),
                torch.randn(1, 2, 3), unipc.UniPCConfig(num_steps=5))
    with tprof.span("after"):
        pass
    assert seen == ["dit.forward"] * 2
    assert _names(tprof.spans()) == [
        "dit.forward", "unipc.step", "dit.forward", "unipc.step",
        "unipc.step", "t23d.denoise", "after"]


def test_rasterize_opens_the_render_spans_per_view(recorder):
    rng = np.random.default_rng(3)
    g = 12
    means = rng.normal(0, 0.3, (g, 3)).astype(np.float32)
    means[:, 2] += 3.0
    covars = np.broadcast_to(0.02 * np.eye(3, dtype=np.float32),
                             (g, 3, 3)).copy()
    harm = rng.normal(0, 0.3, (g, 3, 4)).astype(np.float32)
    op = rng.uniform(0.3, 0.9, g).astype(np.float32)
    vms = np.stack([np.eye(4, dtype=np.float32)] * 2)
    vms[1, 0, 3] = 0.2
    K = np.array([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]], np.float32)
    T = torch.from_numpy
    rgb, _, _ = tr.rasterize(T(means), T(covars), T(harm), T(op), T(vms),
                             T(np.stack([K, K])), 16, 16)
    assert rgb.shape == (2, 16, 16, 3)
    assert _names(tprof.spans()) == list(RENDER_SPANS) * 2


def test_span_cost_is_small(recorder):
    """A span costs about what its profiler range does: recording adds
    microseconds, not milliseconds (a scene opens ~650)."""
    t0 = time.perf_counter()
    for _ in range(200):
        with tprof.span("cost"):
            pass
    assert (time.perf_counter() - t0) / 200 < 1e-3
    assert len(tprof.spans()) == 200
