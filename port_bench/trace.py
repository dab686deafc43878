"""The device trace of a traced run, reduced to what the per-layer readers
and the result's `breakdown` need.

`traced(fn)` runs fn() under `torch.profiler` (CPU and CUDA activities)
and keeps, from the raw Kineto events, each device operation (kernel,
copy, set) as (name, start, end) and each host range
(`record_function`: the benchmark's `bench.*` spans and the program's
`t23d.*`, `decode.*`, `export.*`, `render.*`) as (name, start, end), in
seconds on the trace's clock.  `kernel_group` is copied from the port's
`chip_smoke.py::_kernel_group`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


def kernel_group(name: str) -> str:
    low = name.lower()
    d64 = any(t in low for t in ("kernel<64", "kernelili64"))
    if "flash_fwd_f32_sm90_kernel" in low:
        return "flash attention forward, fp32 3×TF32 wgmma (this repo)"
    if "flash_bwd_dkv_f32_sm90_kernel" in low \
            or "flash_bwd_dq_f32_sm90_kernel" in low:
        return "flash attention backward, fp32 3×TF32 wgmma (this repo)"
    if "tf32_split_planes" in low:
        return "flash attention fp32 split planes (this repo)"
    if "flash_fwd_sm90_kernel" in low:
        return ("flash attention, bf16 D = 64, wgmma (this repo)" if d64
                else "flash attention, natural D = 128, wgmma (this repo)")
    if "flash_bwd_dkv_sm90_kernel" in low or "flash_bwd_dq_sm90_kernel" in low:
        return ("flash attention backward, bf16 D = 64, wgmma (this repo)"
                if d64 else
                "flash attention backward, natural D = 128, wgmma (this repo)")
    if "flash_fwd_kernel<128>" in low or "flash_fwd_kernelili128" in low:
        return "flash attention, natural D = 128 (this repo)"
    if "flash_bwd_dkv_bf16_kernel<128>" in low \
            or "flash_bwd_dq_bf16_kernel<128>" in low:
        return "flash attention backward, bf16 D = 128 (this repo)"
    if "bf16_kernel" in low and "flash_bwd_" in low:
        return "flash attention backward, bf16 D = 64 (this repo)"
    if "flash_fwd_kernel" in low:
        return "flash attention (this repo)"
    if any(t in low for t in ("conv", "cudnn", "implicit_convolve", "wgrad",
                              "dgrad", "fprop")):
        return "convolution (cuDNN)"
    if "memcpy" in low:
        return "host-to-device copies"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "sm90_", "gemv",
                              "nvjet")):
        return "matmul (cuBLAS)"
    if "composite_fwd_kernel" in low:
        return "rasterizer composite (this repo)"
    if "composite_bwd_kernel" in low:
        return "rasterizer composite backward (this repo)"
    if any(t in low for t in ("sort", "radix", "quantile", "topk")):
        return "sort / quantile"
    if "layer_norm" in low or "layernorm" in low:
        return "layer norm"
    if any(t in low for t in ("elementwise", "vectorized", "unrolled",
                              "reduce", "cat", "copy", "index", "fill")):
        return "elementwise / copy / reduce"
    return "other"


FLASH_GROUP_PREFIX = "flash attention"
GLUE_GROUPS = ("elementwise / copy / reduce", "layer norm")


@dataclass
class Trace:
    ops: list = field(default_factory=list)      # (name, start_s, end_s)
    ranges: list = field(default_factory=list)   # (name, start_s, end_s)
    window: tuple = (0.0, 0.0)                   # the traced span
    wall_s: float = 0.0                          # host clock around fn()

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        window, sorted."""
        lo, hi = self.window
        iv = sorted((max(s, lo), min(e, hi)) for _, s, e in self.ops
                    if e > lo and s < hi)
        out = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                if e > out[-1][1]:
                    out[-1][1] = e
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def device_s_by(self, key) -> dict:
        out = {}
        for name, s, e in self.ops:
            k = key(name)
            out[k] = out.get(k, 0.0) + (e - s)
        return out

    def idle_gaps(self) -> list:
        """Each gap between busy intervals inside the window, as
        (host range that covers its middle, seconds): the innermost range
        (the latest to start) that holds the gap's midpoint, or
        "no range" outside every range."""
        lo, hi = self.window
        edges = [lo]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(hi)
        ranges = sorted(self.ranges, key=lambda r: r[1])
        gaps = []
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            label = "no range"
            for name, s, e in ranges:
                if s > mid:
                    break
                if e >= mid:
                    label = name
            gaps.append((label, b - a))
        return gaps

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.device_s_by(lambda n: n).items(),
                     key=lambda kv: -kv[1])[:top]
        gaps = {}
        for label, s in self.idle_gaps():
            gaps[label] = gaps.get(label, 0.0) + s
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:200], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in idle]}


WINDOW_RANGE = "bench.traced"


class Tracer:
    """The profiler between `start()` and `stop()`, inside the range
    `bench.traced`, whose extent is the trace's window."""

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        self.range = record_function(WINDOW_RANGE)
        self.range.__enter__()

    def stop(self) -> Trace:
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self.range.__exit__(None, None, None)
        wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        tr = Trace(wall_s=wall)
        for ev in self.prof.profiler.kineto_results.events():
            s = ev.start_ns() * 1e-9
            e = s + ev.duration_ns() * 1e-9
            if ev.device_type() == DeviceType.CUDA:
                if not ev.is_user_annotation():
                    tr.ops.append((ev.name(), s, e))
            elif ev.is_user_annotation():
                if ev.name() == WINDOW_RANGE:
                    tr.window = (s, e)
                else:
                    tr.ranges.append((ev.name(), s, e))
        self.prof = None
        if not tr.ops:
            raise RuntimeError("the profiler recorded no device operation")
        return tr


def traced(fn) -> tuple[object, Trace]:
    """fn() under a `Tracer` → (fn's result, Trace)."""
    tracer = Tracer()
    tracer.start()
    out = fn()
    return out, tracer.stop()
