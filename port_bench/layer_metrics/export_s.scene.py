"""Seconds of a scene's `bench.export` span: the orbit render
(`kernels/rasterizer.py`) and the mp4 and PLY writers
(`io/video_export.py`, `io/ply_export.py`)."""

from port_bench.layer_metrics_common import span_mean_s


def read(run):
    return span_mean_s(run, "bench.export")
