"""Seconds of a scene's `bench.denoise` span: the 50 UniPC steps with CFG
over the DiT (`diffusion/unipc.py`, `nn/wan_dit.py`)."""

from port_bench.layer_metrics_common import span_mean_s


def read(run):
    return span_mean_s(run, "bench.denoise")
