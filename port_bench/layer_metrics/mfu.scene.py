"""The whole scene's share of the card's bf16 peak: the counted FLOP of
UMT5 over both prompts, the denoise's CFG steps, the VAE decode and the
stitched decoder (`flopcount.scene_flops`; the render is not counted) over
the mean `bench.scene` span outside the profiler."""

from port_bench import flopcount
from port_bench.layer_metrics_common import span_mean_s, t23d


def read(run):
    s = span_mean_s(run, "bench.scene")
    if not s:
        return None
    return 100.0 * flopcount.scene_flops(t23d(run)) / s \
        / flopcount.PEAK_BF16_FLOPS
