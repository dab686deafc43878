"""The whole CFG step's share of the card's bf16 peak: the counted FLOP
of one step (`flopcount.cfg_step_flops`) over the window's time per step
after the profiler stopped, as `denoise_step_ms` counts it (the DiT, the
CFG combine, the UniPC update and each request's prompt embeddings)."""

from port_bench import flopcount
from port_bench.layer_metrics_common import t23d


def read(run):
    steps = run.counters.get("untraced_steps")
    if not steps:
        return None
    return 100.0 * flopcount.cfg_step_flops(t23d(run)) * steps \
        / run.counters["untraced_s"] / flopcount.PEAK_BF16_FLOPS
