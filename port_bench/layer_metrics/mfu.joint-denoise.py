"""The whole CFG step's share of the card's bf16 peak in the CogVideoX
cell: the counted FLOP of one step (`flopcount_cogvideox.cfg_step_flops`:
the DiT over the CFG pair, 6.64×10¹⁴ at the published size) over the
window's time per step after the profiler stopped, as `denoise_step_ms`
counts it (the DiT, the CFG combine, the DDIM update and each request's
prompt embeddings)."""

from port_bench import flopcount_cogvideox as fc


def read(run):
    steps = run.counters.get("untraced_steps")
    if not steps:
        return None
    t2v = fc.ns(run.config["t2v"])
    return 100.0 * fc.cfg_step_flops(t2v) * steps \
        / run.counters["untraced_s"] / fc.PEAK_BF16_FLOPS
