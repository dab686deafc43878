"""The hand-written flash attention's share of its roofline over the
traced steps: row 3 at (2, 4096, 40, 128), the bound of every predicted
launch over the device time of the flash kernels
(`kernels/flash_attention.py` → `csrc/flash_attention_fwd_sm90.cu`)."""

from port_bench import flopcount
from port_bench.layer_metrics_common import flash_roofline, t23d


def read(run):
    steps = run.counters.get("traced_steps")
    if not steps:
        return None
    cfg = t23d(run)
    (count, *shape), = flopcount.denoise_attention_launches(cfg)[
        "flash_natural"]
    per_step = count // cfg.num_inference_steps
    return flash_roofline(run, {"flash_natural": [(per_step * steps,
                                                   *shape)]})
