"""The hand-written flash attention's share of its roofline over the
traced scene: the bound of every predicted launch
(`flopcount.scene_attention_launches`) over the device time of the flash
kernels (`kernels/flash_attention.py` → `csrc/flash_attention_fwd_sm90.cu`)."""

from port_bench import flopcount
from port_bench.layer_metrics_common import flash_roofline, t23d


def read(run):
    return flash_roofline(run, flopcount.scene_attention_launches(t23d(run)))
