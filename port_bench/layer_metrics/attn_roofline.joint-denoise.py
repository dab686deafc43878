"""The hand-written flash attention's share of its roofline in the
CogVideoX cell: row 1 (`csrc/flash_attention_fwd_sm90.cu` `<64, false>`)
at (2, 17,776, 48, 64), one launch a block, 42 a DiT forward.  The bound
of the predicted launches (42 × the traced `cogvideox.forward` spans) over
the device time of the flash kernels; silent when the traced
`launches_unmasked` differs from the prediction."""

from port_bench import flopcount_cogvideox as fc
from port_bench.layer_metrics_common import flash_roofline


def read(run):
    tr = run.trace_data
    if tr is None:
        return None
    forwards = sum(1 for name, *_ in tr.ranges
                   if name == "cogvideox.forward")
    if not forwards:
        return None
    return flash_roofline(run, fc.attention_launches(fc.ns(run.config["t2v"]),
                                                     forwards))
