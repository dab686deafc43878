"""The unfused torch glue of `nn/cogvideox_dit.py` (the expert adaptive
LayerNorm's modulations and gates, the per-head q/k LayerNorm, the RoPE on
the video slice, the fp32 residuals): the device share of the
"elementwise / copy / reduce" and "layer norm" groups over the traced
steps."""

from port_bench import trace as trace_mod
from port_bench.layer_metrics_common import group_share


def read(run):
    return group_share(run, trace_mod.GLUE_GROUPS)
