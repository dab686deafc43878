"""The unfused torch glue of `nn/wan_dit.py`: the device share of the
"elementwise / copy / reduce" and "layer norm" groups over the traced
steps."""

from port_bench import trace as trace_mod
from port_bench.layer_metrics_common import group_share


def read(run):
    return group_share(run, trace_mod.GLUE_GROUPS)
