"""The share of the CogVideoX cell's traced steps in which no operation ran
on the device."""

from port_bench.layer_metrics_common import idle_share


def read(run):
    return idle_share(run)
