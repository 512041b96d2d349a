"""The device's idle share of the profiled stretch (%)."""

from port_bench.harness import idle_share


def read(trace):
    return idle_share(trace)
