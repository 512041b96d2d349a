"""The device's idle share of the profiled solves (%)."""

from port_bench.harness import idle_share


def read(trace):
    return idle_share(trace)
