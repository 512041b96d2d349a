"""Mean GN iterations a frame (`TrackResult.num_iters`)."""

from port_bench.harness import mean


def read(trace):
    return mean(trace["counters"].get("gn_iters", []))
