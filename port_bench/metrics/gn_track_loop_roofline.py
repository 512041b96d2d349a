"""`gn_track_loop`'s share of its roofline over the profiled stretch (%):
its operations bound, each frame's iterations over its points."""

from port_bench import bounds
from port_bench.harness import roofline

KERNELS = ("gn_track_loop",)


def bound_ms(frame):
    return bounds.gn_loop_ops_ms(frame.points, [frame.residuals] * frame.iters)


def read(trace):
    return roofline(trace, "gn_track_loop_roofline")
