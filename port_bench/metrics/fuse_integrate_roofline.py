"""`fuse_integrate`'s share of its roofline over the profiled stretch (%):
the larger of its bytes and operations bound on each fused frame."""

from port_bench import bounds
from port_bench.harness import roofline

KERNELS = ("fuse_integrate",)


def bound_ms(frame):
    if not frame.fused:
        return None
    return bounds.fuse_integrate_bound_ms(**frame.fusion)[0]


def read(trace):
    return roofline(trace, "fuse_integrate_roofline")
