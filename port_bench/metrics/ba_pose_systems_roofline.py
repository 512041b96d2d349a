"""`ba_pose_systems`' share of its roofline over the profiled solves (%):
the summed bound of every launch over the summed time of the kernel and of
its finish."""

from port_bench import ba_bounds
from port_bench.harness import roofline

KERNELS = ("ba_pose_systems", "ba_pose_finish")


def bound_ms(solve):
    return sum(ba_bounds.pose_systems_bound_ms(solve.V, solve.F, pairs)
               for mode, pairs in solve.launches if mode == "pose")


def read(trace):
    return roofline(trace, "ba_pose_systems_roofline")
