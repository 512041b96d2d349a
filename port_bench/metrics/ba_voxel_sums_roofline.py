"""`ba_voxel_sums`' share of its roofline over the profiled solves (%): the
summed bound of every energy, dist and mean launch over the summed time of
the kernel and of the energy's finish."""

from port_bench import ba_bounds
from port_bench.harness import roofline

KERNELS = ("ba_voxel_sums", "ba_energy_finish")


def bound_ms(solve):
    return sum(ba_bounds.ba_sums_bound_ms(solve.V, solve.F, pairs, mode)
               for mode, pairs in solve.launches if mode != "pose")


def read(trace):
    return roofline(trace, "ba_voxel_sums_roofline")
