"""Mean host ms a frame of the span `track_ms` (outside the profiled stretch)."""

from port_bench.harness import mean


def read(trace):
    return mean(trace["spans"].get("track_ms", []))
