"""The benchmark's CPU tests: the checkout's root on the import path, and a
small copy of each cell for rehearsals on the CPU."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def small_scan_cell():
    """The scan3d cell at 320x240 on a grid of 2^12 blocks, with a path
    that sweeps 6 degrees out and back in 24 frames (0.5 degrees a frame)
    and a short profiled stretch: every rule of the cell at a size the CPU
    runs in seconds."""
    from port_bench import harness

    bench = harness.benchmark(ROOT)
    cell = harness.cell(bench, "scan3d-room-dense")
    cfg = copy.deepcopy(harness.config_of(bench, cell["config"], ROOT))
    traffic = copy.deepcopy(harness.data_file("traffic", cell["traffic"], ROOT))
    cfg["camera"].update(width=320, height=240, fx=262.5, fy=262.5, cx=159.5,
                         cy=119.5)
    cfg["grid"].update(num_blocks=4096)
    traffic["camera"].update(frames=24, arc_deg=6.0)
    traffic["check"].update(start_frames=3, window_frames=2, within_frames=4)
    traffic["trace"].update(after_s=0.2, frames=3)
    return bench, cell, cfg, traffic


@pytest.fixture
def scan_cell():
    return small_scan_cell()


@pytest.fixture
def cuda_device():
    """The card, decided inside the test: skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
