"""The least times of the program's kernels, frozen from the program's own
bench tools so that a later change to the program cannot move them.

Each function is the arithmetic of the tool's function with the counts it
derives from its inputs passed in (`tests/test_port_bench_bounds.py` holds
each to the tool's function on the same inputs):

* `gn_loop_ops_ms`: `tools/track_bench.loop_bound`'s operations (counted
  from `csrc/gn_track.cu`) at the issue rates of
  `tools/raycast_bench.py` (128 float32 and 64 int32 operations a clock an
  SM, 132 SMs at 1.98 GHz);
* `fuse_integrate_bound_ms`: `tools/fusion_bench.fuse_bounds`'s integrate
  launch (bytes: the tile list, the valid pixels' images, the directory
  sectors, 40 B a touched row, the merge's 80 B a row of a touched block;
  operations at 67 TFLOP/s), the larger.

Memory at 3.35 TB/s, the H100 SXM's published rate.
"""

from __future__ import annotations

MEM_BYTES_PER_S = 3.35e12
SMS, BOOST_HZ = 132, 1.98e9
F32_ISSUE_PER_S = 128 * SMS * BOOST_HZ    # 33.5e12
INT_ISSUE_PER_S = 64 * SMS * BOOST_HZ     # 16.7e12
FP32_PER_S = 67e12

# gn_track_loop (track_bench)
F32_OPS_PER_POINT, INT_OPS_PER_POINT = 24, 31
F32_OPS_PER_RESIDUAL, INT_OPS_PER_RESIDUAL = 96, 13
STEP_OPS = 381

# fuse_integrate (fusion_bench)
OPS_PER_RAY, OPS_PER_SAMPLE = 39, 40
IMAGE_BYTES_PER_PIXEL = 28

def gn_loop_ops_ms(n_points: int, residuals) -> float:
    """Least time (ms) of one frame's loop by its operations: every
    iteration's pass over `n_points` points with `residuals[k]` residuals,
    and its step."""
    f32 = sum(n_points * F32_OPS_PER_POINT + r * F32_OPS_PER_RESIDUAL
              for r in residuals) + STEP_OPS * len(residuals)
    ints = sum(n_points * INT_OPS_PER_POINT + r * INT_OPS_PER_RESIDUAL
               for r in residuals)
    return max((f32 + ints) / F32_ISSUE_PER_S, ints / INT_ISSUE_PER_S) * 1e3


def merge_bytes(rows: int, nf: int = 5) -> int:
    return rows * 4 * (4 * nf)


def fuse_integrate_bound_ms(*, valid: int, tiles: int, sectors: int,
                            rows: int, blocks: int, live: int,
                            voxels_per_block: int, pixels: int = 0,
                            samples_per_ray: int = 0, misses: int = 0,
                            opened: int = 0) -> tuple:
    """(least ms, "bytes" or "operations") of the integrate-and-merge
    launch on a frame with `valid` gated pixels in `tiles` warp tiles,
    `live` samples of weight > 0 over `sectors` distinct directory
    sectors, `rows` distinct touched voxel rows in `blocks` blocks; a frame
    that opens `opened` blocks adds every candidate's mark byte, the
    misses' keys and claims and 24 B a new block."""
    ops = (valid * OPS_PER_RAY + live * OPS_PER_SAMPLE) / FP32_PER_S * 1e3
    open_bytes = (pixels * samples_per_ray + 8 * misses + 24 * opened
                  if opened else 0)
    nbytes = (4 * tiles + valid * IMAGE_BYTES_PER_PIXEL + 32 * sectors
              + rows * 8 * 5 + open_bytes
              + merge_bytes(blocks * voxels_per_block))
    b = nbytes / MEM_BYTES_PER_S * 1e3
    return (b, "bytes") if b >= ops else (ops, "operations")
