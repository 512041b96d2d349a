"""The least times of PhotoBA's two kernels, frozen from the program's bench
tool (`tools/ba_bench.ba_sums_bound_ms` and `pose_systems_bound_ms`) so
that a later change to the program cannot move them. Each takes the
counts the tool derives from its inputs: V voxels, F frames and the
(voxel, frame) pairs that take part under the pass's gates, which the
benchmark counts with its own reference (`reference/photo_ba.pair_counts`).
`tests/test_port_bench_ba.py` holds each to the tool's function on the
same inputs.

Bytes: every per-voxel input once (vox 12, grad 12, dist 4, vmask 1, the
F visibility flags; the dist step's weight 4; the pose systems' n and
mean 16), the poses (48 B a frame) and K (36), 4 x 12 B of taps a pair,
and the outputs (the energy 4 B, the dist 4 B a voxel, n and the mean 16;
H and b 42 floats a frame), at 3.35 TB/s. Operations: float32 operations
a pair, counted from `csrc/ba_terms.cu` (built without fused
multiply-adds, so each is one instruction), and 30 a voxel, at 128 a clock an
SM on 132 SMs at 1.98 GHz. The bound is the larger.
"""

from __future__ import annotations

MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 128 * 132 * 1.98e9     # 33.5e12

# a pair's sample 67, the intensity gate 6, dA/du and dA/dv 26, dI/dp 24
SAMPLE_OPS, TRUNC_OPS, GRAD_OPS, JAC_OPS = 67, 6, 26, 24
PAIR_OPS = {
    "energy": SAMPLE_OPS + 9,                       # n, sum A, sum |A|^2
    "mean": SAMPLE_OPS + TRUNC_OPS + 4,             # n, sum A
    # -R^T g 18, Jd 15, five sums 19
    "dist": SAMPLE_OPS + TRUNC_OPS + GRAD_OPS + JAC_OPS + 18 + 15 + 19,
    # Jc 81, H's 21 entries 168, b's 6 30, r 3
    "pose": SAMPLE_OPS + TRUNC_OPS + GRAD_OPS + JAC_OPS + 81 + 168 + 30 + 3,
}
VOXEL_OPS = 30


def _ms(nbytes: float, ops: float) -> float:
    return max(nbytes / MEM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def ba_sums_bound_ms(V: int, F: int, pairs: int, mode: str) -> float:
    """`ba_voxel_sums` in `mode` ("energy", "dist" or "mean")."""
    per_voxel = 12 + 12 + 4 + 1 + F + (4 if mode == "dist" else 0)
    out = {"energy": 4, "dist": 4 * V, "mean": 16 * V}[mode]
    fixed = V * per_voxel + F * 48 + 36 + out
    return _ms(fixed + 48 * pairs, PAIR_OPS[mode] * pairs + VOXEL_OPS * V)


def pose_systems_bound_ms(V: int, F: int, pairs: int) -> float:
    """`ba_pose_systems`."""
    fixed = V * (12 + 12 + 4 + 1 + F + 16) + F * 48 + 36 + F * 42 * 4
    return _ms(fixed + 48 * pairs, PAIR_OPS["pose"] * pairs + VOXEL_OPS * V)
