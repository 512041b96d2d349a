"""Frame-to-model rigid camera tracking: Gauss-Newton on SE(3).

Port of `gradient_sdf_tpu/models/tracker.py`
(`RigidPointOptimizer::optimize_sampled`, `RigidPointOptimizer.cpp:40-98`):
each iteration is one vectorized residual pass over the depth-valid pixels
— transform by the current pose, query the SDF, accumulate (E, g, H) =
(sum phi^2, sum phi J, sum J J^T) with J = [grad, p x grad] — then a 6x6
solve and pose <- exp(-xi) * pose. `mode="grad"` queries the semi-implicit
field: with `TrackerConfig.packed_row_gather` (the default) one gather per
residual of a 32-byte row packed once per frame, without it
`query.tsdf_grad` (five field gathers). `mode="trilinear"` is the
base-SDF ablation (`MapPixelSdf::tsdf`: 8 corner gathers, a residual
counts only where all 8 corners are observed, no packed rows).

The GN loop keeps the JAX loop's rules exactly:
  * at most `num_iterations` (25) iterations;
  * converged when ||xi||^2 < conv_threshold^2, tested BEFORE the update
    is applied (a converging step is not applied) (:86-91);
  * a NaN step is skipped and iteration continues (:94-95);
  * non-converged frames are not fused (`main_scan_3d.cpp:258-266`).
On a CUDA map the whole loop is one hand-written kernel,
`ops/kernels/gn_track.gn_track` (one thread-block cluster runs every
iteration on the card, as the JAX package's `lax.while_loop` does; it reads
the SoA fields, so `TrackerConfig.packed_row_gather` is a no-op there), and
the host reads its 20-byte status once per frame. On the CPU the loop is
the plain PyTorch one (`track_points_plain`, `gauss_newton`): one read per
iteration of the convergence and NaN flags, with or without the packed
rows. A mesh of ranks runs `gn_loop`: per iteration the one-pass launch
of the same kernel over its shard, an all_reduce, and `gn_track.gn_step`.

Depth-gating is pose-independent, so the valid pixels are compacted once
before the loop, to exactly the depth-valid count (a dynamic shape);
`TrackerConfig.compact_cap_frac` therefore has no effect here.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import FusionConfig, GridConfig, TrackerConfig
from ..ops import query
from ..ops import voxel_grid as vg
from ..ops.kernels import gn_track
from ..utils import se3


class TrackResult(NamedTuple):
    R: torch.Tensor     # (3,3) refined camera-to-world rotation
    t: torch.Tensor     # (3,)
    converged: bool
    num_iters: int      # iterations executed
    energy: float       # sum of squared residuals of the last iteration
    num_valid: int      # residual count in the last iteration


def _pack_fields(grid):
    """[nvox, 8] row-packed field tensor (dist, weight, gx, gy, gz, 0, 0, 0),
    built once per tracked frame: each GN iteration then gathers one 32-byte
    row per residual instead of five fields."""
    z = torch.zeros_like(vg.flat_field(grid.dist))
    return torch.stack(
        [vg.flat_field(grid.dist), vg.flat_field(grid.weight),
         vg.flat_field(grid.grad_x), vg.flat_field(grid.grad_y),
         vg.flat_field(grid.grad_z), z, z, z], dim=-1)


def _tsdf_grad_packed(grid, packed, points, gcfg, fcfg):
    """query.tsdf_grad semantics from the row-packed field tensor."""
    vs = gcfg.voxel_size
    vi = vg.point_to_voxel(points, vs)
    lin, present = vg.lookup_voxels(grid, vi, gcfg)
    row = packed[lin.long()]
    dist, weight = row[..., 0], row[..., 1]
    gx, gy, gz = row[..., 2], row[..., 3], row[..., 4]
    present = present & (weight > 0.0)
    inv_norm = 1.0 / torch.clamp(torch.sqrt(gx * gx + gy * gy + gz * gz),
                                 min=1e-12)
    s = fcfg.grad_scale * inv_norm
    cmp = vi.to(torch.float32) * vs - points
    phi = dist + s * (gx * cmp[..., 0] + gy * cmp[..., 1] + gz * cmp[..., 2])
    grad = torch.stack([s * gx, s * gy, s * gz], dim=-1)
    zero = torch.zeros_like(phi)
    phi = torch.where(present, phi, zero)
    grad = torch.where(present[..., None], grad, torch.zeros_like(grad))
    weight = torch.where(present, weight, zero)
    return phi, grad, weight


def _residual_pass(grid, points_cam, z_valid, R, t, gcfg, fcfg, packed=None,
                   mode: str = "grad"):
    """One linearization pass: returns (E, g, H, count) as device tensors.
    `mode="grad"` gathers one row of `packed` (from `_pack_fields`) per
    residual, or queries `query.tsdf_grad` (five field gathers) where
    `packed` is None; `mode="trilinear"` queries the grid's 8 corners and
    ignores `packed`.
    H = J^T J in full float32 (the JAX package pins Precision.HIGHEST,
    tracker.py:106; on the card TF32 must stay off)."""
    pts = se3.se3_apply(R, t, points_cam)
    if mode == "grad":
        if packed is not None:
            phi, grad, w0 = _tsdf_grad_packed(grid, packed, pts, gcfg, fcfg)
        else:
            phi, grad, w0 = query.tsdf_grad(grid, pts, gcfg, fcfg)
        valid = z_valid & (w0 > 0.0)
    elif mode == "trilinear":
        phi, grad, full = query.tsdf_trilinear(grid, pts, gcfg, fcfg)
        valid = z_valid & full
    else:
        raise ValueError(f"unknown tracking mode {mode!r}")
    phi = torch.where(valid, phi, torch.zeros_like(phi))
    grad = torch.where(valid[..., None], grad, torch.zeros_like(grad))

    J = torch.cat([grad, torch.linalg.cross(pts, grad, dim=-1)], dim=-1)
    E = torch.sum(phi * phi)
    g = torch.sum(phi[..., None] * J, dim=0)
    H = J.T @ J
    return E, g, H, valid.sum(dtype=torch.int32)


def adaptive_compact_cap(depth, fcfg, *, slack: float = 1.3,
                         floor: float = 0.125,
                         ceil_frac: float = 0.5) -> float:
    """The JAX package's `TrackerConfig.compact_cap_frac` choice from a
    frame's depth-valid fraction (host-side, numpy). Kept for API parity:
    the port compacts to exactly the valid pixels, so the cap is recorded
    in the config but does not change the work."""
    d = np.asarray(depth.cpu() if torch.is_tensor(depth) else depth)
    frac = float(np.mean((d > fcfg.z_min) & (d < fcfg.z_max)))
    target = frac * slack
    if target > ceil_frac:
        return 0.0
    return max(floor, math.ceil(target * 8.0) / 8.0)


def extrapolate_pose(R1, t1, R2, t2, alpha: float = 1.0):
    """Constant-velocity warm start: T_pred = T1 * exp(alpha * log(T2^{-1}
    T1)); alpha = 0 is the previous pose (the reference's init). See the
    JAX module for why the app damps it to 0.5 and keeps it opt-in."""
    R2i, t2i = se3.se3_inv(R2, t2)
    Rd, td = se3.se3_mul(R2i, t2i, R1, t1)
    if alpha != 1.0:
        xi = se3.se3_log(Rd, td) * alpha
        Rd, td = se3.se3_exp(xi)
    return se3.se3_mul(R1, t1, Rd, td)


def backproject_grid(depth: torch.Tensor, K, sampling: int = 1):
    """Depth image -> camera-frame points [N,3] + depth [N] (:62-70);
    `sampling` strides pixels like `optimize_sampled`."""
    H, W = depth.shape
    K = np.asarray(K, np.float32)
    fx, fy = float(K[0, 0]), float(K[1, 1])
    cx, cy = float(K[0, 2]), float(K[1, 2])
    dev = depth.device
    ys = torch.arange(0, H, sampling, dtype=torch.float32, device=dev)
    xs = torch.arange(0, W, sampling, dtype=torch.float32, device=dev)
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    z = depth[::sampling, ::sampling]
    x0 = (xg - cx) / fx
    y0 = (yg - cy) / fy
    pts = torch.stack([x0 * z, y0 * z, z], dim=-1).reshape(-1, 3)
    return pts, z.reshape(-1)


def compact_points(depth: torch.Tensor, K, fcfg: FusionConfig,
                   tcfg: TrackerConfig) -> torch.Tensor:
    """The frame's depth-valid camera-frame points [N, 3] (one host sync)."""
    pts_cam, z = backproject_grid(depth, K, tcfg.sampling)
    return pts_cam[(z > fcfg.z_min) & (z < fcfg.z_max)]


def track_frame(
    grid: vg.VoxelGrid,
    depth: torch.Tensor,
    K,
    R0: torch.Tensor,
    t0: torch.Tensor,
    gcfg: GridConfig,
    fcfg: FusionConfig,
    tcfg: TrackerConfig,
    mode: str = "grad",
) -> TrackResult:
    """Refine pose (R0, t0) against the current map for one depth frame:
    the loop kernel on a CUDA map, the plain loop on the CPU (module
    note)."""
    dev = depth.device
    if dev.type == "cuda" and tcfg.num_iterations < 1:
        # the JAX loop's condition is false at once: the start pose, not
        # converged, no iteration, no residual (and no launch: the loop
        # kernel takes at least one iteration)
        R, t = _pose_copy(R0, t0, dev)
        return TrackResult(R=R, t=t, converged=False, num_iters=0,
                           energy=0.0, num_valid=0)
    pts = compact_points(depth, K, fcfg, tcfg)
    if dev.type == "cuda":
        R, t = _pose_copy(R0, t0, dev)
        status = gn_track.gn_track(
            pts, R, t, grid, gcfg, fcfg, mode=mode,
            num_iterations=tcfg.num_iterations, damping=tcfg.damping,
            conv_sq=tcfg.conv_threshold * tcfg.conv_threshold)
        small, _, E, cnt, iters = status.tolist()
        return TrackResult(R=R, t=t, converged=small != 0.0,
                           num_iters=int(iters), energy=E, num_valid=int(cnt))
    return track_points_plain(grid, pts, R0, t0, gcfg, fcfg, tcfg, mode)


def _pose_copy(R0, t0, dev):
    """Contiguous float32 copies of the pose on `dev`, for the kernels to
    update in place."""
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=dev).clone(
        memory_format=torch.contiguous_format) for a in (R0, t0))


def track_points_plain(grid, pts, R0, t0, gcfg, fcfg, tcfg,
                       mode: str = "grad") -> TrackResult:
    """The plain PyTorch loop over compacted points: `_residual_pass`
    (with the packed rows where `tcfg.packed_row_gather` asks for them in
    grad mode) under `gauss_newton`. The CPU path of `track_frame`, and on
    the card the kernels' plain version."""
    valid = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    packed = (_pack_fields(grid)
              if mode == "grad" and tcfg.packed_row_gather else None)
    return gauss_newton(
        lambda R, t: _residual_pass(grid, pts, valid, R, t, gcfg, fcfg,
                                    packed, mode),
        R0, t0, tcfg, pts.device)


def gauss_newton(residual_pass, R0, t0, tcfg: TrackerConfig,
                 dev) -> TrackResult:
    """The plain GN loop (module note) around `residual_pass(R, t) -> (E,
    g, H, count)`: the step is `gn_track.gn_update`, and the host reads the
    two flags once per iteration."""
    conv_sq = tcfg.conv_threshold * tcfg.conv_threshold
    R = torch.as_tensor(R0, dtype=torch.float32, device=dev)
    t = torch.as_tensor(t0, dtype=torch.float32, device=dev)
    k, converged = 0, False
    E = cnt = None
    while k < tcfg.num_iterations and not converged:
        E, g, H, cnt = residual_pass(R, t)
        R, t, small, bad = gn_track.gn_update(H, g, R, t, tcfg.damping,
                                              conv_sq)
        converged = bool(small)
        k += 1
    return TrackResult(R=R, t=t, converged=converged, num_iters=k,
                       energy=float(E) if E is not None else 0.0,
                       num_valid=int(cnt) if cnt is not None else 0)


def gn_loop(reduce, R0, t0, tcfg: TrackerConfig, dev) -> TrackResult:
    """The GN loop (module note) with its body on the device and its
    control on the host: per iteration `reduce(R, t)` gives the residual
    sums (`gn_track.SUMS`), `gn_track.gn_step` solves and updates (R, t) in
    place, and the host reads the step's 16-byte status once. The mesh
    passes `gn_track.gn_residual_reduce` over its shard plus one all_reduce
    (`parallel/sharding.py`)."""
    conv_sq = tcfg.conv_threshold * tcfg.conv_threshold
    R, t = _pose_copy(R0, t0, dev)
    status = torch.zeros(4, dtype=torch.float32, device=dev)
    k, converged, E, cnt = 0, False, 0.0, 0.0
    while k < tcfg.num_iterations and not converged:
        gn_track.gn_step(reduce(R, t), R, t, status, damping=tcfg.damping,
                         conv_sq=conv_sq)
        small, _, E, cnt = status.tolist()
        converged = small != 0.0
        k += 1
    return TrackResult(R=R, t=t, converged=converged, num_iters=k,
                       energy=E, num_valid=int(cnt))


def track_and_fuse_frame(grid, depth, K, R0, t0, cache, gcfg, fcfg, tcfg,
                         mode: str = "grad", R_prev2=None, t_prev2=None,
                         warm_alpha: float = 1.0):
    """One Scan3D frame: GN tracking, then fusion of the refined pose if
    (and only if) tracking converged (main_scan_3d.cpp:258-266); the
    trilinear mode fuses without gradients, as the base-SDF map does. With
    (R_prev2, t_prev2), the pose before (R0, t0), tracking starts from the
    constant-velocity extrapolation. Returns (grid, TrackResult)."""
    from ..ops import fusion

    if R_prev2 is not None:
        R0, t0 = extrapolate_pose(R0, t0, R_prev2, t_prev2, warm_alpha)
    res = track_frame(grid, depth, K, R0, t0, gcfg, fcfg, tcfg, mode=mode)
    if res.converged:
        grid = fusion.fuse_frame(grid, depth, cache, res.R, res.t, gcfg, fcfg,
                                 accumulate_gradients=(mode == "grad"))
    return grid, res
