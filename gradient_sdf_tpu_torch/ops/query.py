"""SDF queries: semi-implicit (gradient-SDF) and trilinear (baseline).

Port of `gradient_sdf_tpu/ops/query.py`. `tsdf_grad` / `weights_at`
(reference `MapGradPixelSdf::tsdf`/`weights`, `MapGradPixelSdf.h:109-125`):
the distance at a point is the nearest voxel's stored distance plus a
first-order correction along the stored (normalized, x1.2) gradient — one
gather per query. `tsdf_trilinear` / `weights_trilinear` are the base-SDF
ablation (`MapPixelSdf.cpp:43-111`, `MapPixelSdf.h:118-143`): 8-corner
interpolation with the analytic trilinear gradient, -T where no corner
exists and 0 where only some do. The transform math is the correct one;
the reference's double-applied transform (`MapPixelSdf.cpp:160`) is not
reproduced.
"""

from __future__ import annotations

import torch

from ..config import FusionConfig, GridConfig
from . import voxel_grid as vg


def tsdf_grad(grid: vg.VoxelGrid, points: torch.Tensor, gcfg: GridConfig,
              fcfg: FusionConfig):
    """Semi-implicit SDF query at world points (…,3).

    Returns (phi (…,), grad (…,3), weight (…,)); missing or never-observed
    voxels give zeros (callers gate on weight, `RigidPointOptimizer.cpp:72-75`).
    """
    vs = gcfg.voxel_size
    vi = vg.point_to_voxel(points, vs)
    lin, present = vg.lookup_voxels(grid, vi, gcfg)
    lin = lin.long()

    dist = vg.flat_field(grid.dist)[lin]
    weight = vg.flat_field(grid.weight)[lin]
    gx = vg.flat_field(grid.grad_x)[lin]
    gy = vg.flat_field(grid.grad_y)[lin]
    gz = vg.flat_field(grid.grad_z)[lin]
    # a voxel exists (reference: has a hash entry) only if it was observed
    present = present & (weight > 0.0)

    inv_norm = 1.0 / torch.clamp(torch.sqrt(gx * gx + gy * gy + gz * gz),
                                 min=1e-12)
    s = fcfg.grad_scale * inv_norm
    cmp = vi.to(torch.float32) * vs - points  # voxel_center - point
    phi = dist + s * (gx * cmp[..., 0] + gy * cmp[..., 1] + gz * cmp[..., 2])
    grad = torch.stack([s * gx, s * gy, s * gz], dim=-1)

    zero = torch.zeros_like(phi)
    phi = torch.where(present, phi, zero)
    grad = torch.where(present[..., None], grad, torch.zeros_like(grad))
    weight = torch.where(present, weight, zero)
    return phi, grad, weight


def weights_at(grid: vg.VoxelGrid, points: torch.Tensor, gcfg: GridConfig):
    """Nearest-voxel fusion weight (`MapGradPixelSdf.h:117-125`): 0 where
    the voxel is unallocated."""
    vi = vg.point_to_voxel(points, gcfg.voxel_size)
    lin, present = vg.lookup_voxels(grid, vi, gcfg)
    w = vg.flat_field(grid.weight)[lin.long()]
    return torch.where(present, w, torch.zeros_like(w))


def _corners(points: torch.Tensor, vs: float):
    """Lower-corner voxel index (…,3) of the cell holding each point, and the
    8 corner indices (…,8,3) in `meshgrid(indexing="ij")` order: x-major."""
    base = torch.floor(points / vs).to(torch.int32)
    r = torch.arange(2, dtype=torch.int32, device=points.device)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       dim=-1).reshape(8, 3)
    return base, offs, base[..., None, :] + offs


def tsdf_trilinear(grid: vg.VoxelGrid, points: torch.Tensor, gcfg: GridConfig,
                   fcfg: FusionConfig):
    """Trilinear TSDF query (baseline `MapPixelSdf::tsdf`,
    `MapPixelSdf.cpp:43-111`).

    Returns (phi (…,), grad (…,3), valid (…,)):
      * all 8 corners observed -> trilinear value + analytic gradient / vs,
      * no corner observed     -> phi = -T (extrapolation), invalid,
      * some corners observed  -> phi = 0, invalid.
    """
    vs = gcfg.voxel_size
    T = fcfg.trunc_voxels * vs
    # voxel centers sit at vs*i; frac is p's position between two centers
    base, offs, corners = _corners(points, vs)
    frac = torch.clamp(points / vs - base.to(torch.float32), 0.0, 1.0)

    lin, present = vg.lookup_voxels(grid, corners, gcfg)
    lin = lin.long()
    d = vg.flat_field(grid.dist)[lin]  # (…,8)
    w = vg.flat_field(grid.weight)[lin]
    present = present & (w > 0.0)  # existence = observed (see tsdf_grad)
    d = torch.where(present, d, torch.zeros_like(d))

    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    ox, oy, oz = offs[:, 0].long(), offs[:, 1].long(), offs[:, 2].long()
    wx = torch.stack([1 - fx, fx], dim=-1)[..., ox]  # (…,8)
    wy = torch.stack([1 - fy, fy], dim=-1)[..., oy]
    wz = torch.stack([1 - fz, fz], dim=-1)[..., oz]
    phi = torch.sum(wx * wy * wz * d, dim=-1)

    # analytic trilinear gradient (d interp / d point), chain rule 1/vs
    sign = torch.tensor([-1.0, 1.0], dtype=torch.float32, device=points.device)
    gx = torch.sum(sign[ox] * wy * wz * d, dim=-1)
    gy = torch.sum(wx * sign[oy] * wz * d, dim=-1)
    gz = torch.sum(wx * wy * sign[oz] * d, dim=-1)
    grad = torch.stack([gx, gy, gz], dim=-1) / vs

    num_present = present.sum(dim=-1)
    full = num_present == 8
    none = num_present == 0
    phi = torch.where(full, phi, torch.where(none, torch.full_like(phi, -T),
                                             torch.zeros_like(phi)))
    grad = torch.where(full[..., None], grad, torch.zeros_like(grad))
    return phi, grad, full


def weights_trilinear(grid: vg.VoxelGrid, points: torch.Tensor,
                      gcfg: GridConfig):
    """Minimum corner weight; 0 unless all 8 corners are observed
    (reference `MapPixelSdf.h:118-143`)."""
    _, _, corners = _corners(points, gcfg.voxel_size)
    lin, present = vg.lookup_voxels(grid, corners, gcfg)
    w = vg.flat_field(grid.weight)[lin.long()]
    present = present & (w > 0.0)
    w = torch.where(present, w, torch.zeros_like(w))
    full = present.all(dim=-1)
    return torch.where(full, w.min(dim=-1).values, torch.zeros_like(w[..., 0]))
