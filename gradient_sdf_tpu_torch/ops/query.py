"""SDF queries: the semi-implicit (gradient-SDF) lookup.

Port of `tsdf_grad` and `weights_at` of `gradient_sdf_tpu/ops/query.py`
(reference `MapGradPixelSdf::tsdf`/`weights`, `MapGradPixelSdf.h:109-125`):
the distance at a point is the nearest voxel's stored distance plus a
first-order correction along the stored (normalized, x1.2) gradient — one
gather per query. The trilinear pair of the base-SDF ablation is not
ported yet.
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
