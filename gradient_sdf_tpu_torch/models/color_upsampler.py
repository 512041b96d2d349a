"""ColorUpsampler: 2x2x2 subvoxel appearance + high-res colored extraction.

Port of `gradient_sdf_tpu/models/color_upsampler.py` (the reference's
`ColorUpsampler`, `cpp/include/ps_optimizer/ColorUpsampler.cpp`) on the
block-sparse grid:

  * init (:137-162): surface voxels (|dist| < sqrt(3) * voxel_size) of the
    LR map expand to `SdfVoxelHr`: 8 subvoxel distances
    d_k = dist + 0.25 * vs * (s_x gx + s_y gy + s_z gz) with ghat the unit
    gradient and s in {-1,+1}^3, x varying fastest
    (`SdfVoxel.h:91-99` / `centeredCubeCorners`, ColorUpsampler.cpp:97-110).
  * computeColor (:334-377): per-subvoxel albedo = mean RGB over visible
    keyframes of the projected subvoxel surface points
    x_k = c_k - d_k * ghat, clamped to [0, 1] (`setAlbedo` :217-236);
    a frame contributes only if ALL 8 subvoxels project in-image
    (`getIntensity` :168-203).
  * extractCloud (:251-327): per subvoxel with displacement inside the
    quarter-voxel box, emit (point, -ghat, rgb).
  * extractMesh (:240-249): marching cubes on the 2x-resolution lattice
    (centers at vs/2 * j + vs/4) with per-vertex interpolated color.

The voxel set (`HrVoxels`) is compacted on the host and held as numpy
arrays, as in the JAX package. `compute_color` runs on the device of the
images it is given, one keyframe after the other in frame order (the
[V, 8, 3] samples of all frames at once would be F times the memory for a
pass that runs once); `build_hr_grid` builds the half-voxel grid on the
device it is told.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import GridConfig
from ..ops import filters
from ..ops import marching_cubes as mc
from ..ops import voxel_grid as vg
from ..utils.ply import save_mesh_ply, save_point_cloud_ply
from .photo_ba import keyframe_visibility

# subvoxel corner signs, x fastest (matches SdfVoxelHr d-ordering)
_SIGNS = np.array(
    [[(1 if (i >> a) & 1 else -1) for a in range(3)] for i in range(8)],
    dtype=np.float32,
)


class HrVoxels(NamedTuple):
    """Host-compacted high-res voxel set (V surface voxels)."""

    vox: np.ndarray      # int32 [V, 3] LR voxel indices
    dist: np.ndarray     # f32 [V]
    weight: np.ndarray   # f32 [V]
    ghat: np.ndarray     # f32 [V, 3] unit gradients
    d: np.ndarray        # f32 [V, 8] subvoxel distances
    vis: np.ndarray      # bool [V, F]
    albedo: np.ndarray   # f32 [V, 8, 3] (filled by compute_color)


def build_hr_voxels(grid, vis_bits, kf_slots, gcfg: GridConfig) -> HrVoxels:
    """init: LR -> HR surface voxel expansion (ColorUpsampler.cpp:137-162).
    `vis_bits` is the map's int32 bitfield (uint32 bit patterns)."""
    vox, dist, weight, grad = vg.host_voxels(grid, gcfg)
    sel = (weight > 0) & (np.abs(dist) < np.sqrt(3.0) * gcfg.voxel_size)
    vox, dist, weight, grad = vox[sel], dist[sel], weight[sel], grad[sel]
    vis = keyframe_visibility(grid, vis_bits, kf_slots)[sel]

    norms = np.linalg.norm(grad, axis=-1, keepdims=True)
    ghat = grad / np.maximum(norms, 1e-12)
    d = dist[:, None] + 0.25 * gcfg.voxel_size * (_SIGNS @ ghat.T).T

    return HrVoxels(
        vox=vox.astype(np.int32), dist=dist, weight=weight, ghat=ghat,
        d=d.astype(np.float32), vis=vis,
        albedo=np.zeros((len(vox), 8, 3), np.float32),
    )


def compute_color(hr: HrVoxels, images: torch.Tensor, poses, K,
                  gcfg: GridConfig) -> HrVoxels:
    """computeColor (:334-377): mean observed RGB per subvoxel over visible
    keyframes; all-8-in-image gate per (voxel, frame); clamp to [0,1].
    `images` is a float32 tensor [F, H, W, 3]; the pass runs on its device."""
    dev = images.device

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    Kt = f32(K)
    fx, fy, cx, cy = Kt[0, 0], Kt[1, 1], Kt[0, 2], Kt[1, 2]
    vs = gcfg.voxel_size
    centers = hr.vox.astype(np.float32) * vs  # [V,3]
    sub_centers = centers[:, None, :] + 0.25 * vs * _SIGNS  # [V,8,3]
    surf = f32(sub_centers - hr.d[..., None] * hr.ghat[:, None, :])  # [V,8,3]
    vis_fv = torch.as_tensor(np.ascontiguousarray(hr.vis.T), device=dev)

    sums = torch.zeros((len(hr.vox), 8, 3), dtype=torch.float32, device=dev)
    count = torch.zeros((len(hr.vox),), dtype=torch.float32, device=dev)
    Rs = f32(np.stack([np.asarray(p[0], np.float32) for p in poses]))
    ts = f32(np.stack([np.asarray(p[1], np.float32) for p in poses]))
    for i in range(len(poses)):
        p = (surf - ts[i]) @ Rs[i]  # R^T (x - t)
        z = p[..., 2]
        safe_z = torch.where(torch.abs(z) > 1e-12, z, torch.ones_like(z))
        u = fx * p[..., 0] / safe_z + cx
        v = fy * p[..., 1] / safe_z + cy
        A, _, _, inb = filters.bilinear_sample_grad(images[i], u, v)  # [V,8,3]
        ok = torch.all(inb & (z > 0), dim=-1) & vis_fv[i]  # [V]
        sums += torch.where(ok[:, None, None], A, torch.zeros_like(A))
        count += ok.to(torch.float32)

    inv = 1.0 / torch.clamp(count, min=1.0)
    albedo = torch.clamp(sums * inv[:, None, None], 0.0, 1.0)
    albedo = torch.where(count[:, None, None] > 0, albedo,
                         torch.zeros_like(albedo))
    return hr._replace(albedo=albedo.cpu().numpy())


def extract_cloud(hr: HrVoxels, filename: str, gcfg: GridConfig,
                  min_weight: float = 5.0) -> bool:
    """extractCloud (:251-327)."""
    vs4 = 0.25 * gcfg.voxel_size
    visible = hr.vis.any(axis=1)
    keep_vox = visible & (hr.weight >= min_weight)

    centers = hr.vox.astype(np.float32) * gcfg.voxel_size
    sub_centers = centers[:, None, :] + vs4 * _SIGNS
    normal = -hr.ghat  # [V,3]
    disp = normal[:, None, :] * hr.d[..., None]  # [V,8,3]
    inside = np.all(np.abs(disp) < vs4, axis=-1) & keep_vox[:, None]
    inside &= np.all(np.isfinite(hr.albedo), axis=-1)

    pts = (sub_centers + disp)[inside]
    nrm = np.broadcast_to(normal[:, None, :], disp.shape)[inside]
    rgb = (hr.albedo[inside] * 255).astype(np.uint8)
    return save_point_cloud_ply(filename, pts, normals=nrm, colors=rgb)


def build_hr_grid(hr: HrVoxels, gcfg: GridConfig, device):
    """Scatter HR voxels into a half-voxel-size block-sparse grid for MC,
    on `device`.

    HR lattice: center(j) = (vs/2) * j + vs/4; subvoxel k of LR voxel i maps
    to j = 2i + (s_k - 1)/2  (i.e. 2i-1 or 2i per axis).
    Returns (hr_grid, color_field [num_blocks, B^3, 3], hr_gcfg)."""
    hr_gcfg = dataclasses.replace(
        gcfg,
        voxel_size=gcfg.voxel_size / 2.0,
        num_blocks=min(gcfg.num_blocks * 4, 2 ** 17),
        dir_dim=gcfg.dir_dim * 2,  # half-size voxels double the block range
    )
    hgrid = vg.create(hr_gcfg, device)

    signs = _SIGNS.astype(np.int32)  # {-1, 1}
    hr_idx = 2 * hr.vox[:, None, :] + (signs - 1) // 2  # [V,8,3]
    hr_idx = torch.as_tensor(hr_idx.reshape(-1, 3), dtype=torch.int32,
                             device=device)
    valid = torch.ones(len(hr_idx), dtype=torch.bool, device=device)

    hgrid = vg.ensure_blocks(hgrid, hr_idx, valid, hr_gcfg)
    lin, present = vg.lookup_voxels(hgrid, hr_idx, hr_gcfg)
    lin = lin[present].long()

    def flat(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device)[present]

    color_field = torch.zeros(tuple(hgrid.dist.shape) + (3,),
                              dtype=torch.float32, device=device)
    vg.flat_field(hgrid.dist)[lin] = flat(hr.d.reshape(-1))
    vg.flat_field(hgrid.weight)[lin] = flat(np.repeat(hr.weight, 8))
    vg.flat_field(color_field)[lin] = flat(hr.albedo.reshape(-1, 3))
    return hgrid, color_field, hr_gcfg


def extract_mesh_hr(hr: HrVoxels, filename: str, gcfg: GridConfig,
                    device) -> bool:
    """extractMesh via HR colored marching cubes, run on `device`."""
    hgrid, color_field, hr_gcfg = build_hr_grid(hr, gcfg, device)
    origin = gcfg.voxel_size / 4.0
    verts, faces, colors = mc.extract_mesh(
        hgrid, hr_gcfg, color_field=color_field, origin=origin
    )
    rgb = (np.clip(colors, 0.0, 1.0) * 255).astype(np.uint8)
    return save_mesh_ply(filename, verts, faces, vertex_colors=rgb)
