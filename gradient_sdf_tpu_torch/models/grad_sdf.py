"""GradSdfMap: the gradient-SDF volume model (flagship map type).

Port of `gradient_sdf_tpu/models/grad_sdf.py`, single device: a stateful
wrapper bundling the block-sparse grid, visibility bitfield, frame counter
and camera LUT cache, with the reference's `Sdf` / `MapGradPixelSdf` API
(`Sdf.h:113-145`): `setup / update / tsdf / weights / extract_mesh /
extract_pc / save_sdf`. Tensors live on `device`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..ops import fusion, normals, query
from ..ops import voxel_grid as vg
from ..utils.logging_util import get_logger
from ..utils.ply import save_mesh_ply, save_point_cloud_ply


class GradSdfMap:
    def __init__(self, cfg: PipelineConfig, with_vis: bool = False,
                 device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.grid = vg.create(cfg.grid, self.device)
        # fusion's frame accumulator: scratch that lives as long as the map,
        # all-zero between frames (fuse_frame leaves it so); not saved state
        self.acc = fusion.new_accumulator(self.grid)
        self.counter = 0
        # capacity/world-range growth events, dumped by scan3d --metrics-json
        self.growth_events: list = []
        self.cache: Optional[normals.NormalEstimatorCache] = None
        kf_words = max(1, -(-cfg.photo_ba.max_recorded_keyframes // 32))
        # uint32 bit patterns held in int32 (see fusion._merge_vis)
        self.vis = (
            torch.zeros((cfg.grid.num_blocks, cfg.grid.voxels_per_block,
                         kf_words), dtype=torch.int32, device=self.device)
            if with_vis else None
        )

    # -- camera cache -------------------------------------------------------
    def ensure_cache(self, K: np.ndarray, width: int, height: int):
        if self.cache is None:
            self.cache = normals.build_cache(
                width, height, K, self.cfg.fusion.normal_window, self.device)

    def _tensor(self, x):
        """numpy array or tensor -> f32 tensor on the map's device."""
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # -- fusion -------------------------------------------------------------
    def setup(self, depth, K, pose=None, kf_slot: int = -1):
        """First-frame integration with identity pose (Sdf.h:119-121)."""
        if pose is None:
            pose = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        self.update(depth, K, pose, kf_slot=kf_slot)

    def update(self, depth, K, pose, kf_slot: int = -1):
        """Integrate one depth frame (MapGradPixelSdf.cpp:43-122), then act
        on the growth flags (one device->host read)."""
        depth = self._tensor(depth)
        H, W = depth.shape
        self.ensure_cache(np.asarray(K), W, H)
        R, t = self._tensor(pose[0]), self._tensor(pose[1])
        gcfg, fcfg = self.cfg.grid, self.cfg.fusion
        if self.vis is not None:
            self.grid, self.vis = fusion.fuse_frame(
                self.grid, depth, self.cache, R, t, gcfg, fcfg,
                vis=self.vis, kf_slot=kf_slot, acc=self.acc)
        else:
            self.grid = fusion.fuse_frame(self.grid, depth, self.cache, R, t,
                                          gcfg, fcfg, acc=self.acc)
        self.counter += 1
        overflow, oob = torch.stack([self.grid.overflow.to(torch.int32),
                                     self.grid.oob_samples]).tolist()
        if overflow:
            self._grow()
        if oob > 0:
            self._grow_directory()

    def _grow(self):
        """Episodic host-side capacity doubling on overflow (vg.grow)."""
        old_blocks = self.cfg.grid.num_blocks
        self.grid, new_gcfg = vg.grow(self.grid, self.cfg.grid)
        self.cfg = dataclasses.replace(self.cfg, grid=new_gcfg)
        # the accumulator is all-zero here, so growing it is a fresh one
        self.acc = fusion.new_accumulator(self.grid)
        if self.vis is not None:
            pad = new_gcfg.num_blocks - old_blocks
            self.vis = torch.cat(
                [self.vis, self.vis.new_zeros((pad,) + tuple(self.vis.shape[1:]))])
        get_logger().warning("Grid grown to %d blocks", new_gcfg.num_blocks)
        self.growth_events.append(
            {"frame": self.counter, "kind": "capacity",
             "num_blocks": int(new_gcfg.num_blocks)})

    def _grow_directory(self):
        """Enlarge the directory's world range when fusion reported samples
        beyond it; the reporting frame's out-of-range samples are lost."""
        lost = int(self.grid.oob_samples)
        self.grid, new_gcfg, grew = vg.handle_oob_growth(
            self.grid, self.cfg.grid)
        self.growth_events.append(
            {"frame": self.counter, "kind": "world_range",
             "dir_dim": int(new_gcfg.dir_dim), "oob_samples": lost,
             "grew": grew})
        if grew:
            self.cfg = dataclasses.replace(self.cfg, grid=new_gcfg)

    # -- queries ------------------------------------------------------------
    def tsdf(self, points):
        """Semi-implicit SDF + gradient at world points (…,3)."""
        phi, grad, _ = query.tsdf_grad(self.grid, self._tensor(points),
                                       self.cfg.grid, self.cfg.fusion)
        return phi, grad

    def weights(self, points):
        return query.weights_at(self.grid, self._tensor(points), self.cfg.grid)

    # -- export (host side) -------------------------------------------------
    def occupied(self):
        """Host view: (voxel_idx [M,3], dist [M], weight [M], grad [M,3])
        numpy arrays for all voxels in allocated blocks."""
        na = int(self.grid.num_active)
        vox = vg.block_local_to_voxel(self.grid.block_coords[:na], self.cfg.grid)
        vox = vox.reshape(-1, 3).cpu().numpy()
        dist = self.grid.dist[:na].reshape(-1).cpu().numpy()
        weight = self.grid.weight[:na].reshape(-1).cpu().numpy()
        grad = torch.stack([self.grid.grad_x[:na], self.grid.grad_y[:na],
                            self.grid.grad_z[:na]], dim=-1)
        return vox, dist, weight, grad.reshape(-1, 3).cpu().numpy()

    def extract_pc(self, filename: str, min_weight: float = 5.0) -> bool:
        """Oriented point cloud export (MapGradPixelSdf.cpp:177-220):
        voxels with weight >= min_weight whose displacement d = dist * 1.2 ghat
        stays inside the half-voxel box emit point (center - d), normal -1.2 ghat."""
        vox, dist, weight, grad = self.occupied()
        vs = self.cfg.grid.voxel_size
        scale = self.cfg.fusion.grad_scale
        norms = np.linalg.norm(grad, axis=-1)
        ok = (weight >= min_weight) & (norms > 1e-12)
        g = scale * grad[ok] / norms[ok, None]
        d = dist[ok, None] * g
        inside = np.all(np.abs(d) < 0.5 * vs, axis=-1)
        pts = vox[ok][inside] * vs - d[inside]
        nrm = -g[inside]
        return save_point_cloud_ply(filename, pts, normals=nrm)

    def extract_mesh(self, filename: str) -> bool:
        from ..ops import marching_cubes as mc

        verts, faces = mc.extract_mesh(self.grid, self.cfg.grid)
        return save_mesh_ply(filename, verts, faces)

    def save_sdf(self, filename: str) -> bool:
        """Sparse SDF text dump, format-compatible with the reference
        (`MapGradPixelSdf.cpp:222-296`): grid_info + `lin_idx value` lines in
        files _sdf_d/_sdf_weight/_sdf_n0/_sdf_n1/_sdf_n2."""
        vox, dist, weight, grad = self.occupied()
        occupied = weight > 0
        vox, dist, weight, grad = (
            vox[occupied], dist[occupied], weight[occupied], grad[occupied]
        )
        if vox.size == 0:
            return False
        vmin = vox.min(axis=0)
        vmax = vox.max(axis=0)
        dim = vmax - vmin + 1
        lin = (
            dim[0] * dim[1] * (vox[:, 2] - vmin[2])
            + dim[0] * (vox[:, 1] - vmin[1])
            + (vox[:, 0] - vmin[0])
        )
        vs = self.cfg.grid.voxel_size
        with open(filename + "_grid_info.txt", "w") as f:
            f.write(f"voxel size: {vs}\n")
            f.write(f"voxel dim: {dim[0]} {dim[1]} {dim[2]}\n")
            f.write(f"voxel min: {vmin[0]} {vmin[1]} {vmin[2]}\n")
            f.write(f"voxel max: {vmax[0]} {vmax[1]} {vmax[2]}\n")
        for suffix, values in [
            ("_sdf_d.txt", dist),
            ("_sdf_weight.txt", weight),
            ("_sdf_n0.txt", grad[:, 0]),
            ("_sdf_n1.txt", grad[:, 1]),
            ("_sdf_n2.txt", grad[:, 2]),
        ]:
            with open(filename + suffix, "w") as f:
                for li, v in zip(lin, values):
                    f.write(f"{li} {v}\n")
        return True
