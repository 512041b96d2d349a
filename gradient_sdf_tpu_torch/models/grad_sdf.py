"""GradSdfMap: the gradient-SDF volume model (flagship map type).

Port of `gradient_sdf_tpu/models/grad_sdf.py`: a stateful wrapper bundling
the block-sparse grid, visibility bitfield, frame counter and camera LUT
cache, with the reference's `Sdf` / `MapGradPixelSdf` API
(`Sdf.h:113-145`): `setup / update / tsdf / weights / extract_mesh /
extract_pc / save_sdf`. Tensors live on `device`: the CUDA card by default,
`device="cpu"` for tests and CPU callers.

`attach_mesh` switches a map to multi-device operation on a rank mesh
(`parallel/`): the grid's per-voxel storage is block-sharded and `update`
fuses through `sharding.sharded_fuse_frame`. Every rank then calls every
method: the queries and exports assemble the whole grid (a collective),
and only rank 0 writes files.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..ops import fusion, normals, query
from ..ops import voxel_grid as vg
from ..ops.kernels import fuse_integrate
from ..utils import device as device_mod
from ..utils.logging_util import get_logger
from ..utils.ply import save_mesh_ply, save_point_cloud_ply


class GradSdfMap:
    def __init__(self, cfg: PipelineConfig, with_vis: bool = False,
                 device="cuda"):
        self.cfg = cfg
        # the card unless the caller names another device; raises without one
        self.device = device_mod.require(device)
        self.grid = vg.create(cfg.grid, self.device)
        # fusion's frame accumulator and its kernel's scratch (block marks,
        # claim status, candidate buffer): they live as long as the map, the
        # accumulator and the marks all-zero between frames (fuse_frame
        # leaves them so); not saved state
        self._new_scratch()
        self.counter = 0
        # capacity/world-range growth events, dumped by scan3d --metrics-json
        self.growth_events: list = []
        self.mesh = None  # set by attach_mesh for multi-device operation
        self.cache: Optional[normals.NormalEstimatorCache] = None
        kf_words = max(1, -(-cfg.photo_ba.max_recorded_keyframes // 32))
        # uint32 bit patterns held in int32 (see fuse_integrate._kf_word_bit)
        self.vis = (
            torch.zeros((cfg.grid.num_blocks, cfg.grid.voxels_per_block,
                         kf_words), dtype=torch.int32, device=self.device)
            if with_vis else None
        )

    def _new_scratch(self):
        """The accumulator and the kernel's scratch, sized to the grid."""
        self.acc = fusion.new_accumulator(self.grid)
        self.scratch = fuse_integrate.new_scratch(self.grid)

    # -- multi-device -------------------------------------------------------
    def attach_mesh(self, mesh):
        """Run this map on `mesh` (`parallel.mesh.Mesh`, one per rank): the
        grid's per-voxel storage is resident-sharded over the block axis
        (`sharding.shard_grid`, 1/D_b of the fields per rank) on the rank's
        device, and `update` fuses through `sharded_fuse_frame`; growth
        re-shards. Call after a checkpoint restore (scan3d does)."""
        from ..parallel import sharding

        assert self.vis is None, "visibility recording is single-device only"
        self.mesh = mesh
        self.device = mesh.device
        self.grid = sharding.shard_grid(mesh, self.grid)
        self._new_scratch()
        self.cache = None

    def full_grid(self):
        """The whole grid: the map's own, or on a mesh the fields assembled
        over the block axis (a collective: every rank calls it)."""
        if self.mesh is None:
            return self.grid
        from ..parallel import sharding

        return sharding.gather_grid(self.mesh, self.grid)

    def _writes(self) -> bool:
        """Whether this process writes the map's files (rank 0 on a mesh)."""
        return self.mesh is None or self.mesh.rank == 0

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
        self._fuse(depth, R, t, kf_slot)
        self.counter += 1
        overflow, oob = torch.stack([self.grid.overflow.to(torch.int32),
                                     self.grid.oob_samples]).tolist()
        if overflow:
            self._grow()
        if oob > 0:
            self._grow_directory()

    def _fuse(self, depth, R, t, kf_slot):
        gcfg, fcfg = self.cfg.grid, self.cfg.fusion
        if self.mesh is not None:
            from ..parallel import sharding

            self.grid = sharding.sharded_fuse_frame(
                self.mesh, self.grid, depth, self.cache, R, t, gcfg, fcfg,
                acc=self.acc)
        elif self.vis is not None:
            self.grid, self.vis = fusion.fuse_frame(
                self.grid, depth, self.cache, R, t, gcfg, fcfg,
                vis=self.vis, kf_slot=kf_slot, acc=self.acc,
                scratch=self.scratch)
        else:
            self.grid = fusion.fuse_frame(self.grid, depth, self.cache, R, t,
                                          gcfg, fcfg, acc=self.acc,
                                          scratch=self.scratch)

    def restore(self, grid, grid_cfg=None, vis=None, counter: int = 0):
        """Take over a saved state (`utils/checkpoint.load_state`): the grid,
        its possibly grown geometry, the visibility words and the frame
        counter. Everything sized to the grid is rebuilt from the restored
        geometry: the accumulator and the kernel's scratch (never saved)
        would otherwise keep the sizes of the grid this map was created
        with."""
        self.grid = grid
        if grid_cfg is not None:
            self.cfg = dataclasses.replace(self.cfg, grid=grid_cfg)
        if (grid.num_blocks != self.cfg.grid.num_blocks
                or grid.directory.numel() != self.cfg.grid.dir_dim**3):
            raise ValueError(
                f"restored grid ({grid.num_blocks} blocks, directory of "
                f"{grid.directory.numel()}) does not fit {self.cfg.grid}")
        self._new_scratch()
        if vis is not None and self.vis is not None:
            self.vis = vis
        self.counter = counter

    def _grow(self):
        """Episodic host-side capacity doubling on overflow (vg.grow)."""
        old_blocks = self.cfg.grid.num_blocks
        # on a mesh doubling the capacity moves the shard boundaries: rows
        # change owner, so gather, grow, and slice again
        self.grid, new_gcfg = vg.grow(self.full_grid(), self.cfg.grid)
        if self.mesh is not None:
            from ..parallel import sharding

            self.grid = sharding.shard_grid(self.mesh, self.grid)
        self.cfg = dataclasses.replace(self.cfg, grid=new_gcfg)
        # the accumulator and the marks are all-zero here, so growing them
        # is a fresh pair
        self._new_scratch()
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
        beyond it; the reporting frame's out-of-range samples are lost.
        Slots are kept, so no shard row moves on a mesh."""
        lost = int(self.grid.oob_samples)
        self.grid, new_gcfg, grew = vg.handle_oob_growth(
            self.grid, self.cfg.grid)
        self.growth_events.append(
            {"frame": self.counter, "kind": "world_range",
             "dir_dim": int(new_gcfg.dir_dim), "oob_samples": lost,
             "grew": grew})
        if grew:
            self.cfg = dataclasses.replace(self.cfg, grid=new_gcfg)
        self.scratch = fuse_integrate.new_scratch(self.grid)

    # -- queries ------------------------------------------------------------
    def tsdf(self, points):
        """Semi-implicit SDF + gradient at world points (…,3)."""
        phi, grad, _ = query.tsdf_grad(self.full_grid(), self._tensor(points),
                                       self.cfg.grid, self.cfg.fusion)
        return phi, grad

    def weights(self, points):
        return query.weights_at(self.full_grid(), self._tensor(points),
                                self.cfg.grid)

    # -- export (host side; on a mesh every rank calls, rank 0 writes) -----
    def occupied(self):
        """Host view: (voxel_idx [M,3], dist [M], weight [M], grad [M,3])
        numpy arrays for all voxels in allocated blocks."""
        return vg.host_voxels(self.full_grid(), self.cfg.grid)

    def extract_pc(self, filename: str, min_weight: float = 5.0) -> bool:
        """Oriented point cloud export (MapGradPixelSdf.cpp:177-220):
        voxels with weight >= min_weight whose displacement d = dist * 1.2 ghat
        stays inside the half-voxel box emit point (center - d), normal -1.2 ghat."""
        vox, dist, weight, grad = self.occupied()
        if not self._writes():
            return True
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

        grid = self.full_grid()
        if not self._writes():
            return True
        verts, faces = mc.extract_mesh(grid, self.cfg.grid)
        return save_mesh_ply(filename, verts, faces)

    def save_sdf(self, filename: str) -> bool:
        """Sparse SDF text dump, format-compatible with the reference
        (`MapGradPixelSdf.cpp:222-296`): grid_info + `lin_idx value` lines in
        files _sdf_d/_sdf_weight/_sdf_n0/_sdf_n1/_sdf_n2."""
        vox, dist, weight, grad = self.occupied()
        if not self._writes():
            return True
        return write_sdf_dump(
            filename, self.cfg.grid.voxel_size, vox, weight,
            [("_sdf_d.txt", dist), ("_sdf_weight.txt", weight),
             ("_sdf_n0.txt", grad[:, 0]), ("_sdf_n1.txt", grad[:, 1]),
             ("_sdf_n2.txt", grad[:, 2])])


def write_sdf_dump(filename: str, voxel_size: float, vox, weight, columns):
    """Write `<filename>_grid_info.txt` and one `lin_idx value` file per
    (suffix, values) of `columns`, over the observed voxels (weight > 0) of
    the per-voxel host arrays. False (nothing written) on an empty map."""
    occupied = weight > 0
    vox = vox[occupied]
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
    with open(filename + "_grid_info.txt", "w") as f:
        f.write(f"voxel size: {voxel_size}\n")
        f.write(f"voxel dim: {dim[0]} {dim[1]} {dim[2]}\n")
        f.write(f"voxel min: {vmin[0]} {vmin[1]} {vmin[2]}\n")
        f.write(f"voxel max: {vmax[0]} {vmax[1]} {vmax[2]}\n")
    for suffix, values in columns:
        with open(filename + suffix, "w") as f:
            for li, v in zip(lin, values[occupied]):
                f.write(f"{li} {v}\n")
    return True
