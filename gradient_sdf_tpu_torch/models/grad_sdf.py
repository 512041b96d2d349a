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

On one card, without a mesh and without visibility words, `update`
replays the frame's fusion as one CUDA graph (`CudaGraphRecorder`): the
normals, claim and integrate launches of `fusion.fuse_frame`, then two
copies of the growth flags into pinned host memory. The graph reads the
frame's depth and pose from static buffers it owns, and is keyed on
everything it captured by address or value (`_graph_key`: the grid's,
accumulator's, scratch's and camera cache's tensors, the frame's shape,
the configuration, the fusion method). A frame under a key not seen
before runs the direct launches; that frame warms what the capture must
not allocate, and the next frame under the same key captures and
replays. Growth, `restore`, `attach_mesh`, a new camera or a replaced
grid change the key and drop the graph. The CPU, the mesh and the
visibility maps (a per-frame keyframe slot is a by-value kernel
argument) take the direct launches always. Traced as the counters
`gsdf.fuse.graph_captures` and `gsdf.fuse.graph_replays`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..ops import fusion, normals, query
from ..ops import voxel_grid as vg
from ..ops.kernels import fuse_integrate, track_compact
from ..utils import device as device_mod
from ..utils import trace
from ..utils.logging_util import get_logger
from ..utils.ply import save_mesh_ply, save_point_cloud_ply


class CudaGraphRecorder:
    """A function's launches captured as one CUDA graph on `device`, not
    run; `replay()` enqueues them on the current stream and `wait()`
    waits for that stream. Captures on CUDA devices only (`fits`)."""

    @staticmethod
    def fits(device) -> bool:
        return device.type == "cuda"

    def __init__(self, fn, device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            fn()

    def replay(self):
        self.graph.replay()

    def wait(self):
        torch.cuda.current_stream(self.device).synchronize()


class _FuseGraph:
    """One fused frame of map `m` as a graph of `m.graph_recorder` (module
    note): `m._fuse` on the static buffers `depth` (f32 `shape`), `R`, `t`,
    then the grid's overflow flag and oob count copied into `flags` (int32
    [2], pinned on a card; the flag's byte is the first word's low byte).
    `key` is the map's `_graph_key` at the capture. The kernel wrappers'
    launch counters count the launches the capture made once a replay."""

    def __init__(self, m, key, shape):
        dev = m.device
        self.key = key
        self.depth = torch.empty(shape, dtype=torch.float32, device=dev)
        self.R = torch.empty((3, 3), dtype=torch.float32, device=dev)
        self.t = torch.empty(3, dtype=torch.float32, device=dev)
        self.flags = torch.zeros(2, dtype=torch.int32,
                                 pin_memory=dev.type == "cuda")
        before = trace.launches()
        self.graph = m.graph_recorder(lambda: self._frame(m), dev)
        # a capture runs nothing: its counts move to the replays
        self.launches = {k: n - before[k]
                         for k, n in trace.launches().items() if n != before[k]}
        trace.add_launches({k: -n for k, n in self.launches.items()})

    def _frame(self, m):
        m._fuse(self.depth, self.R, self.t, -1)
        g = m.grid
        self.flags.view(torch.uint8)[:1].copy_(
            g.overflow.view(torch.uint8).reshape(1), non_blocking=True)
        self.flags[1:].copy_(g.oob_samples.reshape(1), non_blocking=True)

    def replay(self, depth, R, t):
        """Enqueue the frame of `depth`, `R`, `t` (on the map's device)."""
        # one enqueue for the three copies: the device waits for the host
        # between separate ones
        torch._foreach_copy_([self.depth, self.R, self.t], [depth, R, t])
        self.graph.replay()
        trace.add_launches(self.launches)

    def read(self) -> list:
        """[overflow, oob_samples] after the frame: one wait."""
        self.graph.wait()
        return self.flags.tolist()


class GradSdfMap:
    # captures a fused frame as a graph (a test substitutes a stub)
    graph_recorder = CudaGraphRecorder

    def __init__(self, cfg: PipelineConfig, with_vis: bool = False,
                 device="cuda"):
        self.cfg = cfg
        # the card unless the caller names another device; raises without one
        self.device = device_mod.require(device)
        self.grid = vg.create(cfg.grid, self.device)
        self.mesh = None  # set by attach_mesh for multi-device operation
        # fusion's frame accumulator and its kernel's scratch (block marks,
        # claims, status, candidate and tile buffers): they live as long as
        # the map, the accumulator and the marks all-zero and the claims
        # INT32_MAX between frames (fuse_frame leaves them so); not saved
        # state
        self._new_scratch()
        self.counter = 0
        # capacity/world-range growth events, dumped by scan3d --metrics-json
        self.growth_events: list = []
        self.cache: Optional[normals.NormalEstimatorCache] = None
        # the tracker's compaction buffer (`track_buffer`), one per camera
        self._track_buf: Optional[track_compact.CompactBuffer] = None
        kf_words = max(1, -(-cfg.photo_ba.max_recorded_keyframes // 32))
        # uint32 bit patterns held in int32 (see fuse_integrate._kf_word_bit)
        self.vis = (
            torch.zeros((cfg.grid.num_blocks, cfg.grid.voxels_per_block,
                         kf_words), dtype=torch.int32, device=self.device)
            if with_vis else None
        )
        # the fused frame's graph, and the key of the last frame that ran
        # without one (module note)
        self._graph: Optional[_FuseGraph] = None
        self._graph_seen = None

    def _new_scratch(self):
        """The accumulator and the kernel's scratch, sized to the grid. A
        map on a mesh keeps no accumulator: its merge reads the frame's
        summed rows in place (`sharding.sharded_fuse_frame`)."""
        self.acc = (fusion.new_accumulator(self.grid) if self.mesh is None
                    else None)
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

    def track_buffer(self, shape, sampling: int):
        """The tracker's compaction buffer (`track_compact.new_buffer`) for
        depth frames of `shape` (H, W) at stride `sampling` on the map's
        device: allocated at the first frame and kept while the camera
        stays the same; not saved state."""
        if not track_compact.fits(self._track_buf, shape, sampling,
                                  self.device):
            self._track_buf = track_compact.new_buffer(shape, sampling,
                                                       self.device)
        return self._track_buf

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
        on the growth flags (one device->host read). On one card a replay
        of the frame's graph where it fits (module note). Traced as
        `gsdf.fuse.launch`, `gsdf.fuse.read` and, on a frame that grows the
        grid, `gsdf.fuse.grow` (`utils/trace`)."""
        with trace.span("gsdf.fuse.launch"):
            depth = self._tensor(depth)
            H, W = depth.shape
            self.ensure_cache(np.asarray(K), W, H)
            R, t = self._tensor(pose[0]), self._tensor(pose[1])
            graph = self._launch(depth, R, t, kf_slot)
        self.counter += 1
        with trace.span("gsdf.fuse.read"):
            if graph is None:
                overflow, oob = torch.stack(
                    [self.grid.overflow.to(torch.int32),
                     self.grid.oob_samples]).tolist()
            else:
                overflow, oob = graph.read()
        trace.count("gsdf.reads")
        if overflow or oob > 0:
            with trace.span("gsdf.fuse.grow"):
                if overflow:
                    self._grow()
                if oob > 0:
                    self._grow_directory()

    def _launch(self, depth, R, t, kf_slot) -> Optional[_FuseGraph]:
        """Enqueue the frame's fusion: a replay of the map's graph while its
        key holds; a capture and its replay where the last frame without a
        graph ran under this frame's key; else the direct launches (module
        note). Returns the graph replayed, or None."""
        if not (self.mesh is None and self.vis is None
                and self.graph_recorder.fits(self.device)):
            self._fuse(depth, R, t, kf_slot)
            return None
        key = self._graph_key(depth.shape)
        if self._graph is None or self._graph.key != key:
            self._graph = None
            if key != self._graph_seen:
                self._fuse(depth, R, t, kf_slot)
                # after the frame: it may have grown the scratch
                self._graph_seen = self._graph_key(depth.shape)
                return None
            self._graph = _FuseGraph(self, key, depth.shape)
            trace.count("gsdf.fuse.graph_captures")
        self._graph.replay(depth, R, t)
        trace.count("gsdf.fuse.graph_replays")
        return self._graph

    def _graph_key(self, shape) -> tuple:
        """What a graph of this map's fusion captures by address or value:
        the grid's, the accumulator's, the scratch's and the camera cache's
        tensors, the frame's shape, the grid and fusion configurations and
        the fusion method (its field count)."""
        tensors = (*self.grid, self.acc, *vars(self.scratch).values(),
                   *self.cache[:-1])
        return (tuple(map(torch.Tensor.data_ptr, tensors)), tuple(shape),
                self.cfg.grid, self.cfg.fusion, type(self)._fuse)

    def _fuse(self, depth, R, t, kf_slot):
        gcfg, fcfg = self.cfg.grid, self.cfg.fusion
        if self.mesh is not None:
            from ..parallel import sharding

            self.grid = sharding.sharded_fuse_frame(
                self.mesh, self.grid, depth, self.cache, R, t, gcfg, fcfg)
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
