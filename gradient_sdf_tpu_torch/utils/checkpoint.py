"""Checkpoint / resume for the sparse SDF volume and trajectory.

Port of `gradient_sdf_tpu/utils/checkpoint.py`: the whole reconstruction
state (block-sparse grid, visibility bitfield, frame counter, poses so far)
goes into one compressed npz of plain numpy arrays, for `--resume` in Scan3D
and crash recovery in long runs. Keys, dtypes and the atomic write are the
JAX package's (format v2), so a file written by either package loads in the
other; the visibility words are uint32 in the file and int32 with the same
bit patterns in memory (`utils/interop`). `load_state` puts the tensors on
the card unless the caller names another device. Scratch that is sized to
the grid (the map's accumulator) is not saved: `GradSdfMap.restore`
rebuilds it.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..config import GridConfig
from ..ops import voxel_grid as vg
from . import device as device_mod
from . import interop

FORMAT_VERSION = 2  # v2 adds the GridConfig geometry (dir_dim may have grown)


def save_state(path: str, grid: vg.VoxelGrid, *, vis=None, counter: int = 0,
               poses=None, grid_cfg: Optional[GridConfig] = None,
               extra: Optional[dict] = None, mesh=None):
    """poses: list of (timestamp, R [3,3], t [3]). `grid_cfg` persists the
    grid geometry — mandatory for runs where capacity or directory growth
    fired (a stale dir_dim mis-linearizes every key on resume). With
    `mesh` the grid is a block shard (`parallel/sharding.py`): every rank
    calls, the whole grid is gathered, and rank 0 writes the same file a
    single-device run writes. On resume every rank loads it and the map is
    sharded again (`GradSdfMap.attach_mesh`)."""
    if mesh is not None:
        from ..parallel import sharding

        grid = sharding.gather_grid(mesh, grid)
        if mesh.rank != 0:
            return
    data = {"format_version": FORMAT_VERSION, "counter": counter}
    data.update(interop.grid_to_numpy(grid))
    if grid_cfg is not None:
        data["gcfg"] = np.asarray([
            grid_cfg.block_shape, grid_cfg.num_blocks, grid_cfg.dir_dim
        ], np.int64)
        data["gcfg_voxel_size"] = np.float64(grid_cfg.voxel_size)
    if vis is not None:
        data["vis"] = interop.vis_to_numpy(vis)
    if poses:
        data["pose_stamps"] = np.asarray([p[0] for p in poses])
        data["pose_R"] = np.stack([_host(p[1]) for p in poses])
        data["pose_t"] = np.stack([_host(p[2]) for p in poses])
    if extra:
        for k, v in extra.items():
            data["extra_" + k] = v
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **data)
    os.replace(tmp, path)


def _host(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def load_state(path: str, device=None):
    """Returns dict with grid and vis (or None) on `device` (default: the
    CUDA card, raising where there is none), counter, poses (list of
    (stamp, R, t) with numpy R, t) and grid_cfg."""
    device = device_mod.require() if device is None else device
    z = np.load(path, allow_pickle=False)
    grid = interop.grid_from_numpy(z, device)
    vis = interop.vis_from_numpy(z["vis"], device) if "vis" in z else None
    if "gcfg" in z:
        bs, nb, dd = (int(v) for v in z["gcfg"])
        grid_cfg = GridConfig(
            voxel_size=float(z["gcfg_voxel_size"]),
            block_shape=bs, num_blocks=nb, dir_dim=dd,
        )
    else:
        # legacy checkpoint: recover geometry from array shapes; voxel_size
        # was not recorded (NaN -> caller supplies it, e.g. from the CLI)
        grid_cfg = GridConfig(
            voxel_size=float("nan"),
            block_shape=round(z["dist"].shape[1] ** (1.0 / 3.0)),
            num_blocks=z["dist"].shape[0],
            dir_dim=round(len(z["directory"]) ** (1.0 / 3.0)),
        )
    poses = []
    if "pose_stamps" in z:
        for ts, R, t in zip(z["pose_stamps"], z["pose_R"], z["pose_t"]):
            poses.append((str(ts), R, t))
    return {
        "grid": grid,
        "vis": vis,
        "counter": int(z["counter"]),
        "poses": poses,
        "grid_cfg": grid_cfg,
    }
