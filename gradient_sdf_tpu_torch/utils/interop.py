"""State carried across packages: port `VoxelGrid` <-> dict of numpy arrays.

The dict's keys are those `gradient_sdf_tpu/utils/checkpoint.save_state`
writes (npz format v2), so `np.load` of a JAX checkpoint, or
`{k: np.asarray(v) for k, v in jax_grid._asdict().items()}`, gives a port
grid that computes the same thing — and `grid_to_numpy` gives arrays the
JAX package's `VoxelGrid(**{k: jnp.asarray(v) ...})` takes back.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.voxel_grid import VoxelGrid

_DTYPES = {
    "directory": torch.int32,
    "coarse_occ": torch.int32,
    "num_active": torch.int32,
    "overflow": torch.bool,
    "oob_samples": torch.int32,
    "block_coords": torch.int32,
    "dist": torch.float32,
    "weight": torch.float32,
    "grad_x": torch.float32,
    "grad_y": torch.float32,
    "grad_z": torch.float32,
}


def grid_from_numpy(d, device="cpu") -> VoxelGrid:
    """Dict (or npz) of numpy arrays with the checkpoint's keys -> VoxelGrid
    on `device`. A missing `oob_samples` (legacy checkpoints) reads as 0.
    The arrays are copied: the port updates its grid in place."""
    fields = {}
    for k, dt in _DTYPES.items():
        a = np.asarray(d[k]) if k in d else np.zeros((), np.int32)
        fields[k] = torch.tensor(a, dtype=dt, device=device)
    return VoxelGrid(**fields)


def grid_to_numpy(grid: VoxelGrid) -> dict:
    """VoxelGrid -> dict of host numpy arrays under the checkpoint's keys."""
    return {k: v.detach().cpu().numpy() for k, v in grid._asdict().items()}
