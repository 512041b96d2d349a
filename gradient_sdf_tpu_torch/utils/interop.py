"""State carried across packages, as numpy arrays.

Grid: port `VoxelGrid` <-> dict of numpy arrays.

The dict's keys are those `gradient_sdf_tpu/utils/checkpoint.save_state`
writes (npz format v2), so `np.load` of a JAX checkpoint, or
`{k: np.asarray(v) for k, v in jax_grid._asdict().items()}`, gives a port
grid that computes the same thing — and `grid_to_numpy` gives arrays the
JAX package's `VoxelGrid(**{k: jnp.asarray(v) ...})` takes back.

PhotoBA: `BAProblem` / `BAState` <-> dicts of numpy arrays under the field
names both packages share (`jax_problem._asdict()` through `np.asarray`
gives such a dict). `HrVoxels` is a tuple of host numpy arrays in both
packages, so it crosses field by field. The visibility bitfield is uint32
in the JAX package and int32 with the same bit patterns here (torch's
uint32 has no shifts).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.color_upsampler import HrVoxels
from ..models.photo_ba import BAProblem, BAState
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


def _record_from_numpy(cls, d, device):
    """NamedTuple of tensors from a mapping of numpy arrays, dtypes kept
    (copies: numpy views of JAX arrays are read-only)."""
    return cls(**{k: torch.tensor(np.asarray(d[k]), device=device)
                  for k in cls._fields})


def _record_to_numpy(rec) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in rec._asdict().items()}


def problem_from_numpy(d, device="cpu") -> BAProblem:
    """Mapping with `BAProblem`'s field names -> BAProblem on `device`."""
    return _record_from_numpy(BAProblem, d, device)


def state_from_numpy(d, device="cpu") -> BAState:
    """Mapping with `BAState`'s field names -> BAState on `device`."""
    return _record_from_numpy(BAState, d, device)


def problem_to_numpy(problem: BAProblem) -> dict:
    return _record_to_numpy(problem)


def state_to_numpy(state: BAState) -> dict:
    return _record_to_numpy(state)


def hr_from_numpy(d) -> HrVoxels:
    """Mapping with `HrVoxels`' field names (the JAX package's
    `hr._asdict()`) -> the port's HrVoxels, host numpy arrays."""
    return HrVoxels(**{k: np.array(d[k]) for k in HrVoxels._fields})


def hr_to_numpy(hr: HrVoxels) -> dict:
    return {k: np.asarray(v) for k, v in hr._asdict().items()}


def vis_from_numpy(words, device="cpu") -> torch.Tensor:
    """The JAX package's uint32 visibility words -> the port's int32 tensor
    holding the same bit patterns."""
    a = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    return torch.tensor(a.view(np.int32), device=device)


def vis_to_numpy(vis: torch.Tensor) -> np.ndarray:
    """The port's int32 visibility tensor -> uint32 words."""
    return vis.detach().cpu().numpy().view(np.uint32)
