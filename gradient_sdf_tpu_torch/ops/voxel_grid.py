"""Block-sparse voxel grid: dense block directory + SoA voxel blocks.

Port of `gradient_sdf_tpu/ops/voxel_grid.py` (see its docstring for the
design): voxels live in dense 8x8x8 blocks stored as structure-of-arrays,
and a dense int32 block *directory* over the representable block volume
(dir_dim^3, 8 MB at the default 128^3) maps block coordinates to block
slots by arithmetic + one gather. The layout, `coarse_occ` included, is the
JAX package's, so a state converts between the packages array for array
(`utils/interop.py`).

What changes in PyTorch:
  * JAX's `mode="drop"` scatters become writes through a mask or into a
    sink element one past the end that is sliced off — torch `index_*`
    raises on out-of-range indices instead of dropping them.
  * The claim insert's scatter-min is `scatter_reduce_(..., "amin")` with
    int64 indices; slots are still assigned by cumsum in candidate order,
    so slot ids equal the JAX package's for the same candidate list.
  * Functions that write the directory, `coarse_occ` or `block_coords`
    update those tensors IN PLACE and return the grid with its new scalars
    (`num_active`, `overflow`, `oob_samples`); callers use the returned
    grid. At the app default the state is ~170 MB, and one copy is kept.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import GridConfig

EMPTY_KEY = -1
COARSE_FACTOR = 4  # blocks per coarse occupancy cell edge
INT32_MAX = 2**31 - 1


class VoxelGrid(NamedTuple):
    """The sparse SDF volume (`SdfVoxel{dist, grad, weight}`,
    `cpp/include/sdf_voxel/SdfVoxel.h:45-57`); fields as in the JAX
    package's VoxelGrid, all on one device."""

    directory: torch.Tensor     # int32 [dir_dim^3], block dir-index -> slot
    coarse_occ: torch.Tensor    # int32 [(dir_dim/4)^3], 1 = any block allocated
    num_active: torch.Tensor    # int32 [], allocated block count
    overflow: torch.Tensor      # bool [], sticky capacity-overflow flag
    oob_samples: torch.Tensor   # int32 [], sticky out-of-range sample counter
    block_coords: torch.Tensor  # int32 [num_blocks, 3]
    dist: torch.Tensor          # f32 [num_blocks, B^3], x fastest in a block
    weight: torch.Tensor        # f32 [num_blocks, B^3]
    grad_x: torch.Tensor        # f32 [num_blocks, B^3]
    grad_y: torch.Tensor
    grad_z: torch.Tensor

    @property
    def num_blocks(self) -> int:
        """Block capacity: the rows of `block_coords`, which a grid sharded
        over a mesh's block axis keeps whole (its per-voxel fields hold only
        the rank's rows; `parallel/sharding.py`)."""
        return self.block_coords.shape[0]

    @property
    def voxels_per_block(self) -> int:
        return self.dist.shape[1]

    @property
    def device(self) -> torch.device:
        return self.dist.device

    @property
    def grad(self) -> torch.Tensor:
        """Stacked [num_blocks, B^3, 3] copy for host-side consumers."""
        return torch.stack([self.grad_x, self.grad_y, self.grad_z], dim=-1)


def create(cfg: GridConfig, device) -> VoxelGrid:
    """An empty grid on `device` (required: nothing here picks one)."""
    nb, vpb = cfg.num_blocks, cfg.voxels_per_block
    d3 = cfg.dir_dim**3
    c3 = (cfg.dir_dim // COARSE_FACTOR) ** 3
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return VoxelGrid(
        directory=torch.full((d3,), EMPTY_KEY, **i32),
        coarse_occ=torch.zeros((c3,), **i32),
        num_active=torch.zeros((), **i32),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
        oob_samples=torch.zeros((), **i32),
        block_coords=torch.zeros((nb, 3), **i32),
        dist=torch.zeros((nb, vpb), **f32),
        weight=torch.zeros((nb, vpb), **f32),
        grad_x=torch.zeros((nb, vpb), **f32),
        grad_y=torch.zeros((nb, vpb), **f32),
        grad_z=torch.zeros((nb, vpb), **f32),
    )


# ---------------------------------------------------------------------------
# coordinate <-> directory index
# ---------------------------------------------------------------------------


def pack_key_xyz(x, y, z, cfg: GridConfig) -> torch.Tensor:
    """Block coordinate components -> directory linear index (int32);
    EMPTY_KEY where out of the directory's range."""
    D = cfg.dir_dim
    half = D // 2
    xs = x + half
    ys = y + half
    zs = z + half
    in_range = (
        (xs >= 0) & (xs < D) & (ys >= 0) & (ys < D) & (zs >= 0) & (zs < D)
    )
    key = (xs * D + ys) * D + zs
    return torch.where(in_range, key, torch.full_like(key, EMPTY_KEY))


def pack_key(block_coords: torch.Tensor, cfg: GridConfig) -> torch.Tensor:
    """(…,3)-tensor convenience wrapper over pack_key_xyz."""
    return pack_key_xyz(
        block_coords[..., 0], block_coords[..., 1], block_coords[..., 2], cfg
    )


def unpack_key(key: torch.Tensor, cfg: GridConfig) -> torch.Tensor:
    D = cfg.dir_dim
    half = D // 2
    z = key % D
    y = torch.div(key, D, rounding_mode="floor") % D
    x = torch.div(key, D * D, rounding_mode="floor")
    return torch.stack([x - half, y - half, z - half], dim=-1)


# ---------------------------------------------------------------------------
# voxel <-> block addressing
# ---------------------------------------------------------------------------


def point_to_voxel(points: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """World point -> nearest voxel index (reference `float2vox`,
    `MapGradPixelSdf.h:74-77`). `torch.round` is half-to-even like
    `jnp.round`."""
    return torch.round(points / voxel_size).to(torch.int32)


def voxel_to_point(voxel_idx: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """Voxel index -> world-space voxel center (reference `vox2float`), in
    float32 on the index's device."""
    return voxel_idx.to(torch.float32) * voxel_size


def voxel_to_block(voxel_idx: torch.Tensor, cfg: GridConfig):
    """Split voxel index into (block coords, intra-block linear offset);
    floor division, so negative indices land in the block below."""
    b = cfg.block_shape
    block = torch.div(voxel_idx, b, rounding_mode="floor")
    local = voxel_idx - block * b
    local_lin = (local[..., 2] * b + local[..., 1]) * b + local[..., 0]
    return block, local_lin


def block_local_to_voxel(block_coords: torch.Tensor,
                         cfg: GridConfig) -> torch.Tensor:
    """All B^3 voxel indices of given blocks: (…,3) -> (…,B^3,3)."""
    b = cfg.block_shape
    r = torch.arange(b, dtype=torch.int32, device=block_coords.device)
    lx = r.repeat(b * b)
    ly = r.repeat_interleave(b).repeat(b)
    lz = r.repeat_interleave(b * b)
    local = torch.stack([lx, ly, lz], dim=-1)  # [B^3, 3], x fastest
    return block_coords[..., None, :] * b + local


# ---------------------------------------------------------------------------
# lookup
# ---------------------------------------------------------------------------


def lookup_keys(grid: VoxelGrid, keys: torch.Tensor,
                cfg: GridConfig) -> torch.Tensor:
    """Directory indices (…,) -> block slots; -1 where absent/invalid."""
    d3 = cfg.dir_dim**3
    slot = grid.directory[torch.clamp(keys, 0, d3 - 1).long()]
    return torch.where(keys >= 0, slot, torch.full_like(slot, -1))


def lookup_voxels(grid: VoxelGrid, voxel_idx: torch.Tensor, cfg: GridConfig):
    """Voxel indices (…,3) -> (linear store index (…,), present mask (…,)).

    Absent voxels get index 0 with present=False (callers mask)."""
    block, local = voxel_to_block(voxel_idx, cfg)
    slot = lookup_keys(grid, pack_key(block, cfg), cfg)
    present = slot >= 0
    lin = torch.where(present, slot, torch.zeros_like(slot))
    return lin * cfg.voxels_per_block + local, present


def lookup_coarse(grid: VoxelGrid, points: torch.Tensor, cfg: GridConfig):
    """World points (…,3) -> coarse-cell occupancy (bool); False outside
    the representable volume. Cells of `block_shape * COARSE_FACTOR` voxels
    are found by floor division, so negative indices round down."""
    cell = cfg.block_shape * COARSE_FACTOR  # voxels per coarse cell edge
    C = cfg.dir_dim // COARSE_FACTOR
    c = torch.div(point_to_voxel(points, cfg.voxel_size), cell,
                  rounding_mode="floor") + C // 2
    in_range = torch.all((c >= 0) & (c < C), dim=-1)
    lin = torch.clamp((c[..., 0] * C + c[..., 1]) * C + c[..., 2], 0,
                      C * C * C - 1)
    return (grid.coarse_occ[lin.long()] > 0) & in_range


# ---------------------------------------------------------------------------
# insertion
# ---------------------------------------------------------------------------


def insert_new(grid: VoxelGrid, keys: torch.Tensor, want: torch.Tensor,
               cfg: GridConfig) -> VoxelGrid:
    """Allocate blocks for keys where `want` is set (duplicates allowed).

    Deterministic claim, as in the JAX package: every wanted key
    scatter-mins its candidate index into a claims array; per distinct key
    the lowest candidate wins and takes the next block slot in candidate
    order. Overflow sets the sticky flag and drops the claim. Writes the
    directory, `coarse_occ` and `block_coords` in place.
    """
    d3 = cfg.dir_dim**3
    n = keys.shape[0]
    dev = keys.device
    cand_ids = torch.arange(n, dtype=torch.int32, device=dev)

    # one sink element past the end takes the unwanted candidates
    claims = torch.full((d3 + 1,), INT32_MAX, dtype=torch.int32, device=dev)
    claims.scatter_reduce_(
        0, torch.where(want, keys, d3).long(),
        torch.where(want, cand_ids, INT32_MAX), "amin")
    won = want & (claims[torch.clamp(keys, 0, d3 - 1).long()] == cand_ids)

    order = torch.cumsum(won.to(torch.int32), 0, dtype=torch.int32) - 1
    new_slot = grid.num_active + order
    ok = won & (new_slot < grid.num_blocks)
    overflow = grid.overflow | torch.any(won & ~ok)

    keys_ok = keys[ok].long()
    slots_ok = new_slot[ok]
    grid.directory[keys_ok] = slots_ok
    # coarse occupancy: mark the 4^3-block cell of every new block
    D = cfg.dir_dim
    C = D // COARSE_FACTOR
    kz = keys_ok % D
    ky = torch.div(keys_ok, D, rounding_mode="floor") % D
    kx = torch.div(keys_ok, D * D, rounding_mode="floor")
    ckey = ((kx // COARSE_FACTOR) * C + (ky // COARSE_FACTOR)) * C + (
        kz // COARSE_FACTOR)
    grid.coarse_occ[ckey] = 1
    grid.block_coords[slots_ok.long()] = unpack_key(keys_ok, cfg).to(torch.int32)

    return grid._replace(
        num_active=grid.num_active + ok.sum(dtype=torch.int32),
        overflow=overflow,
    )


def insert_keys(grid: VoxelGrid, keys: torch.Tensor,
                cfg: GridConfig) -> VoxelGrid:
    """Allocate blocks for the given directory indices (1-D; duplicates and
    EMPTY_KEY padding allowed)."""
    existing = lookup_keys(grid, keys, cfg)
    want = (keys >= 0) & (existing < 0)
    return insert_new(grid, keys, want, cfg)


def ensure_blocks(grid: VoxelGrid, voxel_idx: torch.Tensor,
                  valid: torch.Tensor, cfg: GridConfig) -> VoxelGrid:
    """Allocate blocks for all (valid) voxel indices that need them
    (claim-based insert; duplicates fine, no deduplication needed)."""
    block, _ = voxel_to_block(voxel_idx.reshape(-1, 3), cfg)
    keys = pack_key(block, cfg)
    keys = torch.where(valid.reshape(-1), keys,
                       torch.full_like(keys, EMPTY_KEY))
    return insert_keys(grid, keys, cfg)


# ---------------------------------------------------------------------------
# growth (episodic host-side capacity increase)
# ---------------------------------------------------------------------------


def grow(grid: VoxelGrid, cfg: GridConfig, factor: int = 2):
    """Return (bigger_grid, bigger_cfg): block capacity scaled by `factor`.
    Slot ids are preserved, so growth is a pure array enlargement."""
    new_cfg = dataclasses.replace(cfg, num_blocks=cfg.num_blocks * factor)
    pad = new_cfg.num_blocks - cfg.num_blocks

    def ext(a):
        return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))], dim=0)

    big = grid._replace(
        block_coords=ext(grid.block_coords),
        dist=ext(grid.dist),
        weight=ext(grid.weight),
        grad_x=ext(grid.grad_x),
        grad_y=ext(grid.grad_y),
        grad_z=ext(grid.grad_z),
        overflow=torch.zeros((), dtype=torch.bool, device=grid.device),
    )
    return big, new_cfg


def grow_directory(grid: VoxelGrid, cfg: GridConfig, factor: int = 2):
    """Return (grid, cfg) with the directory's world range scaled by
    `factor` (dir_dim doubled by default -> representable volume 8x).
    Block storage and slot ids are untouched; the directory and the coarse
    occupancy mip are rebuilt from `block_coords`."""
    new_cfg = dataclasses.replace(cfg, dir_dim=cfg.dir_dim * factor)
    D = new_cfg.dir_dim
    C = D // COARSE_FACTOR
    dev = grid.device
    na = int(grid.num_active)
    coords = grid.block_coords[:na]
    slots = torch.arange(na, dtype=torch.int32, device=dev)

    keys = pack_key(coords, new_cfg)
    directory = torch.full((D**3,), EMPTY_KEY, dtype=torch.int32, device=dev)
    inr = keys >= 0
    directory[keys[inr].long()] = slots[inr]

    half = C // 2
    c = torch.div(coords, COARSE_FACTOR, rounding_mode="floor") + half
    ckey = (c[:, 0] * C + c[:, 1]) * C + c[:, 2]
    coarse = torch.zeros((C**3,), dtype=torch.int32, device=dev)
    coarse[ckey.long()] = 1

    big = grid._replace(
        directory=directory,
        coarse_occ=coarse,
        oob_samples=torch.zeros((), dtype=torch.int32, device=dev),
    )
    return big, new_cfg


MAX_DIR_DIM = 512  # 512^3 int32 = 536 MB spatial index


def handle_oob_growth(grid: VoxelGrid, cfg: GridConfig):
    """Grow the directory (factor 2, up to MAX_DIR_DIM) when fusion reported
    out-of-range samples, else warn and clear the counter. Returns
    (grid, cfg, grew: bool)."""
    from ..utils.logging_util import get_logger

    lost = int(grid.oob_samples)
    if lost == 0:
        return grid, cfg, False
    if cfg.dir_dim >= MAX_DIR_DIM:
        get_logger().warning(
            "%d samples beyond the maximum world range (dir_dim=%d) "
            "were dropped", lost, cfg.dir_dim)
        grid = grid._replace(oob_samples=torch.zeros_like(grid.oob_samples))
        return grid, cfg, False
    grid, cfg = grow_directory(grid, cfg)
    half = cfg.dir_dim // 2 * cfg.block_shape * cfg.voxel_size
    get_logger().warning(
        "Directory grown to dir_dim=%d (world range +-%.2f m); %d "
        "out-of-range samples from the triggering frame were dropped",
        cfg.dir_dim, half, lost)
    return grid, cfg, True


# ---------------------------------------------------------------------------
# field access helpers
# ---------------------------------------------------------------------------


def flat_field(x: torch.Tensor) -> torch.Tensor:
    """View a [num_blocks, B^3, ...] field as [num_blocks * B^3, ...]."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def host_voxels(grid: VoxelGrid, cfg: GridConfig):
    """Host view of the allocated blocks, one row per voxel: numpy arrays
    (voxel_idx [M,3], dist [M], weight [M], grad [M,3])."""
    na = int(grid.num_active)
    vox = block_local_to_voxel(grid.block_coords[:na], cfg).reshape(-1, 3)
    grad = torch.stack([grid.grad_x[:na], grid.grad_y[:na], grid.grad_z[:na]],
                       dim=-1).reshape(-1, 3)
    return (vox.cpu().numpy(), grid.dist[:na].reshape(-1).cpu().numpy(),
            grid.weight[:na].reshape(-1).cpu().numpy(), grad.cpu().numpy())
