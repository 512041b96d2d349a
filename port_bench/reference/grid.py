"""The block-sparse grid of the reference: a dense directory over block
coordinates and 8^3-voxel blocks of SoA fields (the program's layout, so
that a snapshot of the program's state reads as one)."""

from __future__ import annotations

import torch

EMPTY = -1


class Grid:
    """directory int32 [D^3] (slot or -1), block_coords int32 [cap, 3],
    num_active (int), overflow (bool), oob (int), fields [cap, B^3]: dist,
    weight, gx, gy, gz in the working float type."""

    def __init__(self, directory, block_coords, num_active, fields,
                 dir_dim, block_shape, voxel_size, overflow=False, oob=0):
        self.directory = directory
        self.block_coords = block_coords
        self.num_active = int(num_active)
        self.dist, self.weight, self.gx, self.gy, self.gz = fields
        self.dir_dim = dir_dim
        self.block_shape = block_shape
        self.voxel_size = voxel_size
        self.overflow = overflow
        self.oob = oob

    @property
    def capacity(self) -> int:
        return self.block_coords.shape[0]

    @property
    def fields(self):
        return [self.dist, self.weight, self.gx, self.gy, self.gz]

    @classmethod
    def empty(cls, capacity, dir_dim, block_shape, voxel_size, device,
              dtype=torch.float32):
        v = block_shape ** 3
        return cls(torch.full((dir_dim ** 3,), EMPTY, dtype=torch.int32,
                              device=device),
                   torch.zeros((capacity, 3), dtype=torch.int32, device=device),
                   0, [torch.zeros((capacity, v), dtype=dtype, device=device)
                       for _ in range(5)], dir_dim, block_shape, voxel_size)

    @classmethod
    def from_state(cls, st: dict, dtype=torch.float32):
        """A working copy of a state dict (`snapshot` of the benchmark's
        entries): the first `num_active` blocks, in room for `capacity`."""
        na, cap = st["num_active"], st["capacity"]
        dev = st["directory"].device
        v = st["dist"].shape[1]
        coords = torch.zeros((cap, 3), dtype=torch.int32, device=dev)
        coords[:na] = st["block_coords"][:na]
        fields = []
        for k in ("dist", "weight", "gx", "gy", "gz"):
            f = torch.zeros((cap, v), dtype=dtype, device=dev)
            f[:na] = st[k][:na].to(dtype)
            fields.append(f)
        return cls(st["directory"].clone(), coords, na, fields, st["dir_dim"],
                   st["block_shape"], st["voxel_size"])

    def grow(self):
        """Double the capacity (the program's `vg.grow`: slots kept)."""
        cap = self.capacity
        self.block_coords = torch.cat([self.block_coords,
                                       torch.zeros_like(self.block_coords)])
        self.dist, self.weight, self.gx, self.gy, self.gz = (
            torch.cat([f, torch.zeros_like(f)]) for f in self.fields)
        self.overflow = False
        return cap * 2

    def state(self) -> dict:
        na = self.num_active
        return {"directory": self.directory, "block_coords": self.block_coords[:na],
                "num_active": na, "capacity": self.capacity,
                "dist": self.dist[:na], "weight": self.weight[:na],
                "gx": self.gx[:na], "gy": self.gy[:na], "gz": self.gz[:na],
                "dir_dim": self.dir_dim, "block_shape": self.block_shape,
                "voxel_size": self.voxel_size}


def pack_key(bx, by, bz, dir_dim):
    """Block coordinates -> directory index, EMPTY out of range."""
    half = dir_dim // 2
    xs, ys, zs = bx + half, by + half, bz + half
    inr = ((xs >= 0) & (xs < dir_dim) & (ys >= 0) & (ys < dir_dim)
           & (zs >= 0) & (zs < dir_dim))
    key = (xs * dir_dim + ys) * dir_dim + zs
    return torch.where(inr, key, torch.full_like(key, EMPTY))


def lookup(grid: Grid, keys):
    """Directory indices -> slots, -1 where absent or out of range."""
    slot = grid.directory[torch.clamp(keys, 0, grid.directory.numel() - 1).long()]
    return torch.where(keys >= 0, slot, torch.full_like(slot, -1))


def voxel_rows(grid: Grid, vi):
    """Voxel indices (N, 3) int32 -> (flat field row int64, found)."""
    b = grid.block_shape
    blk = torch.div(vi, b, rounding_mode="floor")
    loc = vi - blk * b
    local = (loc[:, 2] * b + loc[:, 1]) * b + loc[:, 0]
    slot = lookup(grid, pack_key(blk[:, 0], blk[:, 1], blk[:, 2], grid.dir_dim))
    found = slot >= 0
    row = torch.where(found, slot * (b ** 3) + local, torch.zeros_like(slot))
    return row.long(), found


def claim(grid: Grid, keys, miss):
    """Allocate the blocks of the samples in `miss` (keys int32 [N], in
    candidate order): each missing block goes to its first candidate, and
    the winners take the next slots in candidate order; past the capacity
    the claim is dropped and `overflow` set."""
    want = keys[miss].long()
    if want.numel() == 0:
        return
    uniq, inv = torch.unique(want, return_inverse=True)
    pos = torch.arange(want.numel(), device=want.device)
    first = torch.full((uniq.numel(),), want.numel(), dtype=torch.long,
                       device=want.device)
    first.scatter_reduce_(0, inv, pos, "amin")
    order = torch.argsort(first)
    new_keys = uniq[order]
    slots = grid.num_active + torch.arange(new_keys.numel(), device=want.device)
    ok = slots < grid.capacity
    if not bool(ok.all()):
        grid.overflow = True
    new_keys, slots = new_keys[ok], slots[ok]
    grid.directory[new_keys] = slots.to(torch.int32)
    D, half = grid.dir_dim, grid.dir_dim // 2
    coords = torch.stack([new_keys // (D * D) - half, (new_keys // D) % D - half,
                          new_keys % D - half], dim=-1)
    grid.block_coords[slots] = coords.to(torch.int32)
    grid.num_active += int(slots.numel())
