"""Sharded tracking, fusion, rendering and BA steps over the rank mesh.

Port of `gradient_sdf_tpu/parallel/sharding.py`. The grid's per-voxel
STORAGE is resident-sharded over the mesh's block axis: each rank holds the
[num_blocks / D_b, B^3] rows [b * nb / D_b, (b + 1) * nb / D_b) of dist,
weight and the gradient (b its block index), so per-rank volume memory is
1/D_b; the index structures (directory, coarse_occ, block_coords and the
counters) are small and replicated. A sharded grid is a `VoxelGrid` whose
five fields hold only the rank's rows (`num_blocks` reads `block_coords`,
which stays whole).

Every rank computes the replicated parts itself, on the same inputs with
the same operations: a frame's samples and the claim insert, the
directory, `num_active`, the 6x6 solves and the convergence and growth
flags. If two ranks disagree on one of them, one of them stops iterating
while the others wait in an all_reduce; the group's timeout turns that into
an error, and `check_replicated` tests it outright (tests and the card's
smoke run it every frame).

  * Tracking: every rank compacts the frame's depth-valid pixels with the
    compaction kernel (`track_compact`, one read of the count), takes its
    slice of the ray axis and resolves only the voxels its block shard owns
    (owner-computes), through the GN residual kernel with the shard's slot
    window; one all_reduce of the 29 sums (E, g, H's upper triangle, count)
    over the world per GN iteration, then every rank runs the GN step
    kernel on the same sums.
  * Fusion: each rank scatters its 1/D slice of the frame's samples. The
    touched-block set comes from one all_reduce of an int32 [nb] vector;
    the samples go through the CUDA scatter kernel into a compact
    [cap * B^3, 8] accumulator, one all_reduce over the world sums its five
    columns, and one `merge_touched` launch merges the summed rows of the
    touched blocks the rank owns into the resident shard, reading them in
    place (no host sync). A frame that touches more than `touched_cap`
    blocks takes the full path: a capacity-sized all_reduce, whose rows
    the same launch reads at the blocks' slots.
  * Rendering: rays over the whole world; the fields are assembled once per
    render over the blocks group; each rank runs `raycast` (the CUDA march)
    on its ray slice; the images are assembled on every rank.
  * BA: the surface-voxel axis over the world; per alternation one
    all_reduce of the frames' [F, 6, 6] and [F, 6] pose systems and one of
    the two energies; the per-voxel dist solves stay local.

Differences from the JAX module: only all_reduce and broadcast
(`parallel/mesh.py`); the scatters run through the port's kernel, where the
JAX module uses `.at[].add`; `touched_cap=0` sizes the compact accumulator
to the frame's touched blocks (the port has no static shapes); and a render
whose `active_cap` is below `num_active` raises, where the JAX function
renders the blocks beyond the cap as empty.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models import photo_ba as pba
from ..models import tracker as tracker_mod
from ..ops import fusion as fusion_mod
from ..ops import raycast as rc_mod
from ..ops import voxel_grid as vg
from ..ops.kernels import gn_track, track_compact
from ..ops.kernels.merge_clear import merge_touched
from ..ops.kernels.scatter_add import new_accumulator, scatter_add_fields
from ..utils import trace
from .mesh import (BLOCK_AXIS, RAY_AXIS, WORLD, Mesh, all_gather_rows,
                   broadcast, psum, shard_rows)

FIELDS = ("dist", "weight", "grad_x", "grad_y", "grad_z")
# fusion's accumulator columns: w, w * sdf, w * R n
ACC_FIELDS = 5


def grid_block_specs() -> vg.VoxelGrid:
    """Which fields of a sharded grid are sharded (over `BLOCK_AXIS`) and
    which are replicated (None)."""
    return vg.VoxelGrid(*(BLOCK_AXIS if f in FIELDS else None
                          for f in vg.VoxelGrid._fields))


def block_range(mesh: Mesh, num_blocks: int) -> Tuple[int, int]:
    """(first block slot, slots) of this rank's shard."""
    d = mesh.axis_size(BLOCK_AXIS)
    if num_blocks % d:
        raise ValueError(f"{num_blocks} blocks do not split over {d} ranks")
    m = num_blocks // d
    return mesh.block_index * m, m


def shard_grid(mesh: Mesh, grid: vg.VoxelGrid) -> vg.VoxelGrid:
    """This rank's shard of a whole grid (the same on every rank), on the
    mesh's device: the five fields keep the rank's block rows, the rest is
    kept whole. Everything is copied (the grid functions write in place)."""
    lo, m = block_range(mesh, grid.num_blocks)
    return vg.VoxelGrid(*(
        (a[lo:lo + m] if spec else a).to(mesh.device, copy=True)
        for a, spec in zip(grid, grid_block_specs())))


def _stacked(grid: vg.VoxelGrid) -> torch.Tensor:
    """The five fields as one [rows, 5, B^3] tensor (one collective)."""
    return torch.stack([getattr(grid, f) for f in FIELDS], dim=1)


def _with_fields(grid: vg.VoxelGrid, stacked: torch.Tensor) -> vg.VoxelGrid:
    return grid._replace(**{f: stacked[:, i].contiguous()
                            for i, f in enumerate(FIELDS)})


def gather_grid(mesh: Mesh, grid: vg.VoxelGrid) -> vg.VoxelGrid:
    """The whole grid on every rank (checkpoints, exports, tests): the
    fields assembled over the block axis, bit-equal to the shards."""
    return _with_fields(grid, all_gather_rows(_stacked(grid), mesh, BLOCK_AXIS))


def check_replicated(mesh: Mesh, grid: vg.VoxelGrid, R, t, flags=()):
    """Raise unless every rank holds the same replicated state: the
    directory, coarse occupancy, block coordinates and counters of `grid`,
    the pose (R, t) and `flags`. One MAX and one MIN all_reduce of a float64
    vector of exact checksums (not counted as collectives of the path)."""
    dev = grid.directory.device
    d = grid.directory.to(torch.int64)
    bc = grid.block_coords.to(torch.int64)
    pos = torch.arange(d.numel(), device=dev) % 1009 + 1
    rows = torch.arange(bc.shape[0], device=dev)[:, None] % 1013 + 1
    parts = [d.sum(), (d * pos).sum(), grid.coarse_occ.to(torch.int64).sum(),
             bc.sum(), (bc * rows).sum(), grid.num_active, grid.overflow,
             grid.oob_samples]
    names = ["directory", "directory order", "coarse_occ", "block_coords",
             "block_coords order", "num_active", "overflow", "oob_samples"]
    v = torch.stack([p.to(torch.float64).reshape(()) for p in parts])
    pose = torch.cat([torch.as_tensor(R, device=dev).reshape(-1),
                      torch.as_tensor(t, device=dev).reshape(-1)])
    extra = torch.as_tensor([float(f) for f in flags], dtype=torch.float64,
                            device=dev)
    v = torch.cat([v, pose.to(torch.float64), extra])
    names += [f"R[{i}]" for i in range(9)] + [f"t[{i}]" for i in range(3)]
    names += [f"flag {i}" for i in range(len(flags))]
    hi, lo = v.clone(), v.clone()
    psum(hi, mesh, WORLD, op=torch.distributed.ReduceOp.MAX, count=False)
    psum(lo, mesh, WORLD, op=torch.distributed.ReduceOp.MIN, count=False)
    bad = [n for n, a, b in zip(names, hi.tolist(), lo.tolist()) if a != b]
    if bad:
        raise RuntimeError(f"rank {mesh.rank}: replicated state differs "
                           f"between ranks in {bad}")


# ---------------------------------------------------------------------------
# tracking
# ---------------------------------------------------------------------------


def sharded_residual_pass(mesh: Mesh, grid, pts, R, t, gcfg, fcfg):
    """The residual sums (`gn_track.SUMS`) over every rank's points: `pts`
    are this rank's ray slice of the compacted points; each rank resolves
    only the voxels of the blocks its shard holds (owner-computes: exactly
    one rank of a blocks group owns each allocated voxel), through
    `gn_track.gn_residual_reduce` with the shard's slot window, and one
    all_reduce over the world sums them. Replicated results."""
    lo, _ = block_range(mesh, grid.num_blocks)
    sums = gn_track.gn_residual_reduce(pts, R, t, grid, gcfg, fcfg,
                                       mode="grad", slot_lo=lo)
    return psum(sums, mesh, WORLD)


def sharded_track_frame(mesh: Mesh, grid, depth, K, R0, t0, gcfg, fcfg,
                        tcfg, compact: Optional[track_compact.CompactBuffer]
                        = None) -> tracker_mod.TrackResult:
    """Gauss-Newton tracking (`tracker.gn_loop`) with the residual pass
    sharded over the mesh: the depth-valid pixels are compacted on every
    rank (`track_compact` into `compact`, the caller's buffer for such
    frames, allocated if None; the count is read once, for the slice), each
    rank takes its slice of the ray axis, and every rank runs
    `gn_track.gn_step` on the same replicated sums."""
    pts, count = track_compact.track_compact(depth, K, fcfg.z_min, fcfg.z_max,
                                             tcfg.sampling, compact)
    pts = pts[shard_rows(int(count), mesh, RAY_AXIS)]
    trace.count("gsdf.reads")
    return tracker_mod.gn_loop(
        lambda R, t: sharded_residual_pass(mesh, grid, pts, R, t, gcfg, fcfg),
        R0, t0, tcfg, depth.device)


# ---------------------------------------------------------------------------
# fusion
# ---------------------------------------------------------------------------


def rank_samples(mesh: Mesh, s, lin, ok, vpb: int, nb: int):
    """This rank's 1/D slice of a frame's samples (`fusion._alloc_slots`'
    flat voxel index `lin` and `ok`): (lin, block slot or nb outside the
    map, in-block offset, the five payload fields)."""
    mine = shard_rows(lin.shape[0], mesh, WORLD)
    lin, ok = lin[mine], ok[mine]
    slot = torch.where(ok, torch.div(lin, vpb, rounding_mode="floor"),
                       torch.full_like(lin, nb))
    fields = [f[mine] for f in (s.w, s.wd, s.wn_x, s.wn_y, s.wn_z)]
    return lin, slot, s.local_lin[mine], fields


def touched_blocks(mesh: Mesh, slot, nb: int) -> torch.Tensor:
    """The frame's touched block slots, ascending and the same on every
    rank: one all_reduce of an int32 [nb] vector."""
    touched = torch.zeros(nb + 1, dtype=torch.int32, device=slot.device)
    touched[slot.long()] = 1
    touched = psum(touched[:nb].contiguous(), mesh, WORLD)
    return torch.nonzero(touched).reshape(-1)


def compact_index(slot, local, tidx, nb: int, vpb: int, cap: int):
    """Row of each sample in a [cap * B^3] accumulator over the touched
    blocks `tidx` (cap >= their count); samples outside the map get
    cap * B^3, which the scatter drops."""
    inv = torch.full((nb + 1,), -1, dtype=torch.int32, device=slot.device)
    inv[tidx] = torch.arange(tidx.shape[0], dtype=torch.int32,
                             device=slot.device)
    cslot = inv[slot.long()]
    return torch.where(cslot >= 0, cslot * vpb + local,
                       torch.full_like(cslot, cap * vpb))


def sharded_fuse_frame(mesh: Mesh, grid, depth, cache, R, t, gcfg, fcfg, *,
                       touched_cap: int = 0):
    """Fuse one frame into the block-sharded grid (updated in place;
    returned). `touched_cap` > 0 is the compact accumulator's size in
    blocks, and a frame touching more blocks takes the full path; 0 sizes
    it to the frame's touched blocks. Both paths give the same result."""
    s = fusion_mod.frame_samples(depth, cache, R, t, gcfg, fcfg)
    grid, lin, ok = fusion_mod._alloc_slots(grid, s, gcfg)   # replicated
    nb, vpb, dev = grid.num_blocks, gcfg.voxels_per_block, grid.device
    lo, _ = block_range(mesh, nb)
    lin, slot, local, fields = rank_samples(mesh, s, lin, ok, vpb, nb)
    tidx = touched_blocks(mesh, slot, nb)
    cap = int(touched_cap) if touched_cap > 0 else tidx.shape[0]
    full = tidx.shape[0] > cap
    if not full:
        # compact: [cap * B^3] rows, one all_reduce
        lin_c = compact_index(slot, local, tidx, nb, vpb, cap)
        acc = new_accumulator(cap * vpb, dev)
        scatter_add_fields(lin_c, fields, cap * vpb, acc=acc[:, :ACC_FIELDS])
    else:
        # full: a capacity-sized accumulator summed over the world; the
        # merge reads the rank's touched rows of it at their slots
        acc = new_accumulator(nb * vpb, dev)
        scatter_add_fields(lin, fields, nb * vpb, acc=acc[:, :ACC_FIELDS])
    red = psum(acc[:, :ACC_FIELDS].contiguous(), mesh, WORLD)
    merge_touched(red, tidx, lo, grid.weight, grid.dist, grid.grad_x,
                  grid.grad_y, grid.grad_z, full=full)
    return grid


def sharded_track_and_fuse_frame(mesh: Mesh, grid, depth, K, R0, t0, cache,
                                 gcfg, fcfg, tcfg, *, R_prev2=None,
                                 t_prev2=None, warm_alpha: float = 1.0):
    """One multi-device Scan3D frame: sharded GN tracking, then sharded
    fusion at the refined pose if (and only if) tracking converged
    (main_scan_3d.cpp:258-266). Returns (grid, TrackResult)."""
    if R_prev2 is not None:
        R0, t0 = tracker_mod.extrapolate_pose(R0, t0, R_prev2, t_prev2,
                                              warm_alpha)
    res = sharded_track_frame(mesh, grid, depth, K, R0, t0, gcfg, fcfg, tcfg)
    if res.converged:
        grid = sharded_fuse_frame(mesh, grid, depth, cache, res.R, res.t,
                                  gcfg, fcfg)
    return grid, res


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------


def assemble_fields(mesh: Mesh, grid, active_cap: int = 0) -> vg.VoxelGrid:
    """The grid with its fields assembled over the block axis, once per
    render. `active_cap` > 0 moves only the dense prefix of `active_cap`
    block slots (each rank contributes its rows of it; one all_reduce of
    [cap, 5, B^3]); it must cover `num_active` (raises otherwise). 0
    gathers every slot."""
    nb = grid.num_blocks
    if active_cap <= 0:
        return gather_grid(mesh, grid)
    na = int(grid.num_active)
    if active_cap < na:
        raise ValueError(f"active_cap {active_cap} is below num_active {na}: "
                         f"blocks beyond the cap would render as empty")
    cap = min(int(active_cap), nb)
    lo, m = block_range(mesh, nb)
    hi = min(lo + m, cap)
    buf = torch.full((cap, len(FIELDS), grid.voxels_per_block), -0.0,
                     dtype=torch.float32, device=grid.device)
    if hi > lo:
        buf[lo:hi] = _stacked(grid)[:hi - lo]
    return _with_fields(grid, psum(buf, mesh, BLOCK_AXIS))


def sharded_render_depth_normal(mesh: Mesh, grid, K, R, t, width: int,
                                height: int, gcfg, fcfg, *, s_min: float = 0.1,
                                s_max: float = 5.0, active_cap: int = 0, **kw):
    """Render depth/normal/hit images with the rays split over the whole
    mesh and the grid block-sharded: the fields are assembled once
    (`assemble_fields`), each rank marches its slice of the image's rays
    with `raycast` (the CUDA march kernel on the card), and one all_reduce
    assembles the images on every rank. Every ray is computed as an
    unsharded `raycast` of the same rays computes it. Returns (depth [H,W],
    normal [H,W,3], hit [H,W])."""
    dev = grid.device
    K, R, t = (torch.as_tensor(a, dtype=torch.float32, device=dev)
               for a in (K, R, t))
    origins, dirs, inv_hnorm = rc_mod.camera_rays(K, R, t, width, height,
                                                  device=dev)
    full = assemble_fields(mesh, grid, active_cap)
    n = origins.shape[0]
    mine = shard_rows(n, mesh, WORLD)
    res = rc_mod.raycast(full, origins[mine], dirs[mine], gcfg, fcfg,
                         s_min=s_min, s_max=s_max, **kw)
    part = torch.cat([res.depth[:, None], res.normal,
                      res.hit[:, None].to(torch.float32)], dim=1)
    img = all_gather_rows(part, mesh, WORLD, n=n)
    depth = (img[:, 0] * inv_hnorm).reshape(height, width)
    return (depth, img[:, 1:4].reshape(height, width, 3),
            (img[:, 4] > 0.5).reshape(height, width))


# ---------------------------------------------------------------------------
# photometric bundle adjustment
# ---------------------------------------------------------------------------


def shard_ba(mesh: Mesh, problem: pba.BAProblem, state: pba.BAState):
    """This rank's slice of the voxel axis of a whole problem and state
    (V must split evenly: `build_problem` pads to 1024); images, K and the
    poses stay whole."""
    V = problem.vox.shape[0]
    if V % mesh.size:
        raise ValueError(f"{V} voxels do not split over {mesh.size} ranks")
    sl = shard_rows(V, mesh, WORLD)
    return (problem._replace(vox=problem.vox[sl], grad=problem.grad[sl],
                             weight=problem.weight[sl],
                             vmask=problem.vmask[sl], vis=problem.vis[sl]),
            state._replace(dist=state.dist[sl]))


def gather_ba_state(mesh: Mesh, state: pba.BAState) -> pba.BAState:
    """The whole dist vector from the ranks' slices (bit-equal)."""
    return state._replace(dist=all_gather_rows(state.dist, mesh, WORLD))


def sharded_ba_step(mesh: Mesh, problem, state, gcfg, pcfg):
    """One PhotoBA alternation (pose step + dist step) on this rank's voxel
    slice (`shard_ba`): the per-frame pose systems of all frames are summed
    over the ranks in one all_reduce and solved on every rank (replicated
    poses); the dist solves are per voxel and local; the two energies are
    summed in one more. Returns (state slice, E after pose, E after dist)."""
    H, b = pba.pose_systems(problem, state, gcfg, pcfg)
    F = b.shape[0]
    sys = psum(torch.cat([H.reshape(F, 36), b], dim=1).contiguous(), mesh,
               WORLD)
    state = pba.apply_pose_systems(state, sys[:, :36].reshape(F, 6, 6),
                                   sys[:, 36:])
    e_pose = pba.energy(problem, state, gcfg)
    state = pba.solve_dist(problem, state, gcfg, pcfg)
    e = psum(torch.stack([e_pose, pba.energy(problem, state, gcfg)]), mesh,
             WORLD)
    return state, e[0], e[1]


def broadcast_ba(mesh: Mesh, problem: Optional[pba.BAProblem],
                 state: Optional[pba.BAState]):
    """Rank 0's whole problem and state on every rank (the others pass
    None): the shapes first, then each array. Re-fusing the frames on every
    rank would give each its own float atomics order, and poses that are
    meant to be replicated would drift apart."""
    dev = mesh.device
    dims = torch.zeros(4, dtype=torch.int64, device=dev)
    if mesh.rank == 0:
        dims[:] = torch.tensor([problem.vox.shape[0], *problem.images.shape[:3]])
    V, F, H, W = broadcast(dims, mesh).tolist()
    shapes = {"vox": ((V, 3), torch.int32), "grad": ((V, 3), torch.float32),
              "weight": ((V,), torch.float32), "vmask": ((V,), torch.uint8),
              "vis": ((V, F), torch.uint8),
              "images": ((F, H, W, 3), torch.float32),
              "K": ((3, 3), torch.float32), "dist": ((V,), torch.float32),
              "R": ((F, 3, 3), torch.float32), "t": ((F, 3), torch.float32)}
    out = {}
    for name, (shape, dtype) in shapes.items():
        if mesh.rank == 0:
            src = getattr(problem if name in pba.BAProblem._fields else state,
                          name)
            x = src.to(dev, dtype).contiguous()
        else:
            x = torch.empty(shape, dtype=dtype, device=dev)
        out[name] = broadcast(x, mesh)
    for name in ("vmask", "vis"):
        out[name] = out[name].to(torch.bool)
    return (pba.BAProblem(**{k: out[k] for k in pba.BAProblem._fields}),
            pba.BAState(**{k: out[k] for k in pba.BAState._fields}))
