"""fuse_integrate: one depth frame's fusion on one card in two launches of
the hand-written kernel of `csrc/fuse_integrate.cu` (see the note there),
with no host sync.

  * `claim_pass` gates every pixel, walks its K = 2 * floor(T / vs) + 1
    samples (`fusion._pixel_rays`, `fusion._ray_samples`) and looks each
    live sample's block up in the directory. For every candidate c = pixel
    * K + k over all pixels of the frame it sets a mark (uint8, 1 for a
    live sample whose block is missing) and, where marked, the block key
    (int32). It returns the status, int32 [4] on the device: the misses,
    the live samples outside the directory's range (oob), the warp tiles
    with a valid pixel (`tile_of_pixels`) and the missing blocks (claimed
    blocks). On the card it also claims each missing block for its lowest
    candidate id (an atomicMin into the scratch's `claims`), lists the
    claimed blocks' keys and the tiles with a valid pixel for the
    integrate pass and adds the oob count to the grid's `oob_samples`.
  * `integrate_merge` hands the claimed blocks their slots in candidate
    order (the JAX package's `insert_new` order), walks the samples again,
    looks them up, adds (w, w * trunc(sdf), w * R n) into the map's
    accumulator, then merges and clears the rows of every touched block
    (`merge_clear`'s formula, over the touched blocks only) and ORs the
    keyframe bit into `vis` for every voxel that received a sample. On the
    card this is ONE cooperative launch (grid-wide barriers between its
    phases); the grid's directory, coarse occupancy, block coordinates,
    block count and overflow flag are updated in place.

On a CUDA tensor the wrappers launch the kernel or raise; they never fall
back. On a CPU tensor they take the plain versions, `claim_pass_reference`
and `integrate_merge_reference`; the block claim between them is then
`claim_alloc_reference` (through `fusion.claim_blocks`). These three are
also what the kernel is checked against on the card. The plain versions
compact the valid pixels (a host sync that the kernel does not make) and
walk them with `fusion._ray_samples` itself; the candidate ids are the
same.

The kernel's scratch lives in a `FuseScratch` (`new_scratch(grid)`) that
`GradSdfMap` owns beside its accumulator: the block marks (all-zero between
frames), the claims (INT32_MAX between frames), the status, the
candidates' marks (all-zero between frames: the integrate pass clears
them) and keys, and the lists of claimed keys and of tiles with a valid
pixel. The accumulator is all-zero on entry and on exit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...config import FusionConfig, GridConfig
from .. import voxel_grid as vg
from .scatter_add import ACC_ROW

STATUS = 4   # int32: misses, oob, tiles with a valid pixel, claimed blocks
# csrc/fuse_integrate.cu's pixel layout: a warp takes an 8 x 4 pixel tile;
# the tiles are numbered in 32 x 32 pixel super tiles of 4 x 8 tiles, row by
# row, and the super tiles row by row over the image
TILE_W, TILE_H, SUPER_W, SUPER_H = 8, 4, 4, 8

# launches since the last reset_launch_count(), the integrate-and-merge
# launch and the claim launch; the CPU path and the plain versions do not
# count
launch_count = 0
claim_launch_count = 0

_shapes = {}   # field count -> (CTAs an SM holds, SMs, threads, cooperative)


def reset_launch_count():
    global launch_count, claim_launch_count
    launch_count = claim_launch_count = 0


class FuseScratch:
    """The kernels' scratch for a grid of `num_blocks` blocks and a
    directory of `dir_size` entries on `device`: `marks` int32 [num_blocks]
    (all-zero between frames), `claims` int32 [dir_size] (INT32_MAX between
    frames), `status` int32 [STATUS]; and, grown by
    `candidates(n, n_tiles)`, the candidates' `cand_mark` uint8 (all-zero
    between frames) and `cand_keys` int32, the claimed keys' list
    `new_keys` int32 and the list of tiles with a valid pixel `tiles`
    int32."""

    def __init__(self, num_blocks: int, dir_size: int, device):
        i32 = dict(dtype=torch.int32, device=device)
        self.marks = torch.zeros(num_blocks, **i32)
        self.claims = torch.full((dir_size,), vg.INT32_MAX, **i32)
        self.status = torch.zeros(STATUS, **i32)
        self.cand_mark = torch.zeros(0, dtype=torch.uint8, device=device)
        self.cand_keys = torch.empty(0, **i32)
        self.new_keys = torch.empty(0, **i32)
        self.tiles = torch.empty(0, **i32)

    def candidates(self, n: int, n_tiles: int):
        """(mark, keys) of `n` candidates, with room for `n_tiles` tiles and
        as many claimed keys as a frame can list."""
        dev = self.marks.device
        if self.cand_mark.numel() < n:
            self.cand_mark = torch.zeros(n, dtype=torch.uint8, device=dev)
            self.cand_keys = torch.empty(n, dtype=torch.int32, device=dev)
            self.new_keys = torch.empty(min(n, self.claims.numel()),
                                        dtype=torch.int32, device=dev)
        if self.tiles.numel() < n_tiles:
            self.tiles = torch.empty(n_tiles, dtype=torch.int32, device=dev)
        return self.cand_mark[:n], self.cand_keys[:n]


def new_scratch(grid: vg.VoxelGrid) -> FuseScratch:
    return FuseScratch(grid.num_blocks, grid.directory.numel(), grid.device)


class FuseArgs(ctypes.Structure):
    """`FuseArgs` of csrc/fuse_integrate.cu, field for field (all 8 bytes)."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "depth", "normals", "x0", "y0", "n_sq_inv", "R", "t", "directory",
        "coarse_occ", "block_coords", "num_active", "overflow", "oob_samples",
        "claims", "cand_mark", "cand_keys", "tiles", "new_keys", "status",
        "acc", "weight", "dist", "grad_x", "grad_y", "grad_z", "marks",
        "vis")]
        + [(n, ctypes.c_int64) for n in (
            "height", "width", "factor", "dir_dim", "block_shape", "stride",
            "cosine", "num_blocks", "vis_words", "kf_word", "kf_bit")]
        + [(n, ctypes.c_double) for n in (
            "vs", "inv_vs", "trunc", "inv_trunc", "z_min", "z_max",
            "normal_sq_min", "view_cos_sq")])


def walk_constants(gcfg: GridConfig, fcfg: FusionConfig) -> dict:
    """The float32 constants of the walk as the plain version on the card
    applies them: a Python number is rounded to float32 once, and a
    division by one is a multiplication by its float32 reciprocal (1/vs is
    rounded from the double, 1/T is a float32 division)."""
    f32 = np.float32
    vs = gcfg.voxel_size
    T = fcfg.trunc_voxels * vs
    return {"vs": f32(vs), "inv_vs": f32(1.0 / vs), "trunc": f32(T),
            "inv_trunc": f32(1.0) / f32(T), "z_min": f32(fcfg.z_min),
            "z_max": f32(fcfg.z_max), "normal_sq_min": f32(fcfg.normal_sq_min),
            "view_cos_sq": f32(fcfg.view_angle_cos_sq)}


def samples_per_ray(fcfg: FusionConfig) -> int:
    return 2 * int(fcfg.trunc_voxels) + 1


def tile_count(height: int, width: int) -> int:
    """The warp tiles of a height x width frame (whole super tiles)."""
    sw, sh = TILE_W * SUPER_W, TILE_H * SUPER_H
    return -(-width // sw) * -(-height // sh) * SUPER_W * SUPER_H


def tile_of_pixels(pix: torch.Tensor, width: int) -> torch.Tensor:
    """The warp tile of each pixel index (the kernel's numbering)."""
    x, y = pix % width, torch.div(pix, width, rounding_mode="floor")
    wx, wy = x // TILE_W, y // TILE_H
    supers_x = -(-width // (TILE_W * SUPER_W))
    return (((wy // SUPER_H) * supers_x + wx // SUPER_W) * SUPER_W * SUPER_H
            + (wy % SUPER_H) * SUPER_W + wx % SUPER_W)


def _check(depth, normals, cache, R, t, grid, gcfg):
    H, W = depth.shape if depth.dim() == 2 else (None, None)
    want = {"depth": (depth, (H, W)), "normals": (normals, (H, W, 3)),
            "x0": (cache.x0, (H, W)), "y0": (cache.y0, (H, W)),
            "n_sq_inv": (cache.n_sq_inv, (H, W)), "R": (R, (3, 3)),
            "t": (t, (3,)), "weight": (grid.weight, tuple(grid.dist.shape))}
    for name, (a, shape) in want.items():
        if H is None or tuple(a.shape) != shape or a.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {shape}, got {a.dtype} "
                             f"{tuple(a.shape)}")
        if a.device != grid.device or not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {grid.device}")
    if grid.directory.numel() != gcfg.dir_dim**3:
        raise ValueError("the grid's directory does not fit its GridConfig")


def _check_samples(depth, fcfg) -> int:
    """The frame's samples, H * W * K: the kernel's candidate ids and pixel
    indices are int32."""
    n = depth.numel() * samples_per_ray(fcfg)
    if n >= 2**31 - 32:
        raise ValueError(f"{n} samples a frame: the kernel takes < 2^31")
    return n


@functools.lru_cache(maxsize=16)
def _config_args(gcfg: GridConfig, fcfg: FusionConfig) -> tuple:
    """The FuseArgs fields that come from the configuration, as (name,
    value) pairs (immutable: the cache hands them to every call)."""
    return tuple(dict(
        factor=int(fcfg.trunc_voxels), dir_dim=gcfg.dir_dim,
        block_shape=gcfg.block_shape, stride=int(fcfg.fusion_stride),
        cosine=int(bool(fcfg.cosine_correction)),
        **{k: float(v) for k, v in walk_constants(gcfg, fcfg).items()}).items())


def _args(depth, normals, cache, R, t, grid, gcfg, fcfg, scratch,
          **kw) -> FuseArgs:
    ptr = {name: getattr(grid, name).data_ptr() for name in (
        "directory", "coarse_occ", "block_coords", "num_active", "overflow",
        "oob_samples")}
    ptr.update({name: getattr(scratch, name).data_ptr() for name in (
        "claims", "cand_mark", "cand_keys", "tiles", "new_keys", "status")})
    a = FuseArgs(
        depth=depth.data_ptr(), normals=normals.data_ptr(),
        x0=cache.x0.data_ptr(), y0=cache.y0.data_ptr(),
        n_sq_inv=cache.n_sq_inv.data_ptr(), R=R.data_ptr(), t=t.data_ptr(),
        height=depth.shape[0], width=depth.shape[1],
        num_blocks=grid.num_blocks, **ptr, **dict(_config_args(gcfg, fcfg)))
    for k, v in kw.items():
        setattr(a, k, v)
    return a


def _check_scratch(scratch, grid, depth, fcfg):
    """The card's passes need a FuseScratch of the grid's geometry, grown
    to this frame."""
    if scratch is None or scratch.marks.shape != (grid.num_blocks,) or (
            scratch.claims.numel() != grid.directory.numel()):
        raise ValueError("the card's fusion passes need a FuseScratch of the "
                         "grid's block count and directory")
    for name in ("num_active", "oob_samples"):
        a = getattr(grid, name)
        if a.dtype != torch.int32 or a.dim() != 0:
            raise ValueError(f"grid.{name} must be an int32 scalar")
    if grid.overflow.dtype != torch.bool or grid.overflow.dim() != 0:
        raise ValueError("grid.overflow must be a bool scalar")
    n = _check_samples(depth, fcfg)
    return scratch.candidates(n, tile_count(*depth.shape))


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def claim_pass(depth: torch.Tensor, normals: torch.Tensor, cache, R, t,
               grid: vg.VoxelGrid, gcfg: GridConfig, fcfg: FusionConfig,
               scratch: FuseScratch = None):
    """The claim pass (module note) over a frame: depth f32 [H, W], its
    FALS normals f32 [H, W, 3], the camera cache of `ops/normals`, the pose
    (R f32 [3, 3], t f32 [3], camera-to-world) and the grid. Returns
    (status int32 [STATUS], mark uint8 [H * W * K], keys int32 [H * W * K]).
    On CUDA the kernel launches on the current stream without
    synchronizing; `scratch` (`new_scratch(grid)`) is then required and
    holds the outputs, its `claims` the frame's claims, and the grid's
    `oob_samples` grows by the oob count."""
    _check(depth, normals, cache, R, t, grid, gcfg)
    dev = depth.device
    if dev.type == "cpu":
        return claim_pass_reference(depth, normals, cache, R, t, grid, gcfg,
                                    fcfg)
    if dev.type != "cuda":
        raise RuntimeError(f"fuse_integrate: no kernel for {dev}")
    mark, keys = _check_scratch(scratch, grid, depth, fcfg)
    from . import _build

    lib = _build.load()
    a = _args(depth, normals, cache, R, t, grid, gcfg, fcfg, scratch)
    global claim_launch_count
    with torch.cuda.device(dev):
        rc = lib.gsdf_fuse_claim_f32(ctypes.byref(a), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"fuse_claim kernel launch failed: CUDA error {rc}")
    claim_launch_count += 1
    return scratch.status, mark, keys


def integrate_shape(nf: int = 5) -> tuple:
    """(CTAs an SM holds, SMs, threads a CTA, cooperative launches) of the
    integrate pass with `nf` fields (5, or 2 without gradients); raises if
    the card cannot place its cooperative launch."""
    if nf not in _shapes:
        from . import _build

        out = (ctypes.c_int * 4)()
        rc = _build.load().gsdf_fuse_integrate_shape(nf, out)
        if rc != 0 or out[0] < 1 or not out[3]:
            raise RuntimeError(
                f"fuse_integrate's cooperative launch cannot be placed: CUDA "
                f"error {rc}, shape {list(out)}")
        _shapes[nf] = tuple(out)
    return _shapes[nf]


def _kf_word_bit(vis, kf_slot):
    """(word, bit) of keyframe slot `kf_slot` in `vis`, or None (no vis,
    or a negative slot: not a keyframe), as the JAX package's `_merge_vis`
    picks them. `vis` holds the JAX package's uint32 words as int32
    (torch's uint32 lacks shifts): bit 31 reads negative."""
    if vis is None or kf_slot is None or int(kf_slot) < 0:
        return None
    k = int(kf_slot)
    return min(max(k // 32, 0), vis.shape[-1] - 1), k % 32


def integrate_merge(depth: torch.Tensor, normals: torch.Tensor, cache, R, t,
                    grid: vg.VoxelGrid, gcfg: GridConfig, fcfg: FusionConfig,
                    acc: torch.Tensor, scratch: FuseScratch = None, *,
                    accumulate_gradients: bool = True, vis=None, kf_slot=None):
    """The integrate-and-merge pass (module note), after the claim pass
    (and on the CPU after `claim_alloc_reference`): the grid's fields are
    updated in place, `acc` (f32 [num_blocks * B^3, 8], all-zero) is
    all-zero again on return, and `vis` (int32 [num_blocks, B^3, words],
    optional) gets keyframe slot `kf_slot`'s bit for every voxel that
    received a sample (none for a negative slot). Nothing is returned. On
    CUDA it is one cooperative launch on the current stream, without
    synchronizing, which first hands out the claim pass's blocks (the
    grid's structure updated in place) when its status counts claimed
    blocks; `scratch`, the claim pass's, is then required."""
    _check(depth, normals, cache, R, t, grid, gcfg)
    nvox = grid.num_blocks * grid.voxels_per_block
    if (acc.shape != (nvox, ACC_ROW) or acc.dtype != torch.float32
            or acc.device != grid.device or not acc.is_contiguous()):
        raise ValueError(
            f"acc must be contiguous float32 [{nvox}, {ACC_ROW}] on "
            f"{grid.device}, got {acc.dtype} {tuple(acc.shape)}")
    if vis is not None and (vis.dtype != torch.int32 or vis.dim() != 3
                            or vis.shape[:2] != grid.dist.shape
                            or vis.device != grid.device
                            or not vis.is_contiguous()):
        raise ValueError(f"vis must be contiguous int32 [{nvox}-voxel "
                         f"grid, words], got {vis.dtype} {tuple(vis.shape)}")
    kf = _kf_word_bit(vis, kf_slot)
    dev = depth.device
    if dev.type == "cpu":
        integrate_merge_reference(
            depth, normals, cache, R, t, grid, gcfg, fcfg, acc,
            accumulate_gradients=accumulate_gradients, vis=vis, kf_slot=kf_slot)
        return
    if dev.type != "cuda":
        raise RuntimeError(f"fuse_integrate: no kernel for {dev}")
    if nvox >= 2**31:
        raise ValueError(f"{nvox} voxels: the kernel's rows need < 2^31")
    if acc.data_ptr() % 32:
        raise ValueError("acc must be 32-byte aligned")
    _check_scratch(scratch, grid, depth, fcfg)
    nf = 5 if accumulate_gradients else 2
    integrate_shape(nf)
    from . import _build

    lib = _build.load()
    a = _args(depth, normals, cache, R, t, grid, gcfg, fcfg, scratch,
              acc=acc.data_ptr(), weight=grid.weight.data_ptr(),
              dist=grid.dist.data_ptr(), grad_x=grid.grad_x.data_ptr(),
              grad_y=grid.grad_y.data_ptr(), grad_z=grid.grad_z.data_ptr(),
              marks=scratch.marks.data_ptr(),
              vis=None if kf is None else vis.data_ptr(),
              vis_words=0 if vis is None else vis.shape[-1],
              kf_word=0 if kf is None else kf[0],
              kf_bit=0 if kf is None else kf[1])
    global launch_count
    with torch.cuda.device(dev):
        rc = lib.gsdf_fuse_integrate_f32(ctypes.byref(a), nf, _stream(dev))
    if rc != 0:
        raise RuntimeError(
            f"fuse_integrate kernel launch failed: CUDA error {rc}")
    launch_count += 1


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def frame_walk(depth, normals, cache, R, t, gcfg: GridConfig,
               fcfg: FusionConfig):
    """(pixel index of each walked ray int64 [n], samples): the frame's
    valid pixels compacted in pixel order and walked by
    `fusion._ray_samples`; sample j of the result is sample j % K of ray
    j // K."""
    from .. import fusion

    rays = fusion._pixel_rays(depth, normals, cache, fcfg)
    idx = torch.nonzero(rays.valid).reshape(-1)
    rays = fusion.FrameRays(*(a[idx] for a in rays[:-1]),
                            valid=torch.ones_like(idx, dtype=torch.bool))
    return idx, fusion._ray_samples(rays, R, t, gcfg, fcfg)


def claim_pass_reference(depth, normals, cache, R, t, grid, gcfg, fcfg):
    """Plain PyTorch version of `claim_pass` (keys -1 where unmarked)."""
    idx, s = frame_walk(depth, normals, cache, R, t, gcfg, fcfg)
    k = samples_per_ray(fcfg)
    miss = (s.keys >= 0) & (vg.lookup_keys(grid, s.keys, gcfg) < 0)
    cand = (idx[:, None] * k + torch.arange(k, device=idx.device)).reshape(-1)
    n = depth.numel() * k
    mark = torch.zeros(n, dtype=torch.uint8, device=depth.device)
    keys = torch.full((n,), vg.EMPTY_KEY, dtype=torch.int32, device=depth.device)
    mark[cand[miss]] = 1
    keys[cand[miss]] = s.keys[miss]
    zero = torch.zeros((), dtype=torch.int32, device=depth.device)
    status = torch.stack([
        miss.sum(dtype=torch.int32), s.oob.to(torch.int32),
        zero + torch.unique(tile_of_pixels(idx, depth.shape[1])).numel(),
        zero + torch.unique(s.keys[miss]).numel()])
    return status, mark, keys


def claim_mins_reference(claims, mark, keys):
    """The claim pass's claims, plain: every marked candidate c scatter-mins
    c into `claims[keys[c]]` (int32 [dir_dim^3], in place). Returns the
    marked candidates in order (int64) and their keys (int64)."""
    cand = torch.nonzero(mark).reshape(-1)
    want = keys[cand].long()
    claims.scatter_reduce_(0, want, cand.to(torch.int32), "amin")
    return cand, want


def claim_alloc_reference(grid: vg.VoxelGrid, mark, keys, gcfg: GridConfig,
                          claims=None) -> vg.VoxelGrid:
    """Plain version of the card's block claim (the claim pass's atomicMin
    and the integrate pass's phase 0), over the claim pass's `mark` and
    `keys`: the claims (`claim_mins_reference`; `claims` int32
    [dir_dim^3] all INT32_MAX, or a fresh one), the winners (claims[key] ==
    c), their ranks by a cumsum over the candidates in order, slot
    num_active + rank, and the writes: directory, coarse occupancy and
    block coordinates in place, or the overflow flag past the capacity. The
    claims and marks are put back. Returns the grid with its new block
    count and overflow flag: the JAX package's `insert_new` over the frame's
    missing samples, without calling it."""
    if claims is None:
        claims = torch.full((grid.directory.numel(),), vg.INT32_MAX,
                            dtype=torch.int32, device=grid.device)
    cand, want = claim_mins_reference(claims, mark, keys)
    won = claims[want] == cand
    slot = grid.num_active + torch.cumsum(won, 0, dtype=torch.int32) - 1
    ok = won & (slot < grid.num_blocks)
    new_keys, new_slots = want[ok], slot[ok]
    grid.directory[new_keys] = new_slots
    D = gcfg.dir_dim
    C = D // vg.COARSE_FACTOR
    kx, ky, kz = new_keys // (D * D), (new_keys // D) % D, new_keys % D
    c = vg.COARSE_FACTOR
    grid.coarse_occ[((kx // c) * C + ky // c) * C + kz // c] = 1
    grid.block_coords[new_slots.long()] = vg.unpack_key(new_keys, gcfg).to(
        torch.int32)
    claims[want] = vg.INT32_MAX
    mark[cand] = 0
    return grid._replace(num_active=grid.num_active + ok.sum(dtype=torch.int32),
                         overflow=grid.overflow | (won & ~ok).any())


def merge_blocks_reference(acc, grid: vg.VoxelGrid, blocks, *,
                           with_grad: bool, vis=None, kf=None):
    """Merge and clear the accumulator rows of the block slots `blocks`
    (int64 [m]) with `merge_clear`'s formula, and set bit `kf` = (word, bit)
    of `vis` for every row whose weight sum is > 0."""
    vpb = grid.voxels_per_block
    rows = (blocks[:, None] * vpb + torch.arange(vpb, device=blocks.device)
            ).reshape(-1)
    a = acc[rows]
    weight, dist = grid.weight.view(-1), grid.dist.view(-1)
    w_old, d_old = weight[rows], dist[rows]
    w_new = w_old + a[:, 0]
    dist[rows] = torch.where(
        w_new > 0.0, (d_old * w_old + a[:, 1]) / torch.clamp(w_new, min=1e-30),
        d_old)
    weight[rows] = w_new
    if with_grad:
        for f, g in enumerate((grid.grad_x, grid.grad_y, grid.grad_z)):
            g.view(-1)[rows] += a[:, 2 + f]
    if kf is not None:
        hit = rows[a[:, 0] > 0.0]
        words = vis.view(-1, vis.shape[-1])
        words[hit, kf[0]] |= torch.ones((), dtype=torch.int32,
                                        device=words.device) << kf[1]
    acc[rows] = 0.0


def integrate_merge_reference(depth, normals, cache, R, t, grid, gcfg, fcfg,
                              acc, *, accumulate_gradients=True, vis=None,
                              kf_slot=None):
    """Plain PyTorch version of `integrate_merge`."""
    _, s = frame_walk(depth, normals, cache, R, t, gcfg, fcfg)
    slot = vg.lookup_keys(grid, s.keys, gcfg)
    ok = slot >= 0
    lin = (slot * gcfg.voxels_per_block + s.local_lin)[ok].long()
    nf = 5 if accumulate_gradients else 2
    fields = [s.w, s.wd, s.wn_x, s.wn_y, s.wn_z][:nf]
    acc[:, :nf].index_add_(0, lin, torch.stack([f[ok] for f in fields], -1))
    merge_blocks_reference(acc, grid, torch.unique(slot[ok]).long(),
                           with_grad=accumulate_gradients, vis=vis,
                           kf=_kf_word_bit(vis, kf_slot))
