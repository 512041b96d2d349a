"""render_windows: the renderer's exact march windows from the active
blocks rasterized to screen tiles (`block_raster_windows`).

For the active block slots of a grid and a camera it computes what
`block_raster_windows` computes in `gradient_sdf_tpu/ops/raycast.py`
(:544-694): each block's conservative ray-parameter range [|q| - r, |q| +
r], min/max-scattered into the 16-pixel tiles its projected bounding sphere
covers; blocks that straddle the camera plane or span `max_span` tiles or
more go into a range every tile takes; more active blocks than `active_cap`
give every pixel [0, inf]. A pixel takes its tile's window; pixels whose
tile no block covers get [inf, -inf], an empty window (an exact miss).

The JAX package leaves this to XLA. In eager PyTorch it is ~100 small
launches (`render_windows_reference`, the plain version), so on the card
it is one launch of the hand-written kernel of `csrc/render_windows.cu`:
the tile grid is cut into patches (4 x 4 tiles at VGA, larger for larger
images, so the grid stays at most one CTA an SM and a patch fits in shared
memory at any image size), and each CTA projects every active block,
min/maxes its range into the tiles of its own patch where the block's span
meets it (the scattered values are non-negative floats, so integer atomics
on their bits are exact and the tiles equal the plain version's bit for
bit), reduces the global range itself and writes its patch's windows with
16-byte stores. Its bound is the 8 B a window it writes and the 12 B a
block slot it reads; at VGA the launch and the projection, which every CTA
repeats, take most of its time. `num_active` is read on the device, so a
call makes no host sync. The output is every pixel's window, or only the
strided pixels (`stride`, `offset`) that a coarse pass marches, optionally
clamped to [s_min, s_max] as `raycast` clamps them. On a CUDA grid the
wrapper launches the kernel or raises; on a CPU grid it takes the plain
version.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ...config import GridConfig
from .. import voxel_grid as vg

# wrapper calls that launched the kernel since the last
# reset_launch_count() (one launch a call); the CPU path does not count
launch_count = 0


def reset_launch_count():
    global launch_count
    launch_count = 0


def out_shape(width: int, height: int, stride: int, offset: int):
    """(rows, cols) of the windows a call returns: the pixels offset + k
    stride of each axis."""
    return (-(-(height - offset) // stride), -(-(width - offset) // stride))


def _check(grid: vg.VoxelGrid, width, height, tile, stride, offset):
    nt = -(-width // tile) * -(-height // tile)
    if width <= 0 or height <= 0 or tile <= 0:
        raise ValueError(f"image {width}x{height}, tile {tile}: all must be positive")
    if stride <= 0 or not 0 <= offset < min(stride, width, height):
        raise ValueError(f"stride {stride}, offset {offset}: want 0 <= offset "
                         f"< stride and offset inside the image")
    if grid.block_coords.dtype != torch.int32 or grid.block_coords.dim() != 2 \
            or grid.block_coords.shape[1] != 3:
        raise ValueError("block_coords must be int32 [num_blocks, 3]")
    return nt


def _camera(K, R, t, dev):
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                 for a in (K, R, t))


def raster_tiles_reference(grid: vg.VoxelGrid, K, R, t, width: int, height: int,
                           gcfg: GridConfig, *, tile: int = 16,
                           max_span: int = 4, active_cap: int = 4096):
    """Plain PyTorch version of the raster launch: the finished tile grid
    (tiles_lo, tiles_hi), each f32 [HT * WT], row-major, with the global
    range folded in and the `active_cap` escape applied."""
    dev = grid.device
    vs = gcfg.voxel_size
    bs = gcfg.block_shape
    cap = min(active_cap, grid.num_blocks)
    K, R, t = _camera(K, R, t, dev)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    WT = -(-width // tile)
    HT = -(-height // tile)
    inf = float("inf")

    bc = grid.block_coords[:cap]
    alive = torch.arange(cap, dtype=torch.int32, device=dev) < grid.num_active
    # block centre / bounding radius (voxel i spans [i*vs - vs/2, +vs/2])
    ccx = (bc[:, 0].to(torch.float32) * bs + 0.5 * (bs - 1)) * vs
    ccy = (bc[:, 1].to(torch.float32) * bs + 0.5 * (bs - 1)) * vs
    ccz = (bc[:, 2].to(torch.float32) * bs + 0.5 * (bs - 1)) * vs
    r = 0.5 * bs * vs * math.sqrt(3.0)

    dx_ = ccx - t[0]
    dy_ = ccy - t[1]
    dz_ = ccz - t[2]
    qx = R[0, 0] * dx_ + R[1, 0] * dy_ + R[2, 0] * dz_
    qy = R[0, 1] * dx_ + R[1, 1] * dy_ + R[2, 1] * dz_
    qz = R[0, 2] * dx_ + R[1, 2] * dy_ + R[2, 2] * dz_
    s_c = torch.sqrt(qx * qx + qy * qy + qz * qz)
    lo_b = torch.clamp(s_c - r, min=0.0)
    hi_b = s_c + r

    behind = alive & (qz + r <= 0.0)          # no forward ray reaches it
    near = alive & ~behind & (qz <= r)        # straddles the camera plane
    proj = alive & ~behind & ~near
    qz_safe = torch.where(proj, qz, 1.0)
    u = fx * qx / qz_safe + cx
    v = fy * qy / qz_safe + cy
    # conservative silhouette half-extent: fx*r/(qz-r) is exact only
    # on-axis; an off-axis sphere's screen silhouette extends up to |q|/qz
    # times further, so scale by s_c/qz >= 1. The same bound gates the
    # offscreen cull, so a partially visible block is never culled.
    sil = s_c / qz_safe
    ru = fx * r * sil / torch.clamp(qz_safe - r, min=1e-6)
    rv = fy * r * sil / torch.clamp(qz_safe - r, min=1e-6)

    def tile_of(x, last):
        # clamped as floats: a block grazing the camera plane projects to
        # values no int32 holds
        return torch.clamp(torch.floor(x / tile), 0, last).to(torch.int32)

    tx0, tx1 = tile_of(u - ru, WT - 1), tile_of(u + ru, WT - 1)
    ty0, ty1 = tile_of(v - rv, HT - 1), tile_of(v + rv, HT - 1)
    offscreen = proj & ((u + ru < 0) | (u - ru >= width)
                        | (v + rv < 0) | (v - rv >= height))
    proj = proj & ~offscreen
    wide = proj & ((tx1 - tx0 >= max_span) | (ty1 - ty0 >= max_span))
    proj = proj & ~wide

    # global (all-tile) contribution from near/wide blocks
    glob = near | wide
    glob_lo = torch.min(torch.where(glob, lo_b, inf))
    glob_hi = torch.max(torch.where(glob, hi_b, -inf))

    # scatter each projecting block's range into its covered tiles; a sink
    # tile past the end takes what is masked out
    ii = torch.arange(max_span, dtype=torch.int32, device=dev)
    tyi = ty0[:, None] + ii[None, :]                       # [cap, S]
    txj = tx0[:, None] + ii[None, :]
    ok_y = proj[:, None] & (tyi <= ty1[:, None])
    ok_x = txj <= tx1[:, None]
    idx = tyi[:, :, None] * WT + txj[:, None, :]           # [cap, S, S]
    ok = ok_y[:, :, None] & ok_x[:, None, :]
    nt = WT * HT
    idx = torch.where(ok, idx, nt).reshape(-1).long()
    shape = (cap, max_span, max_span)
    lo_s = lo_b[:, None, None].expand(shape).reshape(-1)
    hi_s = hi_b[:, None, None].expand(shape).reshape(-1)
    tiles_lo = torch.full((nt + 1,), inf, dtype=torch.float32, device=dev)
    tiles_hi = torch.full((nt + 1,), -inf, dtype=torch.float32, device=dev)
    tiles_lo.scatter_reduce_(0, idx, lo_s, "amin", include_self=True)
    tiles_hi.scatter_reduce_(0, idx, hi_s, "amax", include_self=True)
    tiles_lo = torch.clamp(tiles_lo[:nt], max=glob_lo)
    tiles_hi = torch.clamp(tiles_hi[:nt], min=glob_hi)

    # conservative escape: more active blocks than were rasterized -> the
    # full range everywhere, never a silent truncation
    over = grid.num_active > cap
    return torch.where(over, 0.0, tiles_lo), torch.where(over, inf, tiles_hi)


def render_windows_reference(grid: vg.VoxelGrid, K, R, t, width: int,
                             height: int, gcfg: GridConfig, *, tile: int = 16,
                             max_span: int = 4, active_cap: int = 4096,
                             stride: int = 1, offset: int = 0,
                             s_min: Optional[float] = None,
                             s_max: Optional[float] = None):
    """Plain PyTorch version of `render_windows`, on any device."""
    _check(grid, width, height, tile, stride, offset)
    tiles_lo, tiles_hi = raster_tiles_reference(
        grid, K, R, t, width, height, gcfg, tile=tile, max_span=max_span,
        active_cap=active_cap)
    # tiles -> the pixels (offset + k stride) of each axis
    dev = grid.device
    hs, ws = out_shape(width, height, stride, offset)
    ty = (offset + stride * torch.arange(hs, device=dev)) // tile
    tx = (offset + stride * torch.arange(ws, device=dev)) // tile
    k = (ty[:, None] * -(-width // tile) + tx[None, :]).reshape(-1)
    lo, hi = tiles_lo[k], tiles_hi[k]
    if s_min is not None:
        lo = torch.clamp(lo, min=s_min)
    if s_max is not None:
        hi = torch.clamp(hi, max=s_max)
    return lo, hi


def render_windows(grid: vg.VoxelGrid, K, R, t, width: int, height: int,
                   gcfg: GridConfig, *, tile: int = 16, max_span: int = 4,
                   active_cap: int = 4096, stride: int = 1, offset: int = 0,
                   s_min: Optional[float] = None,
                   s_max: Optional[float] = None):
    """(s_lo, s_hi), each f32 [rows * cols] (`out_shape`): the block-raster
    windows of the pixels (offset + i stride, offset + j stride) of a
    width x height image seen from the camera-to-world pose (R, t) with
    intrinsics K (arrays or tensors; moved to the grid's device), each
    clamped to [s_min, s_max] where given. Every pixel's window for stride
    1 (the default); `stride=tile`, `offset=0` and no clamps give the
    finished tile grid itself (pixel k tile lies in tile k). On CUDA the
    one launch goes on the current stream without synchronizing."""
    dev = grid.device
    if dev.type == "cpu":
        return render_windows_reference(
            grid, K, R, t, width, height, gcfg, tile=tile, max_span=max_span,
            active_cap=active_cap, stride=stride, offset=offset, s_min=s_min,
            s_max=s_max)
    if dev.type != "cuda":
        raise RuntimeError(f"render_windows: no kernel for {dev}")
    from . import _build

    _check(grid, width, height, tile, stride, offset)
    if max(width, height) + tile >= 2**31:
        raise ValueError(f"image {width}x{height}, tile {tile}: past the "
                         f"kernel's int32 pixel index")
    if grid.num_blocks * 3 >= 2**31:
        raise ValueError(f"{grid.num_blocks} block slots exceed the kernel's "
                         f"int32 index")
    lib = _build.load()
    K, R, t = (a.contiguous() for a in _camera(K, R, t, dev))
    if K.shape != (3, 3) or R.shape != (3, 3) or t.shape != (3,):
        raise ValueError(f"K, R, t must be [3, 3], [3, 3], [3]; got "
                         f"{tuple(K.shape)}, {tuple(R.shape)}, {tuple(t.shape)}")
    bc = grid.block_coords.contiguous()
    num_active = grid.num_active.to(torch.int32)
    hs, ws = out_shape(width, height, stride, offset)
    f32 = dict(dtype=torch.float32, device=dev)
    if hs * ws >= 2**31:
        raise ValueError(f"{hs * ws} windows exceed the kernel's int32 index")
    lo = torch.empty(hs * ws, **f32)
    hi = torch.empty(hs * ws, **f32)
    vs, bs = gcfg.voxel_size, gcfg.block_shape
    r = 0.5 * bs * vs * math.sqrt(3.0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gsdf_render_windows_f32(
            K.data_ptr(), R.data_ptr(), t.data_ptr(), bc.data_ptr(),
            num_active.data_ptr(), min(active_cap, grid.num_blocks), bs,
            vs, r, width, height, tile,
            float(np.float32(1.0) / np.float32(tile)), max_span, stride,
            offset, hs, ws, int(s_min is not None or s_max is not None),
            -math.inf if s_min is None else s_min,
            math.inf if s_max is None else s_max,
            lo.data_ptr(), hi.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"render_windows kernel launch failed: CUDA error {rc}")
    global launch_count
    launch_count += 1
    return lo, hi


def block_raster_windows(grid: vg.VoxelGrid, K, R, t,
                         width: int, height: int, gcfg: GridConfig,
                         *, tile: int = 16, max_span: int = 4,
                         active_cap: int = 4096,
                         occlusion_zcap: bool = False):
    """EXACT per-pixel march windows by rasterizing the active blocks.

    Every observed zero crossing lies inside an allocated block (fusion
    allocates the whole truncation band, MapGradPixelSdf.cpp:101-116), so
    the union of the active blocks' bounding spheres bounds the surface:
    each block is projected to the image, its conservative ray-parameter
    range [|q| - r, |q| + r] scatter-min/maxed into a (H/tile x W/tile)
    tile grid, and pixels take their tile's hull. Pixels whose tile no
    block covers are exact misses.

    Conservative escapes (windows only widen, never drop coverage):
      * blocks whose projected span exceeds `max_span` tiles, or that
        straddle the camera plane, contribute a global range to every tile;
      * more than `active_cap` active blocks -> full-range windows.

    Returns (s_lo [H*W], s_hi [H*W]) ray-parameter bounds; empty windows
    have s_lo > s_hi. `render_windows` over every pixel, unclamped.
    """
    if occlusion_zcap:
        raise ValueError(
            "occlusion_zcap drops real geometry behind silhouettes (an "
            "allocated block need not occlude its tile's rays) and is not "
            "part of this package")
    return render_windows(grid, K, R, t, width, height, gcfg, tile=tile,
                          max_span=max_span, active_cap=active_cap)
