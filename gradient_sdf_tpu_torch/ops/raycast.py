"""Sphere-tracing raycaster over the semi-implicit gradient-SDF.

Port of `gradient_sdf_tpu/ops/raycast.py`: depth and normal images rendered
by sphere tracing the block-sparse gradient-SDF (the reference has no
renderer; tracking queries the SDF at backprojected depth pixels instead).

The march. Each ray is probed at p = o + s d: the nearest voxel's raw
`dist` where it was observed. March values are constant within a voxel, so
a sign change can only happen at a voxel plane and the step is floored by
the DDA distance to the next one (a crossing is never skipped, and tangent
rays do not crawl through the truncation band). Outside allocated blocks
the field is unknown but, by construction of fusion
(`MapGradPixelSdf.cpp:101-116`), every point within the truncation distance
of the surface is allocated, so a ray skips to the next block plane, or to
the next 4^3-block coarse-cell plane where the coarse mip is empty. The
march carries the field values at the crossing bracket's two ends, so the
hit is a secant interpolation between the bracket voxels' centre
projections onto the ray (the classic TSDF crossing interpolation, made
independent of the march's path); `bisect_steps` halvings tighten the
bracket first, so that windowed and unwindowed marches bracket the same
voxel pair. All of that is one launch of `ops/kernels/raycast_march` per
`raycast` call: the hand-written CUDA kernel on the card, its plain version
on the CPU. `render_depth_normal` tells the kernel its passes' image width,
so that each warp marches a compact tile of pixels.

What the JAX module carries besides and this one does not: the burst and
straggler rounds, the capacity ladder, the compacted refinement and the
component-wise ray layout. They exist because an XLA `while_loop` costs its
widest lane count for as long as its slowest ray lives; a CUDA thread ends
with its own ray. `burst_steps` and `compact_divisors` are accepted and
ignored, so call sites carry over (in the JAX package they never change a
result either); each ray gets `max_steps` probes in all, which is what that
schedule's budgets add up to. `occlusion_zcap` was rejected as unsound
there and raises here.

`render_depth_normal` narrows each ray's march window first: from a
low-resolution prior pass (each full-resolution ray marches only inside
[min - margin, max + margin] of its coarse 3x3 neighbourhood's hit range;
with `prior_miss_skip` a ray whose whole neighbourhood missed is a miss),
from the active blocks rasterized to screen tiles (`prior_mode="raster"`,
exact), or from a depth image (`depth_prior=`, the previous frame's render
in a frame-to-model loop).

Differentiability: the march is control flow, and the kernel's outputs are
constants to autograd. The hit is re-expressed straight-through with one
Newton/IFT step from the detached secant point,
    s* = s0 - phi(o + s0 d) / (grad_phi . d),   s0 = detach(s_hit),
whose derivative at the root is the implicit-function-theorem one, so depth
gradients with respect to the pose (through o, d) and to the grid fields
(through the `tsdf_grad` gathers) flow in plain PyTorch, with no custom
backward. The semi-implicit field phi(p) = dist + s ghat.(c - p) increases
macroscopically along the stored (inward) gradient, the gradient the query
returns, but its slope inside a voxel is -s ghat (c is the frozen voxel
centre), so autograd through the query alone would flip the sign; the
polish freezes the query point and reattaches the spatial dependence as an
explicit linearization with the stored gradient.

Sign convention (reference Sdf.h:76-85): the fused field is negative in
observed free space and positive behind the surface, so rays march while
the field is < 0 and a crossing is where it turns >= 0.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..config import FusionConfig, GridConfig
from . import query
from . import voxel_grid as vg
from .kernels.raycast_march import raycast_march


class RaycastResult(NamedTuple):
    depth: torch.Tensor   # [N] ray-parameter depth (0 where no hit)
    points: torch.Tensor  # [N, 3] world-space hit points
    normal: torch.Tensor  # [N, 3] outward unit normals (-ghat)
    hit: torch.Tensor     # [N] bool


def raycast(
    grid: vg.VoxelGrid,
    origins: torch.Tensor,     # [N, 3] ray origins (world)
    dirs: torch.Tensor,        # [N, 3] unit ray directions (world)
    gcfg: GridConfig,
    fcfg: FusionConfig,
    *,
    s_min: float = 0.1,
    s_max: float = 5.0,
    s_lo: Optional[torch.Tensor] = None,   # [N] per-ray march window start
    s_hi: Optional[torch.Tensor] = None,   # [N] per-ray march window end
    max_steps: int = 128,
    bisect_steps: int = 2,
    burst_steps: int = 12,
    compact_divisors: tuple = (64,),
    refine: bool = True,
    width: Optional[int] = None,
) -> RaycastResult:
    """Trace N rays; returns the first zero crossing along each.

    `s_lo`/`s_hi` optionally bound each ray's march window (from a depth
    prior); they default to the scalar [s_min, s_max]. A window with
    s_lo > s_hi is empty: the ray is a miss and is never probed.
    `burst_steps` and `compact_divisors` are ignored (module note). With
    `refine=False` the depth is the crossing bracket's midpoint and the
    normals are zero (the prior pass's form). `width`: the rays are a
    row-major image that wide, which the kernel marches in pixel tiles
    (same results); None keeps their order."""
    n, dev = origins.shape[0], origins.device
    f32 = dict(dtype=torch.float32, device=dev)
    s0 = (torch.full((n,), s_min, **f32) if s_lo is None
          else torch.clamp(s_lo.detach(), min=s_min))
    s_end = (torch.full((n,), s_max, **f32) if s_hi is None
             else torch.clamp(s_hi.detach(), max=s_max))
    res = raycast_march(
        origins.detach().contiguous(), dirs.detach().contiguous(),
        s0.contiguous(), s_end.contiguous(), grid.directory, grid.coarse_occ,
        grid.dist.detach(), grid.weight.detach(), gcfg, fcfg,
        max_steps=max_steps, bisect_steps=bisect_steps, width=width)
    found = res.found
    zeros3 = torch.zeros((n, 3), **f32)
    if not refine:
        points = torch.where(found[:, None],
                             origins + res.s_mid[:, None] * dirs, zeros3)
        return RaycastResult(depth=res.s_mid, points=points, normal=zeros3,
                             hit=found)

    # the polish and the normal, on the hit rays only
    hit = torch.nonzero(found).reshape(-1)
    s_hit, pts, nrm = _ift_polish(grid, origins[hit], dirs[hit], res.s_star[hit],
                                  gcfg, fcfg)
    return RaycastResult(
        depth=torch.zeros(n, **f32).index_put((hit,), s_hit),
        points=zeros3.index_put((hit,), pts),
        normal=zeros3.index_put((hit,), nrm),
        hit=found,
    )


def _ift_polish(grid, o, d, s_star, gcfg, fcfg):
    """One differentiable Newton/IFT step from the detached secant point
    (module note); one semi-implicit query serves the polish and the
    normal. Returns (s_hit, points [., 3], normal [., 3]).

    Straight-through: the VALUE is the secant estimate (the march field's
    macroscopic zero crossing), the GRADIENT is the IFT expression; the
    semi-implicit field's zero level is offset from the dist field's, so
    the IFT value itself is the less accurate depth."""
    s_mid = s_star.detach()
    pts_mid = o + s_mid[:, None] * d
    pts_frozen = pts_mid.detach()
    phi_mid, grad_mid, w_mid = query.tsdf_grad(grid, pts_frozen, gcfg, fcfg)
    g_sem = grad_mid.detach()
    phi_lin = phi_mid + torch.sum(g_sem * (pts_mid - pts_frozen), dim=-1)
    denom = torch.sum(grad_mid * d, dim=-1).detach()
    # at a valid crossing the field increases along the ray (denom > 0);
    # floor the denominator for near-tangent rays
    safe = (w_mid > 0.0) & (denom > 0.0)
    s_ift = s_mid - phi_lin / torch.clamp(denom, min=0.25 * fcfg.grad_scale)
    s_hit = torch.where(safe, s_mid + s_ift - s_ift.detach(), s_mid)
    gn = torch.linalg.norm(grad_mid, dim=-1, keepdim=True)
    normal = -grad_mid / torch.clamp(gn, min=1e-12)  # stored grads: inward
    return s_hit, o + s_hit[:, None] * d, normal


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
    have s_lo > s_hi.
    """
    if occlusion_zcap:
        raise ValueError(
            "occlusion_zcap drops real geometry behind silhouettes (an "
            "allocated block need not occlude its tile's rays) and is not "
            "part of this package")
    dev = grid.device
    vs = gcfg.voxel_size
    bs = gcfg.block_shape
    cap = min(active_cap, grid.num_blocks)
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    R = torch.as_tensor(R, dtype=torch.float32, device=dev)
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
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

    # tiles -> pixels (empty tile: lo = inf > hi = -inf -> instant miss)
    def to_pixels(tiles):
        img = tiles.reshape(HT, WT).repeat_interleave(tile, 0)
        return img.repeat_interleave(tile, 1)[:height, :width].reshape(-1)

    img_lo, img_hi = to_pixels(tiles_lo), to_pixels(tiles_hi)

    # conservative escape: more active blocks than were rasterized -> the
    # full range everywhere, never a silent truncation
    over = grid.num_active > cap
    img_lo = torch.where(over, 0.0, img_lo)
    img_hi = torch.where(over, inf, img_hi)
    return img_lo, img_hi


def camera_rays(K, R, t, width: int, height: int, device=None):
    """Per-pixel world-space rays for a camera-to-world pose.

    Returns (origins [H*W,3], dirs [H*W,3] unit, inv_hnorm [H*W]) where
    camera-z depth = ray length * inv_hnorm. The tensors live on `device`,
    by default R's (the CPU for a numpy R)."""
    if device is None:
        device = R.device if torch.is_tensor(R) else "cpu"
    K = torch.as_tensor(K, dtype=torch.float32, device=device)
    R = torch.as_tensor(R, dtype=torch.float32, device=device)
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    u = (torch.arange(width, dtype=torch.float32, device=device) - cx) / fx
    v = (torch.arange(height, dtype=torch.float32, device=device) - cy) / fy
    y0, x0 = torch.meshgrid(v, u, indexing="ij")
    h = torch.stack([x0, y0, torch.ones_like(x0)], dim=-1).reshape(-1, 3)
    hnorm = torch.linalg.norm(h, dim=-1, keepdim=True)
    d_cam = h / hnorm
    dirs = d_cam @ R.T
    origins = t.expand(dirs.shape)
    return origins, dirs, 1.0 / hnorm[..., 0]


def _neighborhood_minmax(img: torch.Tensor, mask: torch.Tensor):
    """3x3 min/max over `img` counting only masked entries; also returns
    whether any neighbour is masked. The border is padded with "no entry"
    (a wrap would import hit windows from the opposite image border)."""
    h, w = img.shape
    inf = float("inf")
    pad = torch.nn.functional.pad
    big = pad(torch.where(mask, img, inf), (1, 1, 1, 1), value=inf)
    small = pad(torch.where(mask, img, -inf), (1, 1, 1, 1), value=-inf)
    maskp = pad(mask, (1, 1, 1, 1), value=False)
    mn = torch.full_like(img, inf)
    mx = torch.full_like(img, -inf)
    anym = torch.zeros_like(mask)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            mn = torch.minimum(mn, big[dy:dy + h, dx:dx + w])
            mx = torch.maximum(mx, small[dy:dy + h, dx:dx + w])
            anym = anym | maskp[dy:dy + h, dx:dx + w]
    return mn, mx, anym


def render_depth_normal(
    grid: vg.VoxelGrid,
    K,
    R,
    t,
    width: int,
    height: int,
    gcfg: GridConfig,
    fcfg: FusionConfig,
    *,
    prior_stride: int = 4,
    prior_mode: str = "stride",
    prior_miss_skip: bool = True,
    prior_occlusion_zcap: bool = False,
    depth_prior: Optional[torch.Tensor] = None,
    depth_prior_holes: str = "march",
    prior_margin_voxels: Optional[float] = None,
    s_min: float = 0.1,
    s_max: float = 5.0,
    **kw,
):
    """Render a depth (camera-z) and normal image from pose (R, t), on the
    grid's device. Returns (depth [H, W], normal [H, W, 3], hit [H, W]).

    With `prior_stride` > 1 a low-res prior pass (1/stride^2 of the rays,
    itself bounded by the block-raster windows) marches first and each
    full-res ray then marches only inside the [min - margin, max + margin]
    hit range of its coarse 3x3 neighbourhood. With `prior_miss_skip`
    (default), rays whose WHOLE coarse neighbourhood missed are declared
    misses without marching: only geometry thinner than the prior stride
    can be lost. `prior_miss_skip=False` marches those rays over the full
    range instead, `prior_stride=0` disables the prior entirely, and
    `prior_mode="raster"` takes the exact block-raster windows for the
    full-res rays (no low-res march, no miss heuristic). The stride prior's
    windows are a heuristic too: at an occlusion boundary a ray whose coarse
    neighbourhood hit only the far surface starts behind the near one and
    returns the far surface. Where that matters take `prior_stride=0` or
    the raster windows, which are exact.

    `depth_prior` (optional [H, W] camera-z image, e.g. the previous frame's
    render in a frame-to-model loop) replaces the prior pass: each ray
    marches a +-margin window around its prior depth, where margin is
    `prior_margin_voxels * voxel_size` if given and T + 2 voxels otherwise
    (safe against any prior error below the truncation distance).
    `depth_prior_holes` decides prior-hole (depth 0) rays: "march" (default,
    safe) marches them over the full range; "skip" declares them misses.
    """
    if prior_occlusion_zcap:
        raise ValueError("prior_occlusion_zcap: see block_raster_windows "
                         "(occlusion_zcap is not part of this package)")
    dev = grid.device
    # the camera goes to the device once (each host array is a synchronizing
    # copy); camera_rays and block_raster_windows take the tensors as they are
    K, R, t = (torch.as_tensor(a, dtype=torch.float32, device=dev)
               for a in (K, R, t))
    origins, dirs, inv_hnorm = camera_rays(K, R, t, width, height, device=dev)
    T = fcfg.trunc_voxels * gcfg.voxel_size
    # margin applies to BOTH prior flavours (per-pixel depth prior and the
    # coarse stride-prior windows below)
    margin = (float(prior_margin_voxels) * gcfg.voxel_size
              if prior_margin_voxels is not None
              else T + 2.0 * gcfg.voxel_size)

    def windows(ok, lo, hi, skip):
        """March windows from a range estimate [lo, hi] valid where `ok`;
        elsewhere empty (`skip`) or the full range."""
        s_lo = torch.where(ok, torch.clamp(lo - margin, min=s_min),
                           s_max if skip else s_min)
        s_hi = torch.where(ok, torch.clamp(hi + margin, max=s_max),
                           s_min - 1.0 if skip else s_max)
        return s_lo, s_hi

    s_lo = s_hi = None
    if depth_prior is None and prior_mode == "raster":
        s_lo, s_hi = block_raster_windows(grid, K, R, t, width, height, gcfg)
    elif depth_prior is not None:
        prior = torch.as_tensor(depth_prior, dtype=torch.float32,
                                device=dev).detach().reshape(-1)
        sp = prior / inv_hnorm.detach()
        s_lo, s_hi = windows(prior > 0, sp, sp, depth_prior_holes == "skip")
    elif prior_stride and prior_stride > 1 and width % prior_stride == 0 \
            and height % prior_stride == 0:
        wc, hc = width // prior_stride, height // prior_stride
        off = prior_stride // 2

        def coarse(a):
            """The full-res rays' values at the strided pixel centres."""
            img = a.reshape((height, width) + tuple(a.shape[1:]))
            return img[off::prior_stride, off::prior_stride].reshape(
                (-1,) + tuple(a.shape[1:]))

        # the exact block-raster windows bound the COARSE pass: its
        # background rays die at once instead of marching the whole range
        # to conclude "miss". (For the full-res pass a hull window has no
        # occlusion and is the worse bound: silhouette rays would march the
        # whole front-to-back gap.)
        rw_lo, rw_hi = block_raster_windows(grid, K, R, t, width, height, gcfg)
        res_c = raycast(grid, coarse(origins), coarse(dirs), gcfg, fcfg,
                        s_min=s_min, s_max=s_max, s_lo=coarse(rw_lo),
                        s_hi=coarse(rw_hi), refine=False, width=wc, **kw)
        mn, mx, anyhit = _neighborhood_minmax(res_c.depth.reshape(hc, wc),
                                              res_c.hit.reshape(hc, wc))
        lo_c, hi_c = windows(anyhit, mn, mx, prior_miss_skip)

        def fine(a):
            return a.repeat_interleave(prior_stride, 0).repeat_interleave(
                prior_stride, 1).reshape(-1)

        s_lo, s_hi = fine(lo_c), fine(hi_c)

    res = raycast(grid, origins, dirs, gcfg, fcfg, s_min=s_min, s_max=s_max,
                  s_lo=s_lo, s_hi=s_hi, width=width, **kw)
    depth = (res.depth * inv_hnorm).reshape(height, width)
    normal = res.normal.reshape(height, width, 3)
    hit = res.hit.reshape(height, width)
    return depth, normal, hit
