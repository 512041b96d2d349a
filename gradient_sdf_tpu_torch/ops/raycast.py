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

The passes around the march are kernels on the card too, each beside its
plain version (the CPU path and the kernel's oracle): the block-raster
windows (`ops/kernels/render_windows`), the stride and depth priors'
windows (`ops/kernels/prior_windows`) and the finish below
(`ops/kernels/ray_finish`). A render on the card reads nothing back to the
host between its first launch and its return; host arrays K, R, t go up in
one copy before it.

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
(through the `tsdf_grad` gathers) flow: by autograd through the plain
version on the CPU, through `ray_finish.RayFinish`'s backward (the same
gradients) on the card. The semi-implicit field
phi(p) = dist + s ghat.(c - p) increases
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

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import FusionConfig, GridConfig
from . import voxel_grid as vg
from .kernels.prior_windows import depth_prior_windows, stride_windows
# the JAX module's names for two plain passes, kept here for its callers
from .kernels.prior_windows import neighborhood_minmax as _neighborhood_minmax  # noqa: F401
from .kernels.ray_finish import ray_finish
from .kernels.raycast_march import raycast_march
from .kernels.render_windows import block_raster_windows  # noqa: F401
from .kernels.render_windows import render_windows


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
    return _trace(grid, origins, dirs, s0, s_end, gcfg, fcfg,
                  max_steps=max_steps, bisect_steps=bisect_steps,
                  refine=refine, width=width)[0]


def _trace(grid, origins, dirs, s0, s_end, gcfg, fcfg, *, max_steps=128,
           bisect_steps=2, burst_steps=12, compact_divisors=(64,),
           refine=True, width=None, inv_hnorm=None):
    """The march inside the windows [s0, s_end] (taken as they are), then
    the finish (`ray_finish`). Returns (RaycastResult, the camera-z depth
    where `inv_hnorm` is given, else None); with `inv_hnorm` the result
    carries no points (None)."""
    o, d = origins.contiguous(), dirs.contiguous()
    res = raycast_march(
        o.detach(), d.detach(), s0.contiguous(), s_end.contiguous(),
        grid.directory, grid.coarse_occ, grid.dist.detach(),
        grid.weight.detach(), gcfg, fcfg, max_steps=max_steps,
        bisect_steps=bisect_steps, width=width)
    found = res.found
    if not refine:
        zeros3 = torch.zeros_like(o)
        points = torch.where(found[:, None], o + res.s_mid[:, None] * d, zeros3)
        out = RaycastResult(depth=res.s_mid, points=points, normal=zeros3,
                            hit=found)
        return out, None if inv_hnorm is None else res.s_mid * inv_hnorm
    fin = ray_finish(found, res.s_star, o, d, inv_hnorm, grid, gcfg, fcfg,
                     points=inv_hnorm is None)
    return (RaycastResult(depth=fin.depth, points=fin.points,
                          normal=fin.normal, hit=found), fin.zdepth)


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
    K, R, t = _camera_on(dev, K, R, t)
    origins, dirs, inv_hnorm = camera_rays(K, R, t, width, height, device=dev)
    T = fcfg.trunc_voxels * gcfg.voxel_size
    # margin applies to BOTH prior flavours (per-pixel depth prior and the
    # coarse stride-prior windows below)
    margin = (float(prior_margin_voxels) * gcfg.voxel_size
              if prior_margin_voxels is not None
              else T + 2.0 * gcfg.voxel_size)
    clamps = dict(s_min=s_min, s_max=s_max)

    # each branch gives the full-resolution windows already clamped to
    # [s_min, s_max], as `raycast` would clamp them
    if depth_prior is None and prior_mode == "raster":
        s0, s_end = render_windows(grid, K, R, t, width, height, gcfg, **clamps)
    elif depth_prior is not None:
        prior = torch.as_tensor(depth_prior, dtype=torch.float32,
                                device=dev).detach().reshape(-1)
        s0, s_end = depth_prior_windows(prior, inv_hnorm.detach(), margin,
                                        skip=depth_prior_holes == "skip",
                                        **clamps)
    elif prior_stride and prior_stride > 1 and width % prior_stride == 0 \
            and height % prior_stride == 0:
        wc, hc = width // prior_stride, height // prior_stride
        off = prior_stride // 2

        def coarse(a):
            """The full-res rays' values at the strided pixel centres."""
            img = a.reshape((height, width) + tuple(a.shape[1:]))
            return img[off::prior_stride, off::prior_stride].reshape(
                (-1,) + tuple(a.shape[1:])).detach().contiguous()

        # the exact block-raster windows bound the COARSE pass: its
        # background rays die at once instead of marching the whole range
        # to conclude "miss". (For the full-res pass a hull window has no
        # occlusion and is the worse bound: silhouette rays would march the
        # whole front-to-back gap.) The coarse pass is the march alone: its
        # bracket midpoints and hit mask are all the windows need.
        rw_lo, rw_hi = render_windows(grid, K, R, t, width, height, gcfg,
                                      stride=prior_stride, offset=off, **clamps)
        res_c = raycast_march(
            coarse(origins), coarse(dirs), rw_lo, rw_hi, grid.directory,
            grid.coarse_occ, grid.dist.detach(), grid.weight.detach(), gcfg,
            fcfg, max_steps=kw.get("max_steps", 128),
            bisect_steps=kw.get("bisect_steps", 2), width=wc)
        s0, s_end = stride_windows(res_c.s_mid, res_c.found, hc, wc,
                                   prior_stride, margin, skip=prior_miss_skip,
                                   **clamps)
    else:
        n = origins.shape[0]
        s0 = torch.full((n,), s_min, dtype=torch.float32, device=dev)
        s_end = torch.full((n,), s_max, dtype=torch.float32, device=dev)

    res, depth = _trace(grid, origins, dirs, s0, s_end, gcfg, fcfg,
                        width=width, inv_hnorm=inv_hnorm, **kw)
    return (depth.reshape(height, width),
            res.normal.reshape(height, width, 3),
            res.hit.reshape(height, width))


def _camera_on(dev, K, R, t):
    """K, R, t as float32 tensors on `dev`. Host arrays go up in one copy
    (each host-to-device copy waits for the device); tensors are taken as
    they are, gradients included."""
    if not any(torch.is_tensor(a) for a in (K, R, t)):
        flat = np.concatenate([np.asarray(a, dtype=np.float32).reshape(-1)
                               for a in (K, R, t)])
        if flat.shape != (21,):
            raise ValueError(f"K, R, t must hold 9, 9 and 3 numbers, got "
                             f"{flat.shape[0]} in all")
        up = torch.as_tensor(flat, device=dev)
        return up[:9].reshape(3, 3), up[9:18].reshape(3, 3), up[18:]
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                 for a in (K, R, t))
