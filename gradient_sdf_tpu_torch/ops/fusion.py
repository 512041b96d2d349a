"""TSDF + gradient fusion: integrate one depth frame into the sparse grid.

Port of `gradient_sdf_tpu/ops/fusion.py` (`MapGradPixelSdf::update`,
`MapGradPixelSdf.cpp:43-122`), same steps:

  1. FALS normals for the frame (ops.normals).
  2. Per-pixel gating: depth in (z_min, z_max); finite normal with
     ||n||^2 >= 0.1; viewing angle (n.h)^2/||h||^2 >= 0.25 (:87, :95, :98).
  3. Every valid pixel walks 2*floor(T/vs)+1 voxel samples along its ray
     (:79, :101-106): sample point -> nearest voxel -> projective SDF.
  4. Block allocation for the touched blocks (claim insert,
     ops.voxel_grid), then a scatter-add of (w, w*trunc(sdf), w*R n) per
     sample into the [nvox, 8] accumulator (one 32-byte row per voxel).
  5. Merge with the running state: W' = W + sum w,
     d' = (d W + sum w trunc_sdf) / W', g' = g + sum w R n — the
     order-independent fixed point of the reference's running mean
     (:108-116) — and zero the accumulator again, over the touched blocks
     only (an untouched row's accumulator is zero).

`fuse_frame` runs step 1 through `ops/kernels/fals_normals.py` (on the
card one launch of its hand-written kernel) and steps 2-5 through
`ops/kernels/fuse_integrate.py`: on the card two launches of its
hand-written kernel and no host sync, the
claim pass (gates, walk, lookup; it marks the samples whose block is
missing, claims each such block for its lowest candidate and lists the
tiles with a valid pixel) and the integrate-and-merge pass (the block claim's slot
hand-out, then walk, lookup, scatter, merge, visibility bits); on the CPU
their plain versions, with the block claim (`claim_blocks`, plain
PyTorch) between them. Slot order is the JAX package's: the claim's
winners are ordered by their global (pixel, k) candidate index.

A fused frame on the card: three kernel launches and the claim status's
memset, no host sync. `GradSdfMap.update` adds one for the growth flags;
on one card without a mesh or visibility words it replays the four, and
the flags' copies to pinned host memory, as one CUDA graph
(`models/grad_sdf`).

`frame_samples`, `_alloc_slots`, `_scatter_samples` and
`_merge_accumulators` are the same steps as plain tensor passes around the
scatter kernel (ops/kernels/scatter_add.py) and `merge_clear`
(ops/kernels/merge_clear.py): the mesh's sharded fusion
(`parallel/sharding.py`) runs the first two and the scatter kernel, and
merges with `merge_clear.merge_touched`; `tools/fusion_bench.py --split`
times all four.

The accumulator is all-zero on entry and on exit. `GradSdfMap` owns one for
the life of the map, with the kernel's scratch (`fuse_integrate.new_scratch`),
and passes both in; a bare call without them allocates (and drops) its own.
Neither is part of the map's saved state.

The grid's tensors are updated IN PLACE (see ops/voxel_grid.py); use the
returned grid.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import FusionConfig, GridConfig
from . import voxel_grid as vg
from .filters import median_blur
from .kernels import fuse_integrate as fi
from .kernels.fals_normals import fals_normals
from .kernels.merge_clear import merge_clear
from .kernels.scatter_add import new_accumulator as _new_rows
from .kernels.scatter_add import scatter_add_fields
from .normals import NormalEstimatorCache, compute_normals


class FrameSamples(NamedTuple):
    """Flattened per-sample fusion contributions (component tensors)."""

    keys: torch.Tensor       # int32 [N] packed block keys (EMPTY where invalid)
    local_lin: torch.Tensor  # int32 [N] intra-block voxel offset
    w: torch.Tensor          # f32 [N] integration weight (0 where invalid)
    wd: torch.Tensor         # f32 [N] w * trunc(sdf)
    wn_x: torch.Tensor       # f32 [N] w * (R n)_x
    wn_y: torch.Tensor
    wn_z: torch.Tensor
    oob: torch.Tensor        # int32 [] valid samples outside the directory range


class FrameRays(NamedTuple):
    """Flat per-pixel quantities feeding the sample walk (all [H*W])."""

    z: torch.Tensor        # depth
    hx: torch.Tensor       # ray direction x0 (camera frame, z=1 plane)
    hy: torch.Tensor
    nx: torch.Tensor       # FALS normal (camera frame; zeroed where non-finite)
    ny: torch.Tensor
    nz: torch.Tensor
    valid: torch.Tensor    # bool: all three reference pixel gates


def _pixel_rays(depth: torch.Tensor, normal_img: torch.Tensor,
                cache: NormalEstimatorCache, fcfg: FusionConfig) -> FrameRays:
    """Per-pixel gating (reference `MapGradPixelSdf.cpp:85-98`)."""
    z = depth
    hx, hy = cache.x0, cache.y0
    nx = normal_img[..., 0]
    ny = normal_img[..., 1]
    nz = normal_img[..., 2]

    n_finite = torch.isfinite(nx) & torch.isfinite(ny) & torch.isfinite(nz)
    zero = torch.zeros_like(nx)
    nx = torch.where(n_finite, nx, zero)
    ny = torch.where(n_finite, ny, zero)
    nz = torch.where(n_finite, nz, zero)
    n_sq = nx * nx + ny * ny + nz * nz
    ndoth = nx * hx + ny * hy + nz
    valid = (
        (z > fcfg.z_min)
        & (z < fcfg.z_max)
        & n_finite
        & (n_sq >= fcfg.normal_sq_min)
        & (ndoth * ndoth * cache.n_sq_inv >= fcfg.view_angle_cos_sq)
    )
    stride = int(fcfg.fusion_stride)
    if stride > 1:
        # integrate every stride-th pixel only; gates and normals above
        # still use the full image
        hh, ww = z.shape
        dev = z.device
        row_ok = (torch.arange(hh, device=dev) % stride == 0)[:, None]
        col_ok = (torch.arange(ww, device=dev) % stride == 0)[None, :]
        valid = valid & row_ok & col_ok
    return FrameRays(
        z=z.reshape(-1),
        hx=hx.expand(z.shape).reshape(-1),
        hy=hy.expand(z.shape).reshape(-1),
        nx=nx.reshape(-1),
        ny=ny.reshape(-1),
        nz=nz.reshape(-1),
        valid=valid.reshape(-1),
    )


def _ray_samples(rays: FrameRays, R: torch.Tensor, t: torch.Tensor,
                 gcfg: GridConfig, fcfg: FusionConfig) -> FrameSamples:
    """Walk 2*floor(T/vs)+1 voxel samples along each (flat) ray
    (reference :79, :101-116) -> packed keys + weighted contributions."""
    vs = gcfg.voxel_size
    inv_vs = 1.0 / vs
    b = gcfg.block_shape
    T = fcfg.trunc_voxels * vs
    factor = int(fcfg.trunc_voxels)  # floor(T / vs), reference :79

    z, hx, hy = rays.z, rays.hx, rays.hy
    nx, ny, nz = rays.nx, rays.ny, rays.nz

    rh_x = R[0, 0] * hx + R[0, 1] * hy + R[0, 2]
    rh_y = R[1, 0] * hx + R[1, 1] * hy + R[1, 2]
    rh_z = R[2, 0] * hx + R[2, 1] * hy + R[2, 2]
    rn_x = R[0, 0] * nx + R[0, 1] * ny + R[0, 2] * nz
    rn_y = R[1, 0] * nx + R[1, 1] * ny + R[1, 2] * nz
    rn_z = R[2, 0] * nx + R[2, 1] * ny + R[2, 2] * nz

    ks = torch.arange(-factor, factor + 1, dtype=torch.float32, device=z.device)
    depth_k = z[:, None] + ks * vs  # [N, K]

    px = depth_k * rh_x[:, None] + t[0]
    py = depth_k * rh_y[:, None] + t[1]
    pz = depth_k * rh_z[:, None] + t[2]
    # torch.round is half-to-even, like jnp.round
    vi_x = torch.round(px * inv_vs).to(torch.int32)
    vi_y = torch.round(py * inv_vs).to(torch.int32)
    vi_z = torch.round(pz * inv_vs).to(torch.int32)

    # projective SDF: (R^T (c - t))_z = column 2 of R dotted with (c - t)
    sdf = (
        R[0, 2] * (vi_x.to(torch.float32) * vs - t[0])
        + R[1, 2] * (vi_y.to(torch.float32) * vs - t[1])
        + R[2, 2] * (vi_z.to(torch.float32) * vs - t[2])
        - z[:, None]
    )

    if fcfg.cosine_correction:
        # opt-in, non-parity point-to-plane correction (see the JAX module):
        # scale by the FALS-normal incidence cosine, floored at 0.1
        n_norm = torch.sqrt(nx * nx + ny * ny + nz * nz)
        h_norm = torch.sqrt(hx * hx + hy * hy + 1.0)
        cosang = torch.abs(nx * hx + ny * hy + nz) / torch.clamp(
            n_norm * h_norm, min=1e-12)
        sdf = sdf * torch.clamp(cosang, 0.1, 1.0)[:, None]

    # integration weight (Sdf.h:76-85): 1 behind surface, linear drop in front
    w = torch.where(sdf <= 0.0, torch.ones_like(sdf),
                    torch.clamp(1.0 - sdf / T, min=0.0))
    w = torch.where(rays.valid[:, None], w, torch.zeros_like(w))
    trunc_sdf = torch.clamp(sdf, -T, T)

    bx = torch.div(vi_x, b, rounding_mode="floor")
    by = torch.div(vi_y, b, rounding_mode="floor")
    bz = torch.div(vi_z, b, rounding_mode="floor")
    local_lin = ((vi_z - bz * b) * b + (vi_y - by * b)) * b + (vi_x - bx * b)
    keys = vg.pack_key_xyz(bx, by, bz, gcfg)
    # valid samples whose block lies outside the directory's world range are
    # dropped this frame but counted, so the map can grow the directory
    live = w > 0.0
    oob = ((keys < 0) & live).sum(dtype=torch.int32)
    keys = torch.where(live, keys, torch.full_like(keys, vg.EMPTY_KEY))

    return FrameSamples(
        keys=keys.reshape(-1),
        local_lin=local_lin.reshape(-1),
        w=w.reshape(-1),
        wd=(w * trunc_sdf).reshape(-1),
        wn_x=(w * rn_x[:, None]).reshape(-1),
        wn_y=(w * rn_y[:, None]).reshape(-1),
        wn_z=(w * rn_z[:, None]).reshape(-1),
        oob=oob,
    )


def frame_samples(depth: torch.Tensor, cache: NormalEstimatorCache,
                  R: torch.Tensor, t: torch.Tensor, gcfg: GridConfig,
                  fcfg: FusionConfig) -> FrameSamples:
    """A frame's fusion samples, independent of the grid: FALS normals, the
    optional median blur, the pixel gates, the valid pixels compacted (one
    host sync) and their sample walks. Sharded fusion
    (`parallel/sharding.py`) computes the same samples on every rank."""
    normal_img = compute_normals(cache, depth)
    if fcfg.median_blur_depth:
        depth = median_blur(depth, 5)
    rays = _pixel_rays(depth, normal_img, cache, fcfg)
    idx = torch.nonzero(rays.valid).reshape(-1)
    rays = FrameRays(*(a[idx] for a in rays[:-1]),
                     valid=torch.ones_like(idx, dtype=torch.bool))
    return _ray_samples(rays, R, t, gcfg, fcfg)


def _alloc_slots(grid: vg.VoxelGrid, s: FrameSamples, gcfg: GridConfig):
    """Block allocation + scatter-slot lookup for one sample batch. The
    claim insert and its re-lookup run only when some sample's block is
    new (a host sync decides). Returns (grid, lin, ok): flat voxel indices,
    out-of-map samples pointed one past the end (dropped by the scatter)."""
    slot = vg.lookup_keys(grid, s.keys, gcfg)
    need = (s.keys >= 0) & (slot < 0)
    if bool(need.any()):
        grid = vg.insert_new(grid, s.keys, need, gcfg)
        slot = vg.lookup_keys(grid, s.keys, gcfg)
    grid = grid._replace(oob_samples=grid.oob_samples + s.oob)
    ok = slot >= 0
    nvox = grid.num_blocks * grid.voxels_per_block
    lin = torch.where(ok, slot * gcfg.voxels_per_block + s.local_lin,
                      torch.full_like(slot, nvox))
    return grid, lin, ok


def new_accumulator(grid: vg.VoxelGrid) -> torch.Tensor:
    """Zeroed frame accumulator for `grid`: f32 [nvox, 8], one 32-byte row
    per voxel of its per-voxel fields (a block shard's only, for a sharded
    grid) holding (w, wd, wn_x, wn_y, wn_z) and three floats of padding."""
    return _new_rows(grid.dist.numel(), grid.device)


def _scatter_samples(acc, lin, s: FrameSamples, accumulate_gradients: bool):
    """Scatter one batch's contributions into the frame accumulator with ONE
    call of the multi-field scatter-add (the CUDA kernel on the card),
    updating `acc` in place: F = 5 fields, or 2 without gradients."""
    fields = [s.w, s.wd, s.wn_x, s.wn_y, s.wn_z]
    nf = len(fields) if accumulate_gradients else 2
    scatter_add_fields(lin, fields[:nf], acc.shape[0], acc=acc[:, :nf])


def _merge_accumulators(grid: vg.VoxelGrid, acc, accumulate_gradients: bool):
    """Merge the frame accumulator into the running state and zero it, in
    place, over the allocated blocks: W' = W + sum(w),
    d' = (d W + sum(w trunc_sdf)) / W', g' = g + sum(w R n)
    (MapGradPixelSdf.cpp:108-116). The CUDA kernel on the card."""
    merge_clear(acc, grid.weight, grid.dist, grid.grad_x, grid.grad_y,
                grid.grad_z, grid.num_active, with_grad=accumulate_gradients)
    return grid


def claim_blocks(grid: vg.VoxelGrid, mark: torch.Tensor, keys: torch.Tensor,
                 oob, gcfg: GridConfig) -> vg.VoxelGrid:
    """The plain block claim between the CPU's two passes: allocate the
    blocks of the claim pass's marked candidates (`mark` uint8, `keys`
    int32, one entry per candidate) in candidate order, the JAX package's
    claim order, through `fuse_integrate.claim_alloc_reference` (which
    clears the marks), and add the pass's `oob` count to `oob_samples`."""
    grid = fi.claim_alloc_reference(grid, mark, keys, gcfg)
    return grid._replace(oob_samples=grid.oob_samples + oob)


def fuse_frame(
    grid: vg.VoxelGrid,
    depth: torch.Tensor,
    cache: NormalEstimatorCache,
    R: torch.Tensor,
    t: torch.Tensor,
    gcfg: GridConfig,
    fcfg: FusionConfig,
    *,
    vis: Optional[torch.Tensor] = None,
    kf_slot: Optional[int] = None,
    accumulate_gradients: bool = True,
    acc: Optional[torch.Tensor] = None,
    scratch: Optional[fi.FuseScratch] = None,
):
    """Integrate one depth frame under pose (R, t) (camera-to-world).

    Returns the updated grid (and the updated vis bitfield if given).
    `vis` is int32 [num_blocks, B^3, kf_words]; `kf_slot` the keyframe slot
    to mark (negative = not a keyframe). `accumulate_gradients=False` gives
    the baseline TSDF fusion (`MapPixelSdf::update`,
    MapPixelSdf.cpp:114-189). `acc` is the caller's all-zero accumulator
    (`new_accumulator(grid)`), all-zero again on return, and `scratch` the
    kernel's (`fuse_integrate.new_scratch(grid)`); without them they are
    allocated for this call. All tensors must be on the grid's device.
    """
    normal_img = fals_normals(cache, depth.contiguous())
    if fcfg.median_blur_depth:
        depth = median_blur(depth, 5)
    depth = depth.contiguous()
    if acc is None:
        acc = new_accumulator(grid)
    if scratch is None:
        scratch = fi.new_scratch(grid)
    R = R.to(torch.float32).contiguous()
    t = t.to(torch.float32).contiguous()
    status, mark, keys = fi.claim_pass(depth, normal_img, cache, R, t, grid,
                                       gcfg, fcfg, scratch)
    if grid.device.type == "cpu":
        grid = claim_blocks(grid, mark, keys, status[1], gcfg)
    fi.integrate_merge(depth, normal_img, cache, R, t, grid, gcfg, fcfg, acc,
                       scratch, accumulate_gradients=accumulate_gradients,
                       vis=vis, kf_slot=kf_slot)
    if vis is None:
        return grid
    return grid, vis
