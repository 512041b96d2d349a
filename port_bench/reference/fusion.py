"""TSDF + gradient fusion of one depth frame (upstream
`MapGradPixelSdf::update`, `MapGradPixelSdf.cpp:43-122`):

1. FALS normals of the frame;
2. the pixel gates: depth in (z_min, z_max), a finite normal with
   |n|^2 >= 0.1, (n.h)^2 / |h|^2 >= 0.25 (:87, :95, :98);
3. each valid pixel walks 2 floor(T / vs) + 1 samples along its ray
   (:79, :101-106): the nearest voxel, its projective distance (with
   `cosine_correction`, the port's point-to-plane option, scaled by the
   normal's incidence cosine, floored at 0.1), the weight (1 behind the
   surface, falling linearly in front, `Sdf.h:76-85`);
4. the blocks that samples miss are claimed in candidate order (pixel,
   then sample), each for its first candidate;
5. the frame's sums per voxel (w, w trunc(sdf), w R n) merge with the
   running state over every voxel of the touched blocks:
   W' = W + sum w, d' = (d W + sum w trunc(sdf)) / W', g' = g + sum w R n
   (:108-116); with a keyframe slot, a voxel with sum w > 0 gets the slot's
   visibility bit.
"""

from __future__ import annotations

import torch

from . import grid as G
from . import normals as N


def gates(depth, nrm, cache: N.Cache, f: dict):
    nx, ny, nz = nrm[..., 0], nrm[..., 1], nrm[..., 2]
    fin = torch.isfinite(nx) & torch.isfinite(ny) & torch.isfinite(nz)
    zero = torch.zeros_like(nx)
    nx, ny, nz = (torch.where(fin, a, zero) for a in (nx, ny, nz))
    n_sq = nx * nx + ny * ny + nz * nz
    ndoth = nx * cache.x0 + ny * cache.y0 + nz
    valid = ((depth > f["z_min"]) & (depth < f["z_max"]) & fin
             & (n_sq >= f["normal_sq_min"])
             & (ndoth * ndoth * cache.n_sq_inv >= f["view_angle_cos_sq"]))
    return valid, nx, ny, nz


def samples(depth, nrm, cache: N.Cache, R, t, grid: G.Grid, f: dict):
    """The frame's samples in candidate order: (keys int32 [n, K], local
    offsets, w, wd, wn_x, wn_y, wn_z, oob count)."""
    valid, nx, ny, nz = gates(depth, nrm, cache, f)
    idx = torch.nonzero(valid.reshape(-1)).reshape(-1)
    z = depth.reshape(-1)[idx]
    hx, hy = cache.x0.reshape(-1)[idx], cache.y0.reshape(-1)[idx]
    nx, ny, nz = (a.reshape(-1)[idx] for a in (nx, ny, nz))
    vs = grid.voxel_size
    inv_vs = 1.0 / vs
    b = grid.block_shape
    T = f["trunc_voxels"] * vs
    factor = int(f["trunc_voxels"])
    rh = [R[i, 0] * hx + R[i, 1] * hy + R[i, 2] for i in range(3)]
    rn = [R[i, 0] * nx + R[i, 1] * ny + R[i, 2] * nz for i in range(3)]
    ks = torch.arange(-factor, factor + 1, dtype=depth.dtype, device=depth.device)
    zk = z[:, None] + ks * vs
    vi = [torch.round((zk * rh[i][:, None] + t[i]) * inv_vs).to(torch.int32)
          for i in range(3)]
    sdf = (R[0, 2] * (vi[0].to(depth.dtype) * vs - t[0])
           + R[1, 2] * (vi[1].to(depth.dtype) * vs - t[1])
           + R[2, 2] * (vi[2].to(depth.dtype) * vs - t[2]) - z[:, None])
    if f.get("cosine_correction", False):
        # the point-to-plane distance: the projective one scaled by the
        # incidence cosine of the FALS normal, floored at 0.1
        n_norm = torch.sqrt(nx * nx + ny * ny + nz * nz)
        h_norm = torch.sqrt(hx * hx + hy * hy + 1.0)
        cosang = torch.abs(nx * hx + ny * hy + nz) / torch.clamp(n_norm * h_norm,
                                                                 min=1e-12)
        sdf = sdf * torch.clamp(cosang, 0.1, 1.0)[:, None]
    w = torch.where(sdf <= 0.0, torch.ones_like(sdf),
                    torch.clamp(1.0 - sdf / T, min=0.0))
    trunc = torch.clamp(sdf, -T, T)
    blk = [torch.div(v, b, rounding_mode="floor") for v in vi]
    local = ((vi[2] - blk[2] * b) * b + (vi[1] - blk[1] * b)) * b + (vi[0] - blk[0] * b)
    keys = G.pack_key(blk[0], blk[1], blk[2], grid.dir_dim)
    live = w > 0.0
    oob = int(((keys < 0) & live).sum())
    keys = torch.where(live, keys, torch.full_like(keys, G.EMPTY))
    return (keys.reshape(-1), local.reshape(-1), w.reshape(-1),
            (w * trunc).reshape(-1), *[(w * r[:, None]).reshape(-1) for r in rn],
            oob)


def fuse(grid: G.Grid, depth, cache: N.Cache, R, t, f: dict, vis=None,
         kf_slot: int = -1):
    """Integrate `depth` at camera-to-world (R, t) into `grid` in place;
    `vis` int32 [capacity, B^3, words] gets bit `kf_slot` where a voxel is
    hit (kf_slot >= 0)."""
    nrm = N.normals(cache, depth)
    keys, local, w, wd, wnx, wny, wnz, oob = samples(depth, nrm, cache, R, t,
                                                     grid, f)
    grid.oob += oob
    G.claim(grid, keys, (keys >= 0) & (G.lookup(grid, keys) < 0))
    slot = G.lookup(grid, keys)
    ok = slot >= 0
    if not bool(ok.any()):
        return
    vpb = grid.block_shape ** 3
    blocks = torch.unique(slot[ok]).long()
    pos = torch.searchsorted(blocks, slot[ok].long())
    acc = torch.zeros((blocks.numel() * vpb, 5), dtype=w.dtype, device=w.device)
    acc.index_add_(0, pos * vpb + local[ok].long(),
                   torch.stack([a[ok] for a in (w, wd, wnx, wny, wnz)], -1))
    rows = (blocks[:, None] * vpb + torch.arange(vpb, device=w.device)).reshape(-1)
    weight, dist = grid.weight.view(-1), grid.dist.view(-1)
    w_old, d_old = weight[rows], dist[rows]
    w_new = w_old + acc[:, 0]
    dist[rows] = torch.where(w_new > 0.0,
                             (d_old * w_old + acc[:, 1]) / torch.clamp(w_new, min=1e-30),
                             d_old)
    weight[rows] = w_new
    for k, g in enumerate((grid.gx, grid.gy, grid.gz)):
        g.view(-1)[rows] += acc[:, 2 + k]
    if vis is not None and kf_slot >= 0:
        hit = rows[acc[:, 0] > 0.0]
        words = vis.view(-1, vis.shape[-1])
        bit = torch.ones((), dtype=torch.int32, device=w.device) << (kf_slot % 32)
        words[hit, kf_slot // 32] |= bit
