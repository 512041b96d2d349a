"""Frame-to-model Gauss-Newton tracking on SE(3) (upstream
`RigidPointOptimizer::optimize_sampled`, `RigidPointOptimizer.cpp:40-98`,
with `RigidOptimizer.h:70-76`'s defaults):

* the depth-valid pixels (z in (z_min, z_max)) at stride `sampling`, as
  camera-frame points in row-major order;
* per iteration: p = R x + t, the nearest voxel's distance corrected along
  its stored gradient (the semi-implicit SDF: phi = d + 1.2 ghat . (c - p),
  grad = 1.2 ghat, a residual where the voxel's weight is > 0),
  J = [grad, p x grad], the sums E = sum phi^2, g = sum phi J,
  H = sum J J^T;
* xi = damping solve(H + 1e-12 I, g); converged when xi.xi < conv^2,
  tested before the step is applied (a converging step is not applied); a
  NaN step is skipped; otherwise (R, t) <- exp(-xi) (R, t); at most
  `num_iterations` iterations.
"""

from __future__ import annotations

import torch

from . import grid as G
from . import se3


def points(depth, K, z_min, z_max, sampling=1):
    """Camera-frame points [N, 3] of the depth-valid pixels, row-major;
    x0 = (u - cx) / fx as a true division."""
    H, W = depth.shape
    dev, dt = depth.device, depth.dtype
    fx, fy, cx, cy = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
                      float(K[1, 2]))
    ys = torch.arange(0, H, sampling, dtype=torch.float32, device=dev)
    xs = torch.arange(0, W, sampling, dtype=torch.float32, device=dev)
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    z = depth[::sampling, ::sampling].float()
    x0 = (xg - cx) / torch.full_like(xg, fx)
    y0 = (yg - cy) / torch.full_like(yg, fy)
    pts = torch.stack([x0 * z, y0 * z, z], dim=-1).reshape(-1, 3)
    z = z.reshape(-1)
    return pts[(z > z_min) & (z < z_max)].to(dt)


def residuals(pts, R, t, grid: G.Grid, grad_scale: float):
    """(phi [N], J [N, 6], valid [N]); zero where no residual counts."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    p = torch.stack([x * R[i, 0] + y * R[i, 1] + z * R[i, 2] + t[i]
                     for i in range(3)], dim=-1)
    vs = grid.voxel_size
    vi = torch.round(p / torch.tensor(vs, dtype=p.dtype, device=p.device)
                     ).to(torch.int32)
    row, found = G.voxel_rows(grid, vi)
    dist, weight, gx, gy, gz = (f.view(-1)[row] for f in grid.fields)
    valid = found & (weight > 0.0)
    inv_norm = 1.0 / torch.clamp(torch.sqrt(gx * gx + gy * gy + gz * gz),
                                 min=1e-12)
    s = grad_scale * inv_norm
    c = vi.to(p.dtype) * vs - p
    phi = dist + s * (gx * c[:, 0] + gy * c[:, 1] + gz * c[:, 2])
    g = torch.stack([s * gx, s * gy, s * gz], dim=-1)
    cross = torch.stack([p[:, 1] * g[:, 2] - p[:, 2] * g[:, 1],
                         p[:, 2] * g[:, 0] - p[:, 0] * g[:, 2],
                         p[:, 0] * g[:, 1] - p[:, 1] * g[:, 0]], dim=-1)
    J = torch.cat([g, cross], dim=-1)
    phi = torch.where(valid, phi, torch.zeros_like(phi))
    J = torch.where(valid[:, None], J, torch.zeros_like(J))
    return phi, J, valid


def system(phi, J):
    """E, g [6], H [6, 6] as elementwise sums (no matrix product)."""
    E = (phi * phi).sum()
    g = (phi[:, None] * J).sum(0)
    H = torch.stack([torch.stack([(J[:, a] * J[:, b]).sum() for b in range(6)])
                     for a in range(6)])
    return E, g, H


def step(H, g, R, t, damping, conv_sq):
    """(R', t', small, bad): the solve in float32 whatever the working
    type (a 6x6 solve has no lower-precision form here)."""
    eye = 1e-12 * torch.eye(6, dtype=torch.float32, device=H.device)
    xi = damping * torch.linalg.solve_ex(H.float() + eye, g.float())[0]
    small = bool((xi * xi).sum() < conv_sq)
    bad = bool(torch.isnan(xi).any())
    if small or bad:
        return R, t, small, bad
    dR, dt = se3.se3_exp(-xi)
    Rn, tn = se3.se3_mul(dR, dt, R.float(), t.float())
    return Rn.to(R.dtype), tn.to(t.dtype), small, bad


def track(pts, R, t, grid: G.Grid, tr: dict, grad_scale: float):
    """The GN loop from (R, t): (R, t, converged, iterations, E, count)."""
    conv_sq = tr["conv_threshold"] ** 2
    k, small, E, cnt = 0, False, 0.0, 0
    while k < tr["num_iterations"] and not small:
        phi, J, valid = residuals(pts, R, t, grid, grad_scale)
        Ek, g, H = system(phi, J)
        E, cnt = float(Ek), int(valid.sum())
        R, t, small, _ = step(H, g, R, t, tr["damping"], conv_sq)
        k += 1
    return R, t, small, k, E, cnt
