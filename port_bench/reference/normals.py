"""FALS normals from depth (Badino et al.; upstream
`NormalEstimator.h:81-204`): per-pixel rays and the inverse of each
window's 3x3 normal matrix, built once a camera in float64; per frame
b = sum over the window of nbar / z (reflect-101 borders, zero depth
contributes 0), n = M^-1 b, normalized (a window with no depth gives
non-finite values, which fusion's gates reject)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class Cache(NamedTuple):
    x0: torch.Tensor        # [H, W] (u - cx) / fx
    y0: torch.Tensor
    n_sq_inv: torch.Tensor  # 1 / (1 + x0^2 + y0^2)
    x0n: torch.Tensor       # x0 * n_sq_inv
    y0n: torch.Tensor
    Q: torch.Tensor         # [H, W, 6] packed inverse (11, 12, 13, 22, 23, 33)
    window: int


def _box_np(a, window):
    r = window // 2
    x = np.pad(a, r, mode="reflect")
    c = np.pad(np.cumsum(x, axis=1), ((0, 0), (1, 0)))
    h = c[:, window:] - c[:, :-window]
    c2 = np.pad(np.cumsum(h, axis=0), ((1, 0), (0, 0)))
    return c2[window:, :] - c2[:-window, :]


def build_cache(width, height, K, window, device, dtype=torch.float32) -> Cache:
    K = np.asarray(K, dtype=np.float64)
    u = (np.arange(width, dtype=np.float64) - K[0, 2]) * (1.0 / K[0, 0])
    v = (np.arange(height, dtype=np.float64) - K[1, 2]) * (1.0 / K[1, 1])
    x0, y0 = np.meshgrid(u, v)
    nsi = 1.0 / (1.0 + x0 * x0 + y0 * y0)
    x0n, y0n = x0 * nsi, y0 * nsi
    M11, M12, M13 = (_box_np(a, window) for a in (x0 * x0 * nsi, x0 * y0 * nsi, x0n))
    M22, M23, M33 = (_box_np(a, window) for a in (y0 * y0 * nsi, y0n, nsi))
    det_inv = 1.0 / (M11 * M22 * M33 + 2.0 * M12 * M23 * M13
                     - (M13 * M13 * M22 + M12 * M12 * M33 + M23 * M23 * M11))
    Q = np.stack([det_inv * (M22 * M33 - M23 * M23),
                  det_inv * (M13 * M23 - M12 * M33),
                  det_inv * (M12 * M23 - M13 * M22),
                  det_inv * (M11 * M33 - M13 * M13),
                  det_inv * (M12 * M13 - M11 * M23),
                  det_inv * (M11 * M22 - M12 * M12)], axis=-1)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device).to(dtype)

    return Cache(t(x0), t(y0), t(nsi), t(x0n), t(y0n), t(Q), window)


def box_sum(img, window):
    """Reflect-101 box sums of [C, H, W] by running sums along each axis,
    taken in float64 for float32 images (the difference of two prefix sums
    hundreds of pixels long loses ~1e-5 of a window sum in float32) and in
    the image's own type otherwise."""
    r = window // 2
    acc = torch.float64 if img.dtype == torch.float32 else img.dtype
    x = F.pad(img[:, None].float(), (r, r, r, r), mode="reflect")[:, 0].to(acc)
    c = F.pad(torch.cumsum(x, dim=-1), (1, 0))
    h = c[..., window:] - c[..., :-window]
    c2 = F.pad(torch.cumsum(h, dim=-2), (0, 0, 1, 0))
    return (c2[..., window:, :] - c2[..., :-window, :]).to(img.dtype)


def normals(cache: Cache, depth):
    """Unit normals [H, W, 3] of a depth frame [H, W]."""
    z_inv = torch.where(depth != 0.0, 1.0 / depth, torch.zeros_like(depth))
    b = box_sum(torch.stack([cache.x0n * z_inv, cache.y0n * z_inv,
                             cache.n_sq_inv * z_inv]), cache.window)
    b1, b2, b3 = b[0], b[1], b[2]
    Q = cache.Q
    nx = b1 * Q[..., 0] + b2 * Q[..., 1] + b3 * Q[..., 2]
    ny = b1 * Q[..., 1] + b2 * Q[..., 3] + b3 * Q[..., 4]
    nz = b1 * Q[..., 2] + b2 * Q[..., 4] + b3 * Q[..., 5]
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz)
    return torch.stack([nx, ny, nz], dim=-1) / norm[..., None]
