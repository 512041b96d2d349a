"""FALS surface normals from depth (Badino et al.).

Port of `gradient_sdf_tpu/ops/normals.py`, the reference's
`cv::NormalEstimator<T>` (`cpp/include/normals/NormalEstimator.h:81-204`):
per-pixel unit rays, a per-pixel 3x3 normal-equation matrix precomputed
once and inverted analytically (`build_cache`, numpy, copied), then per
frame b = sum_window nbar / z and n = M^{-1} b, normalized.

The per-frame box sums are reflect-101 box filters taken by cumulative
sums along each axis. The JAX package's banded-matmul form (`box_sum_matrix`)
was a TPU compile-time workaround and is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import device as device_mod


class NormalEstimatorCache(NamedTuple):
    """Per-camera precomputed LUTs (reference `cache()`,
    NormalEstimator.h:81-154), f32 tensors on one device. Fusion reuses
    the per-pixel ray (x0, y0, 1) and 1/|(x0,y0,1)|^2."""

    x0: torch.Tensor        # f32 [H, W]  (u - cx) / fx
    y0: torch.Tensor        # f32 [H, W]  (v - cy) / fy
    n_sq_inv: torch.Tensor  # f32 [H, W]  1 / (1 + x0^2 + y0^2)
    x0_n_sq_inv: torch.Tensor
    y0_n_sq_inv: torch.Tensor
    Q: torch.Tensor         # f32 [H, W, 6] packed symmetric inverse (11,12,13,22,23,33)
    window: int


def build_cache(width: int, height: int, K: np.ndarray, window: int = 11,
                device=None) -> NormalEstimatorCache:
    """Precompute the FALS LUTs in float64 (reference does the cache pass in
    double, NormalEstimator.h:84-124) then cast to float32, on `device`
    (default: the CUDA card, raising where there is none)."""
    device = device_mod.require() if device is None else device
    K = np.asarray(K, dtype=np.float64)
    fx_inv, fy_inv = 1.0 / K[0, 0], 1.0 / K[1, 1]
    cx, cy = K[0, 2], K[1, 2]

    u = (np.arange(width, dtype=np.float64) - cx) * fx_inv
    v = (np.arange(height, dtype=np.float64) - cy) * fy_inv
    x0, y0 = np.meshgrid(u, v)

    n_sq = 1.0 + x0 * x0 + y0 * y0
    n_sq_inv = 1.0 / n_sq
    x0n = x0 * n_sq_inv
    y0n = y0 * n_sq_inv

    def bf(a):
        return _np_box_filter(a, window)

    M11 = bf(x0 * x0 * n_sq_inv)
    M12 = bf(x0 * y0 * n_sq_inv)
    M13 = bf(x0n)
    M22 = bf(y0 * y0 * n_sq_inv)
    M23 = bf(y0n)
    M33 = bf(n_sq_inv)

    det = (
        M11 * M22 * M33
        + 2.0 * M12 * M23 * M13
        - (M13 * M13 * M22 + M12 * M12 * M33 + M23 * M23 * M11)
    )
    det_inv = 1.0 / det
    Q11 = det_inv * (M22 * M33 - M23 * M23)
    Q12 = det_inv * (M13 * M23 - M12 * M33)
    Q13 = det_inv * (M12 * M23 - M13 * M22)
    Q22 = det_inv * (M11 * M33 - M13 * M13)
    Q23 = det_inv * (M12 * M13 - M11 * M23)
    Q33 = det_inv * (M11 * M22 - M12 * M12)
    Q = np.stack([Q11, Q12, Q13, Q22, Q23, Q33], axis=-1)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return NormalEstimatorCache(
        x0=f32(x0),
        y0=f32(y0),
        n_sq_inv=f32(n_sq_inv),
        x0_n_sq_inv=f32(x0n),
        y0_n_sq_inv=f32(y0n),
        Q=f32(Q),
        window=window,
    )


def _np_box_filter(a: np.ndarray, window: int) -> np.ndarray:
    """NumPy reflect-101 box sum for the (host-side, once-per-camera) cache."""
    r = window // 2
    x = np.pad(a, r, mode="reflect")
    c = np.cumsum(x, axis=1)
    c = np.pad(c, ((0, 0), (1, 0)))
    h = c[:, window:] - c[:, :-window]
    c2 = np.cumsum(h, axis=0)
    c2 = np.pad(c2, ((1, 0), (0, 0)))
    return c2[window:, :] - c2[:-window, :]


def box_filter(img: torch.Tensor, window: int) -> torch.Tensor:
    """Unnormalized box sum over a window x window neighborhood
    (cv::boxFilter(..., normalize=false), BORDER_REFLECT_101) of one or a
    batch of images [..., H, W]: reflect-pad, then a running sum along each
    axis (cumsum, difference `window` apart). The running sums are taken in
    float64: in float32 the difference of two prefix sums hundreds of
    pixels long loses ~1e-5 of a window sum, enough to flip a pixel at
    fusion's normal gates against the JAX package's exact sums."""
    r = window // 2
    lead = img.shape[:-2]
    x = F.pad(img.reshape((-1, 1) + tuple(img.shape[-2:])), (r, r, r, r),
              mode="reflect")[:, 0].double()
    c = F.pad(torch.cumsum(x, dim=-1), (1, 0))
    h = c[..., window:] - c[..., :-window]
    c2 = F.pad(torch.cumsum(h, dim=-2), (0, 0, 1, 0))
    out = (c2[..., window:, :] - c2[..., :-window, :]).to(img.dtype)
    return out.reshape(lead + tuple(out.shape[-2:]))


def window_sums(cache: NormalEstimatorCache,
                depth: torch.Tensor) -> torch.Tensor:
    """The FALS right-hand sides b = sum_window nbar / z of a depth frame:
    f32 [3, H, W], each the float64 box sum of its float32 products
    rounded to float32 (zero-depth pixels contribute 0)."""
    z_inv = torch.where(depth != 0.0, 1.0 / depth, torch.zeros_like(depth))
    return box_filter(torch.stack([cache.x0_n_sq_inv * z_inv,
                                   cache.y0_n_sq_inv * z_inv,
                                   cache.n_sq_inv * z_inv]), cache.window)


def normals_of_sums(cache: NormalEstimatorCache,
                    b: torch.Tensor) -> torch.Tensor:
    """n = M^{-1} b per pixel (M^{-1} = the cache's packed Q), normalized:
    [3, H, W] -> unit normals [H, W, 3]."""
    b1, b2, b3 = b[0], b[1], b[2]
    Q = cache.Q
    nx = b1 * Q[..., 0] + b2 * Q[..., 1] + b3 * Q[..., 2]
    ny = b1 * Q[..., 1] + b2 * Q[..., 3] + b3 * Q[..., 4]
    nz = b1 * Q[..., 2] + b2 * Q[..., 4] + b3 * Q[..., 5]
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz)
    return torch.stack([nx, ny, nz], dim=-1) / norm[..., None]


def compute_normals(cache: NormalEstimatorCache,
                    depth: torch.Tensor) -> torch.Tensor:
    """Per-frame FALS normals: depth [H, W] -> unit normals [H, W, 3].

    Matches reference `compute()` (NormalEstimator.h:179-204): zero-depth
    pixels contribute 0 to the window sums; normals point toward the
    camera. A window with no valid depth divides by a zero norm and yields
    non-finite values (IEEE, deliberately not clamped): fusion gates on
    `isfinite` and ||n||^2 (MapGradPixelSdf.cpp:95). The plain PyTorch
    version (the CPU path, and the oracle of the hand-written kernel
    `ops/kernels/fals_normals`, which fusion runs on the card).
    """
    return normals_of_sums(cache, window_sums(cache, depth))
