"""SE(3) exp and composition, float32 (Sophus order: twist [v, w])."""

from __future__ import annotations

import torch


def hat(w):
    zero = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zero, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], zero, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], zero], dim=-1)], dim=-2)


def _factors(theta_sq):
    """(sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3), Taylor near 0."""
    theta = torch.sqrt(torch.clamp(theta_sq, min=1e-16))
    small = theta_sq < 1e-8
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / theta_sq)
    c = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / (theta_sq * theta))
    return a, b, c


def so3_exp(w):
    a, b, _ = _factors((w * w).sum(-1))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def se3_exp(xi):
    v, w = xi[..., :3], xi[..., 3:]
    a, b, c = _factors((w * w).sum(-1))
    W = hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return R, (V @ v[..., None])[..., 0]


def se3_mul(Ra, ta, Rb, tb):
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def rotation_angle(Ra, Rb) -> torch.Tensor:
    """Angle (rad) of Ra^T Rb in float64: ||Ra^T Rb - I||_F = 2 sqrt(2)
    sin(angle / 2), exact near 0 where arccos of the trace is not."""
    M = Ra.double().transpose(-1, -2) @ Rb.double()
    eye = torch.eye(3, dtype=M.dtype, device=M.device)
    s = torch.linalg.norm(M - eye, dim=(-2, -1)) / (2.0 * 2.0 ** 0.5)
    return 2.0 * torch.arcsin(torch.clamp(s, max=1.0))
