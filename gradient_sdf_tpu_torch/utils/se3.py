"""SO(3)/SE(3) Lie-group math in PyTorch.

Counterpart of `gradient_sdf_tpu/utils/se3.py` (the reference's Sophus
usage, `cpp/include/mat.h:47-66`). Poses are `(R, t)` pairs of tensors —
a (3,3) rotation and a (3,) translation — and batches of poses are leading
axes. Float32 like the reference; series expansions near theta = 0 keep
every function finite there. Matrix products run in full float32 (callers
on the card keep TF32 off, see `apps/scan3d.main`).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _as_tensor(x, dtype=torch.float32):
    return x if torch.is_tensor(x) else torch.as_tensor(x, dtype=dtype)


def _matvec(M, v):
    """(…,3,3) @ (…,3) -> (…,3)."""
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def hat(w):
    """so(3) hat operator: (…,3) -> (…,3,3) skew-symmetric matrix."""
    w = _as_tensor(w)
    zero = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], zero, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )


def vee(W):
    """Inverse of `hat`: (…,3,3) -> (…,3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_factors(theta_sq):
    """Return (A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3), with
    small-angle Taylor fallbacks."""
    theta = torch.sqrt(torch.clamp(theta_sq, min=_EPS * _EPS))
    small = theta_sq < 1e-8
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / theta_sq)
    c = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / (theta_sq * theta))
    return a, b, c


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w):
    """Rodrigues formula: axis-angle (…,3) -> rotation matrix (…,3,3)."""
    w = _as_tensor(w)
    theta_sq = torch.sum(w * w, dim=-1)
    a, b, _ = _sinc_factors(theta_sq)
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_log(R):
    """Rotation matrix (…,3,3) -> axis-angle (…,3); handles theta near 0
    (Taylor) and near pi (diagonal extraction with sign fix-up)."""
    R = _as_tensor(R)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    theta_sq = theta * theta

    sin_theta = torch.sin(theta)
    near_zero = theta < 1e-4
    safe_sin = torch.where(torch.abs(sin_theta) < _EPS,
                           torch.ones_like(sin_theta), sin_theta)
    factor = torch.where(near_zero, 0.5 + theta_sq / 12.0,
                         theta / (2.0 * safe_sin))
    w_generic = factor[..., None] * vee(R - R.transpose(-1, -2))

    # near pi: axis_i^2 = (R_ii + 1) / 2; the largest component is taken
    # positive and the others signed by the off-diagonal products
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp((diag + 1.0) * 0.5, min=0.0)
    axis = torch.sqrt(axis_sq)
    k = torch.argmax(axis_sq, dim=-1)
    off01 = (R[..., 0, 1] + R[..., 1, 0]) * 0.25
    off02 = (R[..., 0, 2] + R[..., 2, 0]) * 0.25
    off12 = (R[..., 1, 2] + R[..., 2, 1]) * 0.25

    def sgn(x):
        return torch.where(x < 0, -1.0, 1.0).to(R.dtype)

    one = torch.ones_like(off01)
    s0 = torch.where(k == 0, one, torch.where(k == 1, sgn(off01), sgn(off02)))
    s1 = torch.where(k == 1, one, torch.where(k == 0, sgn(off01), sgn(off12)))
    s2 = torch.where(k == 2, one, torch.where(k == 0, sgn(off02), sgn(off12)))
    axis_fixed = axis * torch.stack([s0, s1, s2], dim=-1)
    norm = torch.linalg.norm(axis_fixed, dim=-1, keepdim=True)
    w_near_pi = theta[..., None] * (axis_fixed / torch.clamp(norm, min=_EPS))

    near_pi = cos_theta < -0.999
    return torch.where(near_pi[..., None], w_near_pi, w_generic)


def se3_exp(xi):
    """se(3) exp: twist (…,6) [v, w] -> (R (…,3,3), t (…,3)); Sophus order,
    t = V(w) @ v."""
    xi = _as_tensor(xi)
    v = xi[..., :3]
    w = xi[..., 3:]
    theta_sq = torch.sum(w * w, dim=-1)
    a, b, c = _sinc_factors(theta_sq)
    W = hat(w)
    W2 = W @ W
    eye = _eye_like(W)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return R, _matvec(V, v)


def se3_log(R, t):
    """Inverse of `se3_exp`: -> twist (…,6) [v, w]."""
    R = _as_tensor(R)
    t = _as_tensor(t)
    w = so3_log(R)
    theta_sq = torch.sum(w * w, dim=-1)
    a, b, _ = _sinc_factors(theta_sq)
    W = hat(w)
    W2 = W @ W
    # V^{-1} = I - 1/2 W + (1/theta^2)(1 - a/(2b)) W^2
    small = theta_sq < 1e-8
    safe_theta_sq = torch.clamp(theta_sq, min=_EPS)
    coef = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                       (1.0 - a / (2.0 * b)) / safe_theta_sq)
    V_inv = _eye_like(W) - 0.5 * W + coef[..., None, None] * W2
    return torch.cat([_matvec(V_inv, t), w], dim=-1)


def se3_mul(Ra, ta, Rb, tb):
    """Compose two SE(3) elements: (Ra,ta) * (Rb,tb)."""
    return Ra @ Rb, _matvec(Ra, tb) + ta


def se3_inv(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -_matvec(Rt, t)


def se3_apply(R, t, points):
    """Apply pose to points of shape (…,3); batched poses broadcast against
    the points' leading axes."""
    if R.dim() == 2:  # one pose, many points: one [N,3] x [3,3] product
        return points @ R.T + t
    return _matvec(R, points) + t


def identity(dtype=torch.float32, device=None):
    """The identity pose (I3, 0)."""
    return (torch.eye(3, dtype=dtype, device=device),
            torch.zeros(3, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Quaternion conversions (TUM trajectory format: tx ty tz qx qy qz qw;
# reference writes these at cpp/depth_scanning/src/main_scan_3d.cpp:267-280)
# ---------------------------------------------------------------------------


def quat_to_rotmat(q):
    """Unit quaternion (…,4) in (qx, qy, qz, qw) order -> (…,3,3)."""
    q = _as_tensor(q)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def rotmat_to_quat(R):
    """Rotation matrix (3,3) -> quaternion (4,) in (qx, qy, qz, qw) order
    (Shepperd's method: the branch of the largest of trace and diagonal)."""
    R = _as_tensor(R)
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    trace = m00 + m11 + m22
    branch = int(torch.argmax(torch.stack([trace, m00, m11, m22])))
    if branch == 0:
        s = torch.sqrt(torch.clamp(trace + 1.0, min=_EPS)) * 2.0
        q = torch.stack([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s,
                         0.25 * s])
    elif branch == 1:
        s = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=_EPS)) * 2.0
        q = torch.stack([0.25 * s, (m01 + m10) / s, (m02 + m20) / s,
                         (m21 - m12) / s])
    elif branch == 2:
        s = torch.sqrt(torch.clamp(1.0 + m11 - m00 - m22, min=_EPS)) * 2.0
        q = torch.stack([(m01 + m10) / s, 0.25 * s, (m12 + m21) / s,
                         (m02 - m20) / s])
    else:
        s = torch.sqrt(torch.clamp(1.0 + m22 - m00 - m11, min=_EPS)) * 2.0
        q = torch.stack([(m02 + m20) / s, (m12 + m21) / s, 0.25 * s,
                         (m10 - m01) / s])
    return q / torch.linalg.norm(q)
