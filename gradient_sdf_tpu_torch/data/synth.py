"""Synthetic sphere world: analytic renderer + Kinect noise + ground truth.

Port of the spheres world of `gradient_sdf_tpu/data/synth.py` (the
reference's MATLAB validation pipeline, `matlab/RenderSpheres.m:36-139`,
`matlab/add_kinect_noise.m:50-74`): five random non-intersecting spheres
rendered by analytic ray casts at Kinect intrinsics, with disparity-domain
Gaussian noise and disparity quantization. The sphere draw uses the same
numpy generator as the JAX package, so a seed gives the same world; the
noise comes from a numpy `Generator` (the JAX package draws it with
`jax.random`, so noisy frames differ between the packages). The box world
is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import se3

KINECT_K = np.array(
    [[525.0, 0.0, 319.5], [0.0, 525.0, 239.5], [0.0, 0.0, 1.0]], dtype=np.float32
)


class SphereWorld(NamedTuple):
    centers: torch.Tensor  # [S, 3]
    radii: torch.Tensor    # [S]


def random_spheres(seed: int = 0, n: int = 5, device="cpu") -> SphereWorld:
    """Five random non-intersecting spheres (`RenderSpheres.m:46-53`):
    centers uniform in [-0.5, 0.5]^3, radii in [0.0625, 0.5],
    rejection-sampled for pairwise separation."""
    rng = np.random.RandomState(seed)
    centers, radii = [], []
    while len(centers) < n:
        c = rng.rand(3) - 0.5
        r = 0.0625 + 0.4375 * rng.rand()
        ok = all(
            np.linalg.norm(c - c2) > (r + r2) for c2, r2 in zip(centers, radii)
        )
        if ok:
            centers.append(c)
            radii.append(r)
    return SphereWorld(
        centers=torch.as_tensor(np.array(centers), dtype=torch.float32,
                                device=device),
        radii=torch.as_tensor(np.array(radii), dtype=torch.float32,
                              device=device),
    )


def sphere_sdf(world: SphereWorld, points: torch.Tensor):
    """Analytic SDF + unit gradient of the sphere union at world points (…,3)."""
    diff = points[..., None, :] - world.centers  # (…,S,3)
    d = torch.linalg.norm(diff, dim=-1) - world.radii  # (…,S)
    sdf, s = torch.min(d, dim=-1)
    nearest = torch.gather(
        diff, -2, s[..., None, None].expand(tuple(s.shape) + (1, 3)))[..., 0, :]
    grad = nearest / torch.clamp(
        torch.linalg.norm(nearest, dim=-1, keepdim=True), min=1e-12)
    return sdf, grad


def _ray_sphere_z(world: SphereWorld, R, t, K, width, height):
    """Per-pixel, per-sphere ray hit depth [H, W, S] (inf where missed),
    solving A z^2 + B z + C = 0 as `RenderSpheres.m:96-120`; plus the
    unnormalized ray components (cu, cv)."""
    dev = world.centers.device
    fx, fy, cx, cy = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
                      float(K[1, 2]))
    u = (torch.arange(width, dtype=torch.float32, device=dev) - cx) / fx
    v = (torch.arange(height, dtype=torch.float32, device=dev) - cy) / fy
    cv, cu = torch.meshgrid(v, u, indexing="ij")
    A = cu * cu + cv * cv + 1.0

    R = torch.as_tensor(R, dtype=torch.float32, device=dev)
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    c_cam = se3.se3_apply(*se3.se3_inv(R, t), world.centers)  # [S,3]
    c_sq_r = torch.sum(c_cam * c_cam, dim=-1) - world.radii**2  # [S]
    B = -2.0 * (cu[..., None] * c_cam[:, 0] + cv[..., None] * c_cam[:, 1]
                + c_cam[:, 2])  # [H,W,S]
    disc = B * B - 4.0 * A[..., None] * c_sq_r
    hit = disc >= 0.0
    z = (-B - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * A[..., None])
    z = torch.where(hit & (z > 0.0), z, torch.full_like(z, float("inf")))
    return z, cu, cv


def render_depth(world: SphereWorld, R, t, K: np.ndarray = KINECT_K,
                 width: int = 640, height: int = 480) -> torch.Tensor:
    """Analytic ray-sphere depth render [H, W] under camera-to-world pose
    (R, t); missed rays get depth 0."""
    z, _, _ = _ray_sphere_z(world, R, t, K, width, height)
    depth = torch.min(z, dim=-1).values
    return torch.where(torch.isinf(depth), torch.zeros_like(depth), depth)


def add_kinect_noise(depth: torch.Tensor,
                     rng: np.random.Generator) -> torch.Tensor:
    """Disparity-domain Kinect noise (`add_kinect_noise.m:50-74`):
    d = (3 - 1/z)/2.85e-3, d += 0.5*N(0,1), round, invert. The normal
    draws come from the numpy generator `rng`."""
    mask = depth > 0.0
    safe_z = torch.where(mask, depth, torch.ones_like(depth))
    d = (3.0 - 1.0 / safe_z) / 2.85e-3
    noise = torch.as_tensor(rng.standard_normal(tuple(depth.shape)),
                            dtype=depth.dtype, device=depth.device)
    d = torch.round(d + 0.5 * noise)
    z_inv = -2.85e-3 * d + 3.0
    return torch.where(mask, 1.0 / z_inv, torch.zeros_like(depth))


def quantize_depth(depth: torch.Tensor, unit: float = 1e-3) -> torch.Tensor:
    """16-bit PNG round-trip (`RenderSpheres.m:136`: uint16(1000*z))."""
    return torch.round(depth / unit) * unit


def orbit_poses(
    n: int = 90,
    radius: float = 2.0,
    height_range: tuple = (-0.3, 0.3),
    target: np.ndarray | None = None,
    arc: float = 2.0 * np.pi,
    closed: bool = False,
) -> list:
    """Spiral of camera-to-world look-at poses circling the sphere cluster
    (cf. the reference's `matlab/poses.txt`); `arc` bounds the swept angle,
    `closed=True` makes the trajectory loop back to its start (see the JAX
    module). Returns [(R, t)] as numpy arrays."""
    target = np.zeros(3) if target is None else np.asarray(target)
    poses = []
    for i in range(n):
        ang = arc * i / n
        if closed:
            h = (height_range[0]
                 + (height_range[1] - height_range[0]) * np.sin(np.pi * i / n))
        else:
            h = height_range[0] + (height_range[1] - height_range[0]) * i / max(n - 1, 1)
        eye = target + np.array([radius * np.cos(ang), radius * np.sin(ang), h])
        fwd = target - eye
        fwd = fwd / np.linalg.norm(fwd)
        up_hint = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up_hint)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        # camera axes: x right, y down, z forward (pinhole convention)
        R = np.stack([right, down, fwd], axis=1).astype(np.float32)
        poses.append((R, eye.astype(np.float32)))
    return poses
