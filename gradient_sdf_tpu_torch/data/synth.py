"""Synthetic worlds: analytic renderers + Kinect noise + ground truth.

Port of `gradient_sdf_tpu/data/synth.py` (the reference's MATLAB
validation pipeline, `matlab/RenderSpheres.m:36-139`,
`matlab/add_kinect_noise.m:50-74`): five random non-intersecting spheres
rendered by analytic ray casts at Kinect intrinsics, with disparity-domain
Gaussian noise and disparity quantization; and the box world (a floor slab
and boxes standing on it: planar faces, creases and occlusion edges, with
an exact SDF). Both draws use the same numpy generator as the JAX package,
so a seed gives the same world; the noise comes from a numpy `Generator`
(the JAX package draws it with `jax.random`, so noisy frames differ
between the packages).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import device as device_mod
from ..utils import se3

KINECT_K = np.array(
    [[525.0, 0.0, 319.5], [0.0, 525.0, 239.5], [0.0, 0.0, 1.0]], dtype=np.float32
)


class SphereWorld(NamedTuple):
    centers: torch.Tensor  # [S, 3]
    radii: torch.Tensor    # [S]


def random_spheres(seed: int = 0, n: int = 5, device=None) -> SphereWorld:
    """Five random non-intersecting spheres (`RenderSpheres.m:46-53`):
    centers uniform in [-0.5, 0.5]^3, radii in [0.0625, 0.5],
    rejection-sampled for pairwise separation; on `device` (default: the
    CUDA card, raising where there is none)."""
    device = device_mod.require() if device is None else device
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


class BoxWorld(NamedTuple):
    """Axis-aligned box union (see the JAX module): flat faces, 90-degree
    creases and depth steps where a box occludes the floor slab, with an
    exact SDF and gradient for scoring."""

    centers: torch.Tensor       # [B, 3]
    half_extents: torch.Tensor  # [B, 3]


def default_boxes(seed: int = 0, n: int = 3, device=None) -> BoxWorld:
    """Floor slab (top face at z = -0.4) plus n boxes resting on it,
    rejection-sampled for xy separation >= 5 cm; the JAX package's draw, on
    `device` (default: the CUDA card, raising where there is none)."""
    device = device_mod.require() if device is None else device
    rng = np.random.RandomState(seed)
    centers = [np.array([0.0, 0.0, -0.45])]
    halfs = [np.array([0.8, 0.8, 0.05])]
    placed: list = []
    while len(placed) < n:
        h = 0.06 + 0.14 * rng.rand(3)
        c = np.array([rng.uniform(-0.35, 0.35), rng.uniform(-0.35, 0.35),
                      -0.4 + h[2]])
        ok = all(
            np.max(np.abs(c[:2] - p[:2]) - (h[:2] + ph[:2])) > 0.05
            for p, ph in placed
        )
        if ok:
            placed.append((c, h))
    for c, h in placed:
        centers.append(c)
        halfs.append(h)
    return BoxWorld(
        centers=torch.as_tensor(np.array(centers), dtype=torch.float32,
                                device=device),
        half_extents=torch.as_tensor(np.array(halfs), dtype=torch.float32,
                                     device=device),
    )


def box_sdf(world: BoxWorld, points: torch.Tensor):
    """Exact SDF + unit gradient of the box union at world points (…,3).

    Per box, with q = |p - c| - h: outside distance ||max(q, 0)||, inside
    max_i(q_i); union by min (the SIGNED argmin). Gradients: the outward
    face/edge/corner direction outside, the one-hot max-axis normal inside."""
    d = points[..., None, :] - world.centers           # (…,B,3)
    q = torch.abs(d) - world.half_extents              # (…,B,3)
    out = torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)   # (…,B)
    sdf_b = out + torch.clamp(q.max(dim=-1).values, max=0.0)
    b = torch.argmin(sdf_b, dim=-1)
    sdf = torch.gather(sdf_b, -1, b[..., None])[..., 0]
    idx = b[..., None, None].expand(tuple(b.shape) + (1, 3))
    dn = torch.gather(d, -2, idx)[..., 0, :]
    qn = torch.gather(q, -2, idx)[..., 0, :]
    outn = torch.gather(out, -1, b[..., None])[..., 0]
    g_out = (torch.sign(dn) * torch.clamp(qn, min=0.0)
             / torch.clamp(outn[..., None], min=1e-12))
    g_in = torch.sign(dn) * torch.nn.functional.one_hot(
        torch.argmax(qn, dim=-1), 3).to(points.dtype)
    grad = torch.where((outn > 0.0)[..., None], g_out, g_in)
    return sdf, grad


def render_depth_boxes(world: BoxWorld, R, t, K: np.ndarray = KINECT_K,
                       width: int = 640, height: int = 480) -> torch.Tensor:
    """Exact ray/AABB (slab) depth render [H, W] under camera-to-world
    (R, t), on the world's device. Rays use the unnormalized camera
    direction [cu, cv, 1], so the slab parameter is the camera-space depth
    z; per box tn = max_i min(t1, t2), tf = min_i max(t1, t2), hit iff
    tn <= tf and tf > 0; missed rays get depth 0. The [H, W, B, 3] slab
    terms are ~15 MB at 640x480 with 4 boxes."""
    dev = world.centers.device
    fx, fy, cx, cy = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
                      float(K[1, 2]))
    u = (torch.arange(width, dtype=torch.float32, device=dev) - cx) / fx
    v = (torch.arange(height, dtype=torch.float32, device=dev) - cy) / fy
    cv, cu = torch.meshgrid(v, u, indexing="ij")
    d_cam = torch.stack([cu, cv, torch.ones_like(cu)], dim=-1)     # [H,W,3]
    R = torch.as_tensor(R, dtype=torch.float32, device=dev)
    o = torch.as_tensor(t, dtype=torch.float32, device=dev)
    d_w = d_cam @ R.T
    d_safe = torch.where(torch.abs(d_w) < 1e-12, torch.full_like(d_w, 1e-12), d_w)
    inv = 1.0 / d_safe
    bmin = world.centers - world.half_extents                      # [B,3]
    bmax = world.centers + world.half_extents
    t1 = (bmin - o) * inv[..., None, :]                            # [H,W,B,3]
    t2 = (bmax - o) * inv[..., None, :]
    tn = torch.minimum(t1, t2).max(dim=-1).values                  # [H,W,B]
    tf = torch.maximum(t1, t2).min(dim=-1).values
    hit = (tn <= tf) & (tf > 0.0)
    s = torch.where(tn > 0.0, tn, tf)
    s = torch.where(hit, s, torch.full_like(s, float("inf")))
    depth = s.min(dim=-1).values
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
