"""Synthetic dataset generator: renders the sphere or the box world to disk.

Port of `gradient_sdf_tpu/apps/make_synth.py`: writes `depth/%03d.png`
(16-bit, millimetres), `rgb/%03d.png`, `albedo/%03d.png`,
`intrinsics.txt`, `gt_poses.txt` (TUM format) and `spheres.txt` (or, with
`--world box`, `boxes.txt`), the layout `SynthLoader` reads. PNGs go
through the package's own codec (`data/png.py`). Noise is drawn from
`numpy.random.default_rng(seed)`, so noisy datasets differ from the JAX
package's; `--no-noise` datasets agree up to float rounding of the
renderer. Rendering runs on `--device` (default `cuda`, raising where there
is no card); pass `cpu` where a dataset must come out the same on every
machine.

Usage:  python -m gradient_sdf_tpu_torch.apps.make_synth --out <dir> [--frames 90]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data import synth
from ..data.png import write_png
from ..utils import device as device_mod
from ..utils import se3, tumio

# matplotlib's default color cycle, as used for sphere albedo in
# RenderSpheres.m:82-87
SPHERE_COLORS = np.array(
    [
        [0.0, 0.4470, 0.7410],
        [0.8500, 0.3250, 0.0980],
        [0.9290, 0.6940, 0.1250],
        [0.4940, 0.1840, 0.5560],
        [0.4660, 0.6740, 0.1880],
    ],
    dtype=np.float32,
)


def render_color(world, R, t, K, width, height, gray_texture: bool = False):
    """Albedo render [H, W, 3]: each pixel takes its nearest sphere's flat
    colour, or with `gray_texture` a smooth greyscale world-anchored
    pattern (the BA-parity fixture; see the JAX module)."""
    z, cu, cv = synth._ray_sphere_z(world, R, t, K, width, height)
    zmin, sidx = torch.min(z, dim=-1)
    any_hit = torch.isfinite(zmin)
    if gray_texture:
        zs = torch.where(any_hit, zmin, torch.zeros_like(zmin))
        Rt = torch.as_tensor(R, dtype=torch.float32, device=zs.device)
        tt = torch.as_tensor(t, dtype=torch.float32, device=zs.device)
        pw = se3.se3_apply(Rt, tt, torch.stack([zs * cu, zs * cv, zs], -1))
        g = (0.55
             + 0.15 * torch.sin(31.0 * pw[..., 0])
             + 0.15 * torch.sin(29.0 * pw[..., 1])
             + 0.15 * torch.sin(27.0 * pw[..., 2]))
        g = torch.where(any_hit, g, torch.zeros_like(g))
        return g[..., None].expand(tuple(g.shape) + (3,))
    colors = torch.as_tensor(SPHERE_COLORS[: world.centers.shape[0]],
                             device=zmin.device)
    return torch.where(any_hit[..., None], colors[sidx],
                       torch.zeros((), device=zmin.device))


def render_color_boxes(world, R, t, K, width, height,
                       gray_texture: bool = False):
    """Albedo render [H, W, 3] of the box world: flat per-box colours (the
    sphere palette, cycled) or the greyscale world-anchored pattern of
    `render_color`."""
    fx, fy, cx, cy = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
                      float(K[1, 2]))
    dev = world.centers.device
    depth = synth.render_depth_boxes(world, R, t, K, width, height)
    hit = depth > 0.0
    u = (torch.arange(width, dtype=torch.float32, device=dev) - cx) / fx
    v = (torch.arange(height, dtype=torch.float32, device=dev) - cy) / fy
    cv, cu = torch.meshgrid(v, u, indexing="ij")
    Rt = torch.as_tensor(R, dtype=torch.float32, device=dev)
    tt = torch.as_tensor(t, dtype=torch.float32, device=dev)
    pw = se3.se3_apply(Rt, tt, torch.stack([depth * cu, depth * cv, depth], -1))
    zero = torch.zeros((), device=dev)
    if gray_texture:
        g = (0.55
             + 0.15 * torch.sin(31.0 * pw[..., 0])
             + 0.15 * torch.sin(29.0 * pw[..., 1])
             + 0.15 * torch.sin(27.0 * pw[..., 2]))
        g = torch.where(hit, g, zero)
        return g[..., None].expand(tuple(g.shape) + (3,))
    # a surface point's nearest box is the box it lies on
    q = torch.abs(pw[..., None, :] - world.centers) - world.half_extents
    sdf_b = (torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
             + torch.clamp(q.max(dim=-1).values, max=0.0))
    bidx = torch.argmin(sdf_b, dim=-1)
    n = world.centers.shape[0]
    colors = torch.as_tensor(SPHERE_COLORS[np.arange(n) % len(SPHERE_COLORS)],
                             device=dev)
    return torch.where(hit[..., None], colors[bidx], zero)


def write_png16(path, depth_m):
    mm = np.clip(np.round(np.asarray(depth_m) * 1000.0), 0, 65535)
    write_png(path, mm.astype(np.uint16))


def write_png8(path, img):
    write_png(path, np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8))


def generate(out: str, frames: int = 90, seed: int = 0, width: int = 640,
             height: int = 480, noise: bool = True, arc_deg: float = None,
             gray_texture: bool = False, loop: bool = False,
             world_kind: str = "spheres", device="cuda"):
    dev = device_mod.require(device)
    # Kinect intrinsics, scaled when rendering below the native 640x480
    K = synth.KINECT_K.copy()
    K[0] *= width / 640.0
    K[1] *= height / 480.0
    # default sweep ~4 deg/frame like the reference's 90-pose spiral
    if arc_deg is None:
        arc_deg = 360.0 if loop else 360.0 * frames / 90.0

    for sub in ("depth", "rgb", "albedo"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
    np.savetxt(os.path.join(out, "intrinsics.txt"), K, fmt="%.6f")

    if world_kind == "box":
        world = synth.default_boxes(seed=seed, device=dev)
        # the boxes stand on a floor slab (top at z = -0.4): orbit lower and
        # from above, so faces, creases and box-over-floor occlusion edges
        # are all in view
        poses = synth.orbit_poses(
            n=frames, radius=1.8, height_range=(0.35, 0.6),
            target=np.array([0.0, 0.0, -0.25]), arc=np.deg2rad(arc_deg),
            closed=loop)
        np.savetxt(
            os.path.join(out, "boxes.txt"),
            np.concatenate([world.centers.cpu().numpy(),
                            world.half_extents.cpu().numpy()], axis=1),
            fmt="%.6f",
            header="cx cy cz hx hy hz",
        )
        depth_fn, color_fn = synth.render_depth_boxes, render_color_boxes
    else:
        world = synth.random_spheres(seed=seed, device=dev)
        poses = synth.orbit_poses(n=frames, radius=2.0,
                                  arc=np.deg2rad(arc_deg), closed=loop)
        np.savetxt(
            os.path.join(out, "spheres.txt"),
            np.concatenate([world.centers.cpu().numpy(),
                            world.radii.cpu().numpy()[:, None]], axis=1),
            fmt="%.6f",
            header="cx cy cz r",
        )
        depth_fn, color_fn = synth.render_depth, render_color
    tumio.write_trajectory(
        os.path.join(out, "gt_poses.txt"),
        [(f"{i + 1:03d}", R, t) for i, (R, t) in enumerate(poses)],
    )

    rng = np.random.default_rng(seed)
    for i, (R, t) in enumerate(poses):
        depth = depth_fn(world, R, t, K, width, height)
        if noise:
            depth = synth.add_kinect_noise(depth, rng)
        color = color_fn(world, R, t, K, width, height,
                         gray_texture=gray_texture).cpu().numpy()
        name = f"{i + 1:03d}.png"
        write_png16(os.path.join(out, "depth", name), depth.cpu().numpy())
        write_png8(os.path.join(out, "rgb", name), color)
        write_png8(os.path.join(out, "albedo", name), color)
    print(f"wrote {frames} frames to {out} (rendered on {dev})")


def build_parser():
    p = argparse.ArgumentParser("make_synth")
    p.add_argument("--out", required=True)
    p.add_argument("--frames", type=int, default=90)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--no-noise", action="store_true")
    p.add_argument("--arc-deg", dest="arc_deg", type=float, default=None,
                   help="total orbit sweep in degrees (default: 4 deg/frame)")
    p.add_argument("--gray-texture", action="store_true",
                   help="grayscale world-anchored albedo texture")
    p.add_argument("--loop", action="store_true",
                   help="loop-closing trajectory: full orbit + sine height "
                        "ramp")
    p.add_argument("--world", choices=["spheres", "box"], default="spheres",
                   help="analytic world: smooth convex spheres (default) or "
                        "a floor slab with boxes (planar faces, creases, "
                        "occlusion edges; data/synth.BoxWorld)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; the run "
                        "fails rather than fall back if it is missing)")
    return p


def main(argv=None):
    a = build_parser().parse_args(argv)
    generate(a.out, a.frames, a.seed, a.width, a.height, noise=not a.no_noise,
             arc_deg=a.arc_deg, gray_texture=a.gray_texture, loop=a.loop,
             world_kind=a.world, device=a.device)


if __name__ == "__main__":
    main()
