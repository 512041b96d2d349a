"""The benchmark's own scene: an analytic office room seen from a circle.

Frozen here, apart from the program's `data/synth.py`, so that a change to
the program cannot move the yardstick. Everything is drawn from a seed (a
cell's traffic file may fix it with `scene_seed`, so that every run's seed
gets the same room):

* the room: an axis-aligned box (the inner walls, floor and ceiling), with
  boxes (desks, shelves, cabinets) standing on the floor against the walls
  and spheres half sunk into the walls. Box and sphere sizes are fixed by
  the traffic file; the seed draws where they stand, so every seed gives
  about the same amount of surface in another arrangement;
* the camera: a circle at the room's centre, looking outward with a
  downward pitch, a fixed number of frames a revolution, starting at an
  angle drawn from the seed;
* depth: exact ray casts (camera-space z), then the upstream Kinect
  disparity noise (`matlab/add_kinect_noise.m:50-74`) and 1 mm
  quantization (a 16-bit PNG in millimetres).

World frame: z up, the circle's centre at the origin, the camera at z = 0.
Camera frame: x right, y down, z forward (pinhole, camera-to-world poses).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class Room(NamedTuple):
    lo: torch.Tensor        # [3] inner room corner
    hi: torch.Tensor        # [3]
    box_lo: torch.Tensor    # [B, 3]
    box_hi: torch.Tensor    # [B, 3]
    sph_c: torch.Tensor     # [S, 3]
    sph_r: torch.Tensor     # [S]


def _wall_point(u: float, hx: float, hy: float, half_w: float):
    """Perimeter coordinate u (m, counter-clockwise from the corner
    (-hx, -hy)) -> (wall, coordinate along it), moved along its wall so
    that a feature of half-width `half_w` clears the corners by 5 cm."""
    P = 4.0 * (hx + hy)
    u = u % P
    sides = [(0, 2 * hx, -hx), (3, 2 * hy, -hy), (1, 2 * hx, hx), (2, 2 * hy, hy)]
    for wall, length, start in sides:
        if u < length:
            along = u + half_w + 0.05 if u < half_w + 0.05 else u
            along = min(along, length - half_w - 0.05)
            # y = -hy runs +x, x = +hx runs +y, y = +hy runs -x, x = -hx runs -y
            return wall, (start + along if wall in (0, 3) else start - along)
        u -= length
    raise AssertionError


def make_room(seed: int, traffic: dict, device) -> Room:
    """The room of `traffic["room"]` for `seed`. The boxes (width along
    their wall, depth from it, height; standing on the floor) and the
    spheres (each half sunk into its wall, its centre `sphere_height` below
    the camera) are dealt in a drawn order to places evenly spaced round
    the walls, boxes and spheres in turn, from a drawn start and each moved
    by up to 10 cm: every outward view then holds a sphere or a corner, and
    constrains all six degrees of freedom of the camera (a box seen from
    the front shows one plane; a view of planes with two normals or fewer
    leaves GN's system singular, and the track diverges)."""
    spec = traffic["room"]
    rng = np.random.default_rng([int(seed), 0x5CE7E])
    hx, hy = spec["size"][0] / 2.0, spec["size"][1] / 2.0
    floor = -spec["camera_height"]
    lo = np.array([-hx, -hy, floor])
    hi = np.array([hx, hy, floor + spec["size"][2]])
    boxes, spheres = spec["boxes"], spec["spheres"]
    if len(boxes) != len(spheres):
        raise ValueError("room: as many spheres as boxes (they alternate)")
    bo, so = rng.permutation(len(boxes)), rng.permutation(len(spheres))
    feats = [f for i in range(len(boxes))
             for f in (("box", boxes[bo[i]]), ("sphere", spheres[so[i]]))]
    P = 4.0 * (hx + hy)
    start = rng.uniform(0.0, P)
    zr = spec["sphere_heights"]
    placed, centres = [], []
    for k, (kind, size) in enumerate(feats):
        u = start + k * P / len(feats) + rng.uniform(-0.1, 0.1)
        half_w = size[0] / 2.0 if kind == "box" else size
        wall, s = _wall_point(u, hx, hy, half_w)
        if kind == "sphere":
            zc = -rng.uniform(zr[0], zr[1])
            c = {0: [s, -hy, zc], 1: [s, hy, zc], 2: [-hx, s, zc], 3: [hx, s, zc]}[wall]
            centres.append((c, size))
            continue
        w, d, h = size
        if wall == 0:    # y = -hy
            blo, bhi = [s - w / 2, -hy, floor], [s + w / 2, -hy + d, floor + h]
        elif wall == 1:  # y = +hy
            blo, bhi = [s - w / 2, hy - d, floor], [s + w / 2, hy, floor + h]
        elif wall == 2:  # x = -hx
            blo, bhi = [-hx, s - w / 2, floor], [-hx + d, s + w / 2, floor + h]
        else:            # x = +hx
            blo, bhi = [hx - d, s - w / 2, floor], [hx, s + w / 2, floor + h]
        placed.append((np.array(blo), np.array(bhi)))

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float32,
                               device=device)

    return Room(lo=f32(lo), hi=f32(hi),
                box_lo=f32([b[0] for b in placed]),
                box_hi=f32([b[1] for b in placed]),
                sph_c=f32([c for c, _ in centres]).reshape(-1, 3),
                sph_r=f32([r for _, r in centres]))


def start_angle(seed: int) -> float:
    """The angle of the revolution's first frame, drawn from the seed, at
    least 10 degrees from facing a wall square on. The map's frame is the
    first camera's (as in the app), so this keeps the walls off the voxel
    grid's planes: a wall that lies in a plane of voxel centres gives GN a
    staircase field on which it does not converge (found on the CPU: every
    view of an axis-aligned room failed without depth noise, and a fifth
    with it; the same room turned by 17 degrees converged in 3-7
    iterations)."""
    rng = np.random.default_rng([int(seed), 0xA7])
    return math.radians(90.0 * int(rng.integers(4)) + rng.uniform(10.0, 80.0))


def relative_poses(poses) -> list:
    """The poses in the first camera's frame (the first becomes the
    identity), as the app sees a sequence: the map is anchored there."""
    R0 = poses[0][0].astype(np.float64)
    t0 = poses[0][1].astype(np.float64)
    out = []
    for R, t in poses:
        Rr = R0.T @ R.astype(np.float64)
        tr = R0.T @ (t.astype(np.float64) - t0)
        out.append((Rr.astype(np.float32), tr.astype(np.float32)))
    return out


def circle_poses(traffic: dict, seed: int) -> list:
    """One revolution of camera-to-world poses [(R [3,3], t [3])] (numpy
    float32): the camera on a circle of `radius` at z = 0, looking outward,
    pitched down by `pitch_deg`, `frames` poses a revolution. With
    `arc_deg` under 360 the path sweeps that arc out and back, so that it
    still closes."""
    cam = traffic["camera"]
    n, radius = cam["frames"], cam["radius"]
    pitch = math.radians(cam["pitch_deg"])
    arc = math.radians(cam.get("arc_deg", 360.0))
    a0 = start_angle(seed)
    poses = []
    for i in range(n):
        a = a0 + (2.0 * math.pi * i / n if arc >= 2.0 * math.pi
                  else arc * (1.0 - abs(2.0 * i / n - 1.0)))
        out = np.array([math.cos(a), math.sin(a), 0.0])
        eye = radius * out
        fwd = math.cos(pitch) * out + np.array([0.0, 0.0, -math.sin(pitch)])
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd], axis=1).astype(np.float32)
        poses.append((R, eye.astype(np.float32)))
    return poses


def intrinsics(cfg: dict) -> np.ndarray:
    c = cfg["camera"]
    return np.array([[c["fx"], 0.0, c["cx"]], [0.0, c["fy"], c["cy"]],
                     [0.0, 0.0, 1.0]], dtype=np.float32)


def _rays(R, t, K, width, height, device):
    fx, fy, cx, cy = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
                      float(K[1, 2]))
    u = (torch.arange(width, dtype=torch.float32, device=device) - cx) / fx
    v = (torch.arange(height, dtype=torch.float32, device=device) - cy) / fy
    cv, cu = torch.meshgrid(v, u, indexing="ij")
    d_cam = torch.stack([cu, cv, torch.ones_like(cu)], dim=-1)
    R = torch.as_tensor(R, dtype=torch.float32, device=device)
    o = torch.as_tensor(t, dtype=torch.float32, device=device)
    d_w = (d_cam[..., None, :] * R).sum(-1)   # R d, [H, W, 3]
    return o, d_w


def cast(room: Room, R, t, K, width: int, height: int):
    """Exact ray cast under camera-to-world (R, t): camera-space depth
    [H, W] (the ray parameter of the unnormalized ray [u, v, 1]). Every
    ray leaves the room, so every depth is finite."""
    o, d = _rays(R, t, K, width, height, room.lo.device)
    d_safe = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    inv = 1.0 / d_safe
    # inside the room: the nearest exit over the three axes
    t_far = torch.maximum((room.lo - o) * inv, (room.hi - o) * inv)
    depth = t_far.min(dim=-1).values
    # boxes: the slab test's entry
    t1 = (room.box_lo - o) * inv[..., None, :]
    t2 = (room.box_hi - o) * inv[..., None, :]
    tn = torch.minimum(t1, t2).max(dim=-1).values
    tf = torch.maximum(t1, t2).min(dim=-1).values
    hit = (tn <= tf) & (tn > 0.0)
    tn = torch.where(hit, tn, torch.full_like(tn, float("inf")))
    depth = torch.minimum(depth, tn.min(dim=-1).values)
    # spheres: (o + s d - c)^2 = r^2
    oc = o - room.sph_c                                   # [S, 3]
    a = (d * d).sum(-1)[..., None]                        # [H, W, 1]
    b = 2.0 * (d[..., None, :] * oc).sum(-1)              # [H, W, S]
    c = (oc * oc).sum(-1) - room.sph_r ** 2               # [S]
    disc = b * b - 4.0 * a * c
    s = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a)
    s = torch.where((disc >= 0.0) & (s > 0.0), s, torch.full_like(s, float("inf")))
    return torch.minimum(depth, s.min(dim=-1).values)


def kinect_noise(depth: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Disparity-domain Kinect noise (`add_kinect_noise.m:50-74`):
    d = (3 - 1/z) / 2.85e-3, d += 0.5 N(0, 1), round, invert; the normal
    draws from `gen` on the depth's device."""
    mask = depth > 0.0
    safe_z = torch.where(mask, depth, torch.ones_like(depth))
    d = (3.0 - 1.0 / safe_z) / 2.85e-3
    noise = torch.randn(depth.shape, generator=gen, dtype=depth.dtype,
                        device=depth.device)
    d = torch.round(d + 0.5 * noise)
    return torch.where(mask, 1.0 / (-2.85e-3 * d + 3.0), torch.zeros_like(depth))


def quantize(depth: torch.Tensor, unit: float = 1e-3) -> torch.Tensor:
    return torch.round(depth / unit) * unit


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    return g


def make_frames(room: Room, poses, K, cfg: dict, traffic: dict, seed: int):
    """Depth frames of `poses`, made on the room's device: exact casts,
    Kinect noise from a generator seeded with `seed` (when
    `traffic["depth"]["kinect_noise"]`), 1 mm quantization. Returns float32
    arrays [H, W] on the host, as a loader hands frames to the app."""
    W, H = cfg["camera"]["width"], cfg["camera"]["height"]
    gen = generator(seed, room.lo.device)
    noisy = traffic["depth"].get("kinect_noise", True)
    depths = []
    for R, t in poses:
        z = cast(room, R, t, K, W, H)
        if noisy:
            z = kinect_noise(z, gen)
        depths.append(quantize(z, traffic["depth"].get("quantum_m", 1e-3)).cpu().numpy())
    return depths


def pose_tensors(pose, device, dtype=torch.float32):
    return (torch.as_tensor(pose[0], dtype=dtype, device=device),
            torch.as_tensor(pose[1], dtype=dtype, device=device))
