"""Colour for the room of `scene.py`, and PhotoBA's start states.

Every surface of the room (walls, floor, ceiling, boxes, spheres) carries
one Lambertian albedo texture drawn from the seed: in each colour channel
0.5 + amplitude x the mean of `waves` plane waves, sin(k . x + phase),
held to [0, 1], with directions uniform on the sphere and wavelengths
uniform in `wavelength_m`, all in world coordinates. Under uniform ambient
light the
radiance of a Lambertian surface is its albedo, the same from every view,
so the keyframes are photoconsistent at their true poses and a moved pose
shows as a photometric residual (with flat colours every residual is zero
and the problem has no solution to find).

The start states move every keyframe pose of the truth by a translation
with `t_sigma_m` a component and a right-multiplied rotation exp(w) with
`r_sigma_deg` a component, drawn from the seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import scene
from .reference import se3 as RS


class Texture:
    """The albedo's waves: k [3 channels, waves, 3] (rad/m), phase [3,
    waves], amplitude."""

    def __init__(self, seed: int, spec: dict, device):
        rng = np.random.default_rng([int(seed), 0xA1BE])
        n = spec["waves"]
        d = rng.normal(size=(3, n, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        lam = rng.uniform(*spec["wavelength_m"], size=(3, n, 1))
        self.k = torch.as_tensor(2.0 * math.pi * d / lam, dtype=torch.float32,
                                 device=device)
        self.phase = torch.as_tensor(rng.uniform(0.0, 2.0 * math.pi, (3, n)),
                                     dtype=torch.float32, device=device)
        self.amplitude = float(spec["amplitude"])

    def albedo(self, x):
        """RGB albedo [..., 3] at world points x [..., 3]."""
        arg = torch.einsum("...j,cnj->...cn", x, self.k) + self.phase
        return torch.clamp(0.5 + self.amplitude * torch.sin(arg).mean(dim=-1),
                           0.0, 1.0)


def render(room: scene.Room, tex: Texture, R, t, K, width: int, height: int):
    """The colour image [H, W, 3] (float32 in [0, 1], on the room's device)
    under camera-to-world (R, t): the albedo where each pixel's ray meets
    the room."""
    s = scene.cast(room, R, t, K, width, height)
    o, d = scene._rays(R, t, K, width, height, room.lo.device)
    return tex.albedo(o + s[..., None] * d)


def keyframe_images(room, tex, world_poses, K, cfg) -> np.ndarray:
    """[F, H, W, 3] float32 on the host, as a loader hands colour to the app."""
    c = cfg["camera"]
    return np.stack([render(room, tex, R, t, K, c["width"], c["height"]).cpu().numpy()
                     for R, t in world_poses]).astype(np.float32)


def start_states(poses, spec: dict, seed: int) -> list:
    """`spec["count"]` starts, each [(R, t)] of every keyframe pose in
    `poses` moved (module note); numpy float32."""
    rng = np.random.default_rng([int(seed), 0xBA30])
    R0 = torch.as_tensor(np.stack([p[0] for p in poses]), dtype=torch.float64)
    t0 = np.stack([p[1] for p in poses]).astype(np.float64)
    out = []
    for _ in range(spec["count"]):
        dt = rng.normal(0.0, spec["t_sigma_m"], t0.shape)
        dw = rng.normal(0.0, math.radians(spec["r_sigma_deg"]), t0.shape)
        R = (R0 @ RS.so3_exp(torch.as_tensor(dw))).numpy()
        out.append([(R[i].astype(np.float32), (t0[i] + dt[i]).astype(np.float32))
                    for i in range(len(poses))])
    return out
