"""Class-style rigid optimizer wrappers (reference API parity).

Port of `gradient_sdf_tpu/models/rigid_optimizer.py`. `RigidOptimizer`
mirrors the reference base (`sdf_tracker/RigidOptimizer.h:51-112`:
iteration/threshold/damping settings + current pose); `RigidPointOptimizer`
mirrors `RigidPointOptimizer.h:49-74` with `optimize(depth, K)` /
`optimize_sampled(depth, K, sampling)` driving the functional tracker
(`models/tracker.py`) on the map's device, in the mode the map's type
asks for: trilinear for a `PixelSdfMap`, semi-implicit otherwise.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import TrackerConfig
from . import tracker as tracker_mod
from .pixel_sdf import PixelSdfMap


class RigidOptimizer:
    def __init__(self, sdf_map, num_iterations=25, conv_threshold=1e-3,
                 damping=1.0):
        self.sdf_map = sdf_map  # GradSdfMap or PixelSdfMap
        self.tcfg = TrackerConfig(
            num_iterations=num_iterations,
            conv_threshold=conv_threshold,
            damping=damping,
        )
        self.R = sdf_map._tensor(torch.eye(3))
        self.t = sdf_map._tensor(torch.zeros(3))
        self.last_result = None

    # setters matching the reference (:90-103)
    def set_num_iterations(self, n):
        self.tcfg = dataclasses.replace(self.tcfg, num_iterations=n)

    def set_conv_threshold(self, thr):
        self.tcfg = dataclasses.replace(self.tcfg, conv_threshold=thr)

    def set_damping(self, d):
        self.tcfg = dataclasses.replace(self.tcfg, damping=d)

    def set_pose(self, R, t):
        self.R = self.sdf_map._tensor(R)
        self.t = self.sdf_map._tensor(t)

    def pose(self):
        return self.R, self.t


class RigidPointOptimizer(RigidOptimizer):
    def optimize(self, depth, K) -> bool:
        return self.optimize_sampled(depth, K, 1)

    def optimize_sampled(self, depth, K, sampling: int) -> bool:
        m = self.sdf_map
        mode = "trilinear" if isinstance(m, PixelSdfMap) else "grad"
        tcfg = dataclasses.replace(self.tcfg, sampling=sampling)
        res = tracker_mod.track_frame(
            m.grid, m._tensor(depth), K, self.R, self.t, m.cfg.grid,
            m.cfg.fusion, tcfg, mode=mode)
        self.R, self.t = res.R, res.t
        self.last_result = res
        return bool(res.converged)
