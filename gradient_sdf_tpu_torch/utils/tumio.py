"""TUM trajectory file IO.

Format: `timestamp tx ty tz qx qy qz qw` per line, '#' comments
(read: `ImageLoader.h:231-259`; write: `main_scan_3d.cpp:267-280`,
`PhotometricOptimizer.cpp:592-609`). Poses are camera-to-world. Port of
`gradient_sdf_tpu/utils/tumio.py`; values come back as numpy arrays.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import se3


def read_trajectory(path: str):
    """Returns list of (timestamp str, R [3,3], t [3]) camera-to-world."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            ts = parts[0]
            vals = np.array([float(x) for x in parts[1:8]], dtype=np.float64)
            t = vals[:3]
            q = vals[3:7]  # qx qy qz qw
            if q @ q < 0.99:
                print(f"pose {ts} has invalid rotation", file=sys.stderr)
            R = se3.quat_to_rotmat(torch.from_numpy(q.astype(np.float32)))
            out.append((ts, R.numpy().astype(np.float32), t.astype(np.float32)))
    return out


def write_trajectory(path: str, entries):
    """entries: iterable of (timestamp str, R [3,3], t [3])."""
    with open(path, "w") as f:
        for ts, R, t in entries:
            R = torch.as_tensor(np.asarray(R, np.float32))
            q = se3.rotmat_to_quat(R).numpy()
            t = np.asarray(t, np.float32)
            f.write(
                f"{ts} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )


def ate_rmse(traj_est, traj_gt, align: bool = True) -> float:
    """Absolute trajectory error (RMSE of translation) after an optional
    rigid Horn alignment, in float64. `traj_*`: lists of (ts, R, t),
    paired by exact timestamp string. Raises ValueError under 3 pairs.
    (`utils/ate.ate_rmse` is the TUM tool's nearest-stamp variant.)"""
    gt_map = {ts: t for ts, _, t in traj_gt}
    pairs = [(t, gt_map[ts]) for ts, _, t in traj_est if ts in gt_map]
    if len(pairs) < 3:
        raise ValueError("not enough matched timestamps for ATE")
    est = np.array([p[0] for p in pairs], dtype=np.float64)
    gt = np.array([p[1] for p in pairs], dtype=np.float64)
    if align:
        mu_e, mu_g = est.mean(0), gt.mean(0)
        E, G = est - mu_e, gt - mu_g
        U, _, Vt = np.linalg.svd(E.T @ G)
        S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
        R = Vt.T @ S @ U.T
        est = (R @ E.T).T + mu_g
        gt = G + mu_g
    err = est - gt
    return float(np.sqrt((err * err).sum(axis=1).mean()))
