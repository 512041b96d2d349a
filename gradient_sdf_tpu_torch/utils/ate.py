"""Absolute trajectory error (ATE) — the TUM RGB-D benchmark protocol.

The reference writes TUM-format trajectories and relies on the external TUM
evaluation tooling for accuracy numbers
(`cpp/depth_scanning/src/main_scan_3d.cpp:267-280`, SURVEY.md §4.2); this
module brings that evaluation in-repo: timestamp association (nearest
neighbor within a window), closed-form rigid (Horn/Umeyama) alignment of the
estimated to the ground-truth trajectory, and the RMSE of the residual
translational error — the standard `evaluate_ate.py` semantics (no scale
correction: metric depth sensors).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np


class AteResult(NamedTuple):
    rmse: float
    mean: float
    median: float
    max: float
    num_pairs: int
    R: np.ndarray  # (3,3) alignment rotation  (gt ~= R @ est + t)
    t: np.ndarray  # (3,)


def horn_align(est: np.ndarray, gt: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Closed-form rigid alignment (Horn 1987 / Umeyama without scale):
    R, t minimizing sum ||gt_i - (R est_i + t)||^2 over paired [N,3] arrays."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    E = est - mu_e
    G = gt - mu_g
    # cross-covariance; SVD with reflection guard
    W = E.T @ G
    U, _, Vt = np.linalg.svd(W)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1.0
    R = (U @ S @ Vt).T  # maps est -> gt
    t = mu_g - R @ mu_e
    return R, t


def associate(
    est_ts: np.ndarray, gt_ts: np.ndarray, max_dt: float = 0.02
) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-timestamp association within `max_dt` seconds (greedy unique
    matches like the TUM associate.py default)."""
    est_ts = np.asarray(est_ts, np.float64)
    gt_ts = np.asarray(gt_ts, np.float64)
    order = np.argsort(gt_ts)
    gt_sorted = gt_ts[order]
    pos = np.searchsorted(gt_sorted, est_ts)
    pairs = []
    used = set()
    for i, p in enumerate(pos):
        best, best_dt = -1, max_dt
        for q in (p - 1, p):
            if 0 <= q < len(gt_sorted):
                dt = abs(gt_sorted[q] - est_ts[i])
                if dt <= best_dt:
                    best, best_dt = q, dt
        if best >= 0 and order[best] not in used:
            used.add(order[best])
            pairs.append((i, order[best]))
    if not pairs:
        return np.zeros(0, int), np.zeros(0, int)
    a = np.array([p[0] for p in pairs])
    b = np.array([p[1] for p in pairs])
    return a, b


def ate_rmse(est_xyz: np.ndarray, gt_xyz: np.ndarray) -> AteResult:
    """ATE over already-associated position arrays [N,3]."""
    R, t = horn_align(est_xyz, gt_xyz)
    aligned = est_xyz @ R.T + t
    err = np.linalg.norm(aligned - gt_xyz, axis=-1)
    return AteResult(
        rmse=float(np.sqrt(np.mean(err**2))),
        mean=float(err.mean()),
        median=float(np.median(err)),
        max=float(err.max()),
        num_pairs=len(err),
        R=R,
        t=t,
    )


def evaluate_ate(
    est: Sequence[Tuple[float, np.ndarray]],
    gt: Sequence[Tuple[float, np.ndarray]],
    max_dt: float = 0.02,
) -> Optional[AteResult]:
    """End-to-end ATE between (timestamp, position[3]) sequences.

    Returns None when fewer than 2 timestamp pairs associate (alignment
    would be degenerate)."""
    if len(est) == 0 or len(gt) == 0:
        return None
    est_ts = np.array([e[0] for e in est], np.float64)
    gt_ts = np.array([g[0] for g in gt], np.float64)
    ia, ib = associate(est_ts, gt_ts, max_dt)
    if len(ia) < 2:
        return None
    est_xyz = np.stack([np.asarray(est[i][1], np.float64) for i in ia])
    gt_xyz = np.stack([np.asarray(gt[i][1], np.float64) for i in ib])
    return ate_rmse(est_xyz, gt_xyz)
