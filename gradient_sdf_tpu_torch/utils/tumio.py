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
