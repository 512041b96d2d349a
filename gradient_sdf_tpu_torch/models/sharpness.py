"""Keyframe sharpness test: modified-Laplacian focus measure (LAPM, Nayar89).

Port of `gradient_sdf_tpu/models/sharpness.py` (`sharpDetector` /
`modifiedLaplacian`, `cpp/include/ps_optimizer/SharpDetector.h:44-70`):
separable filters [-1, 2, -1] x gaussian([.25, .5, .25]) in both
orientations on the colour image, focus = mean(|Lx| + |Ly|) of the first
channel, compared against a per-dataset threshold
(`main_photo_ba.cpp:109-120`).

It runs once per converged frame on the loader's host image, so it is
numpy on the host, in float32: nothing is sent to the device for one number.
"""

from __future__ import annotations

import numpy as np

_LAP = np.asarray([-1.0, 2.0, -1.0], np.float32)
_GAUSS = np.asarray([0.25, 0.5, 0.25], np.float32)


def _sep_filter(img, kx, ky):
    """Separable 3-tap filter with BORDER_REFLECT_101 (cv sepFilter2D)."""
    x = np.pad(img, ((1, 1), (1, 1)), mode="reflect")
    # horizontal (kx along columns), then vertical
    h = kx[0] * x[:, :-2] + kx[1] * x[:, 1:-1] + kx[2] * x[:, 2:]
    return ky[0] * h[:-2, :] + ky[1] * h[1:-1, :] + ky[2] * h[2:, :]


def modified_laplacian(img) -> np.float32:
    """img: [H, W] or [H, W, C] float; returns the scalar focus measure
    (first channel only, matching cv::mean(...).val[0])."""
    img = np.asarray(img, np.float32)
    chan = img[..., 0] if img.ndim == 3 else img
    lx = _sep_filter(chan, _LAP, _GAUSS)
    ly = _sep_filter(chan, _GAUSS, _LAP)
    return np.mean(np.abs(lx) + np.abs(ly))


def sharp_detector(img, threshold: float) -> bool:
    return float(modified_laplacian(img)) >= threshold
