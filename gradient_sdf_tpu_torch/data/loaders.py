"""Dataset loaders: TUM RGB-D and Synth.

Port of `gradient_sdf_tpu/data/loaders.py` (the reference's
`cpp/include/img_loader/ImageLoader.h:51-263` hierarchy): same directory
conventions, depth units and trajectory format, as iterators yielding
numpy frames. Images are decoded by the package's stdlib PNG codec
(`data/png.py`), synchronously; there is no native prefetcher and no
Pillow. The Redwood (JPEG colour) and Printed3D loaders are not ported yet.

Conventions preserved:
  * 16-bit depth PNGs scaled by the dataset's unit to float32 metres
    (TUM: 1/5000, synth: 1/1000 — `TumrgbdLoader.h:62`, `SynthLoader.h:53`).
  * colour as float32 in [0, 1], stored channel order.
  * TUM trajectory lines `timestamp tx ty tz qx qy qz qw`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

import numpy as np

from ..utils import tumio
from .png import read_png


def _depth_from_raw(raw: np.ndarray, unit: float) -> np.ndarray:
    return raw.astype(np.float32) * unit


def _color_from_raw(raw: np.ndarray) -> np.ndarray:
    if raw.ndim == 2:
        raw = np.repeat(raw[..., None], 3, axis=-1)
    return raw.astype(np.float32) / 255.0


def load_depth_png(path: str, unit: float) -> np.ndarray:
    """16-bit depth PNG -> float32 metres (`ImageLoader.h:159-175`)."""
    return _depth_from_raw(read_png(path), unit)


def load_color_png(path: str) -> np.ndarray:
    """Colour PNG -> float32 RGB in [0,1]; greyscale is replicated to 3
    channels (`ImageLoader.h:196-217`)."""
    return _color_from_raw(read_png(path))


@dataclasses.dataclass
class Frame:
    color: np.ndarray           # [H, W, 3] float32 RGB in [0,1]
    depth: np.ndarray           # [H, W] float32 metres
    timestamp: str
    index: int


class ImageLoader:
    """Base loader: intrinsics + GT-pose files + frame iteration."""

    unit: float = 1e-3

    def __init__(self, path: str):
        self.path = path.rstrip("/") + "/"

    def load_intrinsics(self, filename: str = "intrinsics.txt") -> Optional[np.ndarray]:
        """3x3 row-major K from a whitespace text file (`ImageLoader.h:138-157`)."""
        p = os.path.join(self.path, filename)
        if not os.path.isfile(p):
            return None
        vals = np.loadtxt(p, dtype=np.float64).reshape(3, 3)
        return vals.astype(np.float32)

    def load_poses(self, filename: str):
        """TUM trajectory -> list of (ts, R, t) camera-to-world, or None."""
        p = os.path.join(self.path, filename)
        if not os.path.isfile(p):
            return None
        return tumio.read_trajectory(p)

    def _frame_specs(self, first: int, last: Optional[int]):
        """Ordered list of (index, timestamp, color_path, depth_path) for
        the requested range — the loader-specific directory convention."""
        raise NotImplementedError

    def frames(self, first: int = 0, last: Optional[int] = None) -> Iterator[Frame]:
        for i, ts, cp, dp in self._frame_specs(first, last):
            yield Frame(color=load_color_png(cp),
                        depth=load_depth_png(dp, self.unit),
                        timestamp=ts, index=i)

    def load_color_at(self, index: int) -> Optional[np.ndarray]:
        """Random-access reload of one frame's colour image, so PhotoBA
        keeps frame INDICES for its keyframe candidates and decodes only
        the <= --key-frame sampled images right before BA."""
        return None


class TumrgbdLoader(ImageLoader):
    """TUM RGB-D: `associated.txt` lines `ts_rgb rgb_path ts_depth depth_path`
    (`TumrgbdLoader.h:79-103`); depth unit 1/5000."""

    unit = 1.0 / 5000.0

    def __init__(self, path: str):
        super().__init__(path)
        self.assoc = []
        with open(os.path.join(self.path, "associated.txt")) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts_rgb, rgb_f, ts_depth, depth_f = line.split()[:4]
                self.assoc.append((ts_rgb, rgb_f, ts_depth, depth_f))

    def _frame_specs(self, first=0, last=None):
        last = len(self.assoc) if last is None else min(last, len(self.assoc))
        return [
            (i, self.assoc[i][0],
             os.path.join(self.path, self.assoc[i][1]),
             os.path.join(self.path, self.assoc[i][3]))
            for i in range(first, last)
        ]

    def __len__(self):
        return len(self.assoc)

    def load_color_at(self, index: int):
        if not (0 <= index < len(self.assoc)):
            return None
        return load_color_png(os.path.join(self.path, self.assoc[index][1]))


class SynthLoader(ImageLoader):
    """Synthetic spheres: `depth/%03d.png` + `rgb/%03d.png` from 1
    (`SynthLoader.h:65-84`); unit 1/1000. Iteration stops at the first frame missing either file."""

    unit = 1.0 / 1000.0

    def _name(self, i: int) -> str:
        return f"{i + 1:03d}.png"

    def _frame_specs(self, first=0, last=None):
        specs = []
        i = first
        while last is None or i < last:
            dp = os.path.join(self.path, "depth", self._name(i))
            cp = os.path.join(self.path, "rgb", self._name(i))
            if not (os.path.isfile(dp) and os.path.isfile(cp)):
                break
            specs.append((i, f"{i + 1:03d}", cp, dp))
            i += 1
        return specs

    def load_color_at(self, index: int):
        cp = os.path.join(self.path, "rgb", self._name(index))
        return load_color_png(cp) if os.path.isfile(cp) else None


def make_loader(data_type: str, path: str) -> ImageLoader:
    """Dataset dispatch (`main_scan_3d.cpp:117-159`)."""
    data_type = data_type.lower()
    if data_type in ("tum", "tumrgbd"):
        return TumrgbdLoader(path)
    if data_type in ("synth", "synthetic"):
        return SynthLoader(path)
    if data_type in ("rw", "redwood", "printed", "printed3d"):
        raise SystemExit(f"--data-type {data_type}: not yet ported to the "
                         "PyTorch package (use gradient_sdf_tpu)")
    raise ValueError(f"unknown data type: {data_type}")
