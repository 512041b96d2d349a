"""Dataset loaders: TUM RGB-D, Redwood, Synth, Printed3D.

Port of `gradient_sdf_tpu/data/loaders.py` (the reference's
`cpp/include/img_loader/ImageLoader.h:51-263` hierarchy): same directory
conventions, depth units and trajectory format, as iterators yielding
numpy frames. Images are decoded synchronously by the package's own codecs,
chosen by extension: PNG by `data/png.py`, JPEG (Redwood's colour) by
`data/jpeg.py`; there is no prefetcher and no Pillow.

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
from .jpeg import read_jpeg
from .png import read_png


def _imread(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        return read_png(path)
    if ext in (".jpg", ".jpeg"):
        return read_jpeg(path)
    raise ValueError(f"{path}: no decoder for {ext!r} images (PNG and JPEG)")


def _depth_from_raw(raw: np.ndarray, unit: float) -> np.ndarray:
    return raw.astype(np.float32) * unit


def _color_from_raw(raw: np.ndarray) -> np.ndarray:
    """Decoded samples -> float32 RGB in [0, 1]: grey is replicated to 3
    channels, alpha dropped. Unlike the JAX package's PIL path, a grey+alpha
    image gives its grey three times (there it reaches this point with 2
    channels)."""
    if raw.ndim == 2:
        raw = raw[..., None]
    if raw.shape[-1] in (1, 2):
        raw = np.repeat(raw[..., :1], 3, axis=-1)
    return raw[..., :3].astype(np.float32) / 255.0


def load_depth_png(path: str, unit: float) -> np.ndarray:
    """16-bit depth PNG -> float32 metres (`ImageLoader.h:159-175`)."""
    return _depth_from_raw(read_png(path), unit)


def load_color_png(path: str) -> np.ndarray:
    """Colour image (PNG or JPEG) -> float32 RGB in [0,1]; greyscale is
    replicated to 3 channels (`ImageLoader.h:196-217`)."""
    return _color_from_raw(_imread(path))


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

    def load_keyframe(self, index: int) -> Optional[Frame]:
        return None

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


class RedwoodLoader(ImageLoader):
    """Redwood: sorted `depth/*.png` + `rgb/*.jpg` listings
    (`RedwoodLoader.h:57-141`); unit 1/1000; timestamp = filename stem."""

    unit = 1.0 / 1000.0

    def __init__(self, path: str):
        super().__init__(path)
        self.depth_files = sorted(os.listdir(os.path.join(self.path, "depth")))
        self.rgb_files = sorted(os.listdir(os.path.join(self.path, "rgb")))

    def _frame_specs(self, first=0, last=None):
        n = len(self)
        last = n if last is None else min(last, n)
        return [
            (i, os.path.splitext(self.depth_files[i])[0],
             os.path.join(self.path, "rgb", self.rgb_files[i]),
             os.path.join(self.path, "depth", self.depth_files[i]))
            for i in range(first, last)
        ]

    def __len__(self):
        return min(len(self.depth_files), len(self.rgb_files))

    def load_color_at(self, index: int):
        if not (0 <= index < len(self.rgb_files)):
            return None
        return load_color_png(
            os.path.join(self.path, "rgb", self.rgb_files[index]))


class SynthLoader(ImageLoader):
    """Synthetic spheres: `depth/%03d.png` + `rgb/%03d.png` from 1
    (`SynthLoader.h:65-84`); unit 1/1000; keyframes read `albedo/`.
    Iteration stops at the first frame missing either file."""

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

    def load_keyframe(self, index: int):
        """Keyframe colour comes from `albedo/` (`SynthLoader.h:86-107`)."""
        dp = os.path.join(self.path, "depth", self._name(index))
        cp = os.path.join(self.path, "albedo", self._name(index))
        if not (os.path.isfile(dp) and os.path.isfile(cp)):
            return None
        return Frame(color=load_color_png(cp),
                     depth=load_depth_png(dp, self.unit),
                     timestamp=f"{index + 1:03d}", index=index)


class Printed3dLoader(ImageLoader):
    """Printed3D: `depth_%06d.png` + `color_%06d.png` from 0
    (`Printed3dLoader.h:52-112`); unit 1/1000."""

    unit = 1.0 / 1000.0

    def load_color_at(self, index: int):
        cp = os.path.join(self.path, f"color_{index:06d}.png")
        return load_color_png(cp) if os.path.isfile(cp) else None

    def _frame_specs(self, first=0, last=None):
        specs = []
        i = first
        while last is None or i < last:
            dp = os.path.join(self.path, f"depth_{i:06d}.png")
            cp = os.path.join(self.path, f"color_{i:06d}.png")
            if not (os.path.isfile(dp) and os.path.isfile(cp)):
                break
            specs.append((i, f"{i:06d}", cp, dp))
            i += 1
        return specs


def make_loader(data_type: str, path: str) -> ImageLoader:
    """Dataset dispatch (`main_scan_3d.cpp:117-159`)."""
    data_type = data_type.lower()
    if data_type in ("tum", "tumrgbd"):
        return TumrgbdLoader(path)
    if data_type in ("rw", "redwood"):
        return RedwoodLoader(path)
    if data_type in ("synth", "synthetic"):
        return SynthLoader(path)
    if data_type in ("printed", "printed3d"):
        return Printed3dLoader(path)
    raise ValueError(f"unknown data type: {data_type}")
