"""Dataset loaders: TUM RGB-D, Redwood, Synth, Printed3D.

Port of `gradient_sdf_tpu/data/loaders.py` (the reference's
`cpp/include/img_loader/ImageLoader.h:51-263` hierarchy): same directory
conventions, depth units and trajectory format, as iterators yielding
numpy frames. Images are decoded by the package's own codecs, chosen by
extension: PNG by `data/png.py`, JPEG (Redwood's colour) by `data/jpeg.py`;
no Pillow.

`frames()` decodes ahead, as the JAX package's does: `_PrefetchReader`
runs two worker threads over the ordered list of the range's colour and
depth files, at most 16 images ahead of the loop, and hands the loop ready
float32 arrays in order. The threads are Python threads. They decode in
parallel with the frame loop because the calls that take the time release
the GIL: the file read, `zlib.decompress` (PNG), the ctypes calls of
`native/png_unfilter.c` and `native/jpeg_decode.c`, and numpy's passes to
float32. What holds the GIL is the bytecode around them, and each return
from such a call retakes it: a handoff that can stall the frame loop. So
`read_png` inflates in one call (an output buffer of the expected size)
and the conversions below are one numpy pass each. A worker's error is
raised at its frame, on the loop's thread; nothing is decoded again
synchronously.

Conventions preserved:
  * 16-bit depth PNGs scaled by the dataset's unit to float32 metres
    (TUM: 1/5000, synth: 1/1000 — `TumrgbdLoader.h:62`, `SynthLoader.h:53`).
  * colour as float32 in [0, 1], stored channel order.
  * TUM trajectory lines `timestamp tx ty tz qx qy qz qw`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading
import time
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
    # raw.astype(float32) * unit in one pass (the same float32 products)
    return np.multiply(raw, unit, dtype=np.float32)


def _color_from_raw(raw: np.ndarray) -> np.ndarray:
    """Decoded samples -> float32 RGB in [0, 1]: grey is replicated to 3
    channels, alpha dropped. Unlike the JAX package's PIL path, a grey+alpha
    image gives its grey three times (there it reaches this point with 2
    channels)."""
    if raw.ndim == 2:
        raw = raw[..., None]
    if raw.shape[-1] in (1, 2):
        raw = np.repeat(raw[..., :1], 3, axis=-1)
    # raw.astype(float32) / 255 in one pass (the same float32 quotients)
    return np.divide(raw[..., :3], 255.0, dtype=np.float32)


def load_depth_png(path: str, unit: float) -> np.ndarray:
    """16-bit depth PNG -> float32 metres (`ImageLoader.h:159-175`)."""
    return _depth_from_raw(read_png(path), unit)


def load_color_png(path: str) -> np.ndarray:
    """Colour image (PNG or JPEG) -> float32 RGB in [0,1]; greyscale is
    replicated to 3 channels (`ImageLoader.h:196-217`)."""
    return _color_from_raw(_imread(path))


class _PrefetchReader:
    """Ordered decode-ahead over a list of image files (the JAX package's
    `_PrefetchReader` over its native prefetcher, `native/gradsdf_native.cpp`
    `Prefetcher`, for PNG and JPEG alike).

    `get(k)` returns image k decoded, and passed through `convert[k]` when
    given, in the order of `paths`. `n_threads` worker threads decode
    ahead; a worker starts image i only while i < (images taken) + `window`,
    so at most `window` images are resident or in progress (`peak_resident`
    records the most), whatever the sequence's length; 0 means no bound. A
    `get` past the window slides it forward (random access trades the bound
    for progress). A decode error is raised by `get` of that image, with
    its path. `n_threads=0` decodes on the calling thread, in `get`.
    `close()` stops and joins the workers."""

    def __init__(self, paths, n_threads: int = 2, window: int = 16,
                 convert=None):
        self._paths = list(paths)
        self._convert = (list(convert) if convert is not None
                         else [None] * len(self._paths))
        self._window = window if window > 0 else max(1, len(self._paths))
        self._cv = threading.Condition()
        self._next = 0          # the next image a worker takes up
        self._consumed = 0      # images below this are no longer ahead
        self._done = {}         # image -> (array, None) or (None, error)
        self._busy = set()      # images being decoded
        self._closed = False
        self.n_threads = n_threads
        self.window = window
        self.peak_resident = 0
        self._threads = [threading.Thread(target=self._work, daemon=True,
                                          name=f"gsdf-decode-{t}")
                         for t in range(n_threads)]
        for t in self._threads:
            t.start()

    def _decode(self, k: int) -> np.ndarray:
        arr = _imread(self._paths[k])
        return arr if self._convert[k] is None else self._convert[k](arr)

    def _work(self):
        n = len(self._paths)
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._closed or self._next >= n
                                  or self._next < self._consumed + self._window)
                if self._closed or self._next >= n:
                    return
                k = self._next
                self._next += 1
                self._busy.add(k)
                self.peak_resident = max(self.peak_resident,
                                         len(self._done) + len(self._busy))
            try:
                res = (self._decode(k), None)
            except Exception as e:   # raised by get(k), on the loop's thread
                res = (None, e)
            with self._cv:
                self._busy.discard(k)
                self._done[k] = res
                self._cv.notify_all()

    def get(self, k: int) -> np.ndarray:
        if not 0 <= k < len(self._paths):
            raise IndexError(f"image {k} of {len(self._paths)}")
        if not self._threads:
            try:
                return self._decode(k)
            except Exception as e:
                raise RuntimeError(f"cannot decode {self._paths[k]}: {e}") from e
        with self._cv:
            if self._closed:
                raise RuntimeError("the reader is closed")
            if k + 1 > self._consumed + self._window:
                self._consumed = k + 1 - self._window
                self._cv.notify_all()
            if k < self._next and k not in self._done and k not in self._busy:
                raise IndexError(f"image {k} was taken already")
            self._cv.wait_for(lambda: k in self._done)
            arr, err = self._done.pop(k)
            if k + 1 > self._consumed:
                self._consumed = k + 1
                self._cv.notify_all()
        if err is not None:
            raise RuntimeError(f"cannot decode {self._paths[k]}: {err}") from err
        return arr

    def close(self):
        with self._cv:
            self._closed = True
            self._done.clear()
            self._cv.notify_all()
        for t in self._threads:
            t.join()


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
        self.reader: Optional[_PrefetchReader] = None   # frames()' last

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

    def frames(self, first: int = 0, last: Optional[int] = None, *,
               n_threads: int = 2, window: int = 16) -> Iterator[Frame]:
        """Iterate the range's frames, decoded ahead by `n_threads` worker
        threads at most `window` images (colour and depth count one each)
        ahead of the caller; `n_threads=0` decodes synchronously. The reader
        is closed, its threads joined, when the iteration ends, breaks or
        raises; `self.reader` keeps it for its counters."""
        specs = self._frame_specs(first, last)
        paths, convert = [], []
        depth = functools.partial(_depth_from_raw, unit=self.unit)
        for _, _, cp, dp in specs:
            paths += [cp, dp]
            convert += [_color_from_raw, depth]
        self.reader = reader = _PrefetchReader(paths, n_threads, window, convert)
        try:
            for k, (i, ts, _, _) in enumerate(specs):
                yield Frame(color=reader.get(2 * k), depth=reader.get(2 * k + 1),
                            timestamp=ts, index=i)
        finally:
            reader.close()

    def load_keyframe(self, index: int) -> Optional[Frame]:
        return None

    def load_color_at(self, index: int) -> Optional[np.ndarray]:
        """Random-access reload of one frame's colour image, so PhotoBA
        keeps frame INDICES for its keyframe candidates and decodes only
        the <= --key-frame sampled images right before BA."""
        return None


def timed(frames: Iterator[Frame]):
    """Yield (frame, t_ask, t_got) for each frame of `frames`: the host
    clock (`time.perf_counter`) when the loop asked for the frame and when
    it held it. Closes `frames` when the loop ends, breaks or raises."""
    with contextlib.closing(frames):
        while True:
            t_ask = time.perf_counter()
            frame = next(frames, None)
            if frame is None:
                return
            yield frame, t_ask, time.perf_counter()


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
