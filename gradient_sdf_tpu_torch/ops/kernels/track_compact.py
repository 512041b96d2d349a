"""track_compact: a depth frame's tracking points, compacted on the card.

The tracker backprojects the depth image at stride `TrackerConfig.sampling`
(pixel (u, v) with depth z -> ((u - cx) / fx z, (v - cy) / fy z, z)) and
keeps the pixels with z_min < z < z_max, in row-major pixel order. The JAX
package does this in `gradient_sdf_tpu/models/tracker.py::backproject_grid`
(:162) and the z-gate of its `track_frame` (:194), fused by XLA; it has no
TPU kernel. The plain PyTorch form, `pts_cam[mask]`
(`models/tracker.compact_points`), makes the host wait for the number of
kept pixels before the gather: one host sync a frame.

On the card it is the hand-written CUDA of `csrc/track_compact.cu` (see the
note there: a CTA a tile of up to 4 whole strided rows, 120 tiles a VGA
frame, a single-pass scan with decoupled look-back that resolves in one read
of 128 status words for up to 129 tiles, the points written in 16-byte
stores, in pixel order): the points go into a buffer allocated once per
camera and map (`new_buffer`, with the scan's status words) and their
number into device memory, where the GN loop kernel reads it
(`gn_track.gn_track(..., count=)`). On a CUDA tensor the wrapper launches
that kernel or raises; on a CPU tensor it takes the plain version,
`track_compact_reference`, which writes `pts_cam[mask]` into the same
buffer.

The divisions by fx and fy are true IEEE divisions on every device
(`backproject`), as the JAX package computes them when eager, and the
kernel repeats them: its points are the plain version's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

# kernel launches since the last reset_launch_count(); the CPU path and the
# reference do not count
launch_count = 0


def reset_launch_count():
    global launch_count
    launch_count = 0


# a CTA of the kernel takes min(TILE_ROWS, TILE_CAPACITY // cols) whole
# strided rows of `cols` pixels (csrc/track_compact.cu's kTileRows and
# kCapacity)
TILE_ROWS = 4
TILE_CAPACITY = 3072
# the kernel's epochs lie in [1, EPOCHS]
EPOCHS = 2**30 - 1


def strided_shape(shape, sampling: int) -> tuple:
    """(rows, cols) of the pixels a stride of `sampling` keeps."""
    H, W = shape
    return -(-H // sampling), -(-W // sampling)


def tile_count(shape, sampling: int) -> int:
    """The kernel's tiles (CTAs, status words) for frames of `shape` (H,
    W) at `sampling`."""
    rows, cols = strided_shape(shape, sampling)
    per_tile = max(1, min(TILE_ROWS, TILE_CAPACITY // cols))
    return -(-rows // per_tile)


class CompactBuffer:
    """Room for every strided pixel's point and the kept count, with the
    kernel's scratch: one status word a tile (zero when allocated), the
    tile counter (zero between launches) and the number of launches made,
    from which each launch takes a new epoch."""

    def __init__(self, shape, sampling: int, device):
        rows, cols = strided_shape(shape, sampling)
        n = rows * cols
        self.shape, self.sampling = tuple(shape), int(sampling)
        self.pts = torch.empty((n, 3), dtype=torch.float32, device=device)
        self.count = torch.zeros(1, dtype=torch.int32, device=device)
        self.status = torch.zeros(tile_count(shape, sampling),
                                  dtype=torch.int64, device=device)
        self.next_tile = torch.zeros(1, dtype=torch.int32, device=device)
        self.launches = 0


def new_buffer(shape, sampling: int, device) -> CompactBuffer:
    """A buffer for frames of `shape` (H, W) at stride `sampling`."""
    return CompactBuffer(shape, sampling, device)


def fits(buf, shape, sampling: int, device) -> bool:
    """Whether `buf` takes frames of `shape` at `sampling` on `device`."""
    return (buf is not None and buf.shape == tuple(shape)
            and buf.sampling == sampling and buf.pts.device == device)


def _intrinsics(K):
    K = np.asarray(K, np.float32)
    return float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])


def backproject(depth: torch.Tensor, K, sampling: int = 1):
    """Depth image -> camera-frame points [N, 3] + depth [N] of the pixels
    at stride `sampling`, row-major. x0 = (u - cx) / fx is a true division
    on every device (a CUDA tensor divided by a Python number would be
    multiplied by its reciprocal instead)."""
    H, W = depth.shape
    fx, fy, cx, cy = _intrinsics(K)
    dev = depth.device
    ys = torch.arange(0, H, sampling, dtype=torch.float32, device=dev)
    xs = torch.arange(0, W, sampling, dtype=torch.float32, device=dev)
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    z = depth[::sampling, ::sampling]
    x0 = (xg - cx) / torch.full_like(xg, fx)
    y0 = (yg - cy) / torch.full_like(yg, fy)
    pts = torch.stack([x0 * z, y0 * z, z], dim=-1).reshape(-1, 3)
    return pts, z.reshape(-1)


def compact(depth: torch.Tensor, K, z_min: float, z_max: float,
            sampling: int = 1) -> torch.Tensor:
    """The kept pixels' points [N, 3] in row-major pixel order:
    `pts_cam[mask]`, whose `nonzero` makes the host wait on the card."""
    pts_cam, z = backproject(depth, K, sampling)
    return pts_cam[(z > z_min) & (z < z_max)]


def track_compact_reference(depth: torch.Tensor, K, z_min: float,
                            z_max: float, buf: CompactBuffer):
    """Plain version: `compact` (one host sync on the card) written into
    the first rows of `buf.pts`, its length into `buf.count`. Returns
    (buf.pts, buf.count)."""
    kept = compact(depth, K, z_min, z_max, buf.sampling)
    buf.pts[:kept.shape[0]] = kept
    buf.count.fill_(kept.shape[0])
    return buf.pts, buf.count


def track_compact(depth: torch.Tensor, K, z_min: float, z_max: float,
                  sampling: int = 1, buf: CompactBuffer = None):
    """The kept pixels' camera-frame points of the depth frame `depth` (f32
    [H, W]) at stride `sampling`, in row-major pixel order, into `buf`
    (`new_buffer`; one is allocated if None): returns (points f32 [cap, 3],
    count int32 [1]), the first `count` rows being the points. On CUDA the
    kernel launches on the current stream without synchronizing, and the
    count stays on the device."""
    dev = depth.device
    if buf is None:
        buf = new_buffer(depth.shape, sampling, dev)
    if not fits(buf, depth.shape, sampling, dev):
        raise ValueError(f"the buffer takes {buf.shape} frames at stride "
                         f"{buf.sampling} on {buf.pts.device}, not "
                         f"{tuple(depth.shape)} at {sampling} on {dev}")
    if depth.dtype != torch.float32 or depth.dim() != 2:
        raise ValueError(f"depth must be float32 [H, W], got {depth.dtype} "
                         f"{tuple(depth.shape)}")
    if dev.type == "cpu":
        return track_compact_reference(depth, K, z_min, z_max, buf)
    if dev.type != "cuda":
        raise RuntimeError(f"track_compact: no kernel for {dev}")
    from . import _build

    lib = _build.load()
    depth = depth.contiguous()
    H, W = depth.shape
    if lib.gsdf_track_compact_tiles(H, W, sampling) != buf.status.numel():
        raise RuntimeError(f"the kernel takes {H} x {W} frames at stride "
                           f"{sampling} in "
                           f"{lib.gsdf_track_compact_tiles(H, W, sampling)} "
                           f"tiles, not tile_count's {buf.status.numel()}")
    fx, fy, cx, cy = _intrinsics(K)
    global launch_count
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gsdf_track_compact_f32(
            depth.data_ptr(), H, W, sampling, fx, fy, cx, cy, z_min, z_max,
            buf.pts.data_ptr(), buf.count.data_ptr(), buf.status.data_ptr(),
            buf.next_tile.data_ptr(), buf.launches % EPOCHS + 1, stream)
    if rc != 0:
        raise RuntimeError(f"track_compact kernel launch failed: CUDA error {rc}")
    buf.launches += 1
    launch_count += 1
    return buf.pts, buf.count
