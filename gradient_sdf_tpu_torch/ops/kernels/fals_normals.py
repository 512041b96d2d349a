"""fals_normals: a depth frame's FALS unit normals, in one launch on the card.

Per pixel, with the camera cache of `ops/normals.build_cache`: z_inv = 1 /
depth where depth != 0, else 0; b = the window x window box sums
(reflect-101 border) of (x0 / |h|^2, y0 / |h|^2, 1 / |h|^2) z_inv, taken in
float64 and rounded to float32; n = Q b with the cache's packed inverse Q,
normalized. A window without depth gives NaN (0 / 0), which fusion's gates
drop.

The JAX package computes this in `gradient_sdf_tpu/ops/normals.py::
compute_normals` as XLA-fused passes around banded matrix products; it has
no TPU kernel. On the card it is the hand-written CUDA of
`csrc/fals_normals.cu` (see the note there: one CTA a 64 x 16 tile, 300
CTAs a VGA frame in one wave, the halo in shared memory converted to
float64 once, separable running float64 sums, built without fused
multiply-adds so that its normals are the plain version's bit for bit): on
a CUDA tensor the wrapper launches that kernel or raises; on a CPU tensor
it takes the plain version, `ops/normals.compute_normals` (and
`window_sums` for b), which `fals_normals_reference` returns on any device.
"""

from __future__ import annotations

import torch

from .. import normals as nrm

# kernel launches since the last reset_launch_count(); the CPU path and the
# reference do not count
launch_count = 0


def reset_launch_count():
    global launch_count
    launch_count = 0


def fals_normals_reference(cache: nrm.NormalEstimatorCache,
                           depth: torch.Tensor):
    """Plain version: (unit normals f32 [H, W, 3], b f32 [3, H, W])."""
    b = nrm.window_sums(cache, depth)
    return nrm.normals_of_sums(cache, b), b


def _check(cache, depth):
    H, W = depth.shape
    r = cache.window // 2
    if cache.window < 1 or cache.window % 2 == 0 or r >= H or r >= W:
        raise ValueError(f"window {cache.window} must be odd with window // 2 "
                         f"below the image's {H} x {W}")
    for name, a, shape in (("depth", depth, (H, W)),
                           ("x0_n_sq_inv", cache.x0_n_sq_inv, (H, W)),
                           ("y0_n_sq_inv", cache.y0_n_sq_inv, (H, W)),
                           ("n_sq_inv", cache.n_sq_inv, (H, W)),
                           ("Q", cache.Q, (H, W, 6))):
        if (a.dtype != torch.float32 or tuple(a.shape) != shape
                or a.device != depth.device or not a.is_contiguous()):
            raise ValueError(
                f"{name} must be contiguous float32 {shape} on {depth.device},"
                f" got {a.dtype} {tuple(a.shape)} on {a.device}")


def fals_normals(cache: nrm.NormalEstimatorCache, depth: torch.Tensor, *,
                 with_sums: bool = False):
    """Unit normals f32 [H, W, 3] of the depth frame `depth` (f32 [H, W],
    on the cache's device); with `with_sums`, (normals, b f32 [3, H, W]).
    On CUDA the kernel launches on the current stream without
    synchronizing."""
    _check(cache, depth)
    if depth.device.type == "cpu":
        if with_sums:
            return fals_normals_reference(cache, depth)
        return nrm.compute_normals(cache, depth)
    if depth.device.type != "cuda":
        raise RuntimeError(f"fals_normals: no kernel for {depth.device}")
    from . import _build

    lib = _build.load()
    H, W = depth.shape
    out = torch.empty((H, W, 3), dtype=torch.float32, device=depth.device)
    b = (torch.empty((3, H, W), dtype=torch.float32, device=depth.device)
         if with_sums else None)
    global launch_count
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream(depth.device).cuda_stream
        rc = lib.gsdf_fals_normals_f32(
            depth.data_ptr(), cache.x0_n_sq_inv.data_ptr(),
            cache.y0_n_sq_inv.data_ptr(), cache.n_sq_inv.data_ptr(),
            cache.Q.data_ptr(), out.data_ptr(),
            None if b is None else b.data_ptr(), H, W, cache.window, stream)
    if rc != 0:
        raise RuntimeError(f"fals_normals kernel launch failed: CUDA error {rc}")
    launch_count += 1
    return (out, b) if with_sums else out
