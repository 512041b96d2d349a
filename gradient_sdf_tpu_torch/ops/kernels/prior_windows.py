"""prior_windows: the full-resolution march windows of the renderer's two
priors, the stride prior's 3x3 neighbourhood windows and a depth prior's.

For the coarse march's bracket midpoints and hit mask ([hc, wc]) it
computes what `render_depth_normal` computes in
`gradient_sdf_tpu/ops/raycast.py` (:857-880, over `_neighborhood_minmax`
:714-733): per coarse cell the min, max and any-hit of the hits among its
3x3 neighbours (the border counts as "no entry"), the window [min - margin,
max + margin] clamped to [s_min, s_max] where a neighbour hit, and an empty
window (`skip`, the `prior_miss_skip` rule) or the full range where none
did, repeated over the cell's stride x stride pixels. For a depth prior
(:803-820) each pixel's window is +-margin around its prior depth over
inv_hnorm, and a hole (depth 0) is an empty window (`skip`, holes "skip")
or the full range (holes "march"). Either result is clamped to [s_min,
s_max] as `raycast` clamps its windows, so it goes to the march as it is.

The JAX package leaves this to XLA. In eager PyTorch it is ~40 small
launches (`stride_windows_reference`, `depth_prior_windows_reference`, the
plain versions), so on the card each is one launch of a hand-written
kernel of `csrc/prior_windows.cu`, equal to the plain versions bit for
bit. Stride mode: a CTA stages 32 x 8 coarse cells and their halo in
shared memory, forms each cell's window once and writes its pixels as
16-byte rows of four. Depth mode: a thread four pixels, 16-byte loads and
stores. Both are bound by the 8 B a pixel they write; at VGA an empty
launch at their grid is about half of their time. On a CUDA tensor the wrappers launch the kernel
or raise; on a CPU tensor they take the plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

# wrapper calls (either mode) that launched the kernel since the last
# reset_launch_count(); the CPU path does not count
launch_count = 0


def reset_launch_count():
    global launch_count
    launch_count = 0


def neighborhood_minmax(img: torch.Tensor, mask: torch.Tensor):
    """3x3 min/max over `img` counting only masked entries; also returns
    whether any neighbour is masked. The border is padded with "no entry"
    (a wrap would import hit windows from the opposite image border)."""
    h, w = img.shape
    inf = float("inf")
    pad = torch.nn.functional.pad
    big = pad(torch.where(mask, img, inf), (1, 1, 1, 1), value=inf)
    small = pad(torch.where(mask, img, -inf), (1, 1, 1, 1), value=-inf)
    maskp = pad(mask, (1, 1, 1, 1), value=False)
    mn = torch.full_like(img, inf)
    mx = torch.full_like(img, -inf)
    anym = torch.zeros_like(mask)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            mn = torch.minimum(mn, big[dy:dy + h, dx:dx + w])
            mx = torch.maximum(mx, small[dy:dy + h, dx:dx + w])
            anym = anym | maskp[dy:dy + h, dx:dx + w]
    return mn, mx, anym


def _misses(s_min: float, s_max: float, skip: bool):
    """The window of a ray with no range estimate: empty (s_max, s_min - 1)
    when skipped, else the full range."""
    return (s_max, s_min - 1.0) if skip else (s_min, s_max)


def _windows(ok, lo, hi, margin, s_min, s_max, skip):
    """March windows from a range estimate [lo, hi] valid where `ok`;
    elsewhere empty (`skip`) or the full range; then `raycast`'s clamps."""
    miss_lo, miss_hi = _misses(s_min, s_max, skip)
    s_lo = torch.where(ok, torch.clamp(lo - margin, min=s_min), miss_lo)
    s_hi = torch.where(ok, torch.clamp(hi + margin, max=s_max), miss_hi)
    return torch.clamp(s_lo, min=s_min), torch.clamp(s_hi, max=s_max)


def stride_windows_reference(s_mid: torch.Tensor, found: torch.Tensor,
                             hc: int, wc: int, stride: int, margin: float,
                             s_min: float, s_max: float, skip: bool):
    """Plain PyTorch version of `stride_windows`, on any device."""
    _check_stride(s_mid, found, hc, wc, stride)
    mn, mx, anyhit = neighborhood_minmax(s_mid.reshape(hc, wc),
                                         found.reshape(hc, wc))
    lo_c, hi_c = _windows(anyhit, mn, mx, margin, s_min, s_max, skip)

    def fine(a):
        return a.repeat_interleave(stride, 0).repeat_interleave(
            stride, 1).reshape(-1)

    return fine(lo_c), fine(hi_c)


def depth_prior_windows_reference(prior: torch.Tensor, inv_hnorm: torch.Tensor,
                                  margin: float, s_min: float, s_max: float,
                                  skip: bool):
    """Plain PyTorch version of `depth_prior_windows`, on any device."""
    _check_depth(prior, inv_hnorm)
    sp = prior / inv_hnorm
    return _windows(prior > 0, sp, sp, margin, s_min, s_max, skip)


def _check_stride(s_mid, found, hc, wc, stride):
    if stride <= 0 or hc <= 0 or wc <= 0:
        raise ValueError(f"coarse image {wc}x{hc}, stride {stride}: all must "
                         f"be positive")
    if (tuple(s_mid.shape) != (hc * wc,) or s_mid.dtype != torch.float32
            or tuple(found.shape) != (hc * wc,) or found.dtype != torch.bool):
        raise ValueError(f"s_mid must be f32 and found bool, both [{hc * wc}]; "
                         f"got {s_mid.dtype} {tuple(s_mid.shape)}, {found.dtype} "
                         f"{tuple(found.shape)}")
    if found.device != s_mid.device:
        raise ValueError("s_mid and found must be on one device")


def _check_depth(prior, inv_hnorm):
    if (prior.dim() != 1 or prior.dtype != torch.float32
            or inv_hnorm.dtype != torch.float32
            or inv_hnorm.shape != prior.shape):
        raise ValueError(f"prior and inv_hnorm must be f32 [n] alike; got "
                         f"{prior.dtype} {tuple(prior.shape)}, {inv_hnorm.dtype} "
                         f"{tuple(inv_hnorm.shape)}")
    if inv_hnorm.device != prior.device:
        raise ValueError("prior and inv_hnorm must be on one device")


def _launch(depth: bool, val, found, inv_hnorm, width, height, stride, margin,
            s_min, s_max, skip):
    from . import _build

    dev = val.device
    lib = _build.load()
    n = width * height
    if n >= 2**31:
        raise ValueError(f"{n} windows exceed the kernel's int32 index")
    lo = torch.empty(n, dtype=torch.float32, device=dev)
    hi = torch.empty(n, dtype=torch.float32, device=dev)
    # the miss windows as the plain version's torch.where writes them: the
    # Python numbers rounded to float32 once
    miss_lo, miss_hi = (float(np.float32(x)) for x in _misses(s_min, s_max, skip))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gsdf_prior_windows_f32(
            int(depth), val.data_ptr(), found.data_ptr() if found is not None else None,
            inv_hnorm.data_ptr() if inv_hnorm is not None else None, width,
            height, stride, margin, s_min, s_max, miss_lo, miss_hi,
            lo.data_ptr(), hi.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"prior_windows kernel launch failed: CUDA error {rc}")
    global launch_count
    launch_count += 1
    return lo, hi


def _device(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"prior_windows: no kernel for {t.device}")
    return t.device.type


def stride_windows(s_mid: torch.Tensor, found: torch.Tensor, hc: int, wc: int,
                   stride: int, margin: float, s_min: float, s_max: float,
                   skip: bool):
    """(s_lo, s_hi), f32 [hc stride * wc stride] each: the stride prior's
    windows of every full-resolution pixel (row-major) from the coarse
    march's s_mid f32 [hc * wc] and found bool [hc * wc]."""
    if _device(s_mid) == "cpu":
        return stride_windows_reference(s_mid, found, hc, wc, stride, margin,
                                        s_min, s_max, skip)
    _check_stride(s_mid, found, hc, wc, stride)
    return _launch(False, s_mid.contiguous(), found.contiguous(), None,
                   wc * stride, hc * stride, stride, margin, s_min, s_max, skip)


def depth_prior_windows(prior: torch.Tensor, inv_hnorm: torch.Tensor,
                        margin: float, s_min: float, s_max: float, skip: bool):
    """(s_lo, s_hi), f32 [n] each: the windows of a depth prior f32 [n]
    (camera-z, 0 for a hole) for rays with inv_hnorm f32 [n]."""
    if _device(prior) == "cpu":
        return depth_prior_windows_reference(prior, inv_hnorm, margin, s_min,
                                             s_max, skip)
    _check_depth(prior, inv_hnorm)
    return _launch(True, prior.contiguous(), None, inv_hnorm.contiguous(),
                   prior.shape[0], 1, 1, margin, s_min, s_max, skip)
