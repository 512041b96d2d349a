"""Small image filters: median blur and bilinear sampling.

Port of `gradient_sdf_tpu/ops/filters.py`: `median_blur`
(cv::medianBlur(depth, 5), `MapGradPixelSdf.cpp:53`), wired behind
`FusionConfig.median_blur_depth`, and `bilinear_sample_grad`, PhotoBA's
image sampler with its analytic gradient
(`PhotometricOptimizer.cpp:57-139`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def median_blur(img: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """Median filter with BORDER_REFLECT_101 (matches cv::medianBlur): the
    k^2 shifted views stacked on a new axis, middle order statistic by
    sort."""
    r = ksize // 2
    h, w = img.shape
    padded = F.pad(img[None, None], (r, r, r, r), mode="reflect")[0, 0]
    stack = torch.stack(
        [padded[dy:dy + h, dx:dx + w]
         for dy in range(ksize) for dx in range(ksize)],
        dim=-1,
    )
    return torch.sort(stack, dim=-1).values[..., (ksize * ksize) // 2]


def bilinear_sample_grad(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Bilinear sample + analytic image gradient (the package's single image
    sampler; PhotoBA's intensity/Jacobian source).

    img: [H, W, C]; u/v: (…,) pixel coords (u = x/col, v = y/row). A stack
    of images [F, H, W, C] takes u/v of shape (F, …): row f samples image f.
    Returns (A (…,C), dAdu (…,C), dAdv (…,C), in_bounds (…,)).

    In-bounds test as in the reference (0 <= u < W, 0 <= v < H,
    `PhotometricOptimizer.cpp:176-178`); out-of-bounds samples clamp to the
    border and callers discard them via the mask. Interior gradients equal
    the reference's bilinearly-weighted forward differences
    (`computeImageGradient`, PhotometricOptimizer.cpp:81-139). The four
    taps are row gathers from the image flattened to [H*W, C].
    """
    H, W, C = img.shape[-3:]
    inb = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    uc = torch.clamp(u, 0.0, W - 1.000001)
    vc = torch.clamp(v, 0.0, H - 1.000001)
    u0f = torch.floor(uc)
    v0f = torch.floor(vc)
    u0 = u0f.long()
    v0 = v0f.long()
    u1 = torch.clamp(u0 + 1, max=W - 1)
    v1 = torch.clamp(v0 + 1, max=H - 1)
    fu = (uc - u0f)[..., None]
    fv = (vc - v0f)[..., None]
    flat = img.reshape(-1, C)
    if img.dim() == 4:  # image f starts at row f * H * W
        base = torch.arange(img.shape[0], device=img.device) * (H * W)
        r0 = v0 * W + base.reshape((-1,) + (1,) * (u.dim() - 1))
        r1 = r0 + (v1 - v0) * W
    else:
        r0, r1 = v0 * W, v1 * W
    i00 = flat[r0 + u0]
    i01 = flat[r0 + u1]
    i10 = flat[r1 + u0]
    i11 = flat[r1 + u1]
    top = i00 + fu * (i01 - i00)
    bot = i10 + fu * (i11 - i10)
    A = top + fv * (bot - top)
    dAdu = (1 - fv) * (i01 - i00) + fv * (i11 - i10)
    dAdv = (1 - fu) * (i10 - i00) + fu * (i11 - i01)
    return A, dAdu, dAdv, inb
