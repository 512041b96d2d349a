"""Small image filters: the median blur fusion uses.

Port of `gradient_sdf_tpu/ops/filters.median_blur` (cv::medianBlur(depth, 5),
`MapGradPixelSdf.cpp:53`), wired behind `FusionConfig.median_blur_depth`.
The PhotoBA bilinear sampler of the JAX module is not ported yet.
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
