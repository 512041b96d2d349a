"""Robust loss functions (reference `ps_optimizer/loss.h:41-48`).

Port of `gradient_sdf_tpu/models/loss.py`. The reference declares {L2,
CAUCHY, HUBER, TUKEY, TRUNC_L2} but its solvers only branch on TRUNC_L2
(PhotometricOptimizer.cpp:364-365); every other value behaves as plain L2.
The enum is kept for config parity, with the actual weight functions should
a robustified solver be wanted (`weight(r, loss, scale)` returns the IRLS
weight).
"""

from __future__ import annotations

import enum

import torch


class LossFunction(str, enum.Enum):
    L2 = "l2"
    CAUCHY = "cauchy"
    HUBER = "huber"
    TUKEY = "tukey"
    TRUNC_L2 = "trunc_l2"


def weight(r: torch.Tensor, loss: LossFunction, scale: float = 1.0):
    """IRLS weight w(r) such that the robust normal equations use w * r."""
    a = torch.abs(r) / scale
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    if loss == LossFunction.L2:
        return one
    if loss == LossFunction.CAUCHY:
        # listed for parity: the reference never applies it (see the doc)
        return 1.0 / (1.0 + a * a)
    if loss == LossFunction.HUBER:
        return torch.where(a <= 1.0, one, 1.0 / torch.clamp(a, min=1e-12))
    if loss == LossFunction.TUKEY:
        return torch.where(a <= 1.0, (1.0 - a * a) ** 2, zero)
    if loss == LossFunction.TRUNC_L2:
        return torch.where(a <= 1.0, one, zero)
    raise ValueError(loss)
