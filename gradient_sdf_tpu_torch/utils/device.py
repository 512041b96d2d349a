"""Device selection shared by the package's entry points.

Everything runs on the CUDA card unless the caller names another device;
a missing card is an error, never a silent move to the CPU.
"""

from __future__ import annotations

import torch


def require(device="cuda") -> torch.device:
    """`torch.device(device)`, raising when it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: CUDA is not available (pass --device cpu "
            'on the command line, or device="cpu", to run on the CPU)')
    return dev
