"""Multi-field scatter-add: the port's counterpart of the Pallas kernels in
`gradient_sdf_tpu/ops/pallas/scatter_add.py` (`scatter_add_multi`, and
`scatter_add_rows` as its F = 1 case).

On a CUDA tensor the wrapper launches the hand-written kernel of
`csrc/scatter_add.cu` (one thread per sample, F float atomics each; see the
note there for what bounds it) or raises; it never falls back. On a CPU
tensor it takes the plain PyTorch version, `scatter_add_multi_reference`,
which is also what the card's kernel is checked against.

The TPU kernel's lane-packed [rows, 128] accumulator was a VMEM layout and
is not ported: the accumulator is a plain row-major [out_size, F] f32
tensor, and `unpack_multi` is the identity kept for API parity.
"""

from __future__ import annotations

import torch

MAX_FIELDS = 5  # fusion's (w, wd, wn_x, wn_y, wn_z)

# kernel launches since the last reset_launch_count(); the CPU path and the
# reference do not count
launch_count = 0


def reset_launch_count():
    global launch_count
    launch_count = 0


def _check(idx, vals, out_size, acc):
    if idx.dim() != 1 or vals.dim() != 2 or vals.shape[0] != idx.shape[0]:
        raise ValueError(
            f"want idx [N] and vals [N, F], got {tuple(idx.shape)} and "
            f"{tuple(vals.shape)}")
    if idx.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError(
            f"want int32 idx and float32 vals, got {idx.dtype}, {vals.dtype}")
    if idx.device != vals.device:
        raise ValueError(f"idx on {idx.device}, vals on {vals.device}")
    if not (idx.is_contiguous() and vals.is_contiguous()):
        raise ValueError("idx and vals must be contiguous")
    if not 1 <= vals.shape[1] <= MAX_FIELDS:
        raise ValueError(f"F = {vals.shape[1]} fields, want 1..{MAX_FIELDS}")
    if out_size < 0 or out_size >= 2**31:
        raise ValueError(f"out_size {out_size} outside [0, 2^31)")
    if acc is not None:
        if acc.shape != (out_size, vals.shape[1]) or acc.dtype != torch.float32:
            raise ValueError(
                f"acc must be float32 [{out_size}, {vals.shape[1]}], got "
                f"{acc.dtype} {tuple(acc.shape)}")
        if acc.device != idx.device or not acc.is_contiguous():
            raise ValueError("acc must be contiguous and on idx's device")


def scatter_add_multi_reference(idx: torch.Tensor, vals: torch.Tensor,
                                out_size: int, *, acc=None) -> torch.Tensor:
    """Plain PyTorch version: `index_add_` of the in-range samples (torch
    has no `mode="drop"`, so out-of-range indices are masked out first).
    Updates `acc` in place when given, like the kernel."""
    out = acc if acc is not None else vals.new_zeros((out_size, vals.shape[1]))
    keep = (idx >= 0) & (idx < out_size)
    out.index_add_(0, idx[keep].long(), vals[keep])
    return out


def scatter_add_multi(idx: torch.Tensor, vals: torch.Tensor, out_size: int,
                      *, acc=None) -> torch.Tensor:
    """Multi-field scatter-add in one pass: out[idx[j], f] += vals[j, f].

    idx int32 [N], vals f32 [N, F] with 1 <= F <= 5 (fusion uses 5, or 2
    without gradients).
    Indices outside [0, out_size) are dropped. `acc` (f32 [out_size, F]),
    when given, is the carry-in and is UPDATED IN PLACE and returned;
    otherwise a zeroed [out_size, F] tensor is allocated. On CUDA the kernel
    launches on the current stream without synchronizing."""
    _check(idx, vals, out_size, acc)
    if idx.device.type == "cpu":
        return scatter_add_multi_reference(idx, vals, out_size, acc=acc)
    if idx.device.type != "cuda":
        raise RuntimeError(f"scatter_add_multi: no kernel for {idx.device}")
    from . import _build

    lib = _build.load()
    out = acc if acc is not None else vals.new_zeros((out_size, vals.shape[1]))
    n = idx.shape[0]
    if n == 0:
        return out
    global launch_count
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        rc = lib.gsdf_scatter_add_f32(
            idx.data_ptr(), vals.data_ptr(), out.data_ptr(), n, out_size,
            vals.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"scatter_add kernel launch failed: CUDA error {rc}")
    launch_count += 1
    return out


def unpack_multi(packed: torch.Tensor, out_size: int, f: int) -> torch.Tensor:
    """Identity on the port's [out_size, F] accumulator (the TPU kernel's
    lane-packed layout does not exist here); kept for API parity."""
    return packed[:out_size, :f]


def scatter_add_rows(idx: torch.Tensor, val: torch.Tensor,
                     out_size: int) -> torch.Tensor:
    """out[idx[j]] += val[j] into a zeroed f32 [out_size]; indices outside
    [0, out_size) are dropped. The F = 1 call of `scatter_add_multi`."""
    return scatter_add_multi(idx, val.reshape(-1, 1), out_size)[:, 0]


def scatter_add_rows_reference(idx: torch.Tensor, val: torch.Tensor,
                               out_size: int) -> torch.Tensor:
    """Plain PyTorch version of `scatter_add_rows`."""
    return scatter_add_multi_reference(idx, val.reshape(-1, 1), out_size)[:, 0]
