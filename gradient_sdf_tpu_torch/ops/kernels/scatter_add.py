"""Multi-field scatter-add: the port's counterpart of the Pallas kernels in
`gradient_sdf_tpu/ops/pallas/scatter_add.py` (`scatter_add_multi`, and
`scatter_add_rows` as its F = 1 case).

On a CUDA tensor the wrappers launch the hand-written kernel of
`csrc/scatter_add.cu` (warp-aggregated vector reductions; see the note
there for what bounds it and what the design does about it) or raise; they
never fall back. On a CPU tensor they take the plain PyTorch version,
`scatter_add_multi_reference`, which is also what the card's kernel is
checked against.

The TPU kernel's lane-packed [rows, 128] accumulator was a VMEM layout and
is not ported. The destination is a row-major f32 tensor whose rows may be
wider than F: fusion keeps a persistent [out_size, ACC_ROW] accumulator
(one 32-byte sector per destination) and passes its `[:, :F]` view as
`acc`, which is the layout the kernel's vector reductions need. A
contiguous [out_size, F] destination works too, with scalar reductions.
`unpack_multi` is the identity kept for API parity.

The payload comes either as one [N, F] array (`scatter_add_multi`) or as F
separate [N] arrays (`scatter_add_fields`, which the mesh's fusion uses so
that no [N, F] copy is built); both reach the same kernel. One card's
fusion scatters inside `fuse_integrate`'s second launch instead, with this
kernel's device code (`csrc/warp_scatter.cuh`).
"""

from __future__ import annotations

from typing import Sequence

import torch

MAX_FIELDS = 5  # fusion's (w, wd, wn_x, wn_y, wn_z)
ACC_ROW = 8     # floats per row of fusion's accumulator: one 32-byte sector

# kernel launches since the last reset_launch_count(); the CPU path and the
# reference do not count. `rows_launch_count` counts the F = 1 launches
# among them (`scatter_add_rows`' case).
launch_count = 0
rows_launch_count = 0


def reset_launch_count():
    global launch_count, rows_launch_count
    launch_count = rows_launch_count = 0


def new_accumulator(out_size: int, device) -> torch.Tensor:
    """Zeroed f32 [out_size, ACC_ROW] accumulator; pass `acc[:, :F]` to the
    scatter wrappers."""
    return torch.zeros((out_size, ACC_ROW), dtype=torch.float32, device=device)


def _check_idx_acc(idx, nf, out_size, acc):
    if idx.dim() != 1 or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise TypeError(
            f"want contiguous int32 idx [N], got {idx.dtype} {tuple(idx.shape)}")
    if not 1 <= nf <= MAX_FIELDS:
        raise ValueError(f"F = {nf} fields, want 1..{MAX_FIELDS}")
    if out_size < 0 or out_size >= 2**31:
        raise ValueError(f"out_size {out_size} outside [0, 2^31)")
    if acc is not None:
        if acc.shape != (out_size, nf) or acc.dtype != torch.float32:
            raise ValueError(
                f"acc must be float32 [{out_size}, {nf}], got "
                f"{acc.dtype} {tuple(acc.shape)}")
        if acc.device != idx.device:
            raise ValueError(f"acc on {acc.device}, idx on {idx.device}")
        # rows `row stride` floats apart, fields adjacent: a contiguous
        # tensor, or the [:, :F] view of a wider one
        if ((out_size > 1 and acc.stride(0) < nf)
                or (nf > 1 and acc.stride(1) != 1)):
            raise ValueError(
                f"acc strides {acc.stride()}: want fields adjacent and rows "
                f"at least {nf} floats apart")


def _check(idx, vals, out_size, acc):
    if vals.dim() != 2 or idx.dim() != 1 or vals.shape[0] != idx.shape[0]:
        raise ValueError(
            f"want idx [N] and vals [N, F], got {tuple(idx.shape)} and "
            f"{tuple(vals.shape)}")
    if vals.dtype != torch.float32:
        raise TypeError(f"want float32 vals, got {vals.dtype}")
    if idx.device != vals.device:
        raise ValueError(f"idx on {idx.device}, vals on {vals.device}")
    if not vals.is_contiguous():
        raise ValueError("idx and vals must be contiguous")
    _check_idx_acc(idx, vals.shape[1], out_size, acc)


def _check_fields(idx, fields, out_size, acc):
    for f in fields:
        if f.shape != idx.shape or f.dtype != torch.float32:
            raise ValueError(
                f"want float32 fields of idx's shape {tuple(idx.shape)}, got "
                f"{f.dtype} {tuple(f.shape)}")
        if f.device != idx.device or not f.is_contiguous():
            raise ValueError("fields must be contiguous and on idx's device")
    _check_idx_acc(idx, len(fields), out_size, acc)


def scatter_add_multi_reference(idx: torch.Tensor, vals: torch.Tensor,
                                out_size: int, *, acc=None) -> torch.Tensor:
    """Plain PyTorch version: `index_add_` of the in-range samples (torch
    has no `mode="drop"`, so out-of-range indices are masked out first).
    Updates `acc` in place when given, like the kernel."""
    out = acc if acc is not None else vals.new_zeros((out_size, vals.shape[1]))
    keep = (idx >= 0) & (idx < out_size)
    out.index_add_(0, idx[keep].long(), vals[keep])
    return out


def _require_cuda(idx):
    if idx.device.type != "cuda":
        raise RuntimeError(f"scatter_add: no kernel for {idx.device}")


def _launch(idx, ptrs, sample_stride, out, out_size):
    """Launch the kernel on idx's device and current stream: field f of
    sample j is read at ptrs[f] + 4 * j * sample_stride."""
    from . import _build

    lib = _build.load()
    n, nf = idx.shape[0], len(ptrs)
    if n == 0 or out_size == 0:
        return out
    global launch_count, rows_launch_count
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        rc = lib.gsdf_scatter_add_f32(
            idx.data_ptr(), *ptrs, *([None] * (MAX_FIELDS - nf)), sample_stride,
            out.data_ptr(), out.stride(0) if out_size > 1 else nf, n, out_size,
            nf, stream)
    if rc != 0:
        raise RuntimeError(f"scatter_add kernel launch failed: CUDA error {rc}")
    launch_count += 1
    if nf == 1:
        rows_launch_count += 1
    return out


def scatter_add_multi(idx: torch.Tensor, vals: torch.Tensor, out_size: int,
                      *, acc=None) -> torch.Tensor:
    """Multi-field scatter-add in one pass: out[idx[j], f] += vals[j, f].

    idx int32 [N], vals f32 [N, F] with 1 <= F <= 5 (fusion uses 5, or 2
    without gradients).
    Indices outside [0, out_size) are dropped. `acc` (f32 [out_size, F],
    contiguous or the `[:, :F]` view of a wider row-major tensor), when
    given, is the carry-in and is UPDATED IN PLACE and returned; otherwise a
    zeroed contiguous [out_size, F] tensor is allocated. On CUDA the kernel
    launches on the current stream without synchronizing."""
    _check(idx, vals, out_size, acc)
    if idx.device.type == "cpu":
        return scatter_add_multi_reference(idx, vals, out_size, acc=acc)
    _require_cuda(idx)
    nf = vals.shape[1]
    out = acc if acc is not None else vals.new_zeros((out_size, nf))
    base = vals.data_ptr()
    return _launch(idx, [base + 4 * f for f in range(nf)], nf, out, out_size)


def scatter_add_fields(idx: torch.Tensor, fields: Sequence[torch.Tensor],
                       out_size: int, *, acc=None) -> torch.Tensor:
    """`scatter_add_multi` with the payload as F separate f32 [N] tensors:
    out[idx[j], f] += fields[f][j]. Same kernel, same `acc` rules; on the
    card no [N, F] copy of the payload is built."""
    _check_fields(idx, fields, out_size, acc)
    if idx.device.type == "cpu":
        return scatter_add_multi_reference(
            idx, torch.stack(list(fields), dim=-1), out_size, acc=acc)
    _require_cuda(idx)
    out = acc if acc is not None else idx.new_zeros(
        (out_size, len(fields)), dtype=torch.float32)
    return _launch(idx, [f.data_ptr() for f in fields], 1, out, out_size)


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
