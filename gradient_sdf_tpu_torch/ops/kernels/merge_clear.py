"""merge_clear: fold fusion's frame accumulator into the running voxel state
and zero the accumulator, over the allocated block slots only.

Per voxel, with (w, wd, wn_x, wn_y, wn_z) the first floats of its
accumulator row (`MapGradPixelSdf.cpp:108-116`):

    W' = W + w;  d' = (d W + wd) / max(W', 1e-30) where W' > 0, else d;
    g' = g + wn                        (skipped when `with_grad` is False)

The JAX package leaves this to XLA as one fused dense pass over every
voxel (`gradient_sdf_tpu/ops/fusion.py`, `_merge_accumulators` and the
fresh accumulator of `_zero_accs`); it has no TPU kernel. On the card the
dense form was the most expensive part of fusing a frame, so here it is
the hand-written kernel of `csrc/merge_clear.cu` (see the note there),
which reads `num_active` on the device and touches only the rows of the
block slots [0, num_active). On a CUDA tensor the wrapper launches that
kernel or raises; on a CPU tensor it takes `merge_clear_reference`. The
mesh's sharded fusion (`parallel/sharding.py`) merges each rank's shard
with it; one card's fusion merges inside `fuse_integrate`'s second launch
instead, with the same arithmetic over the blocks the frame touched.

Restricting the merge to the allocated slots is exact: slots are handed
out contiguously from 0 (`voxel_grid.insert_new`), and an unallocated slot
has W = 0 and an all-zero accumulator row, for which the formula is the
identity. All tensors are updated IN PLACE.
"""

from __future__ import annotations

import torch

from .scatter_add import ACC_ROW

# kernel launches since the last reset_launch_count(); the CPU path and the
# reference do not count
launch_count = 0


def reset_launch_count():
    global launch_count
    launch_count = 0


def _check(acc, weight, fields, num_active):
    nb, vpb = weight.shape
    if acc.shape != (nb * vpb, ACC_ROW) or acc.dtype != torch.float32:
        raise ValueError(
            f"acc must be float32 [{nb * vpb}, {ACC_ROW}], got {acc.dtype} "
            f"{tuple(acc.shape)}")
    if num_active.dtype != torch.int32 or num_active.numel() != 1:
        raise TypeError(
            f"num_active must be one int32, got {num_active.dtype} "
            f"{tuple(num_active.shape)}")
    for a in (acc, num_active) + tuple(fields):
        if a.device != weight.device or not a.is_contiguous():
            raise ValueError("all tensors must be contiguous, on one device")
    for a in fields:
        if a.shape != weight.shape or a.dtype != torch.float32:
            raise ValueError(
                f"fields must be float32 {tuple(weight.shape)}, got {a.dtype} "
                f"{tuple(a.shape)}")


def merge_clear_reference(acc, weight, dist, grad_x, grad_y, grad_z,
                          num_active, *, with_grad: bool = True,
                          dense: bool = False):
    """Plain PyTorch version. Merges and clears the rows of the block slots
    [0, num_active) (reading `num_active` on the host), or of every slot
    with `dense=True`; the two give the same bits (see the module note)."""
    slots = weight.shape[0] if dense else int(num_active)
    rows = slots * weight.shape[1]
    a = acc[:rows]
    w_old, d_old = weight[:slots], dist[:slots]
    shape = w_old.shape
    w_new = w_old + a[:, 0].reshape(shape)
    d_new = torch.where(
        w_new > 0.0,
        (d_old * w_old + a[:, 1].reshape(shape)) / torch.clamp(w_new, min=1e-30),
        d_old,
    )
    d_old.copy_(d_new)
    w_old.copy_(w_new)
    if with_grad:
        grad_x[:slots].add_(a[:, 2].reshape(shape))
        grad_y[:slots].add_(a[:, 3].reshape(shape))
        grad_z[:slots].add_(a[:, 4].reshape(shape))
    a.zero_()


def merge_clear(acc: torch.Tensor, weight: torch.Tensor, dist: torch.Tensor,
                grad_x: torch.Tensor, grad_y: torch.Tensor,
                grad_z: torch.Tensor, num_active: torch.Tensor, *,
                with_grad: bool = True):
    """Merge the accumulator `acc` (f32 [num_blocks * B^3, 8]) into the SoA
    fields (f32 [num_blocks, B^3] each) and zero it, over the block slots
    [0, num_active); `num_active` is an int32 scalar tensor, read on the
    device. Everything is updated in place; nothing is returned. On CUDA the
    kernel launches on the current stream without synchronizing."""
    fields = (weight, dist, grad_x, grad_y, grad_z)
    _check(acc, weight, fields, num_active)
    if weight.device.type == "cpu":
        merge_clear_reference(acc, *fields, num_active, with_grad=with_grad)
        return
    if weight.device.type != "cuda":
        raise RuntimeError(f"merge_clear: no kernel for {weight.device}")
    from . import _build

    lib = _build.load()
    if acc.data_ptr() % 32:
        raise ValueError("acc must be 32-byte aligned")
    if weight.numel() == 0:
        return
    global launch_count
    with torch.cuda.device(weight.device):
        stream = torch.cuda.current_stream(weight.device).cuda_stream
        rc = lib.gsdf_merge_clear_f32(
            acc.data_ptr(), *(f.data_ptr() for f in fields),
            num_active.data_ptr(), weight.shape[0], weight.shape[1],
            int(with_grad), stream)
    if rc != 0:
        raise RuntimeError(f"merge_clear kernel launch failed: CUDA error {rc}")
    launch_count += 1
