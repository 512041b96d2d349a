"""merge_clear: fold fusion's summed frame rows into the running voxel
state, block by block.

Per voxel, with (w, wd, wn_x, wn_y, wn_z) the first floats of its source
row (`MapGradPixelSdf.cpp:108-116`):

    W' = W + w;  d' = (d W + wd) / max(W', 1e-30) where W' > 0, else d;
    g' = g + wn                        (skipped when `with_grad` is False)

The JAX package leaves this to XLA: the mesh's compact path scatters the
world-summed rows into a dense shard buffer and merges the whole shard
(`gradient_sdf_tpu/parallel/sharding.py:244-288`), one device merges
densely (`gradient_sdf_tpu/ops/fusion.py`, `_merge_accumulators`); it has
no TPU kernel. Here both are modes of the hand-written kernel of
`csrc/merge_clear.cu` (see the note there), one CTA a block:

  * `merge_touched` (the mesh's sharded fusion, `parallel/sharding.py`):
    the world-summed rows `red` [rows, 5] read in place, for the frame's
    touched block slots `tidx` that the rank's shard [lo, lo + m) holds.
    The ownership filter runs on the device: the wrapper reads neither the
    list nor any count, and makes no host sync.
  * `merge_clear` (`fusion._merge_accumulators`): a map's accumulator
    [nvox, 8] over the allocated slots [0, num_active), `num_active` read
    on the device, and the rows zeroed after the merge. Restricting it to
    the allocated slots is exact: slots are handed out contiguously from 0
    (`voxel_grid.insert_new`), and an unallocated slot has W = 0 and an
    all-zero accumulator row, for which the formula is the identity.

One card's fusion merges inside `fuse_integrate`'s second launch instead,
with the same arithmetic over the blocks the frame touched. On a CUDA
tensor a wrapper launches the kernel or raises; on a CPU tensor it takes
its plain version (`merge_touched_reference`, `merge_clear_reference`),
with the same operations, so the two agree bit for bit. All tensors are
updated IN PLACE. Both wrappers count their launches in `launch_count`.
"""

from __future__ import annotations

import torch

from .scatter_add import ACC_ROW

# the columns of a summed row: w, w * sdf, w * R n
RED_ROW = 5

# kernel launches since the last reset_launch_count(); the CPU path and the
# references do not count
launch_count = 0


def reset_launch_count():
    global launch_count
    launch_count = 0


def _check_fields(weight, fields, *others):
    for a in others + tuple(fields):
        if a.device != weight.device or not a.is_contiguous():
            raise ValueError("all tensors must be contiguous, on one device")
    for a in fields:
        if a.shape != weight.shape or a.dtype != torch.float32:
            raise ValueError(
                f"fields must be float32 {tuple(weight.shape)}, got {a.dtype} "
                f"{tuple(a.shape)}")


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
    _check_fields(weight, fields, acc, num_active)


def _merged(w_old, d_old, w, wd):
    """(W', d') of the module note, in the kernel's order of operations."""
    w_new = w_old + w
    d_new = torch.where(w_new > 0.0,
                        (d_old * w_old + wd) / torch.clamp(w_new, min=1e-30),
                        d_old)
    return w_new, d_new


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
    w_new, d_new = _merged(w_old, d_old, a[:, 0].reshape(shape),
                           a[:, 1].reshape(shape))
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


def merge_touched_reference(red, tidx, lo: int, weight, dist, grad_x, grad_y,
                            grad_z, *, full: bool = False,
                            with_grad: bool = True):
    """Plain PyTorch version of `merge_touched`: the same list, window and
    source indexing, with a boolean mask (a `nonzero`) for the ownership
    filter."""
    m, vpb = weight.shape
    own = torch.nonzero((tidx >= lo) & (tidx < lo + m)).reshape(-1)
    slots = tidx[own] - lo
    a = red.view(-1, vpb, RED_ROW)[tidx[own] if full else own]
    w_new, d_new = _merged(weight[slots], dist[slots], a[..., 0], a[..., 1])
    weight[slots] = w_new
    dist[slots] = d_new
    if with_grad:
        for k, g in enumerate((grad_x, grad_y, grad_z)):
            g[slots] = g[slots] + a[..., 2 + k]


def merge_touched(red: torch.Tensor, tidx: torch.Tensor, lo: int,
                  weight: torch.Tensor, dist: torch.Tensor,
                  grad_x: torch.Tensor, grad_y: torch.Tensor,
                  grad_z: torch.Tensor, *, full: bool = False,
                  with_grad: bool = True):
    """Merge the summed rows `red` (f32 [rows, 5]) of the touched block
    slots `tidx` (int64 [n], ascending, on the fields' device) that this
    shard holds into its SoA fields (f32 [m, B^3] each: the slots
    [lo, lo + m)). Block tidx[i]'s rows are red[i B^3 : (i + 1) B^3] (the
    compact path: rows >= n B^3), or red[tidx[i] B^3 : ...] with `full`
    (sums over every slot: rows >= (lo + m) B^3). The fields are updated
    in place; `red` and `tidx` are only read. On CUDA the kernel launches
    on the current stream without synchronizing; an empty list launches
    nothing."""
    fields = (weight, dist, grad_x, grad_y, grad_z)
    m, vpb = weight.shape
    n = tidx.shape[0]
    need = (lo + m if full else n) * vpb
    if (red.dim() != 2 or red.shape[1] != RED_ROW or red.shape[0] < need
            or red.dtype != torch.float32):
        raise ValueError(f"red must be float32 [>= {need}, {RED_ROW}], got "
                         f"{red.dtype} {tuple(red.shape)}")
    if tidx.dim() != 1 or tidx.dtype != torch.int64:
        raise TypeError(f"tidx must be int64 [n], got {tidx.dtype} "
                        f"{tuple(tidx.shape)}")
    _check_fields(weight, fields, red, tidx)
    if weight.device.type == "cpu":
        merge_touched_reference(red, tidx, lo, *fields, full=full,
                                with_grad=with_grad)
        return
    if weight.device.type != "cuda":
        raise RuntimeError(f"merge_touched: no kernel for {weight.device}")
    from . import _build

    lib = _build.load()
    if n == 0 or weight.numel() == 0:
        return
    global launch_count
    with torch.cuda.device(weight.device):
        stream = torch.cuda.current_stream(weight.device).cuda_stream
        rc = lib.gsdf_merge_touched_f32(
            red.data_ptr(), tidx.data_ptr(), n, lo, m, int(not full),
            *(f.data_ptr() for f in fields), vpb, int(with_grad), stream)
    if rc != 0:
        raise RuntimeError(
            f"merge_touched kernel launch failed: CUDA error {rc}")
    launch_count += 1
