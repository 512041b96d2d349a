"""gn_track: the Gauss-Newton tracking loop of one frame, as one kernel.

One residual pass of the tracker takes every compacted depth point x to p
= R x + t, queries it against the SDF (`mode` "grad": `query.tsdf_grad`,
the nearest voxel plus the stored gradient's correction; "trilinear":
`query.tsdf_trilinear`, counted only where all 8 corners are observed) and
sums the residuals into one float32 vector of 29 (`SUMS`): E = sum phi^2,
g = sum phi J (6), the upper triangle of H = sum J J^T (21, row-major,
`TRIU`) and the count, with J = [grad, p x grad]. One step turns those sums
into xi = damping x solve(H + 1e-12 I, g), small = xi.xi < conv_sq, bad =
any(isnan(xi)), and where neither, (R, t) <- exp(-xi) (R, t).

`gn_track` runs a frame's whole loop, up to `num_iterations` passes and
steps, ending when `small` is set (a NaN step is skipped), with R and t
updated in place and one status vector out (`STATUS`: small, bad, E, count,
iterations): the one read the host makes per frame. On one card its points
are `track_compact`'s buffer, and it reads their number where that kernel
left it, in device memory (`count=`). `gn_residual_reduce`
is one pass's sums (the same kernel with one iteration and no step) and
`gn_step` one step from given sums, in place, with a 4-float status: the
mesh runs those two around its all_reduce (`parallel/sharding.py`).

The JAX package compiles this loop into one jitted `lax.while_loop`
(`gradient_sdf_tpu/models/tracker.py:201-233`); it has no TPU kernel. On
the card it is the hand-written CUDA of `csrc/gn_track.cu` (see the note
there: one thread-block cluster runs the loop, reducing through distributed
shared memory): on a CUDA tensor each wrapper launches its kernel or
raises; on a CPU tensor it takes its plain version, `gn_track_reference`,
`gn_residual_reduce_reference` or `gn_step_reference`.

The plain residual pass computes what `models/tracker._residual_pass`
computes, with two differences that the kernel needs and that change no
formula: p = R x + t is written out elementwise in the kernel's order (a
[N,3] x [3,3] product orders its sums its own way, and a point within an
ulp of a voxel plane would read the other voxel), and the fields are read
from the SoA arrays, never from packed rows. Every residual's voxel, phi
and J are then the kernel's bit for bit (the kernel is built without fused
multiply-adds); only the order of the sums differs. The plain step is the
body of `models/tracker.gauss_newton` (`gn_update` below is that body).

A slot window [slot_lo, slot_hi) restricts the pass to the blocks of those
slots, whose rows the grid's fields then hold (a mesh rank's shard,
`parallel/sharding.py`); by default it is every row of the fields.
"""

from __future__ import annotations

import torch

from ...config import FusionConfig, GridConfig
from ...utils import se3
from .. import voxel_grid as vg

# the 29 sums: E, g (6), H's upper triangle (21, row-major), count
SUMS = 29
TRIU = [(a, b) for a in range(6) for b in range(a, 6)]
# gn_track's status: small, bad (1.0 or 0.0), E and count of the last
# iteration, iterations run
STATUS = 5
MODES = {"grad": 0, "trilinear": 1}
INT32_LIMIT = 2**31

# kernel launches since the last reset_launch_count(): `loop_launch_count`
# of gn_track, `launch_count` of gn_residual_reduce (the one-pass launch),
# `step_launch_count` of gn_step; the CPU path and the plain versions do
# not count
loop_launch_count = 0
launch_count = 0
step_launch_count = 0


def reset_launch_count():
    global loop_launch_count, launch_count, step_launch_count
    loop_launch_count = 0
    launch_count = 0
    step_launch_count = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _divide(a, vs: float):
    """a / vs as an IEEE division on every device (a CUDA tensor divided by
    a Python number is multiplied by the number's reciprocal instead)."""
    return a / torch.tensor(vs, dtype=torch.float32, device=a.device)


def transform_points(pts, R, t):
    """p = R x + t per point, as the kernel computes it: per component
    ((R[i,0] x + R[i,1] y) + R[i,2] z) + t[i], each operation rounded."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    return torch.stack([x * R[i, 0] + y * R[i, 1] + z * R[i, 2] + t[i]
                        for i in range(3)], dim=-1)


def _cross(p, g):
    """p x g, each component a product, a product and a difference."""
    return torch.stack([p[:, 1] * g[:, 2] - p[:, 2] * g[:, 1],
                        p[:, 2] * g[:, 0] - p[:, 0] * g[:, 2],
                        p[:, 0] * g[:, 1] - p[:, 1] * g[:, 0]], dim=-1)


def voxel_rows(grid: vg.VoxelGrid, vi, gcfg: GridConfig, slot_lo: int,
               slot_hi: int):
    """(index into the window's fields, found) of voxels vi (..., 3): found
    where the voxel's block is allocated in a slot of [slot_lo, slot_hi);
    index 0 elsewhere."""
    block, local = vg.voxel_to_block(vi, gcfg)
    slot = vg.lookup_keys(grid, vg.pack_key(block, gcfg), gcfg)
    found = (slot >= 0) & (slot >= slot_lo) & (slot < slot_hi)
    row = torch.where(found, (slot - slot_lo) * gcfg.voxels_per_block + local,
                      torch.zeros_like(slot))
    return row.long(), found


def _window(grid, slot_lo, slot_hi):
    if slot_hi is None:
        slot_hi = slot_lo + grid.dist.shape[0]
    return slot_lo, slot_hi


def gn_residual_terms(pts, R, t, grid: vg.VoxelGrid, gcfg: GridConfig,
                      fcfg: FusionConfig, *, mode: str = "grad",
                      slot_lo: int = 0, slot_hi=None):
    """Per point: (phi [N], J [N, 6], valid [N]), with phi and J zero where
    the residual does not count. The plain version's residuals, before the
    sums."""
    slot_lo, slot_hi = _window(grid, slot_lo, slot_hi)
    vs = gcfg.voxel_size
    p = transform_points(pts, R, t)
    fields = [vg.flat_field(f) for f in (grid.dist, grid.weight, grid.grad_x,
                                         grid.grad_y, grid.grad_z)]
    if mode == "grad":
        # query.tsdf_grad
        vi = torch.round(_divide(p, vs)).to(torch.int32)
        row, valid = voxel_rows(grid, vi, gcfg, slot_lo, slot_hi)
        dist, weight, gx, gy, gz = (f[row] for f in fields)
        valid = valid & (weight > 0.0)
        inv_norm = 1.0 / torch.clamp(torch.sqrt(gx * gx + gy * gy + gz * gz),
                                     min=1e-12)
        s = fcfg.grad_scale * inv_norm
        cmp = vi.to(torch.float32) * vs - p
        phi = dist + s * (gx * cmp[:, 0] + gy * cmp[:, 1] + gz * cmp[:, 2])
        grad = torch.stack([s * gx, s * gy, s * gz], dim=-1)
    elif mode == "trilinear":
        # query.tsdf_trilinear where all 8 corners are observed; the corners
        # summed in meshgrid(indexing="ij") order
        q = _divide(p, vs)
        base = torch.floor(q).to(torch.int32)
        frac = torch.clamp(q - base.to(torch.float32), 0.0, 1.0)
        f = [frac[:, a] for a in range(3)]
        valid = torch.ones(p.shape[0], dtype=torch.bool, device=p.device)
        phi = torch.zeros_like(f[0])
        sg = [torch.zeros_like(f[0]) for _ in range(3)]
        for c in range(8):
            o = ((c >> 2) & 1, (c >> 1) & 1, c & 1)
            off = torch.tensor(o, dtype=torch.int32, device=p.device)
            row, found = voxel_rows(grid, base + off, gcfg, slot_lo, slot_hi)
            d, w = fields[0][row], fields[1][row]
            valid = valid & found & (w > 0.0)
            wx, wy, wz = (f[a] if o[a] else 1.0 - f[a] for a in range(3))
            wxy = wx * wy
            phi = phi + wxy * wz * d
            sg[0] = sg[0] + (wy if o[0] else -wy) * wz * d
            sg[1] = sg[1] + (wx if o[1] else -wx) * wz * d
            sg[2] = sg[2] + (wxy if o[2] else -wxy) * d
        grad = _divide(torch.stack(sg, dim=-1), vs)
    else:
        raise ValueError(f"unknown tracking mode {mode!r}")
    J = torch.cat([grad, _cross(p, grad)], dim=-1)
    phi = torch.where(valid, phi, torch.zeros_like(phi))
    J = torch.where(valid[:, None], J, torch.zeros_like(J))
    return phi, J, valid


def sums_of_terms(phi, J, valid):
    """The 29 sums of per-residual terms (`SUMS`)."""
    a = [i for i, _ in TRIU]
    b = [j for _, j in TRIU]
    return torch.cat([(phi * phi).sum()[None], (phi[:, None] * J).sum(0),
                      (J[:, a] * J[:, b]).sum(0),
                      valid.sum(dtype=torch.float32)[None]])


def gn_residual_reduce_reference(pts, R, t, grid: vg.VoxelGrid,
                                 gcfg: GridConfig, fcfg: FusionConfig, *,
                                 mode: str = "grad", slot_lo: int = 0,
                                 slot_hi=None) -> torch.Tensor:
    """Plain version of `gn_residual_reduce`: f32 [29]."""
    return sums_of_terms(*gn_residual_terms(
        pts, R, t, grid, gcfg, fcfg, mode=mode, slot_lo=slot_lo,
        slot_hi=slot_hi))


def system_of_sums(sums):
    """(E, g [6], H [6, 6], count) from the 29 sums."""
    H = torch.zeros((6, 6), dtype=sums.dtype, device=sums.device)
    a = [i for i, _ in TRIU]
    b = [j for _, j in TRIU]
    H[a, b] = sums[7:28]
    H[b, a] = sums[7:28]
    return sums[0], sums[1:7], H, sums[28]


def gn_update(H, g, R, t, damping: float, conv_sq: float):
    """The body of the GN loop after the residual pass (the JAX loop's
    :213-222): xi = damping solve(H + 1e-12 I, g); small = xi.xi < conv_sq,
    bad = any(isnan(xi)); (R, t) <- exp(-xi) (R, t) unless small or bad.
    The tiny diagonal keeps the solve finite when H is singular (no
    residuals); solve_ex does not raise on a singular H, and a NaN step is
    skipped. Returns (R', t', small, bad), the flags as bool tensors."""
    eye6 = 1e-12 * torch.eye(6, dtype=torch.float32, device=H.device)
    xi = damping * torch.linalg.solve_ex(H + eye6, g)[0]
    small = torch.sum(xi * xi) < conv_sq
    bad = torch.any(torch.isnan(xi))
    dR, dt = se3.se3_exp(-xi)
    Rn, tn = se3.se3_mul(dR, dt, R, t)
    apply = ~small & ~bad
    return (torch.where(apply, Rn, R), torch.where(apply, tn, t), small, bad)


def gn_step_reference(sums, R, t, damping: float, conv_sq: float):
    """Plain version of `gn_step`: (R', t', small, bad) from the 29 sums."""
    _, g, H, _ = system_of_sums(sums)
    return gn_update(H, g, R, t, damping, conv_sq)


def gn_track_reference(pts, R, t, grid: vg.VoxelGrid, gcfg: GridConfig,
                       fcfg: FusionConfig, *, mode: str = "grad",
                       num_iterations: int, damping: float, conv_sq: float):
    """Plain version of `gn_track`: the loop over
    `gn_residual_reduce_reference` and `gn_step_reference`, stopping after
    the iteration whose step is small. Returns (R', t', status f32 [5])."""
    small = bad = torch.zeros((), dtype=torch.bool, device=pts.device)
    sums = torch.zeros(SUMS, dtype=torch.float32, device=pts.device)
    k = 0
    while k < num_iterations:
        sums = gn_residual_reduce_reference(pts, R, t, grid, gcfg, fcfg,
                                            mode=mode)
        R, t, small, bad = gn_step_reference(sums, R, t, damping, conv_sq)
        k += 1
        if bool(small):
            break
    status = torch.stack([small.float(), bad.float(), sums[0], sums[SUMS - 1],
                          torch.tensor(float(k), device=pts.device)])
    return R, t, status


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------




def _check_f32(name, a, shape, dev):
    if (a.dtype != torch.float32 or tuple(a.shape) != tuple(shape)
            or a.device != dev or not a.is_contiguous()):
        raise ValueError(f"{name} must be contiguous float32 {tuple(shape)} on "
                         f"{dev}, got {a.dtype} {tuple(a.shape)} on {a.device}")


def _check_pass(pts, R, t, grid, gcfg, mode, slot_lo, slot_hi):
    """Checks what a residual pass takes; returns (slot_lo, slot_hi)."""
    if mode not in MODES:
        raise ValueError(f"unknown tracking mode {mode!r}")
    dev = pts.device
    slot_lo, slot_hi = _window(grid, slot_lo, slot_hi)
    vpb = gcfg.voxels_per_block
    _check_f32("pts", pts, (pts.shape[0], 3), dev)
    _check_f32("R", R, (3, 3), dev)
    _check_f32("t", t, (3,), dev)
    for f in (grid.dist, grid.weight, grid.grad_x, grid.grad_y, grid.grad_z):
        _check_f32("a field", f, (slot_hi - slot_lo, vpb), dev)
    if (grid.directory.dtype != torch.int32 or grid.directory.device != dev
            or grid.directory.numel() != gcfg.dir_dim**3):
        raise ValueError("directory must be int32 [dir_dim^3] on the points' "
                         "device")
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"gn_track: no kernel for {dev}")
    # keys and field indices are int32 in the kernel
    if dev.type == "cuda" and (
            gcfg.dir_dim**3 >= INT32_LIMIT or slot_hi * vpb >= INT32_LIMIT
            or not 0 <= slot_lo <= slot_hi):
        raise ValueError(f"directory {gcfg.dir_dim}^3 or slots [{slot_lo}, "
                         f"{slot_hi}) x {vpb} voxels do not fit int32")
    return slot_lo, slot_hi


def launch_loop(lib, pts, R, t, grid, gcfg, fcfg, *, mode, slot_lo,
                slot_hi, num_iterations, do_step, damping, conv_sq, status,
                sums, count=None):
    """One launch of `gsdf_gn_track_loop_f32` from `lib` (the package's
    library, or a build of another cluster shape), on the current stream,
    without checks or counting; raises if the launch fails. The scalars go
    to it rounded to float32, as PyTorch rounds a Python number that meets
    a float32 tensor. `count` (int32 [1] on the device, or None): how many
    of the rows of `pts` are points, read by the kernel."""
    dev = pts.device
    fields = (grid.dist, grid.weight, grid.grad_x, grid.grad_y, grid.grad_z)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gsdf_gn_track_loop_f32(
            pts.data_ptr(), pts.shape[0],
            None if count is None else count.data_ptr(), R.data_ptr(),
            t.data_ptr(),
            grid.directory.data_ptr(), *(f.data_ptr() for f in fields),
            None if status is None else status.data_ptr(),
            None if sums is None else sums.data_ptr(), MODES[mode],
            gcfg.dir_dim, gcfg.block_shape, slot_lo, slot_hi, num_iterations,
            int(do_step), gcfg.voxel_size, fcfg.grad_scale, damping, conv_sq,
            stream)
    if rc != 0:
        raise RuntimeError(
            f"gn_track kernel launch failed: CUDA error {rc} (the cluster "
            f"shape is checked at first use: an error there means the card "
            f"cannot place it)")


def gn_track(pts, R, t, grid: vg.VoxelGrid, gcfg: GridConfig,
             fcfg: FusionConfig, *, mode: str = "grad", num_iterations: int,
             damping: float, conv_sq: float, count=None) -> torch.Tensor:
    """A frame's GN loop (module note) over the points `pts` (f32 [N, 3],
    camera frame) from the pose (R f32 [3, 3], t f32 [3]), which is updated
    in place. With `count` (int32 [1] on the points' device, e.g. from
    `track_compact`) only the first `count` rows of `pts` are points; the
    kernel reads it on the device. Returns the status, f32 [5] on the
    points' device: small, bad, E, count, iterations. On CUDA the kernel
    launches on the current stream without synchronizing."""
    if num_iterations < 1:
        raise ValueError(f"num_iterations must be >= 1, got {num_iterations}")
    slot_lo, slot_hi = _check_pass(pts, R, t, grid, gcfg, mode, 0, None)
    dev = pts.device
    if count is not None and (count.dtype != torch.int32
                              or count.numel() != 1 or count.device != dev):
        raise ValueError(f"count must be one int32 on {dev}, got "
                         f"{count.dtype} {tuple(count.shape)} on "
                         f"{count.device}")
    if dev.type == "cpu":
        if count is not None:
            pts = pts[:int(count)]
        Rn, tn, status = gn_track_reference(
            pts, R, t, grid, gcfg, fcfg, mode=mode,
            num_iterations=num_iterations, damping=damping, conv_sq=conv_sq)
        R.copy_(Rn)
        t.copy_(tn)
        return status
    from . import _build

    status = torch.empty(STATUS, dtype=torch.float32, device=dev)
    launch_loop(_build.load(), pts, R, t, grid, gcfg, fcfg, mode=mode,
                slot_lo=slot_lo, slot_hi=slot_hi,
                num_iterations=num_iterations, do_step=True, damping=damping,
                conv_sq=conv_sq, status=status, sums=None, count=count)
    global loop_launch_count
    loop_launch_count += 1
    return status


def gn_residual_reduce(pts, R, t, grid: vg.VoxelGrid, gcfg: GridConfig,
                       fcfg: FusionConfig, *, mode: str = "grad",
                       slot_lo: int = 0, slot_hi=None) -> torch.Tensor:
    """The 29 sums of one residual pass (module note) over the points `pts`
    (f32 [N, 3], camera frame) at the pose (R f32 [3, 3], t f32 [3]), which
    stay on the device: f32 [29] on the points' device. On CUDA it is
    `gn_track`'s kernel launched for one iteration without a step (the same
    threads, points and order of sums as each iteration of the loop), on
    the current stream without synchronizing."""
    slot_lo, slot_hi = _check_pass(pts, R, t, grid, gcfg, mode, slot_lo,
                                   slot_hi)
    dev = pts.device
    if dev.type == "cpu":
        return gn_residual_reduce_reference(
            pts, R, t, grid, gcfg, fcfg, mode=mode, slot_lo=slot_lo,
            slot_hi=slot_hi)
    from . import _build

    sums = torch.empty(SUMS, dtype=torch.float32, device=dev)
    launch_loop(_build.load(), pts, R, t, grid, gcfg, fcfg, mode=mode,
                slot_lo=slot_lo, slot_hi=slot_hi, num_iterations=1,
                do_step=False, damping=0.0, conv_sq=0.0, status=None,
                sums=sums)
    global launch_count
    launch_count += 1
    return sums


def gn_step(sums, R, t, status, *, damping: float, conv_sq: float):
    """One GN step from the 29 sums (module note): R (f32 [3, 3]) and t
    (f32 [3]) are updated in place, `status` (f32 [4]) receives small, bad
    (1.0 or 0.0), E and the count. Nothing is returned. On CUDA the kernel
    launches on the current stream without synchronizing."""
    dev = sums.device
    _check_f32("sums", sums, (SUMS,), dev)
    _check_f32("R", R, (3, 3), dev)
    _check_f32("t", t, (3,), dev)
    _check_f32("status", status, (4,), dev)
    if dev.type == "cpu":
        Rn, tn, small, bad = gn_step_reference(sums, R, t, damping, conv_sq)
        R.copy_(Rn)
        t.copy_(tn)
        status.copy_(torch.stack([small.float(), bad.float(), sums[0],
                                  sums[SUMS - 1]]))
        return
    if dev.type != "cuda":
        raise RuntimeError(f"gn_step: no kernel for {dev}")
    from . import _build

    lib = _build.load()
    global step_launch_count
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gsdf_gn_step_f32(sums.data_ptr(), R.data_ptr(), t.data_ptr(),
                                  status.data_ptr(), damping, conv_sq, stream)
    if rc != 0:
        raise RuntimeError(f"gn_step kernel launch failed: CUDA error {rc}")
    step_launch_count += 1


def cluster_shape(mode: str = "grad") -> tuple:
    """(CTAs, threads a CTA, clusters the card holds at once) of
    `gn_track`'s launch; raises if the card cannot place one."""
    import ctypes

    from . import _build

    out = (ctypes.c_int * 3)()
    rc = _build.load().gsdf_gn_cluster_shape(MODES[mode], out)
    if rc != 0:
        raise RuntimeError(f"gn_track's cluster cannot be placed: CUDA error "
                           f"{rc} ({list(out)})")
    return tuple(out)
