"""raycast_march: per-ray sphere tracing of the block-sparse SDF to the first
zero crossing, with the crossing's bracket tightened and interpolated.

For each ray (o, d) and march window [s0, s_end] it computes what `_march`
and the bisection and secant of `_refine` compute in
`gradient_sdf_tpu/ops/raycast.py` (:178-244, :426-477; the module note of
`ops/raycast.py` here describes the algorithm):

    found   the ray crossed from observed free space (dist < 0) into
            dist >= 0 within `max_steps` probes of its window;
    s_mid   midpoint of the crossing's bracket as the march left it;
    s_star  after `bisect_steps` halvings, the secant between the bracket
            voxels' centre projections (the bracket's midpoint where the
            end values do not allow one); 0 with s_mid where not found.

The JAX package has no TPU kernel for this: it is a `lax.while_loop` that
XLA compiles, carried over compacted buffers because such a loop costs its
full width until its slowest ray ends. In eager PyTorch the same loop is
~100 small launches and a host sync per step, so on the card it is the
hand-written kernel of `csrc/raycast_march.cu` (one thread per ray, rays of
an image in 8 x 4 pixel tiles per warp; see the note there). On a CUDA
tensor the wrapper launches that kernel or raises;
on a CPU tensor it takes `raycast_march_reference`, the plain version: the
same arithmetic in the same order on whole tensors, over the rays still
alive at each step. The kernel is built without fused multiply-adds, and
the two agree bit for bit.

Everything the kernel returns sits behind a `stop_gradient` in the JAX
renderer (the differentiable part is the Newton/IFT polish that follows, in
plain PyTorch), so there is no `autograd.Function` and no backward kernel:
inputs are taken detached.

Each ray is probed while it is alive (not found, s <= s_end) and never
otherwise; an empty window (s0 > s_end) is never probed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ...config import FusionConfig, GridConfig
from .. import voxel_grid as vg

# kernel launches since the last reset_launch_count(); the CPU path and the
# reference do not count
launch_count = 0

# block shapes with an instance of their own in the kernel (shifts and masks;
# `pick` in csrc/raycast_march.cu); every other shape takes runtime divisors
POW2_BLOCK_SHAPES = (2, 4, 8, 16, 32)
# a warp's tile of an image's rays, and the warp tiles across a block
WARP_TILE = (8, 4)
TILES_X = 4
THREADS = 128
INT32_LIMIT = 2**31


def reset_launch_count():
    global launch_count
    launch_count = 0


class MarchResult(NamedTuple):
    found: torch.Tensor            # bool [N]
    s_mid: torch.Tensor            # f32 [N]
    s_star: torch.Tensor           # f32 [N]
    stats: Optional[torch.Tensor]  # i32 [N, 2]: probes, 32-byte sectors gathered
    # u8, one byte per 32-byte sector of directory, coarse_occ, dist, weight
    # (`sector_offsets`): 1 where any ray's probe read it
    touched: Optional[torch.Tensor] = None


class _Consts(NamedTuple):
    """The march's scalars, each rounded to float32 once, so that the kernel
    and the plain version multiply by the same bits."""

    vs: float
    inv_vs: float
    trunc: float
    step_min: float
    half_step: float
    half_vox: float
    block_m: float
    inv_block_m: float
    coarse_m: float
    inv_coarse_m: float


def _consts(gcfg: GridConfig, fcfg: FusionConfig) -> _Consts:
    vs = gcfg.voxel_size
    step_min = 0.25 * vs
    block_m = gcfg.block_shape * vs
    coarse_m = block_m * vg.COARSE_FACTOR
    return _Consts(*(float(np.float32(x)) for x in (
        vs, 1.0 / vs, fcfg.trunc_voxels * vs, step_min, 0.5 * step_min,
        0.5 * vs, block_m, 1.0 / block_m, coarse_m, 1.0 / coarse_m)))


def ray_order(n: int, width: Optional[int]) -> torch.Tensor:
    """The ray each thread of the kernel's launch takes, -1 for an idle one,
    in thread order (so that rows of 32 are warps): the rays in their order
    for width None, else 8 x 4 pixel tiles of a row-major image of that
    width, four tiles across a block of `THREADS` threads."""
    if width is None:
        return torch.cat([torch.arange(n), torch.full((-n % 32,), -1)])
    (tw, th), height = WARP_TILE, n // width
    bw, bh = tw * TILES_X, th * (THREADS // 32 // TILES_X)
    lane = torch.arange(THREADS)
    warp, lane = lane // 32, lane % 32
    x0 = (warp % TILES_X) * tw + lane % tw
    y0 = (warp // TILES_X) * th + lane // tw
    by, bx = torch.meshgrid(torch.arange(-(-height // bh)),
                            torch.arange(-(-width // bw)), indexing="ij")
    x = (bx.reshape(-1, 1) * bw + x0).reshape(-1)
    y = (by.reshape(-1, 1) * bh + y0).reshape(-1)
    return torch.where((x < width) & (y < height), y * width + x, -1)


def sector_offsets(gcfg: GridConfig, num_blocks: int):
    """Start of directory, coarse_occ, dist and weight in a `touched` array,
    and its length: 8 four-byte entries to a sector, each array rounded up."""
    n_dir = gcfg.dir_dim**3
    n_coarse = (gcfg.dir_dim // vg.COARSE_FACTOR) ** 3
    n_vox = num_blocks * gcfg.voxels_per_block
    offs = [0]
    for entries in (n_dir, n_coarse, n_vox, n_vox):
        offs.append(offs[-1] + (entries + 7) // 8)
    return tuple(offs)


def _check(origins, dirs, s0, s_end, directory, coarse_occ, dist, weight, gcfg,
           width=None):
    n = origins.shape[0]
    dev = origins.device
    # the kernel computes directory keys and voxel indices in int32
    if gcfg.dir_dim**3 >= INT32_LIMIT:
        raise ValueError(f"dir_dim {gcfg.dir_dim}: {gcfg.dir_dim}^3 directory "
                         f"cells exceed the kernel's int32 index")
    if dist.shape[0] * gcfg.voxels_per_block >= INT32_LIMIT:
        raise ValueError(f"{dist.shape[0]} blocks of {gcfg.voxels_per_block} "
                         f"voxels exceed the kernel's int32 index")
    if width is not None and (width <= 0 or n % width):
        raise ValueError(f"width {width}: {n} rays are no image of that width")
    want = [("origins", origins, (n, 3), torch.float32),
            ("dirs", dirs, (n, 3), torch.float32),
            ("s0", s0, (n,), torch.float32),
            ("s_end", s_end, (n,), torch.float32),
            ("directory", directory, (gcfg.dir_dim**3,), torch.int32),
            ("coarse_occ", coarse_occ,
             ((gcfg.dir_dim // vg.COARSE_FACTOR) ** 3,), torch.int32),
            ("dist", dist, (dist.shape[0], gcfg.voxels_per_block), torch.float32),
            ("weight", weight, tuple(dist.shape), torch.float32)]
    for name, a, shape, dtype in want:
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got {a.dtype} "
                             f"{tuple(a.shape)}")
        if a.device != dev or not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous, on {dev}")


def _probe(directory, coarse_occ, dist, weight, px, py, pz, gcfg, c: _Consts,
           touched=None):
    """(value, observed, block_present, coarse_occupied, sectors) at points
    given by component: the nearest voxel's dist where it was observed.
    `touched` gets a 1 for every sector the kernel's probe would read."""
    b, D = gcfg.block_shape, gcfg.dir_dim
    F = vg.COARSE_FACTOR
    C = D // F
    vx = torch.round(px * c.inv_vs).to(torch.int32)
    vy = torch.round(py * c.inv_vs).to(torch.int32)
    vz = torch.round(pz * c.inv_vs).to(torch.int32)
    bx = torch.div(vx, b, rounding_mode="floor")
    by = torch.div(vy, b, rounding_mode="floor")
    bz = torch.div(vz, b, rounding_mode="floor")
    local = ((vz - bz * b) * b + (vy - by * b)) * b + (vx - bx * b)
    xs, ys, zs = bx + D // 2, by + D // 2, bz + D // 2
    inside = ((xs >= 0) & (xs < D) & (ys >= 0) & (ys < D) & (zs >= 0) & (zs < D))
    key = torch.where(inside, (xs.long() * D + ys) * D + zs, 0)
    slot = directory[key]
    present = inside & (slot >= 0)
    ckey = torch.where(
        inside,
        (torch.div(xs, F, rounding_mode="floor").long() * C
         + torch.div(ys, F, rounding_mode="floor")) * C
        + torch.div(zs, F, rounding_mode="floor"), 0)
    coarse = present | (inside & (coarse_occ[ckey] > 0))
    lin = torch.where(present, slot, 0).long() * gcfg.voxels_per_block + local
    d = vg.flat_field(dist)[lin]
    observed = present & (vg.flat_field(weight)[lin] > 0.0) & torch.isfinite(d)
    sectors = inside.to(torch.int32) * 2 + present.to(torch.int32)
    if touched is not None:
        _, off_coarse, off_dist, off_weight, _ = sector_offsets(gcfg, dist.shape[0])
        touched[key[inside] >> 3] = 1
        touched[off_coarse + (ckey[inside & ~present] >> 3)] = 1
        touched[off_dist + (lin[present] >> 3)] = 1
        touched[off_weight + (lin[present] >> 3)] = 1
    return (torch.where(observed, d, 0.0), observed, present, coarse, sectors)


def _ray_terms(d):
    """Per ray and axis, what the DDA needs of the direction: 1/d (NaN where
    |d| <= 1e-12: that axis has no next plane) and 1 where d > 0, else 0."""
    r = torch.where(torch.abs(d) > 1e-12, torch.reciprocal(d), float("nan"))
    return r, (d > 0).to(d.dtype)


def _dda_axis(p, r, u, cell, inv_cell, half_vox):
    b = torch.floor((p + half_vox) * inv_cell)
    bound = (b + u) * cell
    return (bound - p - half_vox) * r


def _dda(px, py, pz, r, u, cell, inv_cell, c: _Consts):
    """Distance along each ray to its next plane of a lattice of pitch
    `cell`. Voxel i spans [i vs - vs/2, i vs + vs/2), so the planes sit at
    k cell - vs/2. `fmin` drops the NaN of an axis the ray runs parallel
    to; non-positive distances (and all-NaN) become inf, then the result is
    nudged past the plane by half a minimum step."""
    out = _dda_axis(px, r[:, 0], u[:, 0], cell, inv_cell, c.half_vox)
    out = torch.fmin(out, _dda_axis(py, r[:, 1], u[:, 1], cell, inv_cell, c.half_vox))
    out = torch.fmin(out, _dda_axis(pz, r[:, 2], u[:, 2], cell, inv_cell, c.half_vox))
    out = torch.where(out > 0, out, float("inf"))
    return torch.clamp(out + c.half_step, min=c.step_min)


def raycast_march_reference(origins, dirs, s0, s_end, directory, coarse_occ,
                            dist, weight, gcfg: GridConfig, fcfg: FusionConfig,
                            *, max_steps: int = 128, bisect_steps: int = 2,
                            stats: bool = False) -> MarchResult:
    """Plain PyTorch version, on any device: a loop over steps on whole
    tensors restricted to the rays still alive, ending when none is."""
    _check(origins, dirs, s0, s_end, directory, coarse_occ, dist, weight, gcfg)
    origins, dirs = origins.detach(), dirs.detach()
    c = _consts(gcfg, fcfg)
    n, dev = origins.shape[0], origins.device
    grid = (directory, coarse_occ, dist, weight)

    def zeros(dtype=torch.float32):
        return torch.zeros(n, dtype=dtype, device=dev)

    found = zeros(torch.bool)
    lo, hi, v_lo, v_hi, v_lo_ok = zeros(), zeros(), zeros(), zeros(), zeros(torch.bool)
    count = torch.zeros((n, 2), dtype=torch.int32, device=dev)
    touched = (torch.zeros(sector_offsets(gcfg, dist.shape[0])[-1],
                           dtype=torch.uint8, device=dev) if stats else None)

    # state of the alive rays only, compacted as rays end
    r_all, u_all = _ray_terms(dirs)
    idx = torch.nonzero(s0 <= s_end).reshape(-1)
    s = s0[idx]
    s_prev, v_prev = s.clone(), torch.zeros_like(s)
    v_prev_ok = torch.zeros_like(s, dtype=torch.bool)
    for _ in range(max_steps):
        if idx.numel() == 0:
            break
        o, d, r, u = origins[idx], dirs[idx], r_all[idx], u_all[idx]
        dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
        px, py, pz = o[:, 0] + s * dx, o[:, 1] + s * dy, o[:, 2] + s * dz
        phi, observed, present, coarse, sectors = _probe(*grid, px, py, pz, gcfg, c,
                                                         touched)
        count[idx, 0] += 1
        count[idx, 1] += sectors
        crossed = observed & (phi >= 0.0)
        hit = idx[crossed]
        found[hit] = True
        lo[hit], hi[hit] = s_prev[crossed], s[crossed]
        v_lo[hit], v_hi[hit] = v_prev[crossed], phi[crossed]
        v_lo_ok[hit] = v_prev_ok[crossed]
        # step policy: observed voxel -> sphere-trace with -phi (free space
        # is negative), floored by the DDA to the next voxel plane;
        # allocated block, unobserved voxel -> T; unallocated block -> DDA to
        # the next block plane, or coarse-cell plane in an empty coarse cell
        step = torch.where(
            observed,
            torch.maximum(torch.clamp(-phi, max=c.trunc),
                          _dda(px, py, pz, r, u, c.vs, c.inv_vs, c)),
            torch.where(
                present, c.trunc,
                torch.where(coarse,
                            _dda(px, py, pz, r, u, c.block_m, c.inv_block_m, c),
                            _dda(px, py, pz, r, u, c.coarse_m, c.inv_coarse_m,
                                 c))))
        s_new = s + step
        alive = ~crossed & (s_new <= s_end[idx])
        idx = idx[alive]
        s_prev, v_prev, v_prev_ok = s[alive], phi[alive], observed[alive]
        s = s_new[alive]

    s_mid = torch.where(found, 0.5 * (lo + hi), 0.0)
    hit = torch.nonzero(found).reshape(-1)
    o, d = origins[hit], dirs[hit]
    ox, oy, oz, dx, dy, dz = o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]
    lo, hi, v_lo, v_hi, v_lo_ok = lo[hit], hi[hit], v_lo[hit], v_hi[hit], v_lo_ok[hit]
    for _ in range(bisect_steps):
        mid = 0.5 * (lo + hi)
        val, observed, _, _, sectors = _probe(
            *grid, ox + mid * dx, oy + mid * dy, oz + mid * dz, gcfg, c, touched)
        count[hit, 0] += 1
        count[hit, 1] += sectors
        before = ~observed | (val < 0.0)  # still in free space
        lo = torch.where(before, mid, lo)
        v_lo = torch.where(before, val, v_lo)
        v_lo_ok = torch.where(before, observed, v_lo_ok)
        hi = torch.where(before, hi, mid)
        v_hi = torch.where(before, v_hi, val)

    def s_of_center(s):
        """Ray parameter of the point closest to the centre of the voxel that
        holds o + s d (directions are unit vectors)."""
        cx = torch.round((ox + s * dx) * c.inv_vs) * c.vs
        cy = torch.round((oy + s * dy) * c.inv_vs) * c.vs
        cz = torch.round((oz + s * dz) * c.inv_vs) * c.vs
        return (cx - ox) * dx + (cy - oy) * dy + (cz - oz) * dz

    # secant between the bracket voxels' centre projections where both end
    # values are usable, the bracket's midpoint otherwise
    s_lo_c, s_hi_c = s_of_center(lo), s_of_center(hi)
    dv = v_hi - v_lo
    use_sec = (v_lo_ok & (v_lo < 0.0) & (v_hi >= 0.0) & (dv > 1e-12)
               & (s_hi_c > s_lo_c))
    s_star = zeros()
    s_star[hit] = torch.where(
        use_sec,
        s_lo_c + (s_hi_c - s_lo_c) * (-v_lo) / torch.where(use_sec, dv, 1.0),
        0.5 * (lo + hi))
    return MarchResult(found, s_mid, s_star, count if stats else None, touched)


def raycast_march(origins: torch.Tensor, dirs: torch.Tensor, s0: torch.Tensor,
                  s_end: torch.Tensor, directory: torch.Tensor,
                  coarse_occ: torch.Tensor, dist: torch.Tensor,
                  weight: torch.Tensor, gcfg: GridConfig, fcfg: FusionConfig, *,
                  max_steps: int = 128, bisect_steps: int = 2,
                  stats: bool = False, width: Optional[int] = None) -> MarchResult:
    """March N rays: origins, dirs f32 [N, 3] (unit directions), windows s0,
    s_end f32 [N], against a grid's `directory`, `coarse_occ`, `dist` and
    `weight`. All tensors contiguous and on one device. With `stats` the
    result also carries each ray's probe count and the number of 32-byte
    sectors its probes gathered, and `touched`, the distinct sectors of the
    four grid arrays that the launch read (a counting instance of the
    kernel; time the one without). `width`: the rays are the pixels of a
    row-major image that wide, and the kernel gives each warp an 8 x 4 tile
    of them (`ray_order`); no result depends on it. On CUDA the kernel
    launches on the current stream without synchronizing."""
    args = (origins, dirs, s0, s_end, directory, coarse_occ, dist, weight)
    if origins.device.type == "cpu":
        _check(*args, gcfg, width)
        return raycast_march_reference(*args, gcfg, fcfg, max_steps=max_steps,
                                       bisect_steps=bisect_steps, stats=stats)
    if origins.device.type != "cuda":
        raise RuntimeError(f"raycast_march: no kernel for {origins.device}")
    from . import _build

    _check(*args, gcfg, width)
    lib = _build.load()
    origins, dist = args[0], args[6]
    n, dev = origins.shape[0], origins.device
    found = torch.empty(n, dtype=torch.bool, device=dev)   # one byte, 0 or 1
    s_mid = torch.empty(n, dtype=torch.float32, device=dev)
    s_star = torch.empty(n, dtype=torch.float32, device=dev)
    count = torch.empty((n, 2), dtype=torch.int32, device=dev) if stats else None
    touched = (torch.zeros(sector_offsets(gcfg, dist.shape[0])[-1],
                           dtype=torch.uint8, device=dev) if stats else None)
    if n == 0:
        return MarchResult(found, s_mid, s_star, count, touched)
    c = _consts(gcfg, fcfg)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gsdf_raycast_march_f32(
            *(a.detach().data_ptr() for a in args), found.data_ptr(),
            s_mid.data_ptr(), s_star.data_ptr(),
            count.data_ptr() if stats else None,
            touched.data_ptr() if stats else None, n, dist.shape[0], width or 0,
            gcfg.dir_dim, gcfg.block_shape, vg.COARSE_FACTOR, c.vs, c.inv_vs,
            c.trunc, c.step_min, c.half_step, c.half_vox, c.block_m,
            c.inv_block_m, c.coarse_m, c.inv_coarse_m, int(max_steps),
            int(bisect_steps), stream)
    if rc != 0:
        raise RuntimeError(f"raycast_march kernel launch failed: CUDA error {rc}")
    global launch_count
    launch_count += 1
    return MarchResult(found, s_mid, s_star, count, touched)
