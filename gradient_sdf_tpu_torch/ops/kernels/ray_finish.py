"""ray_finish: the renderer's finish, the differentiable Newton/IFT polish
of each hit, its point, outward normal and camera-z depth.

For the march's `found` and secant point `s_star` per ray it computes what
the polish of `_refine` computes in `gradient_sdf_tpu/ops/raycast.py`
(:479-501, over `query.tsdf_grad`) with the hit compaction and scatter-back
of :505-531: at m = s_star the semi-implicit query phi, its gradient g (the
stored gradient times grad_scale / |g|), the straight-through depth
s_hit = m + s_ift - stop_gradient(s_ift), s_ift = m - phi / max(g . d,
grad_scale / 4), where the crossing is safe (observed voxel, g . d > 0),
else m; the point o + s_hit d, the normal -g / |g| and s_hit inv_hnorm;
zeros where nothing was found (the module note of `ops/raycast.py`).

`ray_finish_reference`, the plain version, is that in PyTorch over the hit
rays: a `nonzero` of `found` (a host sync), gathers, `query.tsdf_grad` and
`index_put`s, differentiated by autograd. On the card `ray_finish` is one
launch of the hand-written kernel of `csrc/ray_finish.cu`, one thread a
ray, with no host sync; on a CUDA tensor it launches that kernel or raises,
on a CPU tensor it takes the plain version. The kernel applies the plain
version's float32 operations in its order; the plain version sums g . d
and |g|^2 in an order PyTorch picks, so depth, points and normals may
differ by an ulp, and the hit mask is `found` itself.

The polish is differentiable, so the kernel sits in `RayFinish`, a
`torch.autograd.Function` whose backward gives the plain version's autograd
gradients for origins, dirs, inv_hnorm and the grid's dist and grad_x/y/z.
The backward is plain PyTorch on whole tensors (elementwise terms and
`index_add_` into the fields): the JAX package has no kernel behind it
(JAX differentiates the fused polish itself) and no app runs it, so it
stays plain. The forward launch then also writes what the backward needs
(the voxel's linear index, the safe flag, the stored gradient, its scale,
the centre offset and the clamped denominator); a call that needs no
gradient writes none of it. `finish_values` is the kernel's arithmetic in
PyTorch on whole tensors, the same outputs and state, in the kernel's
order: the CPU tests hold `RayFinish`'s backward to the plain autograd
through it, and on a card it is held to the kernel, so the two cannot
drift apart unseen.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ...config import FusionConfig, GridConfig
from .. import query
from .. import voxel_grid as vg

# kernel launches since the last reset_launch_count(); the CPU path does not
# count
launch_count = 0
THREADS = 256
INT32_LIMIT = 2**31
NORM_EPS = 1e-12


def reset_launch_count():
    global launch_count
    launch_count = 0


class FinishResult(NamedTuple):
    depth: torch.Tensor             # [N] ray-parameter depth (0 where no hit)
    points: Optional[torch.Tensor]  # [N, 3] world points, if asked for
    normal: torch.Tensor            # [N, 3] outward unit normals (-ghat)
    zdepth: Optional[torch.Tensor]  # [N] camera-z depth, with inv_hnorm


def _ift_polish(grid, o, d, s_star, gcfg, fcfg):
    """One differentiable Newton/IFT step from the detached secant point
    (module note of `ops/raycast.py`); one semi-implicit query serves the
    polish and the normal. Returns (s_hit, points [., 3], normal [., 3]).

    Straight-through: the VALUE is the secant estimate (the march field's
    macroscopic zero crossing), the GRADIENT is the IFT expression; the
    semi-implicit field's zero level is offset from the dist field's, so
    the IFT value itself is the less accurate depth."""
    s_mid = s_star.detach()
    pts_mid = o + s_mid[:, None] * d
    pts_frozen = pts_mid.detach()
    phi_mid, grad_mid, w_mid = query.tsdf_grad(grid, pts_frozen, gcfg, fcfg)
    g_sem = grad_mid.detach()
    phi_lin = phi_mid + torch.sum(g_sem * (pts_mid - pts_frozen), dim=-1)
    denom = torch.sum(grad_mid * d, dim=-1).detach()
    # at a valid crossing the field increases along the ray (denom > 0);
    # floor the denominator for near-tangent rays
    safe = (w_mid > 0.0) & (denom > 0.0)
    s_ift = s_mid - phi_lin / torch.clamp(denom, min=0.25 * fcfg.grad_scale)
    s_hit = torch.where(safe, s_mid + s_ift - s_ift.detach(), s_mid)
    gn = torch.linalg.norm(grad_mid, dim=-1, keepdim=True)
    normal = -grad_mid / torch.clamp(gn, min=NORM_EPS)  # stored grads: inward
    return s_hit, o + s_hit[:, None] * d, normal


def ray_finish_reference(found, s_star, origins, dirs, inv_hnorm, grid,
                         gcfg: GridConfig, fcfg: FusionConfig, *,
                         points: bool = True) -> FinishResult:
    """Plain PyTorch version of `ray_finish`, on any device, differentiable
    by autograd."""
    _check(found, s_star, origins, dirs, inv_hnorm, grid, gcfg)
    n = found.shape[0]
    f32 = dict(dtype=torch.float32, device=found.device)
    zeros3 = torch.zeros((n, 3), **f32)
    hit = torch.nonzero(found).reshape(-1)
    s_hit, pts, nrm = _ift_polish(grid, origins[hit], dirs[hit], s_star[hit],
                                  gcfg, fcfg)
    depth = torch.zeros(n, **f32).index_put((hit,), s_hit)
    return FinishResult(
        depth=depth,
        points=zeros3.index_put((hit,), pts) if points else None,
        normal=zeros3.index_put((hit,), nrm),
        zdepth=depth * inv_hnorm if inv_hnorm is not None else None)


def _check(found, s_star, origins, dirs, inv_hnorm, grid, gcfg):
    n = found.shape[0]
    dev = found.device
    if gcfg.dir_dim**3 >= INT32_LIMIT:
        raise ValueError(f"dir_dim {gcfg.dir_dim}: {gcfg.dir_dim}^3 directory "
                         f"cells exceed the kernel's int32 index")
    if grid.dist.shape[0] * gcfg.voxels_per_block >= INT32_LIMIT:
        raise ValueError(f"{grid.dist.shape[0]} blocks of "
                         f"{gcfg.voxels_per_block} voxels exceed the kernel's "
                         f"int32 index")
    want = [("found", found, (n,), torch.bool),
            ("s_star", s_star, (n,), torch.float32),
            ("origins", origins, (n, 3), torch.float32),
            ("dirs", dirs, (n, 3), torch.float32),
            ("directory", grid.directory, (gcfg.dir_dim**3,), torch.int32)]
    if inv_hnorm is not None:
        want.append(("inv_hnorm", inv_hnorm, (n,), torch.float32))
    for name in ("dist", "weight", "grad_x", "grad_y", "grad_z"):
        want.append((name, getattr(grid, name),
                     (grid.dist.shape[0], gcfg.voxels_per_block), torch.float32))
    for name, a, shape, dtype in want:
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got {a.dtype} "
                             f"{tuple(a.shape)}")
        if a.device != dev:
            raise ValueError(f"{name} must be on {dev}")


def _launch(found, s_star, origins, dirs, inv_hnorm, grid, gcfg, fcfg, *,
            points, state):
    """The kernel's outputs (a FinishResult) and, with `state`, the
    backward's (lin int32 [N], safe bool [N], aux f32 [N, 8])."""
    from . import _build

    _check(found, s_star, origins, dirs, inv_hnorm, grid, gcfg)
    n, dev = found.shape[0], found.device
    lib = _build.load()
    f32 = dict(dtype=torch.float32, device=dev)
    depth, normal = torch.empty(n, **f32), torch.empty((n, 3), **f32)
    pts = torch.empty((n, 3), **f32) if points else None
    zdepth = torch.empty(n, **f32) if inv_hnorm is not None else None
    st = ((torch.empty(n, dtype=torch.int32, device=dev),
           torch.empty(n, dtype=torch.bool, device=dev),
           torch.empty((n, 8), dtype=torch.float32, device=dev))
          if state else None)
    if n == 0:
        return FinishResult(depth, pts, normal, zdepth), st
    args = [found, s_star, origins, dirs, inv_hnorm, grid.directory, grid.dist,
            grid.weight, grid.grad_x, grid.grad_y, grid.grad_z]
    args = [a.detach().contiguous() if a is not None else None for a in args]
    outs = [depth, pts, normal, zdepth] + (list(st) if state else [None] * 3)
    vs = gcfg.voxel_size
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gsdf_ray_finish_f32(
            *(a.data_ptr() if a is not None else None for a in args + outs),
            n, gcfg.dir_dim, gcfg.block_shape, vs,
            # p / vs as PyTorch computes it on the card: p times the float32
            # reciprocal of the float32 voxel size
            float(np.float32(1.0) / np.float32(vs)), fcfg.grad_scale,
            0.25 * fcfg.grad_scale, stream)
    if rc != 0:
        raise RuntimeError(f"ray_finish kernel launch failed: CUDA error {rc}")
    global launch_count
    launch_count += 1
    return FinishResult(depth, pts, normal, zdepth), st


def finish_values(found, s_star, origins, dirs, inv_hnorm, grid, gcfg, fcfg, *,
                  points, state):
    """The kernel's per-ray arithmetic in PyTorch on whole tensors (no
    `nonzero`, no autograd graph): the same (FinishResult, state) as the
    launch, with voxels rounded as `voxel_grid.point_to_voxel` rounds on
    the tensors' device."""
    _check(found, s_star, origins, dirs, inv_hnorm, grid, gcfg)
    with torch.no_grad():
        m, o, d = s_star, origins, dirs
        p = o + m[:, None] * d
        vi = vg.point_to_voxel(p, gcfg.voxel_size)
        lin, present = vg.lookup_voxels(grid, vi, gcfg)
        lin = lin.long()
        present = found & present & (vg.flat_field(grid.weight)[lin] > 0.0)
        pm = present[:, None]
        g = torch.stack([vg.flat_field(a)[lin] for a in
                         (grid.grad_x, grid.grad_y, grid.grad_z)], dim=-1)
        g = torch.where(pm, g, 0.0)
        gx, gy, gz = g.unbind(-1)
        norm = torch.clamp(torch.sqrt(gx * gx + gy * gy + gz * gz), min=NORM_EPS)
        s = torch.where(present, (1.0 / norm) * fcfg.grad_scale, 0.0)
        cmp = torch.where(pm, vi.to(torch.float32) * gcfg.voxel_size - p, 0.0)
        q = gx * cmp[:, 0] + gy * cmp[:, 1] + gz * cmp[:, 2]
        phi = torch.where(present, vg.flat_field(grid.dist)[lin] + s * q, 0.0)
        G = s[:, None] * g
        denom = G[:, 0] * d[:, 0] + G[:, 1] * d[:, 1] + G[:, 2] * d[:, 2]
        safe = present & (denom > 0.0)
        dc = torch.clamp(denom, min=0.25 * fcfg.grad_scale)
        s_ift = m - phi / dc
        s_hit = torch.where(found, torch.where(safe, (m + s_ift) - s_ift, m), 0.0)
        cn = torch.clamp(torch.sqrt(G[:, 0] * G[:, 0] + G[:, 1] * G[:, 1]
                                    + G[:, 2] * G[:, 2]), min=NORM_EPS)
        normal = torch.where(found[:, None], -G / cn[:, None], 0.0)
        pts = torch.where(found[:, None], o + s_hit[:, None] * d, 0.0)
        res = FinishResult(
            s_hit, pts if points else None, normal,
            s_hit * inv_hnorm if inv_hnorm is not None else None)
        st = None
        if state:
            aux = torch.cat([g, s[:, None], cmp, dc[:, None]], dim=1)
            st = (torch.where(present, lin, -1).to(torch.int32), safe,
                  torch.where(found[:, None], aux, 0.0))
    return res, st


class RayFinish(torch.autograd.Function):
    """The finish with the plain autograd's gradients (module note).
    `apply(impl, found, s_star, origins, dirs, inv_hnorm, dist, grad_x,
    grad_y, grad_z, grid, gcfg, fcfg, points)`, `impl` the launch or
    `finish_values`; returns (depth, points or [0, 3], normal, zdepth or
    [0])."""

    @staticmethod
    def forward(ctx, impl, found, s_star, origins, dirs, inv_hnorm, dist,
                grad_x, grad_y, grad_z, grid, gcfg, fcfg, points):
        res, (lin, safe, aux) = impl(found, s_star, origins, dirs, inv_hnorm,
                                     grid, gcfg, fcfg, points=points,
                                     state=True)
        ctx.save_for_backward(found, s_star, dirs, inv_hnorm, res.depth, lin,
                              safe, aux)
        ctx.grad_scale = fcfg.grad_scale
        ctx.fields = tuple(dist.shape)
        empty = origins.new_empty((0, 3))
        pts = res.points if points else empty
        zdepth = res.zdepth if inv_hnorm is not None else origins.new_empty(0)
        if not points:
            ctx.mark_non_differentiable(pts)
        if inv_hnorm is None:
            ctx.mark_non_differentiable(zdepth)
        ctx.points = points
        return res.depth, pts, res.normal, zdepth

    @staticmethod
    def backward(ctx, g_depth, g_points, g_normal, g_zdepth):
        found, m, d, ih, s_hit, lin, safe, aux = ctx.saved_tensors
        gs = ctx.grad_scale
        hit = found[:, None]
        a = g_depth.clone()                      # dL / ds_hit
        go = torch.zeros_like(d)
        gd = torch.zeros_like(d)
        if ctx.points:
            bp = torch.where(hit, g_points, 0.0)
            a = a + torch.sum(bp * d, dim=-1)
            go = go + bp
            gd = gd + s_hit[:, None] * bp
        g_ih = None
        if ih is not None:
            a = a + g_zdepth * ih
            g_ih = g_zdepth * s_hit
        g, s, cmp, dc = aux[:, :3], aux[:, 3:4], aux[:, 4:7], aux[:, 7]
        present = (lin >= 0)[:, None]
        G = s * g
        # s_hit = m - phi_lin / dc + const where safe: dL/dphi_lin
        e = torch.where(safe, -a / dc, 0.0)[:, None]
        # phi_lin = phi + G . (p - p_frozen), p = o + m d
        go = go + e * G
        gd = gd + e * m[:, None] * G
        # the normal -G / max(|G|, eps), |G| by linalg.norm
        N = torch.linalg.norm(G, dim=-1, keepdim=True)
        c = torch.clamp(N, min=NORM_EPS)
        bn = torch.where(present, g_normal, 0.0)
        dG = -bn / c + torch.where(
            N >= NORM_EPS, torch.sum(bn * G, dim=-1, keepdim=True) * G
            / (c * c * torch.clamp(N, min=NORM_EPS)), 0.0)
        # G = s g and phi = dist + s (g . cmp), s = gs / max(|g|, eps)
        n = torch.sqrt(torch.sum(g * g, dim=-1, keepdim=True))
        ds = torch.where(n >= NORM_EPS, -gs * g / torch.clamp(n, min=NORM_EPS)**3,
                         0.0)                   # ds / dg
        q = torch.sum(g * cmp, dim=-1, keepdim=True)
        dg = s * (e * cmp + dG) + (e * q + torch.sum(dG * g, dim=-1,
                                                     keepdim=True)) * ds
        grads = [None] * 4
        idx = lin.clamp(min=0).long()
        for k, vals in ((6, e[:, 0]), (7, dg[:, 0]), (8, dg[:, 1]),
                        (9, dg[:, 2])):
            if ctx.needs_input_grad[k]:
                out = torch.zeros(ctx.fields[0] * ctx.fields[1], dtype=vals.dtype,
                                  device=vals.device)
                out.index_add_(0, idx, torch.where(present[:, 0], vals, 0.0))
                grads.append(out.reshape(ctx.fields))
            else:
                grads.append(None)
        return (None, None, None, go if ctx.needs_input_grad[3] else None,
                gd if ctx.needs_input_grad[4] else None,
                g_ih if ctx.needs_input_grad[5] else None,
                *grads[4:], None, None, None, None)


def ray_finish(found: torch.Tensor, s_star: torch.Tensor, origins: torch.Tensor,
               dirs: torch.Tensor, inv_hnorm: Optional[torch.Tensor],
               grid: vg.VoxelGrid, gcfg: GridConfig, fcfg: FusionConfig, *,
               points: bool = True) -> FinishResult:
    """The finish of N rays: found bool [N] and s_star f32 [N] from
    `raycast_march`, origins and dirs f32 [N, 3] (unit directions; they
    and the grid's dist and grad_x/y/z may carry gradients), inv_hnorm f32
    [N] or None (then no camera-z depth), `points` whether to return the
    hit points. All on one device. On CUDA the kernel launches on the
    current stream without synchronizing."""
    dev = found.device
    if dev.type == "cpu":
        return ray_finish_reference(found, s_star, origins, dirs, inv_hnorm,
                                    grid, gcfg, fcfg, points=points)
    if dev.type != "cuda":
        raise RuntimeError(f"ray_finish: no kernel for {dev}")
    diff = (origins, dirs, inv_hnorm, grid.dist, grid.grad_x, grid.grad_y,
            grid.grad_z)
    if not (torch.is_grad_enabled()
            and any(a is not None and a.requires_grad for a in diff)):
        return _launch(found, s_star, origins, dirs, inv_hnorm, grid, gcfg,
                       fcfg, points=points, state=False)[0]
    depth, pts, normal, zdepth = RayFinish.apply(
        _launch, found, s_star, origins, dirs, inv_hnorm, grid.dist,
        grid.grad_x, grid.grad_y, grid.grad_z, grid, gcfg, fcfg, points)
    return FinishResult(depth, pts if points else None, normal,
                        zdepth if inv_hnorm is not None else None)
