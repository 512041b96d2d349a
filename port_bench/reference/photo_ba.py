"""PhotoBA's alternation, plain (upstream `PhotometricOptimizer.cpp`:
`getIntensity` :238-260, `getEnergy` :273-321, `solveDist` :326-388,
`solvePose` :499-590, `optimize` :611-663; `main_photo_ba.cpp:291-297`
for the problem):

* the problem: the voxels of a fused grid with weight > 0 and
  |dist| <= band voxels, in slot order and x-fastest within a block, with
  their stored (unnormalized) gradients, weights, dists and the keyframes'
  visibility bits;
* a voxel's surface point x = centre - dist g / |g|, projected into frame i
  by p = R_i^T (x - t_i), u = fx p0 / z + cx, v = fy p1 / z + cy, and the
  RGB image sampled bilinearly there with the bilinear interpolant's own
  derivative as the image gradient (in bounds: 0 <= u < W, 0 <= v < H);
* a pair (voxel, frame) takes part where the voxel is real, the frame saw
  it (its visibility bit), z > 0 and the sample is in bounds; the energy
  and the pose step take only voxels with |dist| <= voxel size, and under
  the TRUNC_L2 loss the solvers drop pairs with max_c A_c^2 > lambda^2;
* the energy: sum over voxels of sum_i |A_i - mean|^2;
* the dist step: per voxel Jd = dI/dp (-R^T g), H = sum |Jd|^2 - |sum
  Jd|^2 / N + reg_weight weight, b = sum A.Jd - (sum A).(sum Jd) / N,
  dist -= damping b / H where N > 0 and H != 0;
* the pose step: per frame, over its pairs, H = sum (1 - 1/N) Jc^T Jc and
  b = sum (A - mean)^T Jc with Jc = [-dI/dp R^T | dI/dp x p], the 6x6
  systems solved, a NaN step skipped, t -= dt, R <- R exp(-dw).

A voxel's frames are walked in frame order with running sums, so that its
sums add in the order the program's kernels add them; the projection and
the sampler are written out elementwise in the program's order, so that
both pick the same image cells (a cell boundary moves the gradient by a
step); so are R^T g and dI/dp R^T. The sums of the pose systems over the
pairs are matrix products, a slice of rows at a time, and so is R exp(-dw):
computed with TF32 they are the control of `correct`. Voxels are taken in
blocks of `block`, so that the pose Jacobians of all pairs are never held
at once.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from . import se3 as RS


class Problem(NamedTuple):
    vox: torch.Tensor       # int32 [V, 3]
    grad: torch.Tensor      # [V, 3] unnormalized
    weight: torch.Tensor    # [V]
    vis: torch.Tensor       # bool [V, F]
    images: torch.Tensor    # [F, H, W, 3]
    K: torch.Tensor         # [3, 3]


class State(NamedTuple):
    dist: torch.Tensor      # [V]
    R: torch.Tensor         # [F, 3, 3] camera-to-world
    t: torch.Tensor         # [F, 3]


class Settings(NamedTuple):
    """The configuration's numbers the alternation uses."""

    voxel_size: float
    damping: float
    lambda_: float
    reg_weight: float
    trunc: bool             # the TRUNC_L2 loss

    @classmethod
    def of(cls, cfg: dict) -> "Settings":
        b = cfg["photo_ba"]
        return cls(cfg["grid"]["voxel_size"], b["damping"], b["lambda_"],
                   b["reg_weight"], b["loss"] == "trunc_l2")


class Precision:
    """The working float type, and whether the matrix products run in TF32
    (the control: float32 with TF32 on)."""

    def __init__(self, dtype=torch.float32, tf32: bool = False):
        self.dtype, self.tf32 = dtype, tf32

    @contextlib.contextmanager
    def products(self):
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old


FP32 = Precision()


# -- the problem ----------------------------------------------------------------

def build(grid: dict, vis_words, slots, images, K, band_voxels: float,
          dtype=torch.float32):
    """(Problem, dist) from a grid's state (`directory`, `block_coords`,
    `num_active`, `dist`, `weight`, `gx`, `gy`, `gz` of the allocated
    blocks, `block_shape`, `voxel_size`), its visibility words (int32
    [num_active, B^3, words], uint32 bit patterns) and the keyframes'
    slots, in the working float type `dtype`."""
    na, B = grid["num_active"], grid["block_shape"]
    dt = dtype
    dist = grid["dist"][:na].reshape(-1)
    weight = grid["weight"][:na].reshape(-1)
    band = torch.tensor(band_voxels * grid["voxel_size"], dtype=dist.dtype,
                        device=dist.device)
    rows = torch.nonzero((weight > 0) & (dist.abs() <= band)).reshape(-1)
    blk, loc = rows // B ** 3, rows % B ** 3
    local = torch.stack([loc % B, (loc // B) % B, loc // (B * B)], dim=-1)
    vox = (grid["block_coords"][:na][blk].long() * B + local).to(torch.int32)
    grad = torch.stack([grid[k][:na].reshape(-1)[rows]
                        for k in ("gx", "gy", "gz")], dim=-1)
    words = vis_words[:na].reshape(na * B ** 3, -1)[rows]
    vis = torch.stack([((words[:, s // 32] >> (s % 32)) & 1).bool()
                       for s in slots], dim=-1)
    problem = Problem(vox, grad.to(dt), weight[rows].to(dt), vis,
                      torch.as_tensor(images, device=dist.device).to(dt),
                      torch.as_tensor(K, device=dist.device).to(dt))
    return problem, dist[rows].to(dt)


# -- one frame's pairs --------------------------------------------------------

def surface_points(problem: Problem, dist, voxel_size: float):
    g = problem.grad
    norm = torch.sqrt(g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1] + g[:, 2] * g[:, 2])
    ghat = g / torch.clamp(norm, min=1e-12)[:, None]
    return problem.vox.to(dist.dtype) * voxel_size - dist[:, None] * ghat


def sample(img, u, v):
    """Bilinear sample of img [H, W, 3] at (u, v): (A, dA/du, dA/dv, in
    bounds); out of bounds the taps clamp to the border."""
    H, W = img.shape[0], img.shape[1]
    inb = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    uc = torch.clamp(u, 0.0, W - 1.000001)
    vc = torch.clamp(v, 0.0, H - 1.000001)
    u0f, v0f = torch.floor(uc), torch.floor(vc)
    # a no-op in float32; in bfloat16 the clamp's bound rounds up to W
    u0, v0 = u0f.long().clamp(0, W - 1), v0f.long().clamp(0, H - 1)
    u1, v1 = torch.clamp(u0 + 1, max=W - 1), torch.clamp(v0 + 1, max=H - 1)
    fu, fv = (uc - u0f)[:, None], (vc - v0f)[:, None]
    i00, i01, i10, i11 = img[v0, u0], img[v0, u1], img[v1, u0], img[v1, u1]
    top = i00 + fu * (i01 - i00)
    bot = i10 + fu * (i11 - i10)
    A = top + fv * (bot - top)
    dAdu = (1 - fv) * (i01 - i00) + fv * (i11 - i10)
    dAdv = (1 - fu) * (i10 - i00) + fu * (i11 - i01)
    return A, dAdu, dAdv, inb


class Pairs(NamedTuple):
    A: torch.Tensor         # [Vb, 3]
    dI_dp: torch.Tensor     # [Vb, 3 (channel), 3 (xyz)]
    p: torch.Tensor         # [Vb, 3] camera-frame point
    seen: torch.Tensor      # bool [Vb]: visible, z > 0, in bounds, real


def project(problem: Problem, x, vis_f, R, t, img, grad: bool = True) -> Pairs:
    """The pairs of voxels `x` [Vb, 3] with one frame (R, t, img)."""
    K = problem.K
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    d = x - t
    p = d[:, 0:1] * R[0, :] + d[:, 1:2] * R[1, :] + d[:, 2:3] * R[2, :]
    z = p[:, 2]
    safe_z = torch.where(torch.abs(z) > 1e-12, z, torch.ones_like(z))
    zi = 1.0 / safe_z
    u = fx * p[:, 0] * zi + cx
    v = fy * p[:, 1] * zi + cy
    A, dAdu, dAdv, inb = sample(img, u, v)
    seen = vis_f & inb & (z > 1e-12)
    if not grad:
        return Pairs(A, None, p, seen)
    zi2 = zi * zi
    zero = torch.zeros_like(zi)
    du = torch.stack([fx * zi, zero, -fx * p[:, 0] * zi2], dim=-1)
    dv = torch.stack([zero, fy * zi, -fy * p[:, 1] * zi2], dim=-1)
    dI_dp = dAdu[..., None] * du[:, None, :] + dAdv[..., None] * dv[:, None, :]
    return Pairs(A, dI_dp, p, seen)


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _trunc(s: Settings, A, ok):
    if not s.trunc:
        return ok
    return ok & (torch.amax(A * A, dim=-1) <= s.lambda_ * s.lambda_)


def _blocks(V: int, block: int):
    for lo in range(0, V, block):
        yield slice(lo, min(V, lo + block))


# -- the passes -----------------------------------------------------------------

def energy(problem: Problem, state: State, s: Settings, block: int = 1 << 21):
    """The total photometric energy (a 0-dim tensor)."""
    V, F = problem.vis.shape
    total = torch.zeros((), dtype=state.dist.dtype, device=state.dist.device)
    for sl in _blocks(V, block):
        dist = state.dist[sl]
        x = surface_points(_rows(problem, sl), dist, s.voxel_size)
        gate = torch.abs(dist) <= s.voxel_size
        n = torch.zeros_like(dist)
        sA = torch.zeros_like(x)
        sAA = torch.zeros_like(dist)
        for f in range(F):
            pr = project(problem, x, problem.vis[sl, f], state.R[f], state.t[f],
                         problem.images[f], grad=False)
            w = (pr.seen & gate).to(dist.dtype)
            n = n + w
            sA = sA + w[:, None] * pr.A
            sAA = sAA + w * _dot3(pr.A, pr.A)
        e = torch.clamp(sAA - _dot3(sA, sA) / torch.clamp(n, min=1.0), min=0.0)
        total = total + torch.where(n > 0, e, torch.zeros_like(e)).sum()
    return total


def dist_step(problem: Problem, state: State, s: Settings, block: int = 1 << 21):
    """The stepped dist [V] (solveDist)."""
    V, F = problem.vis.shape
    out = torch.empty_like(state.dist)
    for sl in _blocks(V, block):
        dist = state.dist[sl]
        g = problem.grad[sl]
        x = surface_points(_rows(problem, sl), dist, s.voxel_size)
        n = torch.zeros_like(dist)
        sA, sJ, sAJ, sJJ = (torch.zeros_like(x) for _ in range(4))
        for f in range(F):
            pr = project(problem, x, problem.vis[sl, f], state.R[f],
                         state.t[f], problem.images[f])
            Jd = _dot3(pr.dI_dp, -_t_times(g, state.R[f])[:, None, :])   # [Vb, 3]
            w = _trunc(s, pr.A, pr.seen).to(dist.dtype)[:, None]
            n = n + w[:, 0]
            sA = sA + w * pr.A
            sJ = sJ + w * Jd
            sAJ = sAJ + w * pr.A * Jd
            sJJ = sJJ + w * Jd * Jd
        inv_n = 1.0 / torch.clamp(n, min=1.0)
        H = (sJJ[:, 0] + sJJ[:, 1] + sJJ[:, 2]) - inv_n * _dot3(sJ, sJ)
        b = (sAJ[:, 0] + sAJ[:, 1] + sAJ[:, 2]) - inv_n * _dot3(sA, sJ)
        H = H + s.reg_weight * problem.weight[sl]
        step = torch.where((n > 0) & (H != 0.0), s.damping * b / H,
                           torch.zeros_like(H))
        out[sl] = dist - step
    return out


def _t_times(g, R):
    """R^T g for g [Vb, 3], written out as g_0 R[0] + g_1 R[1] + g_2 R[2]."""
    return g[:, 0:1] * R[0, :] + g[:, 1:2] * R[1, :] + g[:, 2:3] * R[2, :]


# rows of the (voxel, channel) axis a partial product of the pose systems
SPLIT_ROWS = 4096


def _chunked_products(lhs, J):
    """lhs^T J over the (voxel, channel) rows of lhs [Vb, 3, 7] and J
    [Vb, 3, 6], as [7, 6]: one matrix product a slice of `SPLIT_ROWS` rows
    (zero-padded), and the slices' products added, so that no float32 sum
    runs along millions of rows."""
    lhs, J = lhs.reshape(-1, lhs.shape[-1]), J.reshape(-1, 6)
    pad = (-J.shape[0]) % SPLIT_ROWS
    if pad:
        lhs = torch.nn.functional.pad(lhs, (0, 0, 0, pad))
        J = torch.nn.functional.pad(J, (0, 0, 0, pad))
    return (lhs.reshape(-1, SPLIT_ROWS, lhs.shape[-1]).transpose(-1, -2)
            @ J.reshape(-1, SPLIT_ROWS, 6)).sum(dim=0)


def _rows(problem: Problem, sl) -> Problem:
    return problem._replace(vox=problem.vox[sl], grad=problem.grad[sl],
                            weight=problem.weight[sl], vis=problem.vis[sl])


def pose_systems(problem: Problem, state: State, s: Settings,
                 prec: Precision = FP32, block: int = 1 << 21):
    """The decoupled pose step's systems (H [F, 6, 6], b [F, 6]): first
    each voxel's count and mean intensity under the pose gates, then the
    frames' sums over their pairs."""
    V, F = problem.vis.shape
    dt, dev = prec.dtype, state.dist.device
    H = torch.zeros((F, 6, 6), dtype=dt, device=dev)
    b = torch.zeros((F, 6), dtype=dt, device=dev)
    with prec.products():
        for sl in _blocks(V, block):
            dist = state.dist[sl]
            x = surface_points(_rows(problem, sl), dist, s.voxel_size)
            gate = torch.abs(dist) <= s.voxel_size
            n = torch.zeros_like(dist)
            sA = torch.zeros_like(x)
            for f in range(F):
                pr = project(problem, x, problem.vis[sl, f], state.R[f],
                             state.t[f], problem.images[f], grad=False)
                w = _trunc(s, pr.A, pr.seen & gate).to(dt)
                n = n + w
                sA = sA + w[:, None] * pr.A
            inv_n = 1.0 / torch.clamp(n, min=1.0)
            mean = sA * inv_n[:, None]
            for f in range(F):
                pr = project(problem, x, problem.vis[sl, f], state.R[f],
                             state.t[f], problem.images[f])
                w = (_trunc(s, pr.A, pr.seen & gate) & (n > 0)).to(dt)
                # dI/dp R^T, row by row: sum_k dI/dp[c, k] R[:, k]
                R = state.R[f]
                left = -(pr.dI_dp[..., 0:1] * R[:, 0] + pr.dI_dp[..., 1:2] * R[:, 1]
                         + pr.dI_dp[..., 2:3] * R[:, 2])             # [Vb, 3, 3]
                right = torch.linalg.cross(pr.dI_dp,
                                           pr.p[:, None, :].expand_as(pr.dI_dp))
                Jc = torch.cat([left, right], dim=-1)
                wh = (w * (1.0 - inv_n))[:, None, None]
                r = (w[:, None] * (pr.A - mean))[..., None]
                bH = _chunked_products(torch.cat([wh * Jc, r], dim=-1), Jc)
                H[f] += bH[:6]
                b[f] += bH[6]
                del pr, left, right, Jc
    return H, b


def apply_pose_systems(state: State, H, b, prec: Precision = FP32) -> State:
    """Each frame's 6x6 solve (in float32 at least: no solver takes
    bfloat16) and its step, a NaN step skipped."""
    st = torch.promote_types(H.dtype, torch.float32)
    eye = 1e-12 * torch.eye(6, dtype=st, device=H.device)
    delta = torch.linalg.solve_ex(H.to(st) + eye, b.to(st))[0].to(H.dtype)
    bad = torch.any(torch.isnan(delta), dim=-1, keepdim=True)
    delta = torch.where(bad, torch.zeros_like(delta), delta)
    with prec.products():
        R = state.R @ RS.so3_exp(-delta[:, 3:])
    return state._replace(R=R, t=state.t - delta[:, :3])


def pose_step(problem: Problem, state: State, s: Settings,
              prec: Precision = FP32, block: int = 1 << 21) -> State:
    H, b = pose_systems(problem, state, s, prec, block)
    return apply_pose_systems(state, H, b, prec)


def alternation(problem: Problem, state: State, s: Settings,
                prec: Precision = FP32, block: int = 1 << 21):
    """One pose step then one dist step, each followed by the energy:
    (state after the pose step, its energy, state after both, its energy)."""
    mid = pose_step(problem, state, s, prec, block)
    e_pose = float(energy(problem, mid, s, block))
    end = mid._replace(dist=dist_step(problem, mid, s, block))
    return mid, e_pose, end, float(energy(problem, end, s, block))


def solve(problem: Problem, state: State, s: Settings, alternations: int,
          prec: Precision = FP32, block: int = 1 << 21):
    """`optimize()` without its stop tests: the energy, then `alternations`
    alternations. Returns (final state, energies as optimize() records
    them: the first, then after each half-step)."""
    energies = [float(energy(problem, state, s, block))]
    for _ in range(alternations):
        _, e_pose, state, e = alternation(problem, state, s, prec, block)
        energies += [e_pose, e]
    return state, energies


def pair_counts(problem: Problem, state: State, s: Settings,
                block: int = 1 << 21) -> dict:
    """The pairs that take part in each pass on `state` under its gates:
    {"energy", "dist", "pose"} ("pose" is also the mean pass's)."""
    V, F = problem.vis.shape
    out = {"energy": 0, "dist": 0, "pose": 0}
    for sl in _blocks(V, block):
        dist = state.dist[sl]
        x = surface_points(_rows(problem, sl), dist, s.voxel_size)
        gate = torch.abs(dist) <= s.voxel_size
        for f in range(F):
            pr = project(problem, x, problem.vis[sl, f], state.R[f], state.t[f],
                         problem.images[f], grad=False)
            out["energy"] += int((pr.seen & gate).sum())
            out["dist"] += int(_trunc(s, pr.A, pr.seen).sum())
            out["pose"] += int(_trunc(s, pr.A, pr.seen & gate).sum())
    return out
