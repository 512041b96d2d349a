"""Photometric bundle adjustment: joint keyframe-pose + SDF refinement.

Port of `gradient_sdf_tpu/models/photo_ba.py` (the reference's
`PhotometricOptimizer`, `cpp/include/ps_optimizer/PhotometricOptimizer.{h,cpp}`)
as vectorized PyTorch passes over (surface voxel x keyframe) pairs:

  * Surface point per voxel: x_j = voxel_center - dist_j * ghat_j, projected
    into keyframe i with camera-to-world pose (R_i, t_i)
    (`getIntensity`, :238-260).
  * Residual: RGB intensity A_ij minus the per-voxel mean over visible
    keyframes (zero-mean photoconsistency — albedo eliminated analytically;
    `getEnergy`, :273-321).
  * Jacobians are the closed forms the reference hand-derives: w.r.t. dist
    `Jd = dI * dpi * (-R^T g_j)` with *unnormalized* g ("gradient norm
    treated as constant", `computeJdOneFrame` :161-196); w.r.t. pose
    `Jc = [-dI dpi R^T, dI dpi skew(p)]` (`computeJc` :200-233). The image
    gradient dI is the exact derivative of the bilinear sampler.
  * solveDist: independent scalar GN per voxel with the mean-subtraction
    folded in: H = sum J^2 - (sum J)^2/N + reg_weight * weight_j,
    b = sum A.J - (sum A).(sum J)/N, dist -= damping * b/H (:326-388).
  * solvePose: decoupled per-frame 6x6 solves with the (1 - 1/N) diagonal
    factor (:499-590); solvePoseFull assembles the full 6Fx6F system with
    -1/N cross-frame blocks (:392-496). Decoupled is the default like the
    reference (:627-628).
  * optimize(): alternate solvePose / solveDist, track energy, stop on
    relative decrease < 5e-4, abort on divergence (:611-663).

Gating preserved: voxels participate when |dist| <= voxel_size (solvePose /
energy; solveDist is ungated like the reference), per-(voxel, frame)
visibility bits from fusion, in-image projection, and the TRUNC_L2 intensity
gate max_ch A^2 > lambda^2 in the solvers but not the energy (:364, :435,
:542 vs :273-321). Pose update as in the reference: t -= delta_t,
R <- R * exp(-omega) (right-multiplicative, :585-589). The first frame is a
keyframe in all arrays (see apps/photoba.py).

What changes in PyTorch: the JAX module scans the keyframes one by one
inside one compiled program. Here the per-(voxel, frame) pass of `energy`,
`solve_dist` and the decoupled pose step (`pose_systems`) goes through
`ops/kernels/ba_terms`: on the card two hand-written kernels that walk the
frames of a voxel in order and keep every intermediate in registers; on
the CPU their plain versions, which evaluate ALL frames at once on
[F, V, ...] tensors with the plain passes below and reduce over the frame
axis (float32 sums agree with the JAX package to tolerance, not bit for
bit). The plain passes write the products of the projection and the
frame sums elementwise, in the kernels' order, so that both take the same
pairs and the same image cells. The coupled system stays plain, with its
voxel chunking; its largest temporary is the pose Jacobian, F*V*72 bytes
(216 MB at F = 30, V = 100k). Float32 throughout: callers on the card
keep TF32 off (`apps/photoba.main`). With `mesh=` the optimizer shards the
voxel axis over the ranks (`parallel/sharding.sharded_ba_step`).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import GridConfig, PhotoBAConfig
from ..ops import voxel_grid as vg
from ..ops.filters import bilinear_sample_grad as _bilerp_rgb
from ..ops.kernels import ba_terms
from ..utils import se3, tumio


class BAProblem(NamedTuple):
    """Static per-run data for PhotoBA (tensors on one device; V voxels,
    F frames)."""

    vox: torch.Tensor       # int32 [V, 3] voxel indices
    grad: torch.Tensor      # f32 [V, 3] stored (unnormalized) gradients
    weight: torch.Tensor    # f32 [V] fusion weights
    vmask: torch.Tensor     # bool [V] true for real (non-padding) voxels
    vis: torch.Tensor       # bool [V, F] per-keyframe visibility
    images: torch.Tensor    # f32 [F, H, W, 3]
    K: torch.Tensor         # f32 [3, 3]


class BAState(NamedTuple):
    dist: torch.Tensor      # f32 [V] optimized SDF values
    R: torch.Tensor         # f32 [F, 3, 3] camera-to-world rotations
    t: torch.Tensor         # f32 [F, 3]


def _sum3(a):
    """a[..., 0] + a[..., 1] + a[..., 2], in that order."""
    return a[..., 0] + a[..., 1] + a[..., 2]


def _dot3(a, b):
    """The dot product over the last axis of 3, in the kernels' order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _rows_times(a, R):
    """a @ R for a [.., 3] and R [.., 3, 3] (broadcast), written out as
    a_0 R[0] + a_1 R[1] + a_2 R[2]: a matrix product would order its sums
    its own way on each device."""
    return (a[..., 0:1] * R[..., 0, :] + a[..., 1:2] * R[..., 1, :]
            + a[..., 2:3] * R[..., 2, :])


def _surface_points(problem: BAProblem, dist: torch.Tensor, voxel_size: float):
    g = problem.grad
    ghat = g / torch.clamp(torch.sqrt(_dot3(g, g)), min=1e-12)[:, None]
    return problem.vox.to(torch.float32) * voxel_size - dist[:, None] * ghat


def _project_sample(problem: BAProblem, x, Ri, ti, img, vis_i):
    """Project surface points into one frame, or into all of them, and
    sample the image there. Returns (A, dAdu, dAdv, p, z_inv, valid)."""
    K = problem.K
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    p = _rows_times(x - ti[..., None, :], Ri[..., None, :, :])  # R^T (x - t)
    z = p[..., 2]
    safe_z = torch.where(torch.abs(z) > 1e-12, z, torch.ones_like(z))
    z_inv = 1.0 / safe_z
    u = fx * p[..., 0] * z_inv + cx
    v = fy * p[..., 1] * z_inv + cy
    A, dAdu, dAdv, inb = _bilerp_rgb(img, u, v)
    valid = vis_i & inb & (z > 1e-12) & problem.vmask
    return A, dAdu, dAdv, p, z_inv, valid


def _per_frame_terms(problem: BAProblem, x: torch.Tensor, Ri, ti, img, vis_i,
                     channel_mix: bool = False):
    """All per-(voxel, frame) quantities: A, Jd factor pieces, validity.

    One frame: Ri [3,3], ti [3], img [H,W,3], vis_i [V]; or all frames at
    once with a leading F axis on each (vis_i [F,V]). Returns A [..,V,3],
    dI_dp (the 3x3 `image_grad @ pi_grad` matrix) [..,V,3,3], point_cam
    [..,V,3], valid [..,V].

    `channel_mix` replicates the reference's `computeImageGradient`
    channel REVERSAL (`Vec3f(v0[2],v0[1],v0[0])`,
    PhotometricOptimizer.cpp:102-126): its image gradients come back
    BGR-reversed while residuals keep native order. Default OFF —
    residual-consistent gradients; ON (PhotoBAConfig.channel_mix_parity)
    makes per-iteration BA steps gateable against the reference binary on
    COLORED data (on grayscale the two coincide).
    """
    K = problem.K
    fx, fy = K[0, 0], K[1, 1]
    A, dAdu, dAdv, p, z_inv, valid = _project_sample(problem, x, Ri, ti, img,
                                                     vis_i)
    # dI/dp_cam = dAdu * dpi_u/dp + dAdv * dpi_v/dp   -> [.., V, 3(ch), 3(xyz)]
    z_inv_sq = z_inv * z_inv
    zero = torch.zeros_like(z_inv)
    du_dp = torch.stack([fx * z_inv, zero, -fx * p[..., 0] * z_inv_sq], dim=-1)
    dv_dp = torch.stack([zero, fy * z_inv, -fy * p[..., 1] * z_inv_sq], dim=-1)
    dI_dp = (dAdu[..., None] * du_dp[..., None, :]
             + dAdv[..., None] * dv_dp[..., None, :])
    if channel_mix:
        dI_dp = torch.flip(dI_dp, dims=(-2,))
    return A, dI_dp, p, valid


def _trunc_gate(pcfg: PhotoBAConfig, A, valid):
    """The solvers' TRUNC_L2 intensity gate (reference :364-365, :435, :542)."""
    if pcfg.loss != "trunc_l2":
        return valid
    return valid & (torch.amax(A * A, dim=-1) <= pcfg.lambda_ * pcfg.lambda_)


def _voxel_means(A, valid):
    """Per-voxel count, 1 / count and mean intensity over the frames of the
    pairs in `valid` [F, V]."""
    w = valid.to(torch.float32)
    n = w.sum(dim=0)
    inv_n = 1.0 / torch.clamp(n, min=1.0)
    return n, inv_n, (w[..., None] * A).sum(dim=0) * inv_n[:, None]


def _pose_samples(problem: BAProblem, state: BAState, gcfg, pcfg):
    """All frames' A [F,V,3], dI_dp [F,V,3,3] and point_cam [F,V,3], and
    valid [F,V] under the pose step's gates (|dist| <= voxel_size, TRUNC_L2)."""
    x = _surface_points(problem, state.dist, gcfg.voxel_size)
    gate = (torch.abs(state.dist) <= gcfg.voxel_size) & problem.vmask
    A, dI_dp, p, valid = _per_frame_terms(
        problem, x, state.R, state.t, problem.images, problem.vis.T,
        channel_mix=pcfg.channel_mix_parity)
    return A, dI_dp, p, _trunc_gate(pcfg, A, valid & gate)


def _pose_jacobian(dI_dp, p, R):
    """Jc = [-dI_dp R^T | dI_dp skew(p)] [F,V,3,6]."""
    F, V = p.shape[:2]
    left = -(dI_dp.reshape(F, V * 3, 3) @ R.transpose(-1, -2))
    # row d of dI_dp times skew(p) is d x p: the products of dI_dp @ hat(p)
    # without its zero terms
    right = torch.linalg.cross(dI_dp, p[..., None, :].expand_as(dI_dp))
    return torch.cat([left.reshape(F, V, 3, 3), right], dim=-1)


def energy(problem: BAProblem, state: BAState, gcfg: GridConfig) -> torch.Tensor:
    """Total photometric energy (getEnergy, :273-321): voxels with
    |dist| <= voxel_size, E = sum_j sum_i |A_ij - mean_j|^2 (a float32
    scalar on the problem's device)."""
    return ba_terms.ba_voxel_sums(problem, state, gcfg, None, "energy")


def solve_dist(problem: BAProblem, state: BAState, gcfg: GridConfig,
               pcfg: PhotoBAConfig) -> BAState:
    """One SDF half-step (solveDist, :326-388): per voxel
    H = sum J^2 - (sum J)^2/N + reg_weight * weight,
    b = sum A.J - (sum A).(sum J)/N, dist -= damping * b/H."""
    return state._replace(
        dist=ba_terms.ba_voxel_sums(problem, state, gcfg, pcfg, "dist"))


def _pose_terms(problem: BAProblem, state: BAState, gcfg, pcfg):
    """Shared pass of the coupled pose step, all frames at once: A [F,V,3],
    Jc [F,V,3,6] and valid [F,V] under the solvers' gates, and the
    per-voxel count, 1/count and mean intensity."""
    A, dI_dp, p, valid = _pose_samples(problem, state, gcfg, pcfg)
    n, inv_n, mean_A = _voxel_means(A, valid)
    return A, _pose_jacobian(dI_dp, p, state.R), valid, n, inv_n, mean_A


# rows of the (voxel, channel) axis per partial product in _weighted_systems
_SPLIT_ROWS = 4096


def _weighted_systems(w, wh, r, Jc):
    """Per-frame b = sum_v w r^T Jc [F,6] and H = sum_v wh Jc^T Jc [F,6,6],
    as float32 matrix products over the (voxel, channel) axis.

    The axis is 3V long (307200 at V = 100k) and the result 7 x 6, a shape
    one batched product handles badly (10.8 ms on an H100 at F = 30,
    against 2.0 ms this way; `tools/ba_bench.py`). So the axis is cut into
    slices of `_SPLIT_ROWS` rows (zero-padded to a whole number), every
    slice gives a partial [7, 6] product in one batched call, and the
    partials are summed."""
    F = Jc.shape[0]
    J = Jc.reshape(F, -1, 6)
    lhs = torch.cat([(wh[..., None, None] * Jc).reshape(F, -1, 6),
                     (w[..., None] * r).reshape(F, -1, 1)], dim=-1)
    pad = (-J.shape[1]) % _SPLIT_ROWS
    if pad:
        J = torch.nn.functional.pad(J, (0, 0, 0, pad))
        lhs = torch.nn.functional.pad(lhs, (0, 0, 0, pad))
    prod = (lhs.reshape(-1, _SPLIT_ROWS, 7).transpose(-1, -2)
            @ J.reshape(-1, _SPLIT_ROWS, 6)).reshape(F, -1, 7, 6).sum(dim=1)
    return prod[:, 6], prod[:, :6]


def pose_systems(problem: BAProblem, state: BAState, gcfg: GridConfig,
                 pcfg: PhotoBAConfig):
    """The decoupled pose step's per-frame systems (H [F,6,6], b [F,6]):
    H = sum (1 - 1/N) Jc^T Jc and b = sum r^T Jc over the voxels, so a
    voxel-sharded step adds the ranks' ones. Two passes: the per-voxel
    count and mean, then the systems."""
    n, mean_A = ba_terms.ba_voxel_sums(problem, state, gcfg, pcfg, "mean")
    return ba_terms.ba_pose_systems(problem, state, gcfg, pcfg, n, mean_A)


def apply_pose_systems(state: BAState, H: torch.Tensor,
                       b: torch.Tensor) -> BAState:
    """Solve every frame's 6x6 system and apply the steps."""
    eye = 1e-12 * torch.eye(6, dtype=H.dtype, device=H.device)
    # solve_ex does not raise on a singular H: a NaN step is skipped below
    delta = torch.linalg.solve_ex(H + eye, b)[0]
    return _apply_pose_delta(state, delta)


def solve_pose(problem: BAProblem, state: BAState, gcfg: GridConfig,
               pcfg: PhotoBAConfig) -> BAState:
    """Decoupled per-frame pose half-step (solvePose, :499-590)."""
    return apply_pose_systems(state, *pose_systems(problem, state, gcfg, pcfg))


def _pose_full_system(problem: BAProblem, state: BAState, gcfg: GridConfig,
                      pcfg: PhotoBAConfig, *, chunk: int = 8192):
    """Assemble the coupled 6Fx6F system (solvePoseFull, :392-496):
    diagonal blocks (1 - 1/N_j) Jc_i^T Jc_i, cross blocks
    -1/N_j Jc_i1^T Jc_i2. Returns (Hfull [6F,6F], bfull [6F]).

    The cross term multiplies all frames' Jacobians per voxel; the voxel
    axis is walked in `chunk`-sized slices, each folding its
    [chunk*3, 6F] Jacobian matrix into the running accumulators. The
    assembled system is chunk-size invariant (pure sums, up to f32
    summation order)."""
    A, Jc, valid, n, inv_n, mean_A = _pose_terms(problem, state, gcfg, pcfg)
    F, V = valid.shape
    w = (valid & (n > 0)).to(torch.float32)
    r = A - mean_A
    dev = Jc.device
    b = torch.zeros((F, 6), dtype=torch.float32, device=dev)
    Hdiag = torch.zeros((F, 6, 6), dtype=torch.float32, device=dev)
    cross = torch.zeros((6 * F, 6 * F), dtype=torch.float32, device=dev)
    chunk = max(1, min(chunk, V))
    for lo in range(0, V, chunk):
        sl = slice(lo, lo + chunk)
        wc, Jcc = w[:, sl], Jc[:, sl]
        bc, hd = _weighted_systems(wc, wc, r[:, sl], Jcc)
        # rows (voxel, channel), columns (frame, twist): M^T diag(1/N) M is
        # the [6F, 6F] matrix of every frame pair's cross block
        M = (wc[..., None, None] * Jcc).permute(1, 2, 0, 3).reshape(-1, 6 * F)
        invn3 = inv_n[sl].repeat_interleave(3)
        b += bc
        Hdiag += hd
        cross += (M * invn3[:, None]).T @ M
    return torch.block_diag(*Hdiag) - cross, b.reshape(6 * F)


def solve_pose_full(problem: BAProblem, state: BAState, gcfg: GridConfig,
                    pcfg: PhotoBAConfig, *, chunk: int = 8192) -> BAState:
    """Coupled pose step: assemble the 6Fx6F system (voxel-chunked, see
    _pose_full_system) and solve."""
    F = problem.images.shape[0]
    Hfull, bfull = _pose_full_system(problem, state, gcfg, pcfg, chunk=chunk)
    eye = 1e-9 * torch.eye(6 * F, dtype=Hfull.dtype, device=Hfull.device)
    delta = torch.linalg.solve_ex(Hfull + eye, bfull)[0].reshape(F, 6)
    return _apply_pose_delta(state, delta)


def _apply_pose_delta(state: BAState, delta: torch.Tensor) -> BAState:
    """Reference update (:585-589 / :487-494): t -= dt, R <- R exp(-w);
    NaN deltas skipped per frame."""
    bad = torch.any(torch.isnan(delta), dim=-1, keepdim=True)
    delta = torch.where(bad, torch.zeros_like(delta), delta)
    Rd = se3.so3_exp(-delta[:, 3:])
    return state._replace(R=state.R @ Rd, t=state.t - delta[:, :3])


class PhotometricOptimizer:
    """The optimization loop of PhotometricOptimizer::optimize (:611-663)."""

    def __init__(self, problem: BAProblem, state: BAState, gcfg: GridConfig,
                 pcfg: PhotoBAConfig, *, coupled_poses: bool = False,
                 verbose: bool = True, mesh=None, save_path=None,
                 key_stamps=None):
        """With `mesh` (a `parallel.mesh.Mesh`; every rank passes the same
        whole problem and state) each rank keeps its slice of the voxel
        axis in `problem`/`state` and every step is `sharded_ba_step`;
        `full_state()` gathers the whole dist vector. The sharded step is
        the decoupled one."""
        if mesh is not None:
            from ..parallel import sharding

            if coupled_poses:
                raise ValueError("the voxel-sharded BA step is the decoupled "
                                 "one (no coupled_poses with a mesh)")
            problem, state = sharding.shard_ba(mesh, problem, state)
        self.mesh = mesh
        self.problem = problem
        self.state = state
        self.gcfg = gcfg
        self.pcfg = pcfg
        self.energies: list = []
        self.verbose = verbose
        # pose-snapshot sink (reference savePoses, :592-609): directory +
        # per-keyframe timestamps; None disables the snapshot writes
        self.save_path = save_path
        self.key_stamps = key_stamps
        self._solve_pose = solve_pose_full if coupled_poses else solve_pose

    def _energy(self) -> float:
        e = energy(self.problem, self.state, self.gcfg)
        if self.mesh is not None:
            from ..parallel import mesh as mesh_mod

            e = mesh_mod.psum(e.reshape(1), self.mesh)[0]
        return float(e)

    def _iteration(self):
        """One pose+dist step; returns (E_after_pose, E_after_dist)."""
        if self.mesh is not None:
            from ..parallel import sharding

            self.state, e_pose, e_dist = sharding.sharded_ba_step(
                self.mesh, self.problem, self.state, self.gcfg, self.pcfg)
            return float(e_pose), float(e_dist)
        self.state = self._solve_pose(self.problem, self.state, self.gcfg,
                                      self.pcfg)
        e_pose = self._energy()
        self.state = solve_dist(self.problem, self.state, self.gcfg, self.pcfg)
        return e_pose, self._energy()

    def full_state(self) -> BAState:
        """The state with the whole dist vector (on a mesh: gathered from
        every rank's slice, so every rank must call it)."""
        if self.mesh is None:
            return self.state
        from ..parallel import sharding

        return sharding.gather_ba_state(self.mesh, self.state)

    def save_poses(self, filename: str) -> bool:
        """Snapshot the CURRENT optimizer poses as a TUM trajectory —
        mirror of `PhotometricOptimizer::savePoses` (:592-609), called at
        the same points the reference calls it: once before BA (:614) and
        at every optimize() exit (:647 converge, :653 diverge, :660
        iteration cap), so a killed/aborted run still leaves the latest
        pose state on disk."""
        if self.save_path is None or self.key_stamps is None:
            return False
        R = self.state.R.cpu().numpy()
        t = self.state.t.cpu().numpy()
        entries = [(stamp, R[i], t[i])
                   for i, stamp in enumerate(self.key_stamps)]
        tumio.write_trajectory(
            os.path.join(self.save_path, filename + ".txt"), entries)
        if self.verbose:
            print("poses file is successfully saved!")
        return True

    def optimize(self) -> bool:
        # save poses before optimization for comparison (:614)
        self.save_poses("selected_frame_poses_before_optimization")
        E = self._energy()
        self.energies.append(E)
        if self.verbose:
            print(f"Energy before BA: {E}")
        for it in range(self.pcfg.max_iterations):
            e_pose, E = self._iteration()
            self.energies.append(e_pose)
            if self.verbose:
                print(f"Energy after {it} iterations of coarse BA (pose): {e_pose}")
            self.energies.append(E)
            if self.verbose:
                print(f"Energy after {it} iterations of coarse BA (dist): {E}")
            # reference (:649): rel_diff = |E_pose - E_dist| / E_pose, where
            # E_pose is the energy after this iteration's pose step
            rel_diff = abs(e_pose - E) / max(e_pose, 1e-30)
            if rel_diff < self.pcfg.conv_threshold:
                if self.verbose:
                    print(f"converged after {it} iterations")
                self.save_poses("coarse_BA_poses_optimized")     # :647
                return True
            if e_pose < E:
                if self.verbose:
                    print(f"DIVERGE after {it} iterations")
                self.save_poses("coarse_BA_poses_optimized")     # :653
                return False
        self.save_poses("coarse_BA_poses_optimized")             # :660
        return False


def keyframe_visibility(grid: vg.VoxelGrid, vis_bits: torch.Tensor,
                        kf_slots) -> np.ndarray:
    """Visibility bitfield of the allocated blocks -> host bool
    [num_active * B^3, len(kf_slots)], one row per voxel. `vis_bits` is
    int32 [num_blocks, B^3, words] holding uint32 bit patterns (slot 31
    reads negative), so the words are reinterpreted as unsigned first."""
    na = int(grid.num_active)
    words = vis_bits[:na].reshape(na * vis_bits.shape[1], -1).cpu().numpy()
    words = words.view(np.uint32)
    vis = np.zeros((len(words), len(kf_slots)), dtype=bool)
    for i, s in enumerate(kf_slots):
        vis[:, i] = (words[:, s // 32] >> np.uint32(s % 32)) & np.uint32(1)
    return vis


def build_problem(
    grid: vg.VoxelGrid,
    vis_bits: torch.Tensor,    # int32 [num_blocks, B^3, words], uint32 bits
    kf_slots: list,            # keyframe slots to optimize over
    images: np.ndarray,        # [F, H, W, 3] float32
    poses: list,               # [(R, t)] camera-to-world per keyframe
    K: np.ndarray,
    gcfg: GridConfig,
    *,
    band_voxels: float = 3.0,
    pad_to: int = 1024,
) -> Tuple[BAProblem, BAState]:
    """Host-side compaction: select voxels near the surface
    (|dist| <= band_voxels * voxel_size and weight > 0), gather their
    visibility bits for the chosen keyframe slots, and upload to the grid's
    device. V is padded to a multiple of `pad_to` with `vmask` false, as the
    JAX package does for its static shapes: the two packages' problems then
    agree array for array."""
    dev = grid.device
    vox, dist, weight, grad = vg.host_voxels(grid, gcfg)
    sel = (weight > 0) & (np.abs(dist) <= band_voxels * gcfg.voxel_size)
    vox, dist, weight, grad = vox[sel], dist[sel], weight[sel], grad[sel]
    vis = keyframe_visibility(grid, vis_bits, kf_slots)[sel]

    V = len(vox)
    Vp = max(pad_to, int(np.ceil(V / pad_to)) * pad_to)
    pad = Vp - V

    def padded(a, dtype):
        a = np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))
        return torch.as_tensor(a, dtype=dtype, device=dev)

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    problem = BAProblem(
        vox=padded(vox, torch.int32),
        grad=padded(grad, torch.float32),
        weight=padded(weight, torch.float32),
        vmask=torch.as_tensor(np.arange(Vp) < V, device=dev),
        vis=padded(vis, torch.bool),
        images=f32(images),
        K=f32(K),
    )
    state = BAState(
        dist=padded(dist, torch.float32),
        R=f32(np.stack([np.asarray(p[0]) for p in poses])),
        t=f32(np.stack([np.asarray(p[1]) for p in poses])),
    )
    return problem, state


def write_back_dist(grid: vg.VoxelGrid, problem: BAProblem, state: BAState,
                    gcfg: GridConfig) -> vg.VoxelGrid:
    """Write optimized dist values back into the sparse grid, in place
    (padding and voxels that are no longer present are masked out before
    the write). Returns the grid."""
    lin, present = vg.lookup_voxels(grid, problem.vox, gcfg)
    ok = problem.vmask & present
    vg.flat_field(grid.dist)[lin[ok].long()] = state.dist[ok]
    return grid
