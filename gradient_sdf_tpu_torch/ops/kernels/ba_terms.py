"""ba_terms: PhotoBA's per-(voxel, frame) pass, as two kernels.

Every step of PhotoBA's alternation walks the (surface voxel, keyframe)
pairs: it projects the voxel's surface point into the frame, samples the
image with its analytic gradient, gates the pair and adds it into sums.
`ba_voxel_sums` adds the pairs of each voxel over the frames, in one of
three modes:
  * "energy": the total photometric energy (`photo_ba.energy`), a float32
    scalar [] on the device;
  * "dist": the dist step (`photo_ba.solve_dist`), the stepped dist [V];
  * "mean": the pose step's per-voxel count n [V] and mean intensity
    [V, 3] under its gates.
`ba_pose_systems` adds them per frame over the voxels: the decoupled pose
step's systems H [F, 6, 6] and b [F, 6] (`photo_ba.pose_systems`), from
the "mean" mode's n and mean.

The JAX package runs this pass as one compiled `lax.scan` over the frames
with per-voxel carries (`gradient_sdf_tpu/models/photo_ba.py:127-275`); it
has no TPU kernel. On the card it is the hand-written CUDA of
`csrc/ba_terms.cu` (see the note there: a warp a group of 32 voxels,
the frames gated first and the passing pairs' taps loaded in batches,
fixed-order reductions, no barrier a frame): on a CUDA
tensor each wrapper launches its kernel or raises; on a CPU tensor it takes
its plain version, `ba_voxel_sums_reference` or
`ba_pose_systems_reference`, built from `models/photo_ba`'s plain passes
over [F, V, ...] tensors.
"""

from __future__ import annotations

import ctypes

import torch

MODES = {"energy": 0, "dist": 1, "mean": 2}

# kernel launches since the last reset_launch_count(); the CPU path and the
# references do not count
launch_count = 0        # ba_voxel_sums
pose_launch_count = 0   # ba_pose_systems


def reset_launch_count():
    global launch_count, pose_launch_count
    launch_count = pose_launch_count = 0


class BAArgs(ctypes.Structure):
    """`BAArgs` of csrc/ba_terms.cu, field for field (all 8 bytes)."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "vox", "grad", "weight", "vmask", "vis", "images", "K", "dist", "R",
        "t")]
        + [(n, ctypes.c_int64) for n in (
            "V", "F", "H", "W", "trunc", "channel_mix")]
        + [(n, ctypes.c_double) for n in (
            "vs", "lambda_sq", "reg_weight", "damping")])


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------


def ba_voxel_sums_reference(problem, state, gcfg, pcfg, mode: str):
    """Plain version of `ba_voxel_sums`, all frames at once on [F, V, ...]
    tensors (`photo_ba`'s plain passes)."""
    from ...models import photo_ba as pba

    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is none of {sorted(MODES)}")
    x = pba._surface_points(problem, state.dist, gcfg.voxel_size)
    frames = (state.R, state.t, problem.images, problem.vis.T)
    if mode == "energy":
        # voxels with |dist| <= voxel_size: sum_j sum_i |A_ij - mean_j|^2
        gate = (torch.abs(state.dist) <= gcfg.voxel_size) & problem.vmask
        A, _, _, _, _, valid = pba._project_sample(problem, x, *frames)
        w = (valid & gate).to(torch.float32)             # [F, V]
        n = w.sum(dim=0)
        sA = (w[..., None] * A).sum(dim=0)
        sAA = (w * pba._dot3(A, A)).sum(dim=0)
        n_safe = torch.clamp(n, min=1.0)
        # sum_i |A_i - mean|^2 = sum|A|^2 - |sum A|^2/N >= 0 exactly; the
        # f32 cancellation can leave a tiny negative when residuals ~ 0
        e_per_vox = torch.clamp(sAA - pba._dot3(sA, sA) / n_safe, min=0.0)
        return torch.sum(torch.where(n > 0, e_per_vox, torch.zeros_like(n)))
    if mode == "mean":
        gate = (torch.abs(state.dist) <= gcfg.voxel_size) & problem.vmask
        A, _, _, _, _, valid = pba._project_sample(problem, x, *frames)
        n, _, mean_A = pba._voxel_means(
            A, pba._trunc_gate(pcfg, A, valid & gate))
        return n, mean_A
    # solveDist: an independent scalar GN step per voxel
    A, dI_dp, _, valid = pba._per_frame_terms(
        problem, x, *frames, channel_mix=pcfg.channel_mix_parity)
    valid = pba._trunc_gate(pcfg, A, valid)
    # Jd = dI_dp @ (-R^T g)  (unnormalized g, :181)
    Rtg = -pba._rows_times(problem.grad[None], state.R[:, None])  # [F, V, 3]
    Jd = pba._dot3(dI_dp, Rtg[..., None, :])                       # [F, V, 3]
    w = valid.to(torch.float32)[..., None]
    n = w[..., 0].sum(dim=0)
    sA = (w * A).sum(dim=0)
    sJ = (w * Jd).sum(dim=0)
    sAJ = (w * A * Jd).sum(dim=0)
    sJJ = (w * Jd * Jd).sum(dim=0)
    inv_n = 1.0 / torch.clamp(n, min=1.0)
    H = pba._sum3(sJJ) - inv_n * pba._dot3(sJ, sJ)
    b = pba._sum3(sAJ) - inv_n * pba._dot3(sA, sJ)
    H = H + pcfg.reg_weight * problem.weight
    step = torch.where((n > 0) & (H != 0.0), pcfg.damping * b / H,
                       torch.zeros_like(H))
    return state.dist - step


def ba_pose_systems_reference(problem, state, gcfg, pcfg, n, mean_A):
    """Plain version of `ba_pose_systems`: the pose Jacobians of all pairs
    [F, V, 3, 6], then the per-frame sums as sliced matrix products."""
    from ...models import photo_ba as pba

    A, dI_dp, p, valid = pba._pose_samples(problem, state, gcfg, pcfg)
    Jc = pba._pose_jacobian(dI_dp, p, state.R)
    inv_n = 1.0 / torch.clamp(n, min=1.0)
    w = (valid & (n > 0)).to(torch.float32)
    b, H = pba._weighted_systems(w, w * (1.0 - inv_n), A - mean_A, Jc)
    return H, b


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _args(problem, state, gcfg, pcfg):
    """The kernels' BAArgs and the tensors it points into (kept alive by
    the caller until the launch is queued). Raises on what the kernels do
    not take."""
    from . import _build

    lib = _build.load()
    dev = state.dist.device
    want = {"vox": torch.int32, "grad": torch.float32, "weight": torch.float32,
            "vmask": torch.bool, "vis": torch.bool, "images": torch.float32,
            "K": torch.float32}
    tensors = {}
    for name, dtype in want.items():
        tensors[name] = getattr(problem, name)
    for name in ("dist", "R", "t"):
        tensors[name] = getattr(state, name)
        want[name] = torch.float32
    for name, x in tensors.items():
        if x.device != dev or x.dtype != want[name]:
            raise ValueError(f"ba_terms: {name} is {x.dtype} on {x.device}, "
                             f"want {want[name]} on {dev}")
        tensors[name] = x.contiguous()
    V, F = tensors["vis"].shape
    Fi, H, W, C = tensors["images"].shape
    shapes = {"vox": (V, 3), "grad": (V, 3), "weight": (V,), "vmask": (V,),
              "K": (3, 3), "dist": (V,), "R": (F, 3, 3), "t": (F, 3)}
    bad = {k: tuple(tensors[k].shape) for k, s in shapes.items()
           if tuple(tensors[k].shape) != s}
    if bad or Fi != F or C != 3 or V < 1:
        raise ValueError(f"ba_terms: shapes {bad} (V = {V}, F = {F}), images "
                         f"{tuple(tensors['images'].shape)}")
    if F > lib.gsdf_ba_max_frames():
        raise ValueError(f"ba_terms: {F} frames, the kernels take at most "
                         f"{lib.gsdf_ba_max_frames()}")
    trunc = pcfg is not None and pcfg.loss == "trunc_l2"
    lam = pcfg.lambda_ if pcfg is not None else 0.0
    a = BAArgs(*[tensors[n].data_ptr() for n in (
        "vox", "grad", "weight", "vmask", "vis", "images", "K", "dist", "R",
        "t")],
        V, F, H, W, int(trunc),
        int(pcfg is not None and pcfg.channel_mix_parity),
        gcfg.voxel_size, lam * lam,
        pcfg.reg_weight if pcfg is not None else 0.0,
        pcfg.damping if pcfg is not None else 0.0)
    return lib, a, tensors, V, F


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def ba_voxel_sums(problem, state, gcfg, pcfg, mode: str):
    """The per-voxel frame sums of `mode` (module note) for a
    `photo_ba.BAProblem` and `BAState` on one device (`pcfg` may be None
    for "energy"). Returns the energy [] ("energy"), the stepped dist [V]
    ("dist") or (n [V], mean [V, 3]) ("mean"), on that device. On CUDA the
    kernel launches on the current stream without synchronizing."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is none of {sorted(MODES)}")
    if mode != "energy" and pcfg is None:
        raise ValueError(f"mode {mode!r} needs the PhotoBAConfig")
    dev = state.dist.device
    if dev.type == "cpu":
        return ba_voxel_sums_reference(problem, state, gcfg, pcfg, mode)
    if dev.type != "cuda":
        raise RuntimeError(f"ba_voxel_sums: no kernel for {dev}")
    lib, a, keep, V, F = _args(problem, state, gcfg, pcfg)
    f32 = dict(dtype=torch.float32, device=dev)
    out1 = partials = None
    if mode == "energy":
        out0 = torch.empty(1, **f32)
        # one energy partial a warp of 32 voxels
        partials = torch.empty(-(-V // 32), **f32)
    elif mode == "dist":
        out0 = torch.empty(V, **f32)
    else:
        out0, out1 = torch.empty(V, **f32), torch.empty((V, 3), **f32)
    global launch_count
    with torch.cuda.device(dev):
        rc = lib.gsdf_ba_voxel_sums_f32(
            ctypes.byref(a), MODES[mode], out0.data_ptr(),
            None if out1 is None else out1.data_ptr(),
            None if partials is None else partials.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"ba_voxel_sums kernel launch failed: CUDA error {rc}")
    launch_count += 1
    if mode == "energy":
        return out0[0]
    return out0 if mode == "dist" else (out0, out1)


def ba_pose_systems(problem, state, gcfg, pcfg, n, mean_A):
    """The decoupled pose step's per-frame systems (H [F, 6, 6], b [F, 6])
    from the "mean" mode's n [V] and mean [V, 3]. On CUDA the kernel and
    its fixed-order sum of the CTAs' partials launch on the current stream
    without synchronizing."""
    dev = state.dist.device
    if dev.type == "cpu":
        return ba_pose_systems_reference(problem, state, gcfg, pcfg, n, mean_A)
    if dev.type != "cuda":
        raise RuntimeError(f"ba_pose_systems: no kernel for {dev}")
    lib, a, keep, V, F = _args(problem, state, gcfg, pcfg)
    if (n.shape != (V,) or mean_A.shape != (V, 3) or n.device != dev
            or mean_A.device != dev or n.dtype != torch.float32
            or mean_A.dtype != torch.float32):
        raise ValueError(f"ba_pose_systems: n {n.dtype} {tuple(n.shape)}, "
                         f"mean {mean_A.dtype} {tuple(mean_A.shape)} on "
                         f"{n.device}; want float32 [{V}] and [{V}, 3] on {dev}")
    n, mean_A = n.contiguous(), mean_A.contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    partials = torch.empty((lib.gsdf_ba_ctas(V), F, 27), **f32)
    H = torch.empty((F, 6, 6), **f32)
    b = torch.empty((F, 6), **f32)
    global pose_launch_count
    with torch.cuda.device(dev):
        rc = lib.gsdf_ba_pose_systems_f32(
            ctypes.byref(a), n.data_ptr(), mean_A.data_ptr(),
            partials.data_ptr(), H.data_ptr(), b.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"ba_pose_systems kernel launch failed: CUDA error {rc}")
    pose_launch_count += 1
    return H, b
