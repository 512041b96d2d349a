#!/usr/bin/env python3
"""Card measurements of one PhotoBA alternation and of its two kernels
(needs one CUDA card).

    python3 gradient_sdf_tpu_torch/tools/ba_bench.py [--frames F] [--voxels V]
        [--kernels [DIR ...]] [--sweep] [--phase6] [--parent DIR] [--out FILE]

The problem is the scale point of the JAX package's benchmark: F = 30
keyframes of 640x480 random images, V = 102400 surface voxels with random
indices in [-60, 60), random gradients, weights in [1, 20], 40% visibility,
dist within +-5 mm at 1 cm voxels, identity rotations and translations
within +-10 cm, all drawn from numpy `RandomState(11)` in that order. One
alternation is what `PhotometricOptimizer._iteration` runs: `solve_pose`,
`energy`, `solve_dist`, `energy`, each energy read back to the host.

It prints the card's name and power limit, then one JSON line of this
tree's alternation (`tree_report`): its time (host clock around
device-synchronized work, median of 5 after a warm-up); the device time of
each of its calls and, where the tree has them, of the kernels inside them
(`device_split`, CUDA events); from `torch.profiler` over one alternation
the number of kernels, the device-busy time and share, the host
synchronizations and the kernels that take most device time; and the peak
of `torch.cuda.max_memory_allocated` over one alternation, above what the
problem and state hold.

`--kernels` adds each kernel of `ops/kernels/ba_terms` (`ba_voxel_sums` in
its three modes, `ba_pose_systems`) held to its plain version
(`kernel_errors`) and timed beside its bound (`ba_sums_bound_ms`,
`pose_systems_bound_ms`: bytes, operations, the distinct 32-byte sectors
of the image taps), the plain version and an empty launch at its grid
(`kernel_report`), at the scale point and on phase 6b's problem of
`chip_smoke.py` (`textured_problem`: textured spheres, BA started ~3 mm
off). Then it takes apart the kernels of each tree DIR (this one if none;
with `--parent P` and no DIR, P and this one) by one-switch builds of a
copy of DIR's `csrc/ba_terms.cu` under this tree's build directory
(`BA_SWITCHES`, one set per design; the package's source is never
switched), launched through this tree's wrapper: each build's kernels
timed at the scale point, the unswitched ones held to the plain versions
and to the first tree's outputs and timed in turns (roots in order, then
in reverse) at the scale point, on phase 6b's problem and on the scale
point's data cut to 8 frames, with the ptxas report and the CTAs an SM
holds (occupancy API) and the waves at V and V / 4 (`kernel_split`). `--parent DIR` (an earlier checkout, e.g.
unpacked with `git archive`) also runs `tree_report` of DIR's tree and of
this one in turns, parent, this, this, parent, each in its own process
through its own package (`--tree DIR` is what the script passes to
itself). `--out FILE` writes the whole JSON there too.

`--sweep` times this tree's kernels with every launch forced onto the
dense and onto the full-card paths (two switches of `BA_SWITCHES`) on the
scale point's data cut to each of `SWEEP_FRAMES` x `SWEEP_VOXELS`
(`path_sweep`): where the two paths cross.

`--phase6` runs `chip_smoke.py`'s phase 6 (the PhotoBA app on 14 VGA
frames of flat-coloured spheres, `phase6_data`) in each tree in turns
(parent, this, this, parent with `--parent`, else this twice), each in a
process of its own (`phase6_report`): the app's BA energies and its BA
timer, the process's first BA; then, on one BA problem shared by all turns
(the first turn's, saved under `smoke_out/ba_bench/phase6`), the
optimizer's energies, final poses and wall time, run twice, and one
alternation's host time (`phase6_compare` sets the trees' results side by
side).
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OWN_ROOT = os.path.dirname(os.path.dirname(HERE))
WIDTH, HEIGHT = 640, 480


def bench_arrays(F=30, V=100 * 1024, seed=11):
    """(problem, state) as dicts of numpy arrays under the field names of
    `BAProblem` / `BAState`."""
    import numpy as np
    from gradient_sdf_tpu_torch.data import synth

    rng = np.random.RandomState(seed)
    vox = rng.randint(-60, 60, size=(V, 3)).astype(np.int32)
    grad = rng.randn(V, 3).astype(np.float32)
    problem = dict(
        vox=vox, grad=grad,
        weight=rng.uniform(1, 20, V).astype(np.float32),
        vmask=np.ones((V,), bool),
        vis=rng.rand(V, F) < 0.4,
        images=rng.rand(F, HEIGHT, WIDTH, 3).astype(np.float32),
        K=np.asarray(synth.KINECT_K, np.float32),
    )
    state = dict(
        dist=rng.uniform(-0.005, 0.005, V).astype(np.float32),
        R=np.tile(np.eye(3, dtype=np.float32), (F, 1, 1)),
        t=rng.uniform(-0.1, 0.1, (F, 3)).astype(np.float32),
    )
    return problem, state


def bench_configs():
    from gradient_sdf_tpu_torch.config import GridConfig, PhotoBAConfig

    return GridConfig(voxel_size=0.01), PhotoBAConfig()


def textured_data(out):
    """Phase 6b's data (`chip_smoke.py`): 8 VGA frames of the spheres with a
    grey texture over a 6 degree arc, and `ba_init.txt`, the ground-truth
    poses with each translation moved by ~3 mm (`RandomState(3)`)."""
    import numpy as np
    from gradient_sdf_tpu_torch.apps import make_synth
    from gradient_sdf_tpu_torch.utils import tumio

    make_synth.main(["--out", out, "--frames", "8", "--seed", "2", "--width",
                     "640", "--height", "480", "--arc-deg", "6", "--no-noise",
                     "--gray-texture", "--device", "cuda"])
    gt = tumio.read_trajectory(os.path.join(out, "gt_poses.txt"))
    rng = np.random.RandomState(3)
    tumio.write_trajectory(
        os.path.join(out, "ba_init.txt"),
        [(ts, R, t + (rng.randn(3) * 0.003).astype(np.float32))
         for ts, R, t in gt])
    return gt


# the PhotoBA app's flags of phase 6b, after its data folder
TEXTURED_FLAGS = ["--data-type", "synth", "--voxel-size", "0.02", "--trunc",
                  "5", "--key-frame", "4", "--pose-file", "gt_poses.txt",
                  "--ba-init-pose-file", "ba_init.txt"]


def textured_problem():
    """(problem, state, gcfg) of phase 6b: the BA problem and initial state
    the PhotoBA app builds (`photo_ba.build_problem`) from `textured_data`,
    fused on the card; the app runs to its end under `smoke_out/ba_bench`."""
    from gradient_sdf_tpu_torch.apps import photoba
    from gradient_sdf_tpu_torch.models import photo_ba

    work = os.path.join(OWN_ROOT, "smoke_out", "ba_bench")
    data, results = os.path.join(work, "textured"), os.path.join(work, "results")
    os.makedirs(results, exist_ok=True)
    textured_data(data)
    build, kept = photo_ba.build_problem, {}

    def keeping(*a, **kw):
        kept["problem"], kept["state"] = out = build(*a, **kw)
        kept["gcfg"] = a[6]
        return out

    photo_ba.build_problem = keeping
    try:
        photoba.main(["--input", data, "--results", results] + TEXTURED_FLAGS)
    finally:
        photo_ba.build_problem = build
    return kept["problem"], kept["state"], kept["gcfg"]


def alternation(problem, state, gcfg, pcfg):
    """solve_pose -> energy -> solve_dist -> energy, as the optimizer's
    iteration: returns (state, E after the pose step, E after the dist
    step), both energies as host floats."""
    from gradient_sdf_tpu_torch.models import photo_ba

    state = photo_ba.solve_pose(problem, state, gcfg, pcfg)
    e_pose = float(photo_ba.energy(problem, state, gcfg))
    state = photo_ba.solve_dist(problem, state, gcfg, pcfg)
    return state, e_pose, float(photo_ba.energy(problem, state, gcfg))


def alternation_ms(problem, state, gcfg, pcfg, runs=5):
    """Median host-clock ms of one alternation on the card, each run ending
    synchronized, after one warm-up run."""
    import torch

    times = []
    for i in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alternation(problem, state, gcfg, pcfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times = sorted(times[1:])
    return times[len(times) // 2], times


# host calls that wait for the device
SYNC_KEYS = ("aten::_local_scalar_dense", "aten::item", "cudaStreamSynchronize",
             "cudaDeviceSynchronize", "cudaEventSynchronize")


def profile_alternation(problem, state, gcfg, pcfg):
    """One alternation under `torch.profiler` (see `profile_call`)."""
    return profile_call(lambda: alternation(problem, state, gcfg, pcfg))


def profile_call(fn, top: int = 8):
    """One `fn()` under `torch.profiler`, after a warm-up call: kernels
    launched, device-busy ms and share of the wall time, host
    synchronizations, the `top` kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows, syncs, launches = [], {}, 0
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0 and e.device_type == DeviceType.CUDA:
            rows.append((dev_us / 1e3, e.count, e.key))
        elif e.key in SYNC_KEYS:
            syncs[e.key] = e.count
        elif e.key == "cudaLaunchKernel":
            launches = e.count
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return {
        "profiled_wall_ms": wall,
        "device_busy_ms": busy,
        "device_busy_share": busy / wall,
        "device_events": sum(r[1] for r in rows),
        "cudaLaunchKernel_calls": launches,
        "host_syncs": syncs,
        "top": [{"ms": r[0], "count": r[1], "name": r[2][:70]} for r in rows[:top]],
    }


def has_kernels() -> bool:
    """Whether the package on the path has the BA kernels (a parent tree
    may predate them)."""
    return importlib.util.find_spec(
        "gradient_sdf_tpu_torch.ops.kernels.ba_terms") is not None


def device_split(problem, state, gcfg, pcfg):
    """Device ms (CUDA events) of the alternation's calls and, where the
    tree has them, of the kernel calls inside them: per alternation
    `ba_voxel_sums` runs in mode "mean" once (in `solve_pose`), "dist" once
    and "energy" twice, and `ba_pose_systems` once."""
    from gradient_sdf_tpu_torch.models import photo_ba
    from gradient_sdf_tpu_torch.tools.fusion_bench import median_ms

    out = {
        "solve_pose_ms": median_ms(
            lambda: photo_ba.solve_pose(problem, state, gcfg, pcfg), reps=3),
        "pose_systems_ms": median_ms(
            lambda: photo_ba.pose_systems(problem, state, gcfg, pcfg), reps=3),
        "energy_ms": median_ms(
            lambda: photo_ba.energy(problem, state, gcfg), reps=3),
        "solve_dist_ms": median_ms(
            lambda: photo_ba.solve_dist(problem, state, gcfg, pcfg), reps=3),
    }
    out["alternation_device_ms"] = (out["solve_pose_ms"] + out["solve_dist_ms"]
                                    + 2 * out["energy_ms"])
    if not has_kernels():
        return out
    from gradient_sdf_tpu_torch.ops.kernels import ba_terms as bt

    n, mean = bt.ba_voxel_sums(problem, state, gcfg, pcfg, "mean")
    for mode in bt.MODES:
        out[f"ba_voxel_sums_{mode}_ms"] = median_ms(
            lambda: bt.ba_voxel_sums(problem, state, gcfg, pcfg, mode), reps=3)
    out["ba_pose_systems_ms"] = median_ms(
        lambda: bt.ba_pose_systems(problem, state, gcfg, pcfg, n, mean), reps=3)
    out["kernel_share"] = (
        (2 * out["ba_voxel_sums_energy_ms"] + out["ba_voxel_sums_dist_ms"]
         + out["ba_voxel_sums_mean_ms"] + out["ba_pose_systems_ms"])
        / out["alternation_device_ms"])
    return out


def peak_memory(problem, state, gcfg, pcfg):
    """MB of device memory: allocated before one alternation (the problem,
    the state and the allocator's leftovers), and the peak of
    `max_memory_allocated` during it above that."""
    import torch

    alternation(problem, state, gcfg, pcfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    alternation(problem, state, gcfg, pcfg)
    torch.cuda.synchronize()
    return {"allocated_before_mb": base / 2 ** 20,
            "alternation_peak_above_mb":
                (torch.cuda.max_memory_allocated() - base) / 2 ** 20}


def tree_report(frames, voxels):
    """This process's package at the scale point: the alternation's host
    ms, device split, profile and peak memory (module note)."""
    from gradient_sdf_tpu_torch.utils import interop

    problem, state = bench_arrays(frames, voxels)
    problem = interop.problem_from_numpy(problem, "cuda")
    state = interop.state_from_numpy(state, "cuda")
    gcfg, pcfg = bench_configs()
    ms, runs = alternation_ms(problem, state, gcfg, pcfg)
    out = {"frames": frames, "voxels": voxels, "kernels": has_kernels(),
           "alternation_ms": ms, "alternation_runs_ms": runs}
    out.update(device_split(problem, state, gcfg, pcfg))
    out.update(profile_alternation(problem, state, gcfg, pcfg))
    out.update(peak_memory(problem, state, gcfg, pcfg))
    return out


# ---------------------------------------------------------------------------
# the kernels' bounds
# ---------------------------------------------------------------------------

# float32 operations of one (voxel, frame) pair, counted from
# csrc/ba_terms.cu (built without fused multiply-adds, so each is one
# issue): the sample 67 (x - t 3, p 15, the safe z and 1/z 3, u and v 6,
# the gates 5, clamps 4, floors 2, fractions 2, three channels' lerps 27);
# the intensity gate 6; dA/du and dA/dv 26; dI/dp 24.
SAMPLE_OPS, TRUNC_OPS, GRAD_OPS, JAC_OPS = 67, 6, 26, 24
PAIR_OPS = {
    "energy": SAMPLE_OPS + 9,                       # n, sum A, sum |A|^2
    "mean": SAMPLE_OPS + TRUNC_OPS + 4,             # n, sum A
    # -R^T g 18, Jd 15, five sums 19
    "dist": SAMPLE_OPS + TRUNC_OPS + GRAD_OPS + JAC_OPS + 18 + 15 + 19,
    # Jc 81, H's 21 entries 168, b's 6 30, r 3
    "pose": SAMPLE_OPS + TRUNC_OPS + GRAD_OPS + JAC_OPS + 81 + 168 + 30 + 3,
}
VOXEL_OPS = 30   # the surface point and the voxel's closing arithmetic


def participating_pairs(problem, state, gcfg, pcfg, mode):
    """(pairs, distinct sectors): the (voxel, frame) pairs that take part
    in `mode` ("energy", "dist", "mean" or "pose") on these inputs, under
    its gates, and the distinct 32-byte sectors of images their four taps
    touch (12 bytes each, two sectors where one straddles), from the plain
    passes."""
    import torch
    from gradient_sdf_tpu_torch.models import photo_ba as pba

    x = pba._surface_points(problem, state.dist, gcfg.voxel_size)
    A, _, _, p, z_inv, valid = pba._project_sample(
        problem, x, state.R, state.t, problem.images, problem.vis.T)
    if mode != "dist":
        valid = valid & (torch.abs(state.dist) <= gcfg.voxel_size)
    if mode != "energy":
        valid = pba._trunc_gate(pcfg, A, valid)
    F, H, W, _ = problem.images.shape
    K = problem.K
    u = (K[0, 0] * p[..., 0] * z_inv + K[0, 2])[valid]
    v = (K[1, 1] * p[..., 1] * z_inv + K[1, 2])[valid]
    f = torch.arange(F, device=u.device)[:, None].expand_as(valid)[valid]
    u0 = torch.floor(torch.clamp(u, 0.0, W - 1.000001)).long()
    v0 = torch.floor(torch.clamp(v, 0.0, H - 1.000001)).long()
    u1, v1 = torch.clamp(u0 + 1, max=W - 1), torch.clamp(v0 + 1, max=H - 1)
    offs = [((f * H + r) * W + c) * 12 for r in (v0, v1) for c in (u0, u1)]
    sectors = torch.cat([o // 32 for o in offs] + [(o + 11) // 32 for o in offs])
    return int(valid.sum()), int(torch.unique(sectors).numel())


def _bound(nbytes, ops, pairs, sectors, extra_bytes):
    from gradient_sdf_tpu_torch.tools.fusion_bench import MEM_BYTES_PER_S
    from gradient_sdf_tpu_torch.tools.raycast_bench import F32_OPS_PER_S

    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "operations": ops, "pairs": pairs,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "distinct_sectors": sectors,
            "sector_bytes_ms": (32 * sectors + extra_bytes) / MEM_BYTES_PER_S * 1e3}


def ba_sums_bound_ms(problem, state, gcfg, pcfg, mode):
    """Least time of `ba_voxel_sums` in `mode` on these inputs: the larger
    of its bytes (each per-voxel input once: vox, grad, dist, vmask, the F
    visibility flags and, for the dist step, the weight; the poses and K;
    4 x 12 bytes of taps a participating pair; the outputs: one float, the
    dist [V] or n and the mean [V, 4]) at the card's memory rate and its
    operations (`PAIR_OPS` a pair, `VOXEL_OPS` a voxel) at its float32
    rate. `sector_bytes_ms` prices the taps as the distinct 32-byte sectors
    they touch instead."""
    V, F = problem.vis.shape
    pairs, sectors = participating_pairs(problem, state, gcfg, pcfg, mode)
    per_voxel = 12 + 12 + 4 + 1 + F + (4 if mode == "dist" else 0)
    out = {"energy": 4, "dist": 4 * V, "mean": 16 * V}[mode]
    fixed = V * per_voxel + F * 48 + 36 + out
    return _bound(fixed + 48 * pairs, PAIR_OPS[mode] * pairs + VOXEL_OPS * V,
                  pairs, sectors, fixed)


def pose_systems_bound_ms(problem, state, gcfg, pcfg):
    """Least time of `ba_pose_systems` on these inputs: per voxel vox,
    grad, dist, vmask, the F visibility flags, n and the mean (16 bytes);
    the poses and K; 4 x 12 bytes of taps a participating pair; H and b
    (F x 42 floats) out; against `PAIR_OPS["pose"]` a pair."""
    V, F = problem.vis.shape
    pairs, sectors = participating_pairs(problem, state, gcfg, pcfg, "pose")
    fixed = V * (12 + 12 + 4 + 1 + F + 16) + F * 48 + 36 + F * 42 * 4
    return _bound(fixed + 48 * pairs, PAIR_OPS["pose"] * pairs + VOXEL_OPS * V,
                  pairs, sectors, fixed)


def kernel_errors(problem, state, gcfg, pcfg, dist_atol=1e-6,
                  dist_rtol=1e-4):
    """Each kernel against its plain version on the same inputs: the
    energy's absolute and relative error; the dist step's largest error,
    the share of voxels beyond `dist_atol` + `dist_rtol` |dist| and the
    largest error of the others; whether n is equal and the mean's largest
    error; H's and b's largest error, absolute and relative to the frame's
    largest entry, and whether H is symmetric; whether the energy, H and b
    are the same bits on a second run. The pose systems of both take the
    plain n and mean."""
    import torch
    from gradient_sdf_tpu_torch.ops.kernels import ba_terms as bt

    def both(mode):
        return (bt.ba_voxel_sums(problem, state, gcfg, pcfg, mode),
                bt.ba_voxel_sums_reference(problem, state, gcfg, pcfg, mode))

    (e, e_ref), (d, d_ref), ((n, mean), (n_ref, mean_ref)) = (
        both(m) for m in ("energy", "dist", "mean"))
    H, b = bt.ba_pose_systems(problem, state, gcfg, pcfg, n_ref, mean_ref)
    Hr, br = bt.ba_pose_systems_reference(problem, state, gcfg, pcfg, n_ref,
                                          mean_ref)
    diff = (d - d_ref).abs()
    miss = diff > dist_atol + dist_rtol * d_ref.abs()
    H2, b2 = bt.ba_pose_systems(problem, state, gcfg, pcfg, n_ref, mean_ref)
    rel = max(float(((H - Hr).abs().amax((1, 2))
                     / Hr.abs().amax((1, 2)).clamp(min=1e-30)).max()),
              float(((b - br).abs().amax(1)
                     / br.abs().amax(1).clamp(min=1e-30)).max()))
    return {
        "energy": {"abs_err": float((e - e_ref).abs()),
                   "rel_err": float((e - e_ref).abs() / e_ref.abs())},
        "dist": {"abs_err": float(diff.max()),
                 "miss_share": float(miss.float().mean()),
                 "inlier_abs_err": float(diff[~miss].max()),
                 "moved": float((d_ref - state.dist).abs().max())},
        "mean": {"n_equal": bool(torch.equal(n, n_ref)),
                 "abs_err": float((mean - mean_ref).abs().max())},
        "pose": {"abs_err": float(max((H - Hr).abs().max(),
                                      (b - br).abs().max())),
                 "rel_err": rel,
                 "symmetric": bool(torch.equal(H, H.transpose(1, 2)))},
        "repeatable": bool(
            torch.equal(bt.ba_voxel_sums(problem, state, gcfg, pcfg, "energy"), e)
            and torch.equal(H2, H) and torch.equal(b2, b)),
    }


def kernel_report(problem, state, gcfg, pcfg):
    """Each kernel on these inputs (`ba_voxel_sums` per mode,
    `ba_pose_systems`), timed (`median_ms`) beside its bound, the plain
    version and an empty launch at its grid. The library column is None:
    no single PyTorch call computes either function."""
    import torch
    from gradient_sdf_tpu_torch.ops.kernels import _build
    from gradient_sdf_tpu_torch.ops.kernels import ba_terms as bt
    from gradient_sdf_tpu_torch.tools.fusion_bench import median_ms

    lib = _build.load()
    V = problem.vis.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    empty_ms = median_ms(lambda: lib.gsdf_ba_empty(V, stream))
    sums = {}
    for mode in bt.MODES:
        sums[mode] = dict(
            ms=median_ms(lambda: bt.ba_voxel_sums(problem, state, gcfg, pcfg,
                                                  mode)),
            plain_ms=median_ms(lambda: bt.ba_voxel_sums_reference(
                problem, state, gcfg, pcfg, mode), reps=3, batches=3),
            launch_floor_ms=empty_ms,
            **ba_sums_bound_ms(problem, state, gcfg, pcfg, mode))
    n, mean = bt.ba_voxel_sums_reference(problem, state, gcfg, pcfg, "mean")
    pose = dict(
        ms=median_ms(lambda: bt.ba_pose_systems(problem, state, gcfg, pcfg,
                                                n, mean)),
        plain_ms=median_ms(lambda: bt.ba_pose_systems_reference(
            problem, state, gcfg, pcfg, n, mean), reps=3, batches=3),
        launch_floor_ms=empty_ms,
        **pose_systems_bound_ms(problem, state, gcfg, pcfg))
    return {"ba_voxel_sums": sums, "ba_pose_systems": pose}


# The BA kernels taken apart (`kernel_split`): one-switch builds of a copy
# of a tree's `csrc/ba_terms.cu`, made as fusion_bench's SPLIT_SWITCHES.
# Per design (a string only its source holds): switch name -> edits.
# Results of a switched build are timings only.
_CONST_TAPS_PR16 = (
    "    const float i00 = __ldg(r0 + 3 * u0 + c), i01 = __ldg(r0 + 3 * u1 + c);\n"
    "    const float i10 = __ldg(r1 + 3 * u0 + c), i11 = __ldg(r1 + 3 * u1 + c);",
    "    const float i00 = 0.25f * c + fu, i01 = 0.5f + fv, i10 = 0.125f * c,\n"
    "                i11 = 0.75f;")
_STAGE_VIS_FN = (
    "template <int kMode>\n__global__ void __launch_bounds__(kThreads)\n"
    "    ba_voxel_sums(",
    "// the CTA's visibility rows (F <= 32) in shared memory, coalesced\n"
    "__device__ __forceinline__ void stage_vis(const Problem& P,\n"
    "                                          unsigned char* sh) {\n"
    "  if (P.F > 32) return;\n"
    "  const int rows = min(kThreads, P.V - static_cast<int>(blockIdx.x) * kThreads);\n"
    "  const size_t base = static_cast<size_t>(blockIdx.x) * kThreads * P.F;\n"
    "  for (int i = threadIdx.x; i < rows * P.F; i += kThreads)\n"
    "    sh[i] = P.vis[base + i];\n"
    "}\n\n"
    "template <int kMode>\n__global__ void __launch_bounds__(kThreads)\n"
    "    ba_voxel_sums(")
BA_SWITCHES = {
    "a thread a voxel, frames in series": (
        "float(*out)[kPoseTerms] = stage[f & 1];", {
            "(a) taps replaced by a constant": [_CONST_TAPS_PR16],
            "(b) visibility rows staged in shared memory first": [
                _STAGE_VIS_FN,
                ("  __shared__ float warp_e[kWarps];\n"
                 "  const Intrinsics k = load_frames(P, pose);",
                 "  __shared__ float warp_e[kWarps];\n"
                 "  __shared__ unsigned char vis_sh[kThreads * 32];\n"
                 "  stage_vis(P, vis_sh);\n"
                 "  const Intrinsics k = load_frames(P, pose);"),
                ("    const unsigned char* vis = P.vis + static_cast<size_t>(v) * P.F;",
                 "    const unsigned char* vis =\n"
                 "        P.F <= 32 ? vis_sh + threadIdx.x * P.F\n"
                 "                  : P.vis + static_cast<size_t>(v) * P.F;"),
                ("  __shared__ float stage[2][kWarps][kPoseTerms];\n"
                 "  const Intrinsics k = load_frames(P, pose);",
                 "  __shared__ float stage[2][kWarps][kPoseTerms];\n"
                 "  __shared__ unsigned char vis_sh[kThreads * 32];\n"
                 "  stage_vis(P, vis_sh);\n"
                 "  const Intrinsics k = load_frames(P, pose);"),
                ("  const unsigned char* vis =\n"
                 "      P.vis + static_cast<size_t>(active ? v : 0) * P.F;",
                 "  const unsigned char* vis =\n"
                 "      P.F <= 32 ? vis_sh + threadIdx.x * P.F\n"
                 "                : P.vis + static_cast<size_t>(active ? v : 0) * P.F;")],
            "(c) pose systems without the per-frame stage and barrier "
            "(wrong sums)": [(
                "    float(*out)[kPoseTerms] = stage[f & 1];\n"
                "    if (__any_sync(kFull, take)) {\n"
                "#pragma unroll\n"
                "      for (int j = 0; j < kPoseTerms; ++j) {\n"
                "        const float t = warp_sum(terms[j]);\n"
                "        if (lane == 0) out[warp][j] = t;\n"
                "      }\n"
                "    } else if (lane == 0) {\n"
                "#pragma unroll\n"
                "      for (int j = 0; j < kPoseTerms; ++j) out[warp][j] = 0.0f;\n"
                "    }\n",
                "    float(*out)[kPoseTerms] = stage[f & 1];\n"
                "    if (__any_sync(kFull, take)) {\n"
                "#pragma unroll\n"
                "      for (int j = 0; j < kPoseTerms; ++j) {\n"
                "        const float t = warp_sum(terms[j]);\n"
                "        if (lane == 0 && warp == 0)\n"
                "          partials[(static_cast<size_t>(blockIdx.x) * P.F + f) *\n"
                "                   kPoseTerms + j] = t;\n"
                "      }\n"
                "    }\n"
                "    continue;\n")],
        }),
    "a warp 32 voxels; dense launches: each lane its frames in batches; "
    "launches that fill the card: gate, then pairs compacted": (
        "template <int kMode, bool kDense>", {
            "(a) taps replaced by a constant": [(
                "    t.i00[c] = __ldg(r0 + 3 * u0 + c);\n"
                "    t.i01[c] = __ldg(r0 + 3 * u1 + c);\n"
                "    t.i10[c] = __ldg(r1 + 3 * u0 + c);\n"
                "    t.i11[c] = __ldg(r1 + 3 * u1 + c);",
                "    t.i00[c] = 0.25f * c + t.fu;\n"
                "    t.i01[c] = 0.5f + t.fv;\n"
                "    t.i10[c] = 0.125f * c;\n"
                "    t.i11[c] = 0.75f;")],
            "inputs and visibility only (wrong sums)": [
                ("      const unsigned pass =\n"
                 "          transpose_bits(gate_by_frame(P, k, pose, f0, vis, xs, lane), lane);",
                 "      const unsigned pass = 0;\n"
                 "      if (vis == 0x5a5a5a5au) out0[0] = 0.0f;"),
                ("      unsigned left =\n"
                 "          take ? (f0 == 0 ? vis0 : own_visible_frames(P, v, f0)) : 0u;",
                 "      unsigned left = 0;\n"
                 "      if ((take ? vis0 : 1u) == 0x5a5a5a5au) out0[0] = 0.0f;"),
                ("      const unsigned by_frame = gate_by_frame(P, k, pose, f0, vis, xs, lane);",
                 "      const unsigned by_frame = 0;\n"
                 "      if (vis == 0x5a5a5a5au) partials[0] = 0.0f;"),
                ("      const unsigned seen =\n"
                 "          active ? (f0 == 0 ? vis0 : own_visible_frames(P, v, f0)) : 0u;",
                 "      const unsigned seen = 0;\n"
                 "      if ((active ? vis0 : 1u) == 0x5a5a5a5au) partials[0] = 0.0f;")],
            "visibility and gate only, full-card paths (wrong sums)": [
                ("      const int cnt = __popc(pass);",
                 "      if (pass == 0x5a5a5a5au) out0[0] = 0.0f;\n"
                 "      const int cnt = 0;"),
                ("      const int off = lane_offsets(__popc(by_frame), lane, total);",
                 "      if (by_frame == 0x5a5a5a5au) partials[0] = 0.0f;\n"
                 "      const int off = lane_offsets(0, lane, total);")],
            "the full-card paths in every launch": [(
                "  return F <= kDenseFrames && (V + 31) / 32 <= 4 * static_cast<int64_t>(sms);",
                "  return sms < 0 && F < 0;")],
            "the dense paths in every launch": [(
                "  return F <= kDenseFrames && (V + 31) / 32 <= 4 * static_cast<int64_t>(sms);",
                "  return sms >= 0 || F < 0;")],
            "one pair a lane a round for energy and mean (full-card "
            "paths)": [(
                "constexpr int kBatch = 2;", "constexpr int kBatch = 1;")],
            "three frames a lane at once (dense paths)": [(
                "constexpr int kDenseBatch = 2;", "constexpr int kDenseBatch = 3;")],
            "the dist sums in registers, the visibility of the next chunk "
            "loaded last (full-card paths)": [
                ("    // the dist step's channel sums: sA, sJ, sAJ, sJJ (3 each), a column a\n"
                 "    // lane\n"
                 "    float* sums = rows + kRound * kRow + lane;\n"
                 "#pragma unroll\n"
                 "    for (int c = 0; c < RowOf<kMode>::kSums; ++c) sums[32 * c] = 0.0f;\n",
                 ""),
                ("    const unsigned takes = __ballot_sync(kFull, take);\n"
                 "    for (int f0 = 0; f0 < P.F; f0 += kChunk) {\n"
                 "      // lane r: the frames of the chunk whose image its voxel's point lands in\n"
                 "      const unsigned vis =\n"
                 "          (f0 == 0 ? vis0 : visible_voxels(P, v0, f0, lane)) & takes;",
                 "    unsigned next = vis0;\n"
                 "    for (int f0 = 0; f0 < P.F; f0 += kChunk) {\n"
                 "      const unsigned vis = next & __ballot_sync(kFull, take);"),
                ("          if constexpr (kMode == kDist) {\n"
                 "            // Sums::add's sums, each in the same order\n"
                 "            acc.n += 1.0f;\n"
                 "#pragma unroll\n"
                 "            for (int c = 0; c < 3; ++c) {\n"
                 "              const float Jd = row[3 + c];\n"
                 "              sums[32 * c] += A[c];\n"
                 "              sums[32 * (3 + c)] += Jd;\n"
                 "              sums[32 * (6 + c)] += A[c] * Jd;\n"
                 "              sums[32 * (9 + c)] += Jd * Jd;\n"
                 "            }\n"
                 "          } else {\n"
                 "            const float Jd[3] = {0.0f, 0.0f, 0.0f};\n"
                 "            acc.add(A, Jd);\n"
                 "          }",
                 "          float Jd[3] = {0.0f, 0.0f, 0.0f};\n"
                 "          if (kMode == kDist) {\n"
                 "#pragma unroll\n"
                 "            for (int c = 0; c < 3; ++c) Jd[c] = row[3 + c];\n"
                 "          }\n"
                 "          acc.add(A, Jd);"),
                ("    if constexpr (kMode == kDist) {\n"
                 "#pragma unroll\n"
                 "      for (int c = 0; c < 3; ++c) {\n"
                 "        acc.sA[c] = sums[32 * c];\n"
                 "        acc.sJ[c] = sums[32 * (3 + c)];\n"
                 "        acc.sAJ[c] = sums[32 * (6 + c)];\n"
                 "        acc.sJJ[c] = sums[32 * (9 + c)];\n"
                 "      }\n"
                 "    }\n",
                 ""),
                ("        __syncwarp();\n"
                 "      }\n"
                 "    }\n"
                 "  }\n"
                 "  if (kMode == kEnergy) {",
                 "        __syncwarp();\n"
                 "      }\n"
                 "      if (f0 + kChunk < P.F) next = visible_voxels(P, v0, f0 + kChunk, lane);\n"
                 "    }\n"
                 "  }\n"
                 "  if (kMode == kEnergy) {")],
        }),
}
BA_FUNCS = ("gsdf_ba_ctas", "gsdf_ba_max_frames", "gsdf_ba_voxel_sums_f32",
            "gsdf_ba_pose_systems_f32", "gsdf_ba_empty", "gsdf_ba_occupancy")
# the occupancy report, appended to a source that lacks it (the
# thread-a-voxel design's: every kernel with F x 48 bytes of dynamic shared
# memory)
OCCUPANCY_PROBE = r"""
extern "C" int gsdf_ba_occupancy(long long F, int* out) {
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&out[4], cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], ba_voxel_sums<kEnergy>, kThreads, pose_smem(F));
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], ba_voxel_sums<kDist>, kThreads, pose_smem(F));
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], ba_voxel_sums<kMean>, kThreads, pose_smem(F));
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], ba_pose_systems,
                                                kThreads, pose_smem(F));
  out[5] = kThreads;
  return static_cast<int>(cudaGetLastError());
}
"""
KERNEL_CALLS = ("energy", "dist", "mean", "pose")
# `kernel_split`'s third problem: a full-card launch whose one chunk has 8
# frames (a quarter of a warp's lanes gate)
SHORT_FRAMES = 8


def occupancy(lib, V, F):
    """CTAs an SM holds of each kernel (`KERNEL_CALLS` order, from the
    occupancy API; `dense_ctas_per_sm`: the dense paths' instances, where
    the source has them), the SMs, the
    threads a CTA, the CTAs of a launch over V voxels and the waves that
    launch takes at V and at V / 4 (a mesh rank's share)."""
    import ctypes

    out = (ctypes.c_int * 10)()
    rc = lib.gsdf_ba_occupancy(F, ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"gsdf_ba_occupancy failed: CUDA error {rc}")
    per_sm = dict(zip(KERNEL_CALLS, out[:4]))
    sms, threads = out[4], out[5]
    dense = dict(zip(KERNEL_CALLS, out[6:10]))
    waves = {}
    for name, v in (("V", V), ("V/4", V // 4)):
        ctas = lib.gsdf_ba_ctas(v)
        waves[name] = {"voxels": v, "ctas": ctas, **{
            k: -(-ctas // (c * sms)) if c > 0 else None
            for k, c in per_sm.items()}}
    return {"ctas_per_sm": per_sm, "sms": sms, "threads": threads,
            "waves": waves, "dense_ctas_per_sm": dense}


def kernel_calls(problem, state, gcfg, pcfg, n, mean):
    """{call: fn} of the four kernel calls of an alternation, the pose
    systems on the given n and mean."""
    from gradient_sdf_tpu_torch.ops.kernels import ba_terms as bt

    out = {m: (lambda m=m: bt.ba_voxel_sums(problem, state, gcfg, pcfg, m))
           for m in ("energy", "dist", "mean")}
    out["pose"] = lambda: bt.ba_pose_systems(problem, state, gcfg, pcfg, n,
                                             mean)
    return out


def _same(a, b):
    import torch

    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    return bool(torch.equal(a, b))


# `path_sweep`'s frame and voxel counts: below, at and above a chunk's
# half (16 frames) and the line of 4 warps an SM (16,896 voxels on 132
# SMs), the mesh rank's share of the scale point (V / 4 = 25,600) and the
# scale point
SWEEP_FRAMES = (4, 8, 12, 16, 24, 30)
SWEEP_VOXELS = (4608, 9216, 16896, 25600, 51200, 102400)
SWEEP_BUILDS = ("the full-card paths in every launch",
                "the dense paths in every launch")


def cut_problem(problem, state, F, V):
    """The first F frames and V voxels of a (BAProblem, BAState)."""
    p = problem._replace(vox=problem.vox[:V], grad=problem.grad[:V],
                         weight=problem.weight[:V], vmask=problem.vmask[:V],
                         vis=problem.vis[:V, :F].contiguous(),
                         images=problem.images[:F])
    return p, state._replace(dist=state.dist[:V], R=state.R[:F],
                             t=state.t[:F])


def path_sweep(frames=SWEEP_FRAMES, voxels=SWEEP_VOXELS):
    """This tree's four kernel calls (`KERNEL_CALLS`) timed (`median_ms`)
    with every launch forced onto each path (`SWEEP_BUILDS`, built
    together under their own directories), in turns (in order, then in
    reverse), on the scale point's data cut to each of `frames` x `voxels`;
    with the path the package takes there (`gsdf_ba_dense`). Returns a
    dict."""
    from gradient_sdf_tpu_torch.ops.kernels import _build
    from gradient_sdf_tpu_torch.ops.kernels import ba_terms as bt
    from gradient_sdf_tpu_torch.tools import fusion_bench as fb
    from gradient_sdf_tpu_torch.utils import interop

    jobs, _ = fb.switch_jobs([OWN_ROOT], "ba_terms.cu", BA_SWITCHES, BA_FUNCS)
    # a directory of their own: a library already loaded from the same
    # path (`kernel_split`'s first tree) would be handed back by dlopen
    built = fb.build_all([(key, a, dict(kw, tag="sweep-"))
                          for key, a, kw in jobs if key[1] in SWEEP_BUILDS])
    arrays = bench_arrays(max(frames), max(voxels))
    problem = interop.problem_from_numpy(arrays[0], "cuda")
    state = interop.state_from_numpy(arrays[1], "cuda")
    gcfg, pcfg = bench_configs()
    order = list(SWEEP_BUILDS) + list(SWEEP_BUILDS)[::-1]
    rows = []
    for F in frames:
        for V in voxels:
            p, st = cut_problem(problem, state, F, V)
            n, mean = bt.ba_voxel_sums_reference(p, st, gcfg, pcfg, "mean")
            calls = kernel_calls(p, st, gcfg, pcfg, n, mean)
            turns = [(name, {m: fb.median_ms(
                lambda f=f, lib=built[(0, name)][0]: fb.with_lib(lib, f))
                for m, f in calls.items()}) for name in order]
            rows.append({"frames": F, "voxels": V,
                         "dense": bool(_build.load().gsdf_ba_dense(V, F)),
                         "turns": turns})
    return {"rows": rows}


def path_sweep_report(res, smi):
    for row in res["rows"]:
        print(f"paths at F={row['frames']}, V={row['voxels']} (the package "
              f"takes the {'dense' if row['dense'] else 'full-card'} paths) "
              f"[{smi}]: " + " | ".join(
                  f"{name}: " + ", ".join(f"{c} {v:.4f}" for c, v in ms.items())
                  for name, ms in row["turns"]), flush=True)


# the PhotoBA app's flags of phase 6 (`chip_smoke.py`), after its data folder
PHASE6_FLAGS = ["--data-type", "synth", "--voxel-size", "0.02", "--trunc",
                "5", "--key-frame", "5"]
PHASE6_DIR = os.path.join(OWN_ROOT, "smoke_out", "ba_bench", "phase6")


def phase6_data(out):
    """Phase 6's data (`chip_smoke.py`): 14 VGA frames of the spheres with
    flat colours, 10 degrees of arc a frame, no noise, rendered on the card."""
    from gradient_sdf_tpu_torch.apps import make_synth

    make_synth.main(["--out", out, "--frames", "14", "--seed", "2", "--width",
                     "640", "--height", "480", "--arc-deg", "10", "--no-noise",
                     "--device", "cuda"])


def phase6_report(data, problem_file):
    """This process's package on phase 6's data (module note): the app's
    run (BA energies, its BA timer in ms, the BA kernels' launches where the
    tree counts them), then the optimizer twice on the BA problem in
    `problem_file` (written from this run's problem if it is not there):
    its energies, final R and t, wall ms; and one alternation's host ms."""
    import dataclasses

    import torch
    from gradient_sdf_tpu_torch.apps import photoba
    from gradient_sdf_tpu_torch.config import GridConfig
    from gradient_sdf_tpu_torch.models import photo_ba

    results = os.path.join(PHASE6_DIR, f"run-{os.getpid()}")
    os.makedirs(results, exist_ok=True)
    build, kept = photo_ba.build_problem, {}

    def keeping(*a, **kw):
        kept["problem"], kept["state"] = got = build(*a, **kw)
        kept["gcfg"] = a[6]
        return got

    counts = None
    if has_kernels():
        from gradient_sdf_tpu_torch.ops.kernels import ba_terms as bt
        bt.reset_launch_count()
    photo_ba.build_problem = keeping
    metrics = os.path.join(results, "metrics.json")
    try:
        photoba.main(["--input", data, "--results", results, "--metrics-json",
                      metrics] + PHASE6_FLAGS)
    finally:
        photo_ba.build_problem = build
    if has_kernels():
        counts = [bt.launch_count, bt.pose_launch_count]
    with open(metrics) as f:
        m = json.load(f)
    out = {"app": {"ba_energies": m["ba_energies"],
                   "ba_ms": m["timers"]["Photometric BA"]["total_s"] * 1e3,
                   "sums_and_pose_launches": counts}}
    if not os.path.exists(problem_file):
        torch.save({"problem": {k: v.cpu() for k, v in
                                kept["problem"]._asdict().items()},
                    "state": {k: v.cpu() for k, v in
                              kept["state"]._asdict().items()},
                    "gcfg": dataclasses.asdict(kept["gcfg"])}, problem_file)
    saved = torch.load(problem_file)
    problem = photo_ba.BAProblem(**{k: v.cuda() for k, v in
                                    saved["problem"].items()})
    state = photo_ba.BAState(**{k: v.cuda() for k, v in
                                saved["state"].items()})
    gcfg = GridConfig(**saved["gcfg"])
    _, pcfg = bench_configs()
    runs = []
    for _ in range(2):
        opt = photo_ba.PhotometricOptimizer(problem, state, gcfg, pcfg,
                                            verbose=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        converged = opt.optimize()
        torch.cuda.synchronize()
        runs.append({"ms": (time.perf_counter() - t0) * 1e3,
                     "energies": opt.energies, "converged": bool(converged),
                     "R": opt.state.R.cpu().numpy().tolist(),
                     "t": opt.state.t.cpu().numpy().tolist()})
    out["shared_problem"] = {
        "voxels": int(problem.vis.shape[0]), "frames": int(problem.vis.shape[1]),
        "runs": runs,
        "runs_equal": runs[0]["energies"] == runs[1]["energies"]
        and runs[0]["R"] == runs[1]["R"] and runs[0]["t"] == runs[1]["t"]}
    out["alternation_ms"] = alternation_ms(problem, state, gcfg, pcfg)
    return out


def phase6_compare(roots):
    """`phase6_report` of each (name, root) in turn, each in its own
    process, on one copy of phase 6's data; with each turn's energies and
    final poses beside the first turn's on the shared problem."""
    import shutil

    import numpy as np

    shutil.rmtree(PHASE6_DIR, ignore_errors=True)
    data = os.path.join(PHASE6_DIR, "data")
    phase6_data(data)
    problem_file = os.path.join(PHASE6_DIR, "problem.pt")
    turns = []
    for name, root in roots:
        r = run_tree(root, 0, 0, ["--phase6-data", data, "--problem",
                                  problem_file])
        r["tree"] = name
        turns.append(r)
    first = turns[0]["shared_problem"]["runs"][0]
    for r in turns:
        run = r["shared_problem"]["runs"][0]
        r["vs_first_turn"] = {
            "same_energies": run["energies"] == first["energies"],
            "R_max_abs_diff": float(np.abs(np.subtract(run["R"], first["R"])).max()),
            "t_max_abs_diff": float(np.abs(np.subtract(run["t"], first["t"])).max())}
    return turns


def phase6_compare_report(turns, smi):
    for r in turns:
        sp = r["shared_problem"]
        print(f"phase 6 in turns, {r['tree']} [{smi}]: the app's BA "
              f"{r['app']['ba_ms']:.2f} ms, energies "
              f"{[float(f'{e:.6g}') for e in r['app']['ba_energies']]}, "
              f"(sums, pose) launches {r['app']['sums_and_pose_launches']}; "
              f"on the shared problem (F = {sp['frames']}, V = {sp['voxels']}) "
              f"the optimizer {sp['runs'][0]['ms']:.2f} / {sp['runs'][1]['ms']:.2f} "
              f"ms, energies {sp['runs'][0]['energies']}, two runs equal "
              f"{sp['runs_equal']}, vs the first turn {r['vs_first_turn']}; "
              f"one alternation {r['alternation_ms'][0]:.3f} ms", flush=True)


def kernel_split(roots, problems):
    """Step 0 of the BA kernels, and the designs side by side: for each
    tree root in `roots`, its `csrc/ba_terms.cu` built as it is and under
    each switch of its design (BA_SWITCHES), with `OCCUPANCY_PROBE` added
    where the source has no occupancy report; all builds started together.
    Every build's four kernel calls timed (`median_ms`) on each of
    `problems` ({name: (problem, state, gcfg, pcfg)}); the unswitched builds
    held to the plain versions (`kernel_errors`) and to the first root's
    outputs (bit for bit) on each problem, and timed in turns there (roots
    in order, then in reverse). Returns a dict."""
    from gradient_sdf_tpu_torch.ops.kernels import ba_terms as bt
    from gradient_sdf_tpu_torch.tools import fusion_bench as fb

    jobs, designs = fb.switch_jobs(roots, "ba_terms.cu", BA_SWITCHES,
                                   BA_FUNCS)
    probe = ("\n// gsdf_ba_empty:", OCCUPANCY_PROBE + "\n// gsdf_ba_empty:")
    jobs = [(key, (text, name, edits + ([probe] if "gsdf_ba_occupancy"
                                        not in text else [])), kw)
            for key, (text, name, edits), kw in jobs]
    built = fb.build_all(jobs)
    ref = {}
    for name, (p, s, g, c) in problems.items():
        ref[name] = bt.ba_voxel_sums_reference(p, s, g, c, "mean")
    first = next(iter(problems))
    p0, s0, g0, c0 = problems[first]
    V, F = p0.vis.shape
    out = {"problems": {k: list(v[0].vis.shape) for k, v in problems.items()},
           "trees": []}
    results = {}
    for k, root in enumerate(roots):
        tree = {"root": root, "design": designs[k], "ms": {}, "ptxas": {}}
        for (kk, name), (lib, log) in built.items():
            if kk != k:
                continue
            tree["ms"][name] = {}
            for what, (p, s, g, c) in problems.items():
                calls = kernel_calls(p, s, g, c, *ref[what])
                tree["ms"][name][what] = {
                    m: fb.median_ms(lambda f=f: fb.with_lib(lib, f))
                    for m, f in calls.items()}
            tree["ptxas"][name] = fb.ptxas_lines(log, "ba_")
        lib = built[(k, "as it is")][0]
        tree["empty_launch_ms"] = fb.median_ms(
            lambda: lib.gsdf_ba_empty(V, _stream()))
        tree["occupancy"] = occupancy(lib, V, F)
        tree["errors"], tree["same_bits_as_first"] = {}, {}
        for name, (p, s, g, c) in problems.items():
            tree["errors"][name] = fb.with_lib(
                lib, lambda: kernel_errors(p, s, g, c))
            got = {m: fb.with_lib(lib, f) for m, f in kernel_calls(
                p, s, g, c, *ref[name]).items()}
            results[(k, name)] = got
            tree["same_bits_as_first"][name] = {
                m: _same(got[m], results[(0, name)][m]) for m in got}
        out["trees"].append(tree)
    order = list(range(len(roots)))
    out["turns"] = {name: [] for name in problems}
    for name, (p, s, g, c) in problems.items():
        for k in order + order[::-1]:
            lib = built[(k, "as it is")][0]
            calls = kernel_calls(p, s, g, c, *ref[name])
            out["turns"][name].append((roots[k], {
                m: fb.median_ms(lambda f=f: fb.with_lib(lib, f))
                for m, f in calls.items()}))
    return out


def _stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


def kernel_split_report(res, smi):
    """One line a fact of `kernel_split`'s result."""
    for t in res["trees"]:
        print(f"ba_terms of {t['root']} ({t['design']}) [{smi}]: empty "
              f"launch at its grid {t['empty_launch_ms']:.4f} ms; occupancy "
              f"{json.dumps(t['occupancy'])}")
        for name, per in t["ms"].items():
            print(f"  {name}: " + " | ".join(
                f"{what}: " + ", ".join(f"{c} {v:.4f}" for c, v in ms.items())
                for what, ms in per.items()))
        for name, lines in t["ptxas"].items():
            for k, v in lines.items():
                print(f"  ptxas ({name}) {k}: {v}")
        for name, err in t["errors"].items():
            print(f"  vs plain on {name}: {json.dumps(err)}; the same bits "
                  f"as the first tree: "
                  f"{json.dumps(t['same_bits_as_first'][name])}")
    for name, turns in res["turns"].items():
        print(f"ba_terms in turns on {name} [{smi}]: " + " | ".join(
            f"{r}: " + ", ".join(f"{c} {v:.4f}" for c, v in ms.items())
            for r, ms in turns))


def run_tree(root, frames, voxels, extra=()):
    """`tree_report` of the package in `root` (with `extra` arguments, what
    they ask for instead), in a process of its own."""
    cmd = [sys.executable, os.path.abspath(__file__), "--tree", root,
           "--frames", str(frames), "--voxels", str(voxels), *extra]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          env=dict(os.environ, PYTHONPATH=root))
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--voxels", type=int, default=100 * 1024)
    ap.add_argument("--kernels", nargs="*", metavar="DIR",
                    help="also hold each kernel to its plain version and time "
                         "it beside its bound (`kernel_report`), then take "
                         "apart the kernels of each tree DIR (this one if "
                         "none; with --parent and no DIR, the parent's and "
                         "this one) by one-switch builds (`kernel_split`)")
    ap.add_argument("--sweep", action="store_true",
                    help="time this tree's kernels on each path over "
                         "SWEEP_FRAMES x SWEEP_VOXELS (`path_sweep`)")
    ap.add_argument("--phase6", action="store_true",
                    help="run chip_smoke.py's phase 6 in each tree in turns "
                         "(`phase6_compare`)")
    ap.add_argument("--phase6-data", help=argparse.SUPPRESS)
    ap.add_argument("--problem", help=argparse.SUPPRESS)
    ap.add_argument("--parent", help="checkout of an earlier commit whose "
                    "alternation is timed in turns with this tree's")
    ap.add_argument("--tree", help="measure the package in DIR alone and print "
                    "one JSON line (what --parent runs per tree)")
    ap.add_argument("--out", help="also write the JSON result to this file")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree or OWN_ROOT))
    import torch

    if not torch.cuda.is_available():
        print("ba_bench: CUDA is not available; this needs a card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.tree:
        out = (phase6_report(args.phase6_data, args.problem) if args.phase6_data
               else tree_report(args.frames, args.voxels))
        print(json.dumps(out), flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    out = {"this": tree_report(args.frames, args.voxels)}
    if args.kernels is not None:
        from gradient_sdf_tpu_torch.utils import interop

        problem, state = bench_arrays(args.frames, args.voxels)
        problem = interop.problem_from_numpy(problem, "cuda")
        state = interop.state_from_numpy(state, "cuda")
        gcfg, pcfg = bench_configs()
        tp, ts, tg = textured_problem()
        problems = {"the scale point": (problem, state, gcfg, pcfg),
                    "phase 6b's problem": (tp, ts, tg, pcfg)}
        out["kernels"] = {name: kernel_report(*args_)
                          for name, args_ in problems.items()}
        out["kernel_errors"] = {name: kernel_errors(*args_)
                                for name, args_ in problems.items()}
        # the split also times a launch that fills the card with a chunk
        # of 8 frames
        short = bench_arrays(SHORT_FRAMES, args.voxels)
        problems[f"the scale point's data at F={SHORT_FRAMES}"] = (
            interop.problem_from_numpy(short[0], "cuda"),
            interop.state_from_numpy(short[1], "cuda"), gcfg, pcfg)
        roots = [os.path.abspath(d) for d in args.kernels] or (
            [os.path.abspath(args.parent), OWN_ROOT] if args.parent
            else [OWN_ROOT])
        out["split"] = kernel_split(roots, problems)
        kernel_split_report(out["split"], smi)
    if args.sweep:
        out["sweep"] = path_sweep()
        path_sweep_report(out["sweep"], smi)
    if args.phase6:
        roots = ([("parent", os.path.abspath(args.parent))] if args.parent
                 else []) + [("this", OWN_ROOT), ("this", OWN_ROOT)]
        if args.parent:
            roots.append(roots[0])
        out["phase6"] = phase6_compare(roots)
        phase6_compare_report(out["phase6"], smi)
    if args.parent:
        parent = os.path.abspath(args.parent)
        out["turns"] = [
            dict(run_tree(root, args.frames, args.voxels), tree=name)
            for name, root in [("parent", parent), ("this", OWN_ROOT),
                               ("this", OWN_ROOT), ("parent", parent)]]
    out["device"] = smi
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
