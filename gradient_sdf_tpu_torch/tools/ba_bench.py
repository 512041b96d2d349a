#!/usr/bin/env python3
"""Card measurements of one PhotoBA alternation (needs one CUDA card).

    python3 gradient_sdf_tpu_torch/tools/ba_bench.py [--frames F] [--voxels V]

The problem is the scale point of the JAX package's benchmark: F = 30
keyframes of 640x480 random images, V = 102400 surface voxels with random
indices in [-60, 60), random gradients, weights in [1, 20], 40% visibility,
dist within +-5 mm at 1 cm voxels, identity rotations and translations
within +-10 cm, all drawn from numpy `RandomState(11)` in that order. One
alternation is what `PhotometricOptimizer._iteration` runs: `solve_pose`,
`energy`, `solve_dist`, `energy`, each energy read back to the host.

It prints the card's name and power limit, then one JSON line with: the
alternation's time (host clock around device-synchronized work, median of 5
after a warm-up); the device time of each of its four calls and of the
per-frame pass they share (`_per_frame_terms` over all frames, and
`_project_sample`, the part of it `energy` needs), by CUDA events; and from
`torch.profiler` over one alternation the number of kernels, the device-busy
time and share, the host synchronizations, and the kernels that take most
device time; the pose systems' product as one batched product beside
the sliced one the package uses, in turns; and the byte bound of `energy`
on these inputs, the yardstick for a fused per-voxel kernel.
"""

import argparse
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


def device_split(problem, state, gcfg, pcfg):
    """Device ms (CUDA events) of the alternation's calls and of the
    per-frame pass inside them."""
    from gradient_sdf_tpu_torch.models import photo_ba
    from gradient_sdf_tpu_torch.tools.fusion_bench import median_ms

    x = photo_ba._surface_points(problem, state.dist, gcfg.voxel_size)
    frames = (state.R, state.t, problem.images, problem.vis.T)
    out = {
        "solve_pose_ms": median_ms(
            lambda: photo_ba.solve_pose(problem, state, gcfg, pcfg), reps=3),
        "energy_ms": median_ms(
            lambda: photo_ba.energy(problem, state, gcfg), reps=3),
        "solve_dist_ms": median_ms(
            lambda: photo_ba.solve_dist(problem, state, gcfg, pcfg), reps=3),
        "per_frame_terms_ms": median_ms(
            lambda: photo_ba._per_frame_terms(problem, x, *frames), reps=3),
        "project_sample_ms": median_ms(
            lambda: photo_ba._project_sample(problem, x, *frames), reps=3),
    }
    # per alternation: `_per_frame_terms` once in each solver, its
    # `_project_sample` part once in each of the two energies
    out["alternation_device_ms"] = (out["solve_pose_ms"] + out["solve_dist_ms"]
                                    + 2 * out["energy_ms"])
    out["per_frame_pass_share"] = (
        (2 * out["per_frame_terms_ms"] + 2 * out["project_sample_ms"])
        / out["alternation_device_ms"])
    return out


def energy_bound_ms(problem, state, gcfg):
    """Least time for the bytes `energy` must move on these inputs at the
    card's memory rate: every per-voxel input once (vox, grad, dist, vmask,
    the F visibility flags), the poses, and four 12-byte image taps for
    each (voxel, frame) pair that takes part; one float out."""
    import torch
    from gradient_sdf_tpu_torch.models import photo_ba
    from gradient_sdf_tpu_torch.tools.fusion_bench import MEM_BYTES_PER_S

    x = photo_ba._surface_points(problem, state.dist, gcfg.voxel_size)
    valid = photo_ba._project_sample(problem, x, state.R, state.t,
                                     problem.images, problem.vis.T)[-1]
    gate = (torch.abs(state.dist) <= gcfg.voxel_size) & problem.vmask
    pairs = int((valid & gate).sum())
    F, V = valid.shape
    nbytes = V * (12 + 12 + 4 + 1 + F) + F * 48 + pairs * 4 * 12 + 4
    return nbytes / MEM_BYTES_PER_S * 1e3, pairs


def pose_product_compare(problem, state, gcfg, pcfg):
    """Device ms of the per-frame pose systems' product, in turns: as one
    batched product over the whole (voxel, channel) axis, and
    `photo_ba._weighted_systems`, which cuts the axis into slices."""
    import torch
    from gradient_sdf_tpu_torch.models import photo_ba
    from gradient_sdf_tpu_torch.tools.fusion_bench import median_ms

    A, Jc, valid, n, inv_n, mean_A = photo_ba._pose_terms(problem, state, gcfg, pcfg)
    w = (valid & (n > 0)).to(torch.float32)
    wh, r = w * (1.0 - inv_n), A - mean_A

    def single():
        F = Jc.shape[0]
        J = Jc.reshape(F, -1, 6)
        b = ((w[..., None] * r).reshape(F, 1, -1) @ J)[:, 0]
        H = (wh[..., None, None] * Jc).reshape(F, -1, 6).transpose(-1, -2) @ J
        return b, H

    def split():
        return photo_ba._weighted_systems(w, wh, r, Jc)

    (b0, H0), (b1, H1) = single(), split()
    err = max(float((H0 - H1).abs().max() / H0.abs().max()),
              float((b0 - b1).abs().max() / b0.abs().max()))
    turns = [("single", single), ("split", split), ("split", split),
             ("single", single)]
    out = {"single": [], "split": [], "max_rel_diff": err}
    for name, fn in turns:
        out[name].append(median_ms(fn, reps=3))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--voxels", type=int, default=100 * 1024)
    args = ap.parse_args()
    sys.path.insert(0, OWN_ROOT)
    import torch
    from gradient_sdf_tpu_torch.utils import interop

    if not torch.cuda.is_available():
        print("ba_bench: CUDA is not available; this needs a card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
        flush=True)
    problem, state = bench_arrays(args.frames, args.voxels)
    problem = interop.problem_from_numpy(problem, "cuda")
    state = interop.state_from_numpy(state, "cuda")
    gcfg, pcfg = bench_configs()
    ms, runs = alternation_ms(problem, state, gcfg, pcfg)
    torch.cuda.reset_peak_memory_stats()
    out = {"frames": args.frames, "voxels": args.voxels,
           "alternation_ms": ms, "alternation_runs_ms": runs}
    out.update(device_split(problem, state, gcfg, pcfg))
    out.update(profile_alternation(problem, state, gcfg, pcfg))
    out["pose_product_ms"] = pose_product_compare(problem, state, gcfg, pcfg)
    out["energy_bound_ms"], out["energy_pairs"] = energy_bound_ms(
        problem, state, gcfg)
    out["peak_device_memory_mb"] = torch.cuda.max_memory_allocated() / 2 ** 20
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
