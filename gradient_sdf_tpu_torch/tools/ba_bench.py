#!/usr/bin/env python3
"""Card measurements of one PhotoBA alternation and of its two kernels
(needs one CUDA card).

    python3 gradient_sdf_tpu_torch/tools/ba_bench.py [--frames F] [--voxels V]
        [--kernels] [--parent DIR]

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
its three modes, `ba_pose_systems`) held to its plain version on these
inputs (`kernel_errors`) and timed beside its bound (`ba_sums_bound_ms`,
`pose_systems_bound_ms`: bytes, operations, the distinct 32-byte sectors
of the image taps), the plain version and an empty launch at its grid
(`kernel_report`). `--parent DIR` (an earlier checkout, e.g. unpacked with
`git archive`) runs `tree_report` of DIR's tree and of this one in turns,
parent, this, this, parent, each in its own process through its own
package (`--tree DIR` is what the script passes to itself): the parent's
calls are its plain passes, this tree's the kernels.
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


def run_tree(root, frames, voxels):
    """`tree_report` of the package in `root`, in a process of its own."""
    cmd = [sys.executable, os.path.abspath(__file__), "--tree", root,
           "--frames", str(frames), "--voxels", str(voxels)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          env=dict(os.environ, PYTHONPATH=root))
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--voxels", type=int, default=100 * 1024)
    ap.add_argument("--kernels", action="store_true",
                    help="also hold each kernel to its plain version and time "
                         "it beside its bound (`kernel_report`)")
    ap.add_argument("--parent", help="checkout of an earlier commit whose "
                    "alternation is timed in turns with this tree's")
    ap.add_argument("--tree", help="measure the package in DIR alone and print "
                    "one JSON line (what --parent runs per tree)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree or OWN_ROOT))
    import torch

    if not torch.cuda.is_available():
        print("ba_bench: CUDA is not available; this needs a card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.tree:
        print(json.dumps(tree_report(args.frames, args.voxels)), flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    out = {"this": tree_report(args.frames, args.voxels)}
    if args.kernels:
        from gradient_sdf_tpu_torch.utils import interop

        problem, state = bench_arrays(args.frames, args.voxels)
        problem = interop.problem_from_numpy(problem, "cuda")
        state = interop.state_from_numpy(state, "cuda")
        out["kernels"] = kernel_report(problem, state, *bench_configs())
        out["kernel_errors"] = kernel_errors(problem, state, *bench_configs())
    if args.parent:
        parent = os.path.abspath(args.parent)
        out["turns"] = [
            dict(run_tree(root, args.frames, args.voxels), tree=name)
            for name, root in [("parent", parent), ("this", OWN_ROOT),
                               ("this", OWN_ROOT), ("parent", parent)]]
    out["device"] = smi
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
