#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`gradient_sdf_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, checks each against its
plain PyTorch version on the card, checks card fusion against the port on
the CPU, then drives the Scan3D main path through its CLI entry point on
the golden protocol (640x480 spheres, seed 2, 6 frames over a 4 degree
arc, 2 cm voxels, app-default 16384-block grid) in tracking and in GT-pose
mode, and checks what comes out. Every phase raises on failure, which ends
the run non-zero. Needs one CUDA card; fails at once without one. Scratch
files go to `smoke_out/` under the checkout.

Output: one line of numbers per phase; then the card's name and power
limit (`nvidia-smi`), a JSON line `{"kernels": [...]}` with each kernel's
launch count in the main-path run, its largest error against the plain
version and both times; and last `{"ok": true, "device": {...}}`.
"""

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "smoke_out")

# scatter-add check at fusion's shape: ~0.5M samples per golden frame into
# the app-default 16384 blocks x 512 voxels
N_SAMPLES = 600_000
OUT_SIZE = 16384 * 512
# atomics change the order of float32 sums from run to run
ATOL, RTOL = 1e-4, 1e-5
# fusion on the card vs the port on the CPU: same ops, only the atomics'
# summation order differs (a voxel sums ~10-20 samples)
FUSE_SHARED_MIN = 0.999
FUSE_TOL = {"weight": 1e-4, "dist": 1e-5, "grad": 1e-4}


def log(msg):
    print(msg, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps=20):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def phase_build():
    from gradient_sdf_tpu_torch.ops.kernels import _build

    _build.load()
    ptxas = [l for l in _build.build_log.splitlines() if "ptxas" in l]
    for line in ptxas:
        log(f"  {line.strip()}")
    log(f"phase1 build: ok, {_build.build_seconds:.2f} s")


def phase_kernel():
    import numpy as np
    import torch
    from gradient_sdf_tpu_torch.ops.kernels import scatter_add as sa

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def case(n, lo=0, hi=OUT_SIZE):
        idx = rng.integers(lo, hi, n)
        oob = rng.random(n) < 0.05   # ~5% dropped: negative or >= out_size
        neg = rng.random(n) < 0.5
        idx[oob & neg] = rng.integers(-100_000, 0, int((oob & neg).sum()))
        idx[oob & ~neg] = rng.integers(OUT_SIZE, OUT_SIZE + 100_000,
                                       int((oob & ~neg).sum()))
        vals = rng.standard_normal((n, 5)).astype(np.float32)
        return (torch.as_tensor(idx.astype(np.int32), device=dev),
                torch.as_tensor(vals, device=dev))

    def check(got, want, what):
        err = float((got - want).abs().max()) if got.numel() else 0.0
        if not torch.allclose(got, want, atol=ATOL, rtol=RTOL):
            raise AssertionError(f"{what}: kernel vs plain max |err| {err}")
        return err

    idx, vals = case(N_SAMPLES)
    idx2, vals2 = case(N_SAMPLES)
    errs = []
    got = sa.scatter_add_multi(idx, vals, OUT_SIZE)
    want = sa.scatter_add_multi_reference(idx, vals, OUT_SIZE)
    errs.append(check(got, want, "F=5"))
    # carry-in: the second call accumulates into the first call's result
    got2 = sa.scatter_add_multi(idx2, vals2, OUT_SIZE, acc=got.clone())
    want2 = sa.scatter_add_multi_reference(idx2, vals2, OUT_SIZE,
                                           acc=want.clone())
    errs.append(check(got2, want2, "F=5 carry-in"))
    v1 = vals[:, 0].contiguous()
    errs_rows = [check(sa.scatter_add_rows(idx, v1, OUT_SIZE),
                       sa.scatter_add_rows_reference(idx, v1, OUT_SIZE), "F=1")]
    empty = sa.scatter_add_multi(idx[:0], vals[:0], OUT_SIZE)
    if empty.shape != (OUT_SIZE, 5) or bool(empty.any()):
        raise AssertionError("empty input must give a zero accumulator")
    torch.cuda.synchronize()

    acc_k = torch.zeros((OUT_SIZE, 5), device=dev)
    acc_p = torch.zeros((OUT_SIZE, 5), device=dev)
    plain_ms = median_ms(lambda: sa.scatter_add_multi_reference(
        idx, vals, OUT_SIZE, acc=acc_p))
    ms = median_ms(lambda: sa.scatter_add_multi(idx, vals, OUT_SIZE, acc=acc_k))
    rows_plain = median_ms(lambda: sa.scatter_add_rows_reference(idx, v1, OUT_SIZE))
    rows_ms = median_ms(lambda: sa.scatter_add_rows(idx, v1, OUT_SIZE))
    # fusion-like locality: the golden scene's samples hit ~131 blocks
    cidx, cvals = case(N_SAMPLES, 0, 131 * 512)
    conc_ms = median_ms(lambda: sa.scatter_add_multi(cidx, cvals, OUT_SIZE, acc=acc_k))
    conc_plain = median_ms(lambda: sa.scatter_add_multi_reference(
        cidx, cvals, OUT_SIZE, acc=acc_p))
    log(f"phase2 scatter_add_multi F=5 N={N_SAMPLES} out={OUT_SIZE}: max_abs_err "
        f"{max(errs):.3g} (atol {ATOL}, rtol {RTOL}); median of 20: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
    log(f"phase2 scatter_add_rows F=1: max_abs_err {max(errs_rows):.3g}; "
        f"kernel {rows_ms:.4f} ms (incl. zeroed output), plain {rows_plain:.4f} ms")
    log(f"phase2 F=5 into 131 blocks (fusion-like locality): kernel "
        f"{conc_ms:.4f} ms, plain {conc_plain:.4f} ms")
    return {"max_abs_err": max(errs + errs_rows), "ms": ms, "plain_ms": plain_ms}


def golden_frame():
    """Frame 0 of the golden protocol, depth rounded to mm as its PNG."""
    import numpy as np
    from gradient_sdf_tpu_torch.data import synth

    world = synth.random_spheres(seed=2)
    R, t = synth.orbit_poses(n=6, radius=2.0, arc=np.deg2rad(4.0))[0]
    depth = synth.quantize_depth(synth.render_depth(world, R, t))
    return depth.numpy(), R, t


def occupied(grid, gcfg):
    """{voxel coord: (weight, dist, gx, gy, gz)} of observed voxels."""
    import torch
    from gradient_sdf_tpu_torch.ops import voxel_grid as vg

    na = int(grid.num_active)
    vox = vg.block_local_to_voxel(grid.block_coords[:na], gcfg).reshape(-1, 3)
    fields = torch.stack([grid.weight[:na], grid.dist[:na], grid.grad_x[:na],
                          grid.grad_y[:na], grid.grad_z[:na]], -1).reshape(-1, 5)
    keep = fields[:, 0] > 0
    vox, fields = vox[keep].cpu().numpy(), fields[keep].cpu().numpy()
    return {tuple(v): f for v, f in zip(vox.tolist(), fields)}


def phase_fusion():
    import numpy as np
    import torch
    from gradient_sdf_tpu_torch.config import FusionConfig, GridConfig
    from gradient_sdf_tpu_torch.data import synth
    from gradient_sdf_tpu_torch.ops import fusion, normals
    from gradient_sdf_tpu_torch.ops import voxel_grid as vg

    gcfg = GridConfig(voxel_size=0.02)
    fcfg = FusionConfig(trunc_voxels=5.0)
    depth, R, t = golden_frame()
    maps = {}
    ms = {}
    for name in ("cuda", "cpu"):
        dev = torch.device(name)
        cache = normals.build_cache(640, 480, synth.KINECT_K, 11, dev)
        grid = vg.create(gcfg, dev)
        args = [torch.as_tensor(a, device=dev) for a in (depth, R, t)]
        t0 = time.perf_counter()
        grid = fusion.fuse_frame(grid, args[0], cache, args[1], args[2], gcfg, fcfg)
        if name == "cuda":
            torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        maps[name] = occupied(grid, gcfg)
    a, b = maps["cuda"], maps["cpu"]
    shared = sorted(set(a) & set(b))
    frac = len(shared) / max(len(a), len(b), 1)
    if not shared or frac < FUSE_SHARED_MIN:
        raise AssertionError(f"card vs CPU fusion share {frac:.5f} of voxels")
    fa = np.stack([a[k] for k in shared])
    fb = np.stack([b[k] for k in shared])
    diff = np.abs(fa - fb)
    errs = {"weight": diff[:, 0].max(), "dist": diff[:, 1].max(),
            "grad": diff[:, 2:].max()}
    for k, tol in FUSE_TOL.items():
        if not errs[k] <= tol:
            raise AssertionError(f"fusion {k}: card vs CPU max |err| {errs[k]} > {tol}")
    log(f"phase3 fusion card vs CPU: {len(a)} / {len(b)} voxels, shared "
        f"{frac:.6f}; max |err| weight {errs['weight']:.3g} dist "
        f"{errs['dist']:.3g} grad {errs['grad']:.3g}; first-call ms card "
        f"{ms['cuda']:.1f} cpu {ms['cpu']:.1f}")


def rel_translation_errors(results, data):
    """Per-frame |t_rel(est) - t_rel(gt)| with t_rel = position of frame i
    in frame 0's camera (frame 0 anchors the estimate at identity)."""
    import numpy as np
    from gradient_sdf_tpu_torch.utils import tumio

    est = tumio.read_trajectory(os.path.join(results, "_poses.txt"))
    gt = tumio.read_trajectory(os.path.join(data, "gt_poses.txt"))

    def rel(traj, i):
        R0, t0 = traj[0][1].astype(np.float64), traj[0][2].astype(np.float64)
        return R0.T @ (traj[i][2] - t0)

    return [float(np.linalg.norm(rel(est, i) - rel(gt, i)))
            for i in range(len(est))]


def run_app(data, results, extra):
    from gradient_sdf_tpu_torch.apps import scan3d

    metrics_path = os.path.join(results, "metrics.json")
    scan3d.main(["--input", data, "--results", results, "--data-type", "synth",
                 "--voxel-size", "0.02", "--trunc", "5", "--device", "cuda",
                 "--metrics-json", metrics_path] + extra)
    with open(metrics_path) as f:
        return json.load(f)


def check_outputs(m, results, launches, n_frames):
    from gradient_sdf_tpu_torch.utils.ply import load_ply

    if m["invalid_frames"]:
        raise AssertionError(f"invalid frames {m['invalid_frames']}")
    if m["overflow"] or m["num_blocks_active"] <= 0 or m["frames"] != n_frames:
        raise AssertionError(f"bad map state {m}")
    fused = sum(1 for e in m["frame_log"] if e["fuse_ms"] is not None)
    if launches < fused:
        raise AssertionError(f"scatter kernel launched {launches} times for "
                             f"{fused} fused frames")
    mesh = load_ply(os.path.join(results, "gradient_sdf_mesh_final.ply"))
    cloud = load_ply(os.path.join(results, "gradient_sdf_cloud_final.ply"))
    n_faces = len(mesh.get("face", []))
    n_pts = len(cloud["vertex"])
    if n_faces <= 0 or n_pts <= 0:
        raise AssertionError(f"mesh faces {n_faces}, cloud points {n_pts}")
    return fused, n_faces, n_pts


def frame_summary(tag, m):
    log_ = m["frame_log"]
    for e in log_:
        tr = "-" if e["track_ms"] is None else f"{e['track_ms']:.2f}"
        fu = "-" if e["fuse_ms"] is None else f"{e['fuse_ms']:.2f}"
        it = "-" if e["gn_iters"] is None else e["gn_iters"]
        log(f"  {tag} frame {e['frame']}: track {tr} ms, GN iters {it}, "
            f"fuse {fu} ms, frame {e['frame_ms']:.2f} ms")
    total = sum(e["frame_ms"] for e in log_) / 1e3
    steady = sum(e["frame_ms"] for e in log_[1:]) / 1e3
    return len(log_) / total, (len(log_) - 1) / steady


def phase_app(data, n_frames):
    from gradient_sdf_tpu_torch.ops.kernels import scatter_add as sa

    # warm-up run (CUDA libraries' lazy init), then the measured run
    run_app(data, os.path.join(WORK, "warm"), ["--pose-file", "none"])
    results = os.path.join(WORK, "track")
    sa.reset_launch_count()
    m = run_app(data, results, ["--pose-file", "none"])
    launches = sa.launch_count
    fused, n_faces, n_pts = check_outputs(m, results, launches, n_frames)
    errs = rel_translation_errors(results, data)
    if not max(errs) < 0.01:
        raise AssertionError(f"relative translation errors {errs} (limit 1 cm)")
    fps, fps_steady = frame_summary("track", m)
    log(f"phase4 scan3d tracking: {m['frames']} frames, {fused} fused, "
        f"{m['num_blocks_active']} blocks, {n_faces} faces, {n_pts} cloud "
        f"points, scatter launches {launches}, max rel. translation error "
        f"{max(errs) * 1e3:.3f} mm; {fps:.2f} fps all frames, "
        f"{fps_steady:.2f} fps frames 1-{n_frames - 1}")
    return launches


def phase_gt(data, n_frames):
    from gradient_sdf_tpu_torch.ops.kernels import scatter_add as sa

    results = os.path.join(WORK, "gt")
    sa.reset_launch_count()
    m = run_app(data, results, ["--pose-file", "gt_poses.txt"])
    fused, n_faces, n_pts = check_outputs(m, results, sa.launch_count, n_frames)
    fps, _ = frame_summary("gt", m)
    log(f"phase5 scan3d GT poses: {fused} fused, {m['num_blocks_active']} "
        f"blocks, {n_faces} faces, {n_pts} cloud points, scatter launches "
        f"{sa.launch_count}; {fps:.2f} fps")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs a card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import gradient_sdf_tpu_torch  # noqa: F401  (fails outside the checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    phase_build()
    kstats = phase_kernel()
    phase_fusion()

    from gradient_sdf_tpu_torch.apps import make_synth

    data = os.path.join(WORK, "golden")
    n_frames = 6
    make_synth.main(["--out", data, "--frames", str(n_frames), "--seed", "2",
                     "--width", "640", "--height", "480", "--arc-deg", "4",
                     "--no-noise"])
    launches = phase_app(data, n_frames)
    phase_gt(data, n_frames)

    log(smi_line())
    log(json.dumps({"kernels": [{
        "name": "scatter_add_multi",
        "route": "cuda",
        "source": "gradient_sdf_tpu_torch/csrc/scatter_add.cu",
        "replaces": "gradient_sdf_tpu/ops/pallas/scatter_add.py:103",
        "launches": launches,
        "max_abs_err": kstats["max_abs_err"],
        "ms": kstats["ms"],
        "plain_ms": kstats["plain_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
