#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`gradient_sdf_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, checks each against its
plain PyTorch version on the card, checks card fusion against the port on
the CPU, then drives the Scan3D main path through its CLI entry point on
the golden protocol (640x480 spheres, seed 2, 6 frames over a 4 degree
arc, 2 cm voxels, app-default 16384-block grid) in tracking and in GT-pose
mode, and checks what comes out. Then the second executable: PhotoBA
through its CLI entry point on 14 VGA frames over a 10 degree arc
(tracking + fusion with visibility bits, keyframes, BA, colour upsampling
and the high-resolution exports; phase 6), the same app on textured
spheres from ground-truth poses with BA started from perturbed poses
(phase 6b: BA has to win energy and pose error back), and one BA
alternation at F = 30 keyframes x V = 102400 voxels x 640x480 images, card
against CPU (phase 7). Every phase raises on failure, which ends the run
non-zero. Needs one CUDA card; fails at once without one. Scratch files go
to `smoke_out/` under the checkout.

Output: one line of numbers per phase; then the card's name and power
limit (`nvidia-smi`), a JSON line `{"kernels": [...]}` with each kernel's
launch count on the main paths (phase 4's Scan3D run plus phase 6's PhotoBA
run, each counted from zero), its largest error against the plain
version, its time beside the plain version's, the byte bound and (for the
scatter) the bare `index_add_` as the library yardstick, all on golden
frame 5's real samples; and last `{"ok": true, "device": {...}}`.
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
# 600k N(0,1) samples into 14k rows: ~43 per row, sums of magnitude ~7-20,
# so a reordered float32 sum moves by a few 1e-6; same relative tolerance
HEAVY_ROWS = 14_000
# fusion on the card vs the port on the CPU: same ops, only the atomics'
# summation order differs (a voxel sums ~10-20 samples)
FUSE_SHARED_MIN = 0.999
FUSE_TOL = {"weight": 1e-4, "dist": 1e-5, "grad": 1e-4}
# one BA alternation, card vs CPU from the same arrays: both run the same
# float32 operations, and differ in the order of the matrix products' and
# reductions' sums. A sample whose projection lands within rounding of a
# pixel edge takes the neighbouring cell's image gradient on one of the two
# (the bilinear sampler's gradient is piecewise constant), which moves that
# voxel's dist step: at most BA_OUTLIERS of the voxels may miss the dist
# tolerance, and their number is printed.
BA_E_RTOL = 1e-4
BA_DIST_ATOL, BA_DIST_RTOL = 1e-6, 1e-4
BA_POSE_ATOL = 1e-5
BA_OUTLIERS = 1e-3
PHOTOBA_ARTIFACTS = ["_poses.txt", "mesh_lr.ply", "cloud_lr.ply",
                     "selected_frame_poses_before_optimization.txt",
                     "coarse_BA_poses_optimized.txt",
                     "coarse_BA_mesh_after_upsample.ply",
                     "coarse_BA_cloud_after_upsample.ply"]


def log(msg):
    print(msg, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_build():
    """Build both kernels; fail on register spills, and on a scatter kernel
    whose machine code holds no vector reduction."""
    import re
    from gradient_sdf_tpu_torch.ops.kernels import _build

    lib = _build.load()
    for name in ("gsdf_scatter_add_f32", "gsdf_merge_clear_f32"):
        getattr(lib, name)   # AttributeError if the library lacks a kernel
    ptxas = [l.strip() for l in _build.build_log.splitlines() if "ptxas" in l
             or "spill" in l]
    spills = [l for l in ptxas if re.search(r"[1-9]\d* bytes spill", l)]
    if spills:
        raise AssertionError(f"register spills: {spills}")
    regs = [int(m.group(1)) for l in ptxas
            for m in [re.search(r"Used (\d+) registers", l)] if m]
    dump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([dump, "-sass", _build.lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    vec = {w: len(re.findall(rf"RED\S*\.ADD\.F32x{w}\b", sass)) for w in (2, 4)}
    if not vec[4] or not vec[2]:
        raise AssertionError(f"no vector reductions in the SASS: {vec}")
    if not regs:
        raise AssertionError("no ptxas report in the build's log")
    log(f"phase1 build: ok, {_build.build_seconds:.2f} s; ptxas: {len(regs)} "
        f"kernels, {min(regs)}-{max(regs)} registers, no spills; SASS has "
        f"{vec[4]} RED.ADD.F32x4 and {vec[2]} RED.ADD.F32x2 opcodes")


def phase_kernel():
    import numpy as np
    import torch
    from gradient_sdf_tpu_torch.ops.kernels import scatter_add as sa
    from gradient_sdf_tpu_torch.tools.fusion_bench import (median_ms,
                                                           scatter_bound_ms)

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def case(n, hi=OUT_SIZE, nf=5):
        idx = rng.integers(0, hi, n)
        oob = rng.random(n) < 0.05   # ~5% dropped: negative or >= out_size
        neg = rng.random(n) < 0.5
        idx[oob & neg] = rng.integers(-100_000, 0, int((oob & neg).sum()))
        idx[oob & ~neg] = rng.integers(OUT_SIZE, OUT_SIZE + 100_000,
                                       int((oob & ~neg).sum()))
        vals = rng.standard_normal((n, nf)).astype(np.float32)
        return (torch.as_tensor(idx.astype(np.int32), device=dev),
                torch.as_tensor(vals, device=dev))

    def check(got, want, what):
        err = float((got - want).abs().max()) if got.numel() else 0.0
        if not torch.allclose(got, want, atol=ATOL, rtol=RTOL):
            raise AssertionError(f"{what}: kernel vs plain max |err| {err}")
        return err

    def dest(nf, wide):
        """Zeroed destination: the [:, :F] view of 32-byte rows (vector
        reductions) or a contiguous [out, F] tensor (scalar reductions)."""
        if wide:
            return sa.new_accumulator(OUT_SIZE, dev)[:, :nf]
        return torch.zeros((OUT_SIZE, nf), device=dev)

    errs = {}
    for nf in (1, 2, 3, 4, 5):
        idx, vals = case(N_SAMPLES, nf=nf)
        idx2, vals2 = case(N_SAMPLES, nf=nf)
        for wide in (False, True):
            what = f"F={nf} {'32-byte rows' if wide else 'contiguous'}"
            got, want = dest(nf, wide), dest(nf, wide)
            sa.scatter_add_multi(idx, vals, OUT_SIZE, acc=got)
            sa.scatter_add_multi_reference(idx, vals, OUT_SIZE, acc=want)
            e1 = check(got, want, what)
            # carry-in: the second call accumulates into the first result
            sa.scatter_add_multi(idx2, vals2, OUT_SIZE, acc=got)
            sa.scatter_add_multi_reference(idx2, vals2, OUT_SIZE, acc=want)
            errs[what] = max(e1, check(got, want, what + " carry-in"))
            if wide and bool(got._base[:, nf:].any()):
                raise AssertionError(f"{what}: the row's padding was written")
    # the payload as five separate fields, fusion's call
    got, want = dest(5, True), dest(5, True)
    sa.scatter_add_fields(idx, [vals[:, f].contiguous() for f in range(5)],
                          OUT_SIZE, acc=got)
    sa.scatter_add_multi_reference(idx, vals, OUT_SIZE, acc=want)
    errs["F=5 separate fields"] = check(got, want, "F=5 separate fields")
    # heavy duplicates: every warp holds repeated destinations
    hidx, hvals = case(N_SAMPLES, hi=HEAVY_ROWS)
    for wide in (False, True):
        what = f"F=5 into {HEAVY_ROWS} rows {'32-byte rows' if wide else 'contiguous'}"
        got, want = dest(5, wide), dest(5, wide)
        sa.scatter_add_multi(hidx, hvals, OUT_SIZE, acc=got)
        sa.scatter_add_multi_reference(hidx, hvals, OUT_SIZE, acc=want)
        errs[what] = check(got, want, what)
    # all 32 lanes of every warp on one destination, in a fixed order
    same = torch.full((1024,), 7, dtype=torch.int32, device=dev)
    got = sa.scatter_add_multi(same, hvals[:1024].contiguous(), OUT_SIZE)
    want = sa.scatter_add_multi_reference(same, hvals[:1024].contiguous(), OUT_SIZE)
    errs["one destination"] = check(got, want, "one destination")
    v1 = vals[:, 0].contiguous()
    errs["rows F=1"] = check(sa.scatter_add_rows(idx, v1, OUT_SIZE),
                             sa.scatter_add_rows_reference(idx, v1, OUT_SIZE),
                             "rows F=1")
    empty = sa.scatter_add_multi(idx[:0], vals[:0], OUT_SIZE)
    if empty.shape != (OUT_SIZE, 5) or bool(empty.any()):
        raise AssertionError("empty input must give a zero accumulator")
    torch.cuda.synchronize()
    for what, err in errs.items():
        log(f"  phase2 {what}: max_abs_err {err:.3g}")

    # times at N=600k, F=5: the kernel into 32-byte rows and into contiguous
    # rows, the plain version, and the bare index_add_ on pre-masked int64
    # indices (a yardstick; the package never calls it)
    del got, want
    wide, narrow = dest(5, True), dest(5, False)
    for name, hi in (("random over all rows", OUT_SIZE),
                     ("into 131 blocks", 131 * 512),
                     (f"into {HEAVY_ROWS} rows", HEAVY_ROWS)):
        idx, vals = case(N_SAMPLES, hi=hi)
        keep = (idx >= 0) & (idx < OUT_SIZE)
        idx64, kept = idx[keep].long(), vals[keep]
        distinct = int(torch.unique(idx64).numel())
        bound = scatter_bound_ms(N_SAMPLES, idx64.numel(), distinct)
        ms = median_ms(lambda: sa.scatter_add_multi(idx, vals, OUT_SIZE, acc=wide))
        ms_c = median_ms(lambda: sa.scatter_add_multi(idx, vals, OUT_SIZE, acc=narrow))
        plain = median_ms(lambda: sa.scatter_add_multi_reference(
            idx, vals, OUT_SIZE, acc=narrow))
        lib = median_ms(lambda: narrow.index_add_(0, idx64, kept))
        log(f"phase2 F=5 N={N_SAMPLES} {name} ({distinct} distinct rows): kernel "
            f"{ms:.4f} ms into 32-byte rows, {ms_c:.4f} ms into contiguous rows; "
            f"plain {plain:.4f} ms; library_ms (index_add_) {lib:.4f}; byte "
            f"bound {bound:.5f} ms")
    idx, vals = case(N_SAMPLES, nf=1)
    keep = (idx >= 0) & (idx < OUT_SIZE)
    idx64, kept = idx[keep].long(), vals[keep]
    distinct = int(torch.unique(idx64).numel())
    dest1 = torch.zeros((OUT_SIZE, 1), device=dev)
    ms = median_ms(lambda: sa.scatter_add_multi(idx, vals, OUT_SIZE, acc=dest1))
    plain = median_ms(lambda: sa.scatter_add_multi_reference(
        idx, vals, OUT_SIZE, acc=dest1))
    lib = median_ms(lambda: dest1.index_add_(0, idx64, kept))
    whole = median_ms(lambda: sa.scatter_add_rows(idx, vals[:, 0], OUT_SIZE))
    log(f"phase2 F=1 N={N_SAMPLES} random over all rows ({distinct} distinct "
        f"rows): kernel {ms:.4f} ms; plain {plain:.4f} ms; library_ms "
        f"(index_add_) {lib:.4f}; byte bound "
        f"{scatter_bound_ms(N_SAMPLES, idx64.numel(), distinct, nf=1):.5f} ms; "
        f"scatter_add_rows with its zero fill {whole:.4f} ms")
    return max(errs.values())


def phase_merge_and_in_situ():
    """`merge_clear` against its plain version, and both kernels' times, on
    golden frame 5's real samples after frames 0-4 were fused."""
    import torch
    from gradient_sdf_tpu_torch.ops.kernels import merge_clear as mc
    from gradient_sdf_tpu_torch.ops.kernels import scatter_add as sa
    from gradient_sdf_tpu_torch.tools.fusion_bench import (
        frame5_samples, median_ms, merge_bound_ms, scatter_bound_ms)

    dev = torch.device("cuda")
    m, grid, lin, s = frame5_samples(dev)
    nvox = grid.num_blocks * grid.voxels_per_block
    n = lin.numel()
    fields = [s.w, s.wd, s.wn_x, s.wn_y, s.wn_z]
    payload = torch.stack(fields, dim=-1)
    inmap = (lin >= 0) & (lin < nvox)
    distinct = int(torch.unique(lin[inmap]).numel())
    active = int(grid.num_active)
    rows = active * grid.voxels_per_block
    state = [grid.weight, grid.dist, grid.grad_x, grid.grad_y, grid.grad_z]
    names = ["weight", "dist", "grad_x", "grad_y", "grad_z"]
    acc = m.acc
    if bool(acc.any()):
        raise AssertionError("the map's accumulator is not zero between frames")

    # scatter, on the real samples: kernel vs plain
    sa.scatter_add_fields(lin, fields, nvox, acc=acc[:, :5])
    want = sa.scatter_add_multi_reference(
        lin, payload, nvox, acc=sa.new_accumulator(nvox, dev)[:, :5])
    scatter_err = float((acc[:, :5] - want).abs().max())
    if not torch.allclose(acc[:, :5], want, atol=ATOL, rtol=RTOL):
        raise AssertionError(f"in-situ scatter vs plain max |err| {scatter_err}")

    # merge_clear: kernel vs plain from the same accumulator and state, with
    # and without gradients. Tolerance 0: the kernel uses the plain
    # version's operations (add, multiply, IEEE divide, no fused
    # multiply-add), so every field must agree bit for bit.
    merge_err = 0.0
    for with_grad in (True, False):
        acc_k, acc_p = acc.clone(), acc.clone()
        got = [f.clone() for f in state]
        ref = [f.clone() for f in state]
        mc.merge_clear(acc_k, *got, grid.num_active, with_grad=with_grad)
        mc.merge_clear_reference(acc_p, *ref, grid.num_active,
                                 with_grad=with_grad)
        torch.cuda.synchronize()
        for name, a, b, before in zip(names, got, ref, state):
            err = float((a - b).abs().max())
            merge_err = max(merge_err, err)
            if not torch.equal(a, b):
                raise AssertionError(
                    f"merge_clear {name} (with_grad={with_grad}): kernel vs "
                    f"plain max |err| {err}, want bit equality")
            if not torch.equal(a[active:], before[active:]):
                raise AssertionError(f"merge_clear wrote {name} past num_active")
            if not with_grad and name.startswith("grad") and not torch.equal(a, before):
                raise AssertionError("merge_clear wrote gradients with_grad=False")
        if bool(acc_k.any()) or bool(acc_p.any()):
            raise AssertionError("the accumulator does not read zero after merge_clear")
        if torch.equal(got[0], state[0]):
            raise AssertionError("merge_clear left the weights unchanged")

    # times, all on these samples (acc holds frame 5's sums; values do not
    # change the work)
    view = acc[:, :5]
    spare = [f.clone() for f in state]
    scatter_ms = median_ms(lambda: sa.scatter_add_fields(lin, fields, nvox, acc=view))
    narrow = torch.zeros((nvox, 5), device=dev)
    scatter_plain = median_ms(lambda: sa.scatter_add_multi_reference(
        lin, payload, nvox, acc=narrow))
    lin64, kept = lin[inmap].long(), payload[inmap]
    scatter_lib = median_ms(lambda: narrow.index_add_(0, lin64, kept))
    del narrow
    # the F = 1 launch (`scatter_add_rows`' kernel) on the same samples'
    # weights, into a contiguous [nvox, 1] destination
    w1 = s.w[:, None].contiguous()
    narrow1 = torch.zeros((nvox, 1), device=dev)
    rows_ms = median_ms(lambda: sa.scatter_add_multi(lin, w1, nvox, acc=narrow1))
    rows_plain = median_ms(lambda: sa.scatter_add_multi_reference(
        lin, w1, nvox, acc=narrow1))
    kept1 = w1[inmap]
    rows_lib = median_ms(lambda: narrow1.index_add_(0, lin64, kept1))
    rows_bound = scatter_bound_ms(n, int(inmap.sum()), distinct, nf=1)
    del narrow1
    log(f"phase2b scatter F=1 (scatter_add_rows' launch) in situ, frame 5: "
        f"kernel {rows_ms:.4f} ms, plain {rows_plain:.4f} ms, library_ms "
        f"(index_add_) {rows_lib:.4f}, byte bound {rows_bound:.5f} ms")
    merge_ms = median_ms(lambda: mc.merge_clear(acc, *spare, grid.num_active))
    merge_plain = median_ms(lambda: mc.merge_clear_reference(
        acc, *spare, grid.num_active))
    merge_dense = median_ms(lambda: mc.merge_clear_reference(
        acc, *spare, grid.num_active, dense=True))
    # each input read once, each output written once, counting only what
    # these samples need: every index and the payload of the samples inside
    # the map in, each touched row read and written; per allocated row, five
    # accumulator floats and five fields read, five fields and five zeros
    # written
    scatter_bound = scatter_bound_ms(n, int(inmap.sum()), distinct)
    merge_bound = merge_bound_ms(rows)
    log(f"phase2b merge_clear + in situ, frame 5: N={n} samples, {distinct} distinct voxels, "
        f"{active} blocks; fuse_scatter_path_ms: payload build 0 (the kernel "
        f"takes the five fields), accumulator zero 0 (merge_clear clears), "
        f"scatter {scatter_ms:.4f} (plain {scatter_plain:.4f}, index_add_ "
        f"{scatter_lib:.4f}, bound {scatter_bound:.5f}), merge_clear "
        f"{merge_ms:.4f} (plain {merge_plain:.4f} over the allocated slots, "
        f"{merge_dense:.4f} over every slot, bound {merge_bound:.5f}); max_abs_err "
        f"scatter {scatter_err:.3g}, merge_clear {merge_err:.3g} (bit equality)")
    return {
        "scatter": {"max_abs_err": scatter_err, "ms": scatter_ms,
                    "plain_ms": scatter_plain, "bound_ms": scatter_bound,
                    "library_ms": scatter_lib},
        "merge": {"max_abs_err": merge_err, "ms": merge_ms,
                  "plain_ms": merge_plain, "bound_ms": merge_bound,
                  "library_ms": None},
    }


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


def reset_launch_counts():
    from gradient_sdf_tpu_torch.ops.kernels import merge_clear as mc
    from gradient_sdf_tpu_torch.ops.kernels import scatter_add as sa

    sa.reset_launch_count()
    mc.reset_launch_count()


def launch_counts():
    from gradient_sdf_tpu_torch.ops.kernels import merge_clear as mc
    from gradient_sdf_tpu_torch.ops.kernels import scatter_add as sa

    return {"scatter_add": sa.launch_count, "merge_clear": mc.launch_count}


def check_outputs(m, results, launches, n_frames):
    from gradient_sdf_tpu_torch.utils.ply import load_ply

    if m["invalid_frames"]:
        raise AssertionError(f"invalid frames {m['invalid_frames']}")
    if m["overflow"] or m["num_blocks_active"] <= 0 or m["frames"] != n_frames:
        raise AssertionError(f"bad map state {m}")
    fused = sum(1 for e in m["frame_log"] if e["fuse_ms"] is not None)
    # the main path launches each kernel exactly once per fused frame
    if any(count != fused for count in launches.values()):
        raise AssertionError(f"kernel launches {launches} for {fused} fused "
                             f"frames, want one each per frame")
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
    # warm-up run (CUDA libraries' lazy init), then the measured run
    run_app(data, os.path.join(WORK, "warm"), ["--pose-file", "none"])
    results = os.path.join(WORK, "track")
    reset_launch_counts()
    m = run_app(data, results, ["--pose-file", "none"])
    launches = launch_counts()
    fused, n_faces, n_pts = check_outputs(m, results, launches, n_frames)
    errs = rel_translation_errors(results, data)
    if not max(errs) < 0.01:
        raise AssertionError(f"relative translation errors {errs} (limit 1 cm)")
    fps, fps_steady = frame_summary("track", m)
    log(f"phase4 scan3d tracking: {m['frames']} frames, {fused} fused, "
        f"{m['num_blocks_active']} blocks, {n_faces} faces, {n_pts} cloud "
        f"points, kernel launches {launches}, max rel. translation error "
        f"{max(errs) * 1e3:.3f} mm; {fps:.2f} fps all frames, "
        f"{fps_steady:.2f} fps frames 1-{n_frames - 1}")
    return launches


def phase_gt(data, n_frames):
    results = os.path.join(WORK, "gt")
    reset_launch_counts()
    m = run_app(data, results, ["--pose-file", "gt_poses.txt"])
    launches = launch_counts()
    fused, n_faces, n_pts = check_outputs(m, results, launches, n_frames)
    fps, _ = frame_summary("gt", m)
    log(f"phase5 scan3d GT poses: {fused} fused, {m['num_blocks_active']} "
        f"blocks, {n_faces} faces, {n_pts} cloud points, kernel launches "
        f"{launches}; {fps:.2f} fps")


def translation_errors(path, truth):
    """|t - t_gt| per pose of the TUM trajectory at `path`, matched by stamp."""
    import numpy as np
    from gradient_sdf_tpu_torch.utils import tumio

    return [float(np.linalg.norm(t - truth[ts]))
            for ts, _, t in tumio.read_trajectory(path)]


def run_photoba(data, results, extra):
    """The PhotoBA app on the card through its CLI entry point, the kernel
    launch counts set to 0 just before and read just after."""
    from gradient_sdf_tpu_torch.apps import photoba

    metrics_path = os.path.join(results, "metrics.json")
    os.makedirs(results, exist_ok=True)
    reset_launch_counts()
    t0 = time.perf_counter()
    photoba.main(["--input", data, "--results", results, "--data-type", "synth",
                  "--voxel-size", "0.02", "--trunc", "5",
                  "--metrics-json", metrics_path] + extra)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    with open(metrics_path) as f:
        return json.load(f), launches, wall


def check_photoba(m, results, launches):
    """What `tests/test_photoba_app.py` asks of the JAX app's outputs, and
    that the run went through both kernels once per fused frame on a CUDA
    device. Returns (fused frames, HR mesh vertices, HR cloud points)."""
    import math
    from gradient_sdf_tpu_torch.utils.ply import load_ply

    for name in PHOTOBA_ARTIFACTS:
        if not os.path.isfile(os.path.join(results, name)):
            raise AssertionError(f"photoba did not write {name}")
    es = m["ba_energies"]
    if m["keyframes"] < 2 or len(es) < 3:
        raise AssertionError(f"{m['keyframes']} keyframes, {len(es)} energies")
    if not all(math.isfinite(e) for e in es):
        raise AssertionError(f"BA energies {es}")
    if not m["device"].startswith("cuda"):
        raise AssertionError(f"photoba ran on {m['device']}")
    fused = m["timers"]["Integrate depth data into Sdf"]["count"]
    if fused <= 0 or any(count != fused for count in launches.values()):
        raise AssertionError(f"kernel launches {launches} for {fused} fused "
                             f"frames, want one each per frame")
    mesh = load_ply(os.path.join(results, "coarse_BA_mesh_after_upsample.ply"))
    cloud = load_ply(os.path.join(results, "coarse_BA_cloud_after_upsample.ply"))
    if len(mesh["vertex"]) <= 100 or "red" not in mesh["vertex"].dtype.names:
        raise AssertionError(f"HR mesh: {len(mesh['vertex'])} vertices, "
                             f"fields {mesh['vertex'].dtype.names}")
    reds = cloud["vertex"]["red"]
    if len(reds) <= 50 or not reds.max() > 20:
        raise AssertionError(f"HR cloud: {len(reds)} points, no colour")
    return fused, len(mesh["vertex"]), len(reds)


def timer_ms(m, name, key="total_s"):
    return m["timers"][name][key] * 1e3 if name in m["timers"] else 0.0


def phase_photoba(data, n_frames):
    results = os.path.join(WORK, "photoba")
    m, launches, wall = run_photoba(data, results, ["--key-frame", "5"])
    fused, n_verts, n_pts = check_photoba(m, results, launches)
    if len(m["invalid_frames"]) > 2 or fused < n_frames - 2:
        raise AssertionError(f"invalid frames {m['invalid_frames']}")
    # No bound on the energies here: the spheres' colours are flat, so only
    # silhouette voxels carry image gradients, the 6x6 pose systems are
    # close to singular, and at 640x480 the first undamped pose step raises
    # the energy in this package and in the JAX app alike (on the CPU, same
    # data: 7.88 -> 246.7 here, 8.37 -> 365.4 there). Phase 6b holds BA to
    # a decrease on data where it is well posed.
    fuse, track = "Integrate depth data into Sdf", "Point optimization"
    log(f"phase6 photoba on {m['device']}: {n_frames} frames 640x480, {fused} "
        f"fused with visibility bits, invalid {m['invalid_frames']}, "
        f"{m['keyframes']} keyframes, BA converged {m['ba_converged']} with "
        f"energies {[float(f'{e:.6g}') for e in m['ba_energies']]}, HR mesh "
        f"{n_verts} vertices, HR cloud {n_pts} points, kernel launches "
        f"{launches}; wall {wall * 1e3:.1f} ms = phase 1 "
        f"{timer_ms(m, fuse) + timer_ms(m, track):.1f} (track "
        f"{timer_ms(m, track):.1f}, fuse {timer_ms(m, fuse):.1f}; fuse_ms with "
        f"with_vis=True median {timer_ms(m, fuse, 'median_s'):.2f}) + BA "
        f"{timer_ms(m, 'Photometric BA'):.1f} + upsampling "
        f"{timer_ms(m, 'Color upsampling'):.1f} + decode, exports and the rest")
    return launches


def phase_photoba_recovery():
    """Textured spheres (with flat colours every residual is zero and BA has
    nothing to do), fused at the ground-truth poses; BA starts from poses
    moved by ~3 mm and has to win energy back. The keyframes' translation
    errors before and after are printed, not checked: the texture pins the
    cameras to the surface, not to the world, so they may move together."""
    import numpy as np
    from gradient_sdf_tpu_torch.apps import make_synth
    from gradient_sdf_tpu_torch.utils import tumio

    data = os.path.join(WORK, "textured")
    make_synth.main(["--out", data, "--frames", "8", "--seed", "2", "--width",
                     "640", "--height", "480", "--arc-deg", "6", "--no-noise",
                     "--gray-texture"])
    gt = tumio.read_trajectory(os.path.join(data, "gt_poses.txt"))
    rng = np.random.RandomState(3)
    tumio.write_trajectory(
        os.path.join(data, "ba_init.txt"),
        [(ts, R, t + (rng.randn(3) * 0.003).astype(np.float32)) for ts, R, t in gt])
    results = os.path.join(WORK, "photoba_recovery")
    m, launches, _ = run_photoba(data, results, [
        "--key-frame", "4", "--pose-file", "gt_poses.txt",
        "--ba-init-pose-file", "ba_init.txt"])
    check_photoba(m, results, launches)
    truth = {ts: t for ts, _, t in gt}
    before = translation_errors(os.path.join(
        results, "selected_frame_poses_before_optimization.txt"), truth)
    after = translation_errors(os.path.join(
        results, "coarse_BA_poses_optimized.txt"), truth)
    es = m["ba_energies"]
    if not es[-1] < 0.9 * es[0] or not np.isfinite(after).all() or after == before:
        raise AssertionError(f"BA did not recover: energies {es}, pose errors "
                             f"{before} -> {after} m")
    log(f"phase6b photoba recovery on textured spheres: {m['keyframes']} "
        f"keyframes, {(len(es) - 1) // 2} BA iterations in "
        f"{timer_ms(m, 'Photometric BA'):.1f} ms, energy {es[0]:.6g} -> "
        f"{es[-1]:.6g}, mean keyframe translation error "
        f"{np.mean(before) * 1e3:.3f} -> {np.mean(after) * 1e3:.3f} mm")


def phase_ba_scale():
    """One BA alternation at F = 30, V = 102400, 640x480 images: the card
    against the CPU from the same arrays, then the card's time, kernel
    count and busy share."""
    import numpy as np
    import torch
    from gradient_sdf_tpu_torch.tools import ba_bench
    from gradient_sdf_tpu_torch.utils import interop

    arrays = ba_bench.bench_arrays()
    gcfg, pcfg = ba_bench.bench_configs()
    out = {}
    for name in ("cuda", "cpu"):
        problem = interop.problem_from_numpy(arrays[0], name)
        state = interop.state_from_numpy(arrays[1], name)
        t0 = time.perf_counter()
        new, e_pose, e_dist = ba_bench.alternation(problem, state, gcfg, pcfg)
        out[name] = (interop.state_to_numpy(new), e_pose, e_dist,
                     (time.perf_counter() - t0) * 1e3)
    (sc, ec1, ec2, _), (sh, eh1, eh2, cpu_ms) = out["cuda"], out["cpu"]
    for what, a, b in (("after the pose step", ec1, eh1),
                       ("after the dist step", ec2, eh2)):
        if not (np.isfinite(a) and abs(a - b) <= BA_E_RTOL * abs(b)):
            raise AssertionError(f"energy {what}: card {a} vs CPU {b}")
    pose_err = max(np.abs(sc["R"] - sh["R"]).max(), np.abs(sc["t"] - sh["t"]).max())
    if not pose_err <= BA_POSE_ATOL:
        raise AssertionError(f"poses after one step: card vs CPU max |err| {pose_err}")
    moved = np.abs(sh["dist"] - arrays[1]["dist"]).max()
    miss = np.abs(sc["dist"] - sh["dist"]) > (BA_DIST_ATOL
                                              + BA_DIST_RTOL * np.abs(sh["dist"]))
    if not moved > 1e-5 or not np.isfinite(sc["dist"]).all():
        raise AssertionError(f"dist step: largest move {moved}")
    if miss.mean() > BA_OUTLIERS:
        raise AssertionError(f"dist: {miss.sum()} of {miss.size} voxels miss "
                             f"atol {BA_DIST_ATOL} + rtol {BA_DIST_RTOL}")
    inliers = np.abs(sc["dist"] - sh["dist"])[~miss].max()

    problem = interop.problem_from_numpy(arrays[0], "cuda")
    state = interop.state_from_numpy(arrays[1], "cuda")
    ms, runs = ba_bench.alternation_ms(problem, state, gcfg, pcfg)
    prof = ba_bench.profile_alternation(problem, state, gcfg, pcfg)
    V, F = arrays[0]["vis"].shape
    log(f"phase7 BA alternation F={F} V={V} 640x480, card vs CPU (all {V} "
        f"voxels): energies {ec1:.6g} / {ec2:.6g} vs {eh1:.6g} / {eh2:.6g} "
        f"(rtol {BA_E_RTOL}), poses max |err| {pose_err:.3g} (atol "
        f"{BA_POSE_ATOL}), dist max |err| {inliers:.3g} with {int(miss.sum())} "
        f"voxels beyond atol {BA_DIST_ATOL} + rtol {BA_DIST_RTOL} (limit "
        f"{BA_OUTLIERS:g} of them); card {ms:.2f} ms per alternation (median "
        f"of {[float(f'{r:.2f}') for r in runs]}), CPU {cpu_ms:.0f} ms (first "
        f"call); profiler: {prof['device_events']} kernels, "
        f"{prof['cudaLaunchKernel_calls']} cudaLaunchKernel calls, device busy "
        f"{prof['device_busy_ms']:.2f} of {prof['profiled_wall_ms']:.2f} ms "
        f"({prof['device_busy_share']:.1%}), host syncs {prof['host_syncs']}")
    for r in prof["top"][:5]:
        log(f"  phase7 top kernel: {r['ms']:.3f} ms x{r['count']} {r['name']}")


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
    synth_err = phase_kernel()
    kstats = phase_merge_and_in_situ()
    kstats["scatter"]["max_abs_err"] = max(kstats["scatter"]["max_abs_err"],
                                           synth_err)
    phase_fusion()

    from gradient_sdf_tpu_torch.apps import make_synth

    data = os.path.join(WORK, "golden")
    n_frames = 6
    make_synth.main(["--out", data, "--frames", str(n_frames), "--seed", "2",
                     "--width", "640", "--height", "480", "--arc-deg", "4",
                     "--no-noise"])
    launches = phase_app(data, n_frames)
    phase_gt(data, n_frames)

    # PhotoBA: the JAX app test's protocol at full VGA width
    ba_data = os.path.join(WORK, "photoba_data")
    ba_frames = 14
    make_synth.main(["--out", ba_data, "--frames", str(ba_frames), "--seed", "2",
                     "--width", "640", "--height", "480", "--arc-deg", "10",
                     "--no-noise"])
    ba_launches = phase_photoba(ba_data, ba_frames)
    phase_photoba_recovery()
    phase_ba_scale()
    # each main path was counted from zero and launched both kernels
    paths = {"phase 4 (scan3d)": launches, "phase 6 (photoba)": ba_launches}
    for path, counts in paths.items():
        if any(c <= 0 for c in counts.values()):
            raise AssertionError(f"{path} launched no kernel: {counts}")
    launches = {k: sum(c[k] for c in paths.values()) for k in launches}
    counted = "phase 4 (scan3d tracking) + phase 6 (photoba)"

    log(smi_line())
    log(json.dumps({"kernels": [{
        "name": "scatter_add_multi",
        "route": "cuda",
        "source": "gradient_sdf_tpu_torch/csrc/scatter_add.cu",
        "replaces": "gradient_sdf_tpu/ops/pallas/scatter_add.py:103",
        "launches": launches["scatter_add"],
        "launches_counted_in": counted,
        "bound_by": "bytes",
        **kstats["scatter"],
    }, {
        "name": "merge_clear",
        "route": "cuda",
        "source": "gradient_sdf_tpu_torch/csrc/merge_clear.cu",
        "replaces": "gradient_sdf_tpu/ops/fusion.py:362",
        "launches": launches["merge_clear"],
        "launches_counted_in": counted,
        "bound_by": "bytes",
        **kstats["merge"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
