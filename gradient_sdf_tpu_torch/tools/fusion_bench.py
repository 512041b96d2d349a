#!/usr/bin/env python3
"""Card measurements of fusion's accumulator path (needs one CUDA card).

    python3 gradient_sdf_tpu_torch/tools/fusion_bench.py [--parent DIR]

Everything runs on the golden protocol (640x480 spheres seed 2, 6 frames
over a 4 degree arc, 2 cm voxels, trunc 5, app-default 16384-block grid)
and is timed on the device with CUDA events (see `median_ms`) unless a line
says otherwise. It prints:

  1. in situ, frame 5's real samples after frames 0-4 are fused: the
     scatter kernel (five separate fields into the 32-byte-row accumulator;
     one [N, 5] payload; a contiguous [nvox, 5] destination; the samples
     reordered k-major) and `merge_clear`, beside the bare `index_add_`
     (the library yardstick, never called by the package), the plain
     versions, and the two passes a persistent accumulator saves
     (`torch.stack` of the payload, a fresh `torch.zeros((nvox, 5))`);
  2. the scatter kernel at N = 600k synthetic samples (random over all 8.4M
     rows, into 131 blocks, into 14k rows), in turns with the yardstick;
  3. per tree, each in its own process: that tree's `scatter_add_multi`
     into a contiguous [nvox, 5] destination (the one call every version
     of the package supports) on the samples of 1 and 2, and `GradSdfMap`
     loops over frames 1-5 under `torch.profiler` (fusion with ground-truth
     poses, and tracking + fusion): wall ms, device-busy ms and the kernels
     that take most device time.

With `--parent DIR` (a checkout of an earlier commit, e.g. unpacked with
`git archive`), part 3 runs parent, this, this, parent; the parent is
reached only through its own Python package, so any earlier version of
the package will do. `--tree DIR SAMPLES` is what the script passes to
itself for part 3: it imports the package from DIR and measures that tree
alone on the samples saved in SAMPLES.

    python3 gradient_sdf_tpu_torch/tools/fusion_bench.py --split [--parent DIR]

runs only the split of `fuse_frame` instead: per tree (parent, this, this,
parent with `--parent`, each in its own process through its own package,
`--split-tree DIR`), golden frames 1-5 fused from ground-truth poses with
the tree's single-card path written out part by part (`fuse_parts`), each
part timed on the host clock (synchronized before and after) and with CUDA
events around it, and counted once under the profiler (kernel launches,
memsets and copies) and PyTorch's sync debug mode (host syncs); beside it
the whole `fuse_frame` on the host clock. Then Scan3D on the golden
dataset through each tree's app in the same turns (`track_bench.app_turns`:
track_ms, fuse_ms, fps).
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OWN_ROOT = os.path.dirname(os.path.dirname(HERE))
N_SYNTH = 600_000
NVOX = 16384 * 512
MEM_BYTES_PER_S = 3.35e12   # the card's memory rate (H100 SXM data sheet)


def log(msg):
    print(msg, flush=True)


def median_ms(fn, reps=20, batches=5):
    """Device time of one `fn()` in ms: the median over `batches` of the
    CUDA-event time around `reps` back-to-back calls, divided by `reps`.
    Each batch is enqueued behind a few ms of device-side spinning, so the
    host runs ahead and the events bracket device work, not the Python
    wrapper (which takes longer than a short kernel). A `fn` that waits for
    the device itself (a host sync) is timed with that wait."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    times.sort()
    return times[len(times) // 2]


def golden_protocol():
    """(pipeline config, [depth numpy], [(R, t)]) of the golden protocol."""
    import numpy as np
    from gradient_sdf_tpu_torch.config import PipelineConfig
    from gradient_sdf_tpu_torch.data import synth

    cfg = PipelineConfig()
    cfg = dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, voxel_size=0.02),
        fusion=dataclasses.replace(cfg.fusion, trunc_voxels=5.0))
    world = synth.random_spheres(seed=2, device="cpu")
    poses = synth.orbit_poses(n=6, radius=2.0, arc=np.deg2rad(4.0))
    depths = [synth.quantize_depth(synth.render_depth(world, R, t)).numpy()
              for R, t in poses]
    return cfg, depths, poses


def frame5_samples(dev):
    """Fuse frames 0-4 through a map, then walk frame 5 as `fuse_frame`
    does up to the scatter. Returns (map, grid, lin, samples)."""
    import torch
    from gradient_sdf_tpu_torch.data import synth
    from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap
    from gradient_sdf_tpu_torch.ops import fusion

    cfg, depths, poses = golden_protocol()
    m = GradSdfMap(cfg, device=dev)
    for depth, pose in zip(depths[:5], poses[:5]):
        m.update(depth, synth.KINECT_K, pose)
    gcfg, fcfg = m.cfg.grid, m.cfg.fusion
    depth = torch.as_tensor(depths[5], device=dev)
    R = torch.as_tensor(poses[5][0], device=dev)
    t = torch.as_tensor(poses[5][1], device=dev)
    rays = fusion._pixel_rays(depth, fusion.compute_normals(m.cache, depth),
                              m.cache, fcfg)
    idx = torch.nonzero(rays.valid).reshape(-1)
    rays = fusion.FrameRays(*(a[idx] for a in rays[:-1]),
                            valid=torch.ones_like(idx, dtype=torch.bool))
    s = fusion._ray_samples(rays, R, t, gcfg, fcfg)
    grid, lin, _ = fusion._alloc_slots(m.grid, s, gcfg)
    m.grid = grid
    torch.cuda.synchronize()
    return m, grid, lin, s


def scatter_bound_ms(n, in_map, distinct, nf=5):
    """Least time for the bytes the scatter must move: every index read,
    the payload of the samples that land in the map read, each touched row
    read and written."""
    return (n * 4 + in_map * 4 * nf + distinct * 8 * nf) / MEM_BYTES_PER_S * 1e3


def merge_bound_ms(rows, nf=5):
    """Least time for the bytes `merge_clear` must move per allocated row:
    nf accumulator floats and nf fields read, nf fields and nf zeros
    written (the row's padding is never needed)."""
    return rows * 4 * (4 * nf) / MEM_BYTES_PER_S * 1e3


def part_in_situ():
    """Returns frame 5's (lin, [N, 5] payload) for the per-tree part."""
    import torch
    from gradient_sdf_tpu_torch.ops.kernels import merge_clear as mc
    from gradient_sdf_tpu_torch.ops.kernels import scatter_add as sa

    dev = torch.device("cuda")
    m, grid, lin, s = frame5_samples(dev)
    n = lin.numel()
    nvox = grid.num_blocks * grid.voxels_per_block
    inmap = (lin >= 0) & (lin < nvox)
    in_map = int(inmap.sum())
    distinct = int(torch.unique(lin[inmap]).numel())
    active = int(grid.num_active)
    fields = [s.w, s.wd, s.wn_x, s.wn_y, s.wn_z]
    bound_scatter = scatter_bound_ms(n, in_map, distinct)
    bound_merge = merge_bound_ms(active * grid.voxels_per_block)
    log(f"in situ frame 5: N={n} samples, {in_map} in the map, "
        f"{distinct} distinct voxels, {active} blocks allocated; byte bounds "
        f"scatter {bound_scatter:.5f} ms, merge_clear {bound_merge:.5f} ms")

    acc8 = m.acc
    view = acc8[:, :5]
    few = [f[:32].contiguous() for f in fields]
    floor = median_ms(lambda: sa.scatter_add_fields(lin[:32], few, nvox, acc=view))
    log(f"  floor of this timing: the scatter kernel on 32 samples {floor:.4f} ms")
    soa = median_ms(lambda: sa.scatter_add_fields(lin, fields, nvox, acc=view))
    payload = torch.stack(fields, dim=-1)
    aos = median_ms(lambda: sa.scatter_add_multi(lin, payload, nvox, acc=view))
    acc5 = torch.zeros((nvox, 5), device=dev)
    contig = median_ms(lambda: sa.scatter_add_multi(lin, payload, nvox, acc=acc5))
    # the same samples with k (the step along the ray) as the slow index
    k = int(m.cfg.fusion.trunc_voxels) * 2 + 1
    lin_k = lin.view(-1, k).T.reshape(-1).contiguous()
    fields_k = [f.view(-1, k).T.reshape(-1).contiguous() for f in fields]
    kmajor = median_ms(
        lambda: sa.scatter_add_fields(lin_k, fields_k, nvox, acc=view))
    lin64, pvals = lin[inmap].long(), payload[inmap]
    lib = median_ms(lambda: acc5.index_add_(0, lin64, pvals))
    plain = median_ms(
        lambda: sa.scatter_add_multi_reference(lin, payload, nvox, acc=acc5))
    log(f"  scatter kernel ms: fields -> 32-byte rows {soa:.4f} "
        f"({bound_scatter / soa:.1%} of the bound); [N,5] payload "
        f"-> 32-byte rows {aos:.4f}; [N,5] -> contiguous [nvox,5] (scalar "
        f"reductions) {contig:.4f}; fields, k-major order {kmajor:.4f}; "
        f"index_add_ bare {lib:.4f}; plain {plain:.4f}")

    acc8.zero_()
    g = [grid.weight, grid.dist, grid.grad_x, grid.grad_y, grid.grad_z]
    spare = [f.clone() for f in g]
    merge = median_ms(lambda: mc.merge_clear(acc8, *spare, grid.num_active))
    merge_plain = median_ms(
        lambda: mc.merge_clear_reference(acc8, *spare, grid.num_active))
    merge_dense = median_ms(lambda: mc.merge_clear_reference(
        acc8, *spare, grid.num_active, dense=True))
    both = median_ms(lambda: (
        sa.scatter_add_fields(lin, fields, nvox, acc=view),
        mc.merge_clear(acc8, *spare, grid.num_active)))
    log(f"  merge_clear ms: kernel {merge:.4f} ({bound_merge / merge:.1%} of "
        f"the bound); plain over the allocated slots (reads num_active on "
        f"the host) {merge_plain:.4f}; plain over every slot "
        f"{merge_dense:.4f}; scatter + merge_clear together {both:.4f}")

    # what the persistent accumulator and the five-field payload save
    stack = median_ms(lambda: (torch.stack(fields, dim=-1),
                               lin.to(torch.int32).contiguous()))
    zero = median_ms(lambda: torch.zeros((nvox, 5), device=dev))
    log(f"  saved per frame, ms: stack + int32 convert {stack:.4f}; "
        f"zeros((nvox, 5)) {zero:.4f}")
    return lin.cpu(), payload.cpu()


def part_synthetic():
    """Returns {case name: (idx, vals)} for the per-tree part."""
    import numpy as np
    import torch
    from gradient_sdf_tpu_torch.ops.kernels import scatter_add as sa

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    acc8 = sa.new_accumulator(NVOX, dev)
    acc5 = torch.zeros((NVOX, 5), device=dev)
    cases = {}
    for name, hi in (("random over 8.4M rows", NVOX),
                     ("into 131 blocks", 131 * 512), ("into 14k rows", 14_000)):
        idx = torch.as_tensor(rng.integers(0, hi, N_SYNTH).astype(np.int32),
                              device=dev)
        vals = torch.as_tensor(
            rng.standard_normal((N_SYNTH, 5)).astype(np.float32), device=dev)
        fields = [vals[:, f].contiguous() for f in range(5)]
        idx64 = idx.long()
        distinct = int(torch.unique(idx).numel())
        bound = scatter_bound_ms(N_SYNTH, N_SYNTH, distinct)
        runs = {
            "fields -> 32-byte rows": lambda: sa.scatter_add_fields(
                idx, fields, NVOX, acc=acc8[:, :5]),
            "[N,5] -> 32-byte rows": lambda: sa.scatter_add_multi(
                idx, vals, NVOX, acc=acc8[:, :5]),
            "[N,5] -> contiguous": lambda: sa.scatter_add_multi(
                idx, vals, NVOX, acc=acc5),
            "index_add_ bare": lambda: acc5.index_add_(0, idx64, vals),
        }
        # in turns: forward, then backward, keeping the lower median
        best = {}
        for order in (list(runs), list(reversed(runs))):
            for key in order:
                ms = median_ms(runs[key])
                best[key] = min(ms, best.get(key, ms))
        share = bound / best["fields -> 32-byte rows"]
        log(f"N={N_SYNTH} F=5 {name} ({distinct} distinct rows, byte bound "
            f"{bound:.5f} ms, {share:.1%} reached): " + "; ".join(
                f"{k} {v:.4f} ms" for k, v in best.items()))
        cases[f"N={N_SYNTH} {name}"] = (idx.cpu(), vals.cpu())
    return cases


def tree_scatter(samples):
    """{case: ms} of the imported tree's `scatter_add_multi` into a
    contiguous [nvox, 5] destination, the samples from the file `samples`."""
    import torch
    from gradient_sdf_tpu_torch.ops.kernels import scatter_add as sa

    dev = torch.device("cuda")
    acc5 = torch.zeros((NVOX, 5), device=dev)
    out = {}
    for name, (idx, vals) in torch.load(samples).items():
        idx, vals = idx.to(dev), vals.to(dev)
        out[name] = median_ms(
            lambda: sa.scatter_add_multi(idx, vals, NVOX, acc=acc5))
    return out


def part_loops():
    """Frames 1-5 under the profiler, after a warm-up pass of the same
    loop: fusion with ground-truth poses, then tracking + fusion. Prints
    one JSON line."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from gradient_sdf_tpu_torch.data import synth
    from gradient_sdf_tpu_torch.models import tracker
    from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap

    dev = torch.device("cuda")
    cfg, depths, poses = golden_protocol()
    K = synth.KINECT_K
    dd = [torch.as_tensor(d, device=dev) for d in depths]

    def on_dev(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    def loop(track, frames):
        R, t = on_dev(poses[0][0]), on_dev(poses[0][1])
        for i in frames:
            if track:
                res = tracker.track_frame(m.grid, dd[i], K, R, t, m.cfg.grid,
                                          m.cfg.fusion, cfg.tracker)
                R, t = res.R, res.t
                m.update(dd[i], K, (R, t))
            else:
                m.update(dd[i], K, poses[i])
        torch.cuda.synchronize()

    out = {}
    for track in (False, True):
        # a warm-up pass, a pass on the host clock, a pass under the profiler
        for step in ("warm", "wall", "profile"):
            m = GradSdfMap(cfg, device=dev)
            m.update(dd[0], K, poses[0])
            torch.cuda.synchronize()
            if step == "profile":
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    loop(track, range(1, 6))
                continue
            t0 = time.perf_counter()
            loop(track, range(1, 6))
            wall = (time.perf_counter() - t0) * 1e3
        # device-side events only (kernels, memsets, copies): the operator
        # rows repeat their kernels' time
        rows = []
        for e in prof.key_averages():
            dev_us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
            if dev_us > 0 and e.device_type == DeviceType.CUDA:
                rows.append((dev_us / 1e3, e.count, e.key))
        rows.sort(reverse=True)
        out["track_fuse" if track else "fuse_gt"] = {
            "wall_ms_frames_1_5": wall,
            "device_busy_ms_frames_1_5": sum(r[0] for r in rows),
            "device_kernels": sum(r[1] for r in rows),
            "own_kernels": [{"ms": r[0], "count": r[1], "name": r[2][:70]}
                            for r in rows
                            if "scatter_add_" in r[2] or "merge_clear" in r[2]],
            "top": [{"ms": r[0], "count": r[1], "name": r[2][:70]}
                    for r in rows[:8]],
        }
    return out


def box_protocol():
    """(pipeline config, [depth numpy], [(R, t)]) of the box world as
    `make_synth --world box` renders it (6 VGA frames over 4 degrees, seed
    2, depth rounded to mm as its PNG), fused at 1 cm."""
    import numpy as np
    from gradient_sdf_tpu_torch.config import PipelineConfig
    from gradient_sdf_tpu_torch.data import synth

    cfg = PipelineConfig()
    cfg = dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, voxel_size=0.01),
        fusion=dataclasses.replace(cfg.fusion, trunc_voxels=5.0))
    world = synth.default_boxes(seed=2, device="cpu")
    poses = synth.orbit_poses(n=6, radius=1.8, height_range=(0.35, 0.6),
                              target=np.array([0.0, 0.0, -0.25]),
                              arc=np.deg2rad(4.0))
    depths = [synth.quantize_depth(synth.render_depth_boxes(world, R, t)).numpy()
              for R, t in poses]
    return cfg, depths, poses


def fuse_steps(m, depth, R, t, *, kernel, kf_slot=None,
               accumulate_gradients=True):
    """One frame through `fusion.fuse_frame`'s steps on the map `m`: the
    claim pass, the block claim, the integrate pass, with the kernel
    (`kernel=True`) or with its plain versions on the same device. Returns
    the claim's (misses, oob, marked candidates, their keys)."""
    import torch
    from gradient_sdf_tpu_torch.ops import fusion
    from gradient_sdf_tpu_torch.ops.kernels import fuse_integrate as fi

    gcfg, fcfg = m.cfg.grid, m.cfg.fusion
    nrm = fusion.compute_normals(m.cache, depth).contiguous()
    if fcfg.median_blur_depth:
        depth = fusion.median_blur(depth, 5)
    depth = depth.contiguous()
    if kernel:
        status, mark, keys = fi.claim_pass(depth, nrm, m.cache, R, t, m.grid,
                                           gcfg, fcfg, m.scratch)
    else:
        status, mark, keys = fi.claim_pass_reference(depth, nrm, m.cache, R, t,
                                                     m.grid, gcfg, fcfg)
    misses, oob = status.tolist()
    cand = torch.nonzero(mark).reshape(-1)
    cand_keys = keys[cand]
    m.grid = fusion.claim_blocks(m.grid, mark, keys, misses, oob, gcfg)
    if bool(mark.any()):
        raise AssertionError("the claim's marks were not cleared")
    kw = dict(accumulate_gradients=accumulate_gradients, vis=m.vis,
              kf_slot=kf_slot)
    if kernel:
        fi.integrate_merge(depth, nrm, m.cache, R, t, m.grid, gcfg, fcfg,
                           m.acc, m.scratch, **kw)
    else:
        fi.integrate_merge_reference(depth, nrm, m.cache, R, t, m.grid, gcfg,
                                     fcfg, m.acc, **kw)
    return misses, oob, cand, cand_keys


def kernel_vs_twin(cfg, depths, poses, K, dev, tol, *, kf_slot=None,
                   accumulate_gradients=True):
    """Fuse `depths` at `poses` into a map on `dev` through the kernel and,
    from a copy of the same state before every frame, through its plain
    versions (`fuse_steps`); hold the two together after every frame: the
    claims (miss and oob counts, candidates) and the maps' directory,
    coarse occupancy, block coordinates, block count, overflow, oob counter
    and visibility words bit for bit, the fields within `tol` ({"weight",
    "dist", "grad"}: float atomics reorder one frame's sums), both
    accumulators and the kernel's block marks all-zero.
    Raises AssertionError on a difference; returns {"frames", "misses",
    "oob", "blocks", "overflow", "weight", "dist", "grad"} (the largest
    errors)."""
    import torch
    from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap

    maps = [GradSdfMap(cfg, with_vis=kf_slot is not None, device=dev)
            for _ in range(2)]
    out = {"frames": 0, "misses": 0, "oob": 0, "weight": 0.0, "dist": 0.0,
           "grad": 0.0}
    for depth, (R, t) in zip(depths, poses):
        d = torch.as_tensor(depth, dtype=torch.float32, device=dev)
        R = torch.as_tensor(R, dtype=torch.float32, device=dev)
        t = torch.as_tensor(t, dtype=torch.float32, device=dev)
        # the plain versions start from the kernel's state
        maps[1].grid = type(maps[0].grid)(*(a.clone() for a in maps[0].grid))
        if kf_slot is not None:
            maps[1].vis = maps[0].vis.clone()
        claims = []
        for m, kernel in zip(maps, (True, False)):
            m.ensure_cache(K, d.shape[1], d.shape[0])
            claims.append(fuse_steps(m, d, R, t, kernel=kernel,
                                     kf_slot=kf_slot,
                                     accumulate_gradients=accumulate_gradients))
        (mk, ok_, ck, kk), (mt, ot, ct, kt) = claims
        what = f"frame {out['frames']}"
        same = torch.equal(ck, ct) and torch.equal(kk, kt)
        if (mk, ok_) != (mt, ot) or ck.numel() != mk or not same:
            raise AssertionError(
                f"{what}: claim (misses, oob) kernel {(mk, ok_)} vs plain "
                f"{(mt, ot)}, marked candidates and keys equal {same}")
        gk, gt = maps[0].grid, maps[1].grid
        for k in ("directory", "coarse_occ", "block_coords", "num_active",
                  "overflow", "oob_samples"):
            if not torch.equal(getattr(gk, k), getattr(gt, k)):
                raise AssertionError(f"{what}: {k} differs kernel vs plain")
        if kf_slot is not None and not torch.equal(maps[0].vis, maps[1].vis):
            raise AssertionError(f"{what}: visibility words differ")
        errs = {"weight": (gk.weight - gt.weight).abs().max(),
                "dist": (gk.dist - gt.dist).abs().max(),
                "grad": max((getattr(gk, g) - getattr(gt, g)).abs().max()
                            for g in ("grad_x", "grad_y", "grad_z"))}
        for k, e in errs.items():
            e = float(e)
            out[k] = max(out[k], e)
            if not e <= tol[k]:
                raise AssertionError(f"{what}: {k} kernel vs plain max |err| "
                                     f"{e} > {tol[k]}")
        if any(bool(m.acc.any()) for m in maps) or bool(
                maps[0].scratch.marks.any()):
            raise AssertionError(f"{what}: accumulator or marks not zero")
        out["frames"] += 1
        out["misses"] += mk
        out["oob"] += ok_
    out["blocks"] = int(maps[0].grid.num_active)
    out["overflow"] = bool(maps[0].grid.overflow)
    if out["blocks"] <= 0 or not bool(maps[0].grid.weight.any()):
        raise AssertionError("nothing was fused")
    return out


# float32 operations a valid pixel's ray and a live sample take in the
# kernel (counted from csrc/fuse_integrate.cu: gates, R h and R n; the
# walk, rounding, SDF, weight and payload), and the card's float32 rate
# outside the tensor cores (H100 SXM data sheet)
OPS_PER_RAY, OPS_PER_SAMPLE = 39, 40
FP32_PER_S = 67e12
IMAGE_BYTES_PER_PIXEL = 28   # depth, normal, x0, y0, 1/|h|^2


def fuse_bounds(m, depth, R, t, misses):
    """Least times (ms) of the two launches on this frame and map, each
    the larger of bytes (each input read once, each output written once)
    and operations: the claim pass reads the images and every directory
    sector a live sample needs and writes the `misses` marks (a byte) and
    keys and the status; the
    integrate pass reads the images and those sectors again, reads and
    writes every touched accumulator row once (8 B a field) and merges the
    touched blocks' rows (`merge_bound_ms`'s 80 B a row). Returns
    {"claim": (ms, by), "integrate": (ms, by), "rows", "blocks",
    "sectors"}."""
    import torch
    from gradient_sdf_tpu_torch.ops import fusion
    from gradient_sdf_tpu_torch.ops import voxel_grid as vg
    from gradient_sdf_tpu_torch.ops.kernels import fuse_integrate as fi

    gcfg, fcfg = m.cfg.grid, m.cfg.fusion
    nrm = fusion.compute_normals(m.cache, depth).contiguous()
    idx, s = fi.frame_walk(depth, nrm, m.cache, R, t, gcfg, fcfg)
    live = s.keys >= 0
    sectors = int(torch.unique(s.keys[live] // 8).numel())
    slot = vg.lookup_keys(m.grid, s.keys, gcfg)
    ok = slot >= 0
    rows = int(torch.unique((slot * gcfg.voxels_per_block + s.local_lin)[ok]).numel())
    blocks = int(torch.unique(slot[ok]).numel())
    image = depth.numel() * IMAGE_BYTES_PER_PIXEL
    ops = (idx.numel() * OPS_PER_RAY + int((s.w > 0).sum()) * OPS_PER_SAMPLE
           ) / FP32_PER_S * 1e3

    def bound(nbytes):
        b = nbytes / MEM_BYTES_PER_S * 1e3
        return (b, "bytes") if b >= ops else (ops, "operations")

    return {"claim": bound(image + 32 * sectors + 5 * misses + 8),
            "integrate": bound(image + 32 * sectors + rows * 8 * 5
                               + merge_bound_ms(blocks * gcfg.voxels_per_block)
                               * MEM_BYTES_PER_S / 1e3),
            "rows": rows, "blocks": blocks, "sectors": sectors}


def fuse_kernel_times(m, depth, R, t):
    """Device times (ms, `median_ms`) of the two launches on golden frame
    5's state `m` (frames 0-4 fused through the kernel): the claim pass and
    its plain version (which compacts: a host sync, timed with it), then,
    after this frame's blocks are claimed, the integrate pass and its plain
    version each on a copy of the map's fields (repeated integration of the
    same frame is the same work), and the launch floor of the integrate
    pass (an empty cooperative launch at its grid). Leaves `m` with frame
    5's blocks claimed and nothing integrated."""
    import torch
    from gradient_sdf_tpu_torch.ops import fusion
    from gradient_sdf_tpu_torch.ops.kernels import _build
    from gradient_sdf_tpu_torch.ops.kernels import fuse_integrate as fi

    gcfg, fcfg = m.cfg.grid, m.cfg.fusion
    nrm = fusion.compute_normals(m.cache, depth).contiguous()
    args = (depth, nrm, m.cache, R, t)
    claim = median_ms(lambda: fi.claim_pass(*args, m.grid, gcfg, fcfg, m.scratch))
    claim_plain = median_ms(lambda: fi.claim_pass_reference(*args, m.grid, gcfg,
                                                            fcfg))
    status, mark, keys = fi.claim_pass(*args, m.grid, gcfg, fcfg, m.scratch)
    misses, oob = status.tolist()
    bounds = fuse_bounds(m, depth, R, t, misses)
    m.grid = fusion.claim_blocks(m.grid, mark, keys, misses, oob, gcfg)

    def spare():
        g = m.grid._replace(**{k: getattr(m.grid, k).clone() for k in (
            "weight", "dist", "grad_x", "grad_y", "grad_z")})
        return g, fusion.new_accumulator(g), fi.new_scratch(g)

    g, acc, scr = spare()
    integ = median_ms(lambda: fi.integrate_merge(*args, g, gcfg, fcfg, acc, scr))
    g, acc, _ = spare()
    integ_plain = median_ms(lambda: fi.integrate_merge_reference(
        *args, g, gcfg, fcfg, acc))
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream

    def empty():
        if lib.gsdf_fuse_coop_empty(stream) != 0:
            raise AssertionError("the empty cooperative launch failed")

    floor = median_ms(empty)
    return {"claim_ms": claim, "claim_plain_ms": claim_plain,
            "integrate_ms": integ, "integrate_plain_ms": integ_plain,
            "coop_empty_ms": floor, "misses": misses, "bounds": bounds,
            "shape": fi.integrate_shape(5)}


def count_fuse_frame(m, depth, R, t):
    """`fusion.fuse_frame` on the card for one frame of the map `m`
    (updated as the map's `update` would fuse it), with its launches and
    host syncs counted: each kernel's launch counter, the CUDA kernels,
    memsets and copies under the profiler, and the syncs at the status read
    (a line of `fusion.fuse_frame`), inside `voxel_grid.insert_new`, and
    anywhere else (`track_bench.count_syncs`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from gradient_sdf_tpu_torch.ops import fusion
    from gradient_sdf_tpu_torch.ops import voxel_grid as vg
    from gradient_sdf_tpu_torch.ops.kernels import fuse_integrate as fi
    from gradient_sdf_tpu_torch.ops.kernels import merge_clear as mc
    from gradient_sdf_tpu_torch.ops.kernels import scatter_add as sa
    from gradient_sdf_tpu_torch.tools.track_bench import _lines, count_syncs

    for mod in (fi, mc, sa):
        mod.reset_launch_count()
    torch.cuda.synchronize()

    def fuse():
        m.grid = fusion.fuse_frame(m.grid, depth, m.cache, R, t, m.cfg.grid,
                                   m.cfg.fusion, acc=m.acc, scratch=m.scratch)

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, syncs = count_syncs(fuse)
        torch.cuda.synchronize()
    where = {"status": _lines(fusion.fuse_frame),
             "insert_new": _lines(vg.insert_new)}
    n = {k: sum(f == file and line in lines for f, line, _ in syncs)
         for k, (file, lines) in where.items()}
    return {"claim": fi.claim_launch_count, "integrate": fi.launch_count,
            "scatter_add": sa.launch_count, "merge_clear": mc.launch_count,
            "device_ops": sum(e.count for e in prof.key_averages()
                              if e.device_type == DeviceType.CUDA),
            "status_syncs": n["status"], "insert_syncs": n["insert_new"],
            "other_syncs": len(syncs) - sum(n.values())}


SPLIT_ROUNDS = 5   # fresh maps fused over frames 0-5, after one warm-up


def fuse_parts(m, depth, R, t):
    """The imported package's single-card `fuse_frame` (no visibility
    bits, the map's accumulator) written out as [(part, fn)], run in
    order; the map's grid is updated as `fuse_frame` would. The package
    with `ops/kernels/fuse_integrate.py` takes its path (normals, claim
    pass and status read, block claim, integrate-and-merge launch); an
    earlier one the plain walk (normals, pixel gates and compaction,
    sample walk, lookup, `need.any()`, claim insert, scatter,
    `merge_clear`). A `vis` part ORs a keyframe bit into a spare bitfield
    (the PhotoBA map's extra; the app's map has none)."""
    import importlib.util

    import torch
    from gradient_sdf_tpu_torch.ops import fusion
    from gradient_sdf_tpu_torch.ops import voxel_grid as vg

    gcfg, fcfg = m.cfg.grid, m.cfg.fusion
    st = {}

    def normals():
        st["nrm"] = fusion.compute_normals(m.cache, depth)

    if importlib.util.find_spec(
            "gradient_sdf_tpu_torch.ops.kernels.fuse_integrate") is not None:
        from gradient_sdf_tpu_torch.ops.kernels import fuse_integrate as fi

        def claim():
            status, st["mark"], st["keys"] = fi.claim_pass(
                depth, st["nrm"], m.cache, R, t, m.grid, gcfg, fcfg, m.scratch)
            st["misses"], st["oob"] = status.tolist()

        def blocks():
            m.grid = fusion.claim_blocks(m.grid, st["mark"], st["keys"],
                                         st["misses"], st["oob"], gcfg)

        def integrate():
            fi.integrate_merge(depth, st["nrm"], m.cache, R, t, m.grid, gcfg,
                               fcfg, m.acc, m.scratch)

        return [("normals", normals), ("claim pass + status read", claim),
                ("block claim (nonzero_static + insert_new)", blocks),
                ("integrate + merge", integrate)]

    def rays():
        r = fusion._pixel_rays(depth, st["nrm"], m.cache, fcfg)
        idx = torch.nonzero(r.valid).reshape(-1)
        st["rays"] = fusion.FrameRays(
            *(a[idx] for a in r[:-1]),
            valid=torch.ones_like(idx, dtype=torch.bool))

    def samples():
        st["s"] = fusion._ray_samples(st["rays"], R, t, gcfg, fcfg)

    def lookup():
        st["slot"] = vg.lookup_keys(m.grid, st["s"].keys, gcfg)
        st["need"] = (st["s"].keys >= 0) & (st["slot"] < 0)

    def need_any():
        st["any"] = bool(st["need"].any())

    def insert():
        g, s, slot = m.grid, st["s"], st["slot"]
        if st["any"]:
            g = vg.insert_new(g, s.keys, st["need"], gcfg)
            slot = vg.lookup_keys(g, s.keys, gcfg)
        g = g._replace(oob_samples=g.oob_samples + s.oob)
        ok = slot >= 0
        nvox = g.num_blocks * g.voxels_per_block
        st["lin"] = torch.where(ok, slot * gcfg.voxels_per_block + s.local_lin,
                                torch.full_like(slot, nvox))
        st["ok"] = ok
        m.grid = g

    def scatter():
        fusion._scatter_samples(m.acc, st["lin"], st["s"], True)

    def merge():
        fusion._merge_accumulators(m.grid, m.acc, True)

    def vis():
        nvox = m.grid.num_blocks * m.grid.voxels_per_block
        touched = torch.zeros(nvox + 1, dtype=torch.bool, device=m.grid.device)
        touched[st["lin"][st["ok"]].long()] = True
        fusion._merge_vis(m.grid, st["vis"], touched[:nvox], 0)

    st["vis"] = torch.zeros(tuple(m.grid.dist.shape) + (1,), dtype=torch.int32,
                            device=m.grid.device)
    return [("normals", normals), ("pixel gates + nonzero compaction", rays),
            ("sample walk (_ray_samples)", samples), ("lookup", lookup),
            ("need.any()", need_any), ("insert_new + re-lookup + oob", insert),
            ("scatter (scatter_add_multi)", scatter),
            ("merge_clear", merge), ("vis", vis)]


def split_tree():
    """The split of `fuse_frame` for the imported tree (module note): per
    part, the mean over frames 1-5 of each frame's median over
    SPLIT_ROUNDS fresh maps, host ms and device ms, and per frame its
    launches and host syncs; the whole `fuse_frame` likewise."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from gradient_sdf_tpu_torch.data import synth
    from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap
    from gradient_sdf_tpu_torch.ops import fusion
    from gradient_sdf_tpu_torch.tools.track_bench import count_syncs

    dev = torch.device("cuda")
    cfg, depths, poses = golden_protocol()
    K = synth.KINECT_K
    dd = [torch.as_tensor(d, dtype=torch.float32, device=dev) for d in depths]
    pp = [tuple(torch.as_tensor(a, dtype=torch.float32, device=dev) for a in p)
          for p in poses]

    def fresh():
        m = GradSdfMap(cfg, device=dev)
        m.update(dd[0], K, poses[0])
        torch.cuda.synchronize()
        return m

    def run(fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, ev[0].elapsed_time(ev[1])

    parts = {}    # name -> frame -> [(host, dev)]
    whole = {}    # frame -> [host ms]
    for rnd in range(SPLIT_ROUNDS + 1):
        m, mw = fresh(), fresh()
        for i in range(1, 6):
            for name, fn in fuse_parts(m, dd[i], *pp[i]):
                got = run(fn)
                if rnd:
                    parts.setdefault(name, {}).setdefault(i, []).append(got)
            host, _ = run(lambda: setattr(mw, "grid", fusion.fuse_frame(
                mw.grid, dd[i], mw.cache, *pp[i], cfg.grid, cfg.fusion,
                acc=mw.acc, **({"scratch": mw.scratch}
                               if hasattr(mw, "scratch") else {}))))
            if rnd:
                whole.setdefault(i, []).append(host)

    def med(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2]

    out = {"parts": [], "whole": {}}
    for name, frames in parts.items():
        host = [med([h for h, _ in frames[i]]) for i in range(1, 6)]
        devt = [med([d for _, d in frames[i]]) for i in range(1, 6)]
        out["parts"].append({"part": name, "host_ms": host, "device_ms": devt})
    out["whole"]["host_ms"] = [med(whole[i]) for i in range(1, 6)]

    # launches and host syncs of each part, once per frame, after a first
    # profiled frame (the profiler missed the package's own kernels in its
    # first sessions of a process)
    m = fresh()
    with profile(activities=[ProfilerActivity.CUDA]):
        for _, fn in fuse_parts(fresh(), dd[1], *pp[1]):
            fn()
        torch.cuda.synchronize()
    counts = {}
    for i in range(1, 6):
        for name, fn in fuse_parts(m, dd[i], *pp[i]):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _, syncs = count_syncs(fn)
                torch.cuda.synchronize()
            n = sum(e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
            counts.setdefault(name, []).append((n, len(syncs)))
    for row in out["parts"]:
        row["launches"] = [c[0] for c in counts[row["part"]]]
        row["syncs"] = [c[1] for c in counts[row["part"]]]
    out["blocks_active"] = int(m.grid.num_active)
    return out


def split_turns(parent, smi):
    """`split_tree` per tree in turns, each in its own process, then the
    app in the same turns (module note)."""
    from gradient_sdf_tpu_torch.tools import track_bench

    turns = [("this", OWN_ROOT)]
    if parent:
        turns = [("parent", parent), ("this", OWN_ROOT), ("this", OWN_ROOT),
                 ("parent", parent)]
    for name, root in turns:
        cmd = [sys.executable, os.path.abspath(__file__), "--split-tree", root]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr[-3000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        log(f"split {name} tree, golden frames 1-5 from ground-truth poses "
            f"({res['blocks_active']} blocks at the end) [{smi}]:")

        def fmt(xs, digits=3):
            return ", ".join(f"{x:.{digits}f}" for x in xs)

        tot_h = tot_d = 0.0
        for row in res["parts"]:
            h = sum(row["host_ms"]) / 5
            d = sum(row["device_ms"]) / 5
            tot_h, tot_d = tot_h + h, tot_d + d
            log(f"  {row['part']}: host {h:.3f} ms ({fmt(row['host_ms'])}), "
                f"device {d:.4f} ms ({fmt(row['device_ms'], 4)}), launches "
                f"{row['launches']}, host syncs {row['syncs']}")
        w = res["whole"]["host_ms"]
        log(f"  sum of parts (each synchronized): host {tot_h:.3f} ms, "
            f"device {tot_d:.4f} ms; whole fuse_frame host {sum(w) / 5:.3f} "
            f"ms ({fmt(w)})")
    if parent:
        track_bench.app_turns(parent, smi)


def run_tree(root, samples):
    cmd = [sys.executable, os.path.abspath(__file__), "--tree", root, samples]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout of an earlier commit to compare")
    ap.add_argument("--tree", nargs=2, metavar=("DIR", "SAMPLES"),
                    help="measure the package in DIR alone (part 3)")
    ap.add_argument("--split", action="store_true",
                    help="only the split of fuse_frame (module note)")
    ap.add_argument("--split-tree", metavar="DIR",
                    help="the split for the package in DIR alone")
    args = ap.parse_args()
    root = args.tree[0] if args.tree else (args.split_tree or OWN_ROOT)
    sys.path.insert(0, os.path.abspath(root))
    import torch

    if not torch.cuda.is_available():
        print("fusion_bench: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.tree:
        print(json.dumps({"scatter": tree_scatter(args.tree[1]),
                          "loops": part_loops()}), flush=True)
        return 0
    if args.split_tree:
        print(json.dumps(split_tree()), flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    if args.split:
        split_turns(args.parent, smi)
        log(smi)
        return 0
    cases = {"in situ frame 5": part_in_situ()}
    cases.update(part_synthetic())
    turns = [("this", OWN_ROOT)]
    if args.parent:
        turns = [("parent", args.parent), ("this", OWN_ROOT),
                 ("this", OWN_ROOT), ("parent", args.parent)]
    with tempfile.TemporaryDirectory() as tmp:
        samples = os.path.join(tmp, "samples.pt")
        torch.save(cases, samples)
        del cases
        torch.cuda.empty_cache()
        for name, root in turns:
            res = run_tree(root, samples)
            log(f"tree {name}: scatter_add_multi, [N,5] -> contiguous [nvox,5]: "
                + "; ".join(f"{k} {v:.4f} ms" for k, v in res["scatter"].items()))
            for mode, r in res["loops"].items():
                log(f"loop {name} {mode}: wall {r['wall_ms_frames_1_5']:.2f} ms, "
                    f"device busy {r['device_busy_ms_frames_1_5']:.3f} ms in "
                    f"{r['device_kernels']} kernels over frames 1-5")
                for row in r["own_kernels"] + r["top"]:
                    log(f"    {row['ms']:.3f} ms x{row['count']} {row['name']}")
    log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
