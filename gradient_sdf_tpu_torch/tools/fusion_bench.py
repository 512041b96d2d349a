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

    python3 gradient_sdf_tpu_torch/tools/fusion_bench.py --kernels [DIR]

takes the fusion kernels of the tree in DIR (this one by default) apart
instead (`kernel_split`): one-switch builds of a copy of its
`csrc/fuse_integrate.cu` under its build directory, timed on golden frames
0 and 5 beside the unswitched kernels, with their ptxas report and the
scatter's reductions counted from the plain walk.

    python3 gradient_sdf_tpu_torch/tools/fusion_bench.py --normals [DIR ...]

takes the normals kernel of each tree DIR (this one if none) apart instead
(`normals_split`): one-switch builds of a copy of its `csrc/fals_normals.cu`
(NORMALS_SWITCHES), timed on golden frame 5 beside the unswitched kernels,
then those in turns.

    python3 gradient_sdf_tpu_torch/tools/fusion_bench.py --mesh-merge [--parent DIR]

times the mesh's merge step instead: a group of 4 ranks (2 rays x 2
blocks) on this card fuses golden frames 0-4 from their poses through
`sharded_fuse_frame` and saves each rank's frame-5 merge inputs (the
world-summed compact rows, the touched blocks, the shard); then, in this
process, rank by rank, `merge_touched` held to its plain version and to
the replaced step (`keep_owned_rows` + `merge_clear`) bit for bit, and
timed beside an empty kernel at its grid, its byte bound, the plain
version, the one-switch builds of `MERGE_SWITCHES` (the design taken back
step by step) and the replaced step, whose `merge_clear` is this tree's
and, with `--parent`, the parent's `csrc/merge_clear.cu` built alone, in
turns (`mesh_merge_times`). `--mesh-merge-report DIR` runs only the
report, on inputs saved in DIR (chip_smoke.py phase 15e).
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


def reset_ms(fn, reset, reps=20):
    """Device time of one `fn()` in ms: the median over `reps` launches of
    the CUDA-event time around each, `reset()` before each outside the
    events (a pass that changes its own inputs). Each launch is enqueued
    behind ~0.5 ms of device-side spinning, so the events bracket device
    work, not the Python wrapper."""
    import torch

    reset()
    fn()
    times = []
    for _ in range(reps):
        reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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
    """One frame through `fusion.fuse_frame`'s steps on the map `m`: with
    the kernel (`kernel=True`: the claim pass, then the integrate pass,
    which hands out the blocks) or with its plain versions on the same
    device (the claim pass's, the plain block claim through
    `fusion.claim_blocks`, the integrate pass's). Returns what the claim
    pass made: its status (misses, oob, valid pixels, claimed blocks), the
    marked candidates, their keys, the claims of those keys, the tiles
    with a valid pixel and the claimed keys, both in order."""
    import torch
    from gradient_sdf_tpu_torch.ops import fusion
    from gradient_sdf_tpu_torch.ops import voxel_grid as vg
    from gradient_sdf_tpu_torch.ops.kernels import fuse_integrate as fi

    gcfg, fcfg = m.cfg.grid, m.cfg.fusion
    nrm = fusion.compute_normals(m.cache, depth).contiguous()
    if fcfg.median_blur_depth:
        depth = fusion.median_blur(depth, 5)
    depth = depth.contiguous()
    if kernel:
        status, mark, keys = fi.claim_pass(depth, nrm, m.cache, R, t, m.grid,
                                           gcfg, fcfg, m.scratch)
        counts = tuple(status.tolist())
        cand = torch.nonzero(mark).reshape(-1)
        want = keys[cand].long()
        claimed = m.scratch.claims[want]
        tiles = torch.sort(m.scratch.tiles[:counts[2]]).values
        new = torch.sort(m.scratch.new_keys[:counts[3]]).values
    else:
        status, mark, keys = fi.claim_pass_reference(depth, nrm, m.cache, R, t,
                                                     m.grid, gcfg, fcfg)
        counts = tuple(status.tolist())
        claims = torch.full((m.grid.directory.numel(),), vg.INT32_MAX,
                            dtype=torch.int32, device=depth.device)
        cand, want = fi.claim_mins_reference(claims, mark, keys)
        claimed = claims[want]
        tiles = torch.unique(fi.tile_of_pixels(torch.nonzero(fusion._pixel_rays(
            depth, nrm, m.cache, fcfg).valid.reshape(-1)).reshape(-1),
            depth.shape[1])).int()
        new = torch.unique(want).int()
        m.grid = fusion.claim_blocks(m.grid, mark, keys, counts[1], gcfg)
        if bool(mark.any()):
            raise AssertionError("the plain claim's marks were not cleared")
    kw = dict(accumulate_gradients=accumulate_gradients, vis=m.vis,
              kf_slot=kf_slot)
    if kernel:
        fi.integrate_merge(depth, nrm, m.cache, R, t, m.grid, gcfg, fcfg,
                           m.acc, m.scratch, **kw)
    else:
        fi.integrate_merge_reference(depth, nrm, m.cache, R, t, m.grid, gcfg,
                                     fcfg, m.acc, **kw)
    return counts, cand, want, claimed, tiles, new


def kernel_vs_twin(cfg, depths, poses, K, dev, tol, *, kf_slot=None,
                   accumulate_gradients=True):
    """Fuse `depths` at `poses` into a map on `dev` through the kernel and,
    from a copy of the same state before every frame, through its plain
    versions (`fuse_steps`); hold the two together after every frame: the
    claim pass (its status, marked candidates and keys, the claims, the
    listed tiles, the claimed keys) and the maps' directory, coarse
    occupancy, block coordinates, block count, overflow, oob counter and
    visibility words bit for bit, the fields within `tol` ({"weight",
    "dist", "grad"}: float atomics reorder one frame's sums), both
    accumulators, the kernel's block and candidate marks all-zero and its
    claims all INT32_MAX. Raises AssertionError on a difference; returns
    {"frames", "misses", "oob", "blocks", "overflow", "weight", "dist",
    "grad"} (the largest errors)."""
    import torch
    from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap
    from gradient_sdf_tpu_torch.ops import voxel_grid as vg

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
        what = f"frame {out['frames']}"
        (ck, *rk), (ct, *rt) = claims
        same = [torch.equal(x, y) for x, y in zip(rk, rt)]
        if ck != ct or rk[0].numel() != ck[0] or not all(same):
            raise AssertionError(
                f"{what}: claim status kernel {ck} vs plain {ct}; candidates, "
                f"keys, claims, tiles, claimed keys equal {same}")
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
        sc = maps[0].scratch
        if (any(bool(m.acc.any()) for m in maps) or bool(sc.marks.any())
                or bool(sc.cand_mark.any())
                or not bool((sc.claims == vg.INT32_MAX).all())):
            raise AssertionError(f"{what}: accumulator, block or candidate "
                                 f"marks or claims not back to idle")
        out["frames"] += 1
        out["misses"] += ck[0]
        out["oob"] += ck[1]
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


def fuse_bounds(m, depth, R, t, misses, opened=0):
    """Least times (ms) of the two launches on this frame, each the larger
    of bytes (each input read once, each output written once) and
    operations, with the map `m` after the frame's claim: the claim pass
    reads the images and every directory sector a live sample needs,
    writes the `misses` marks (a byte) and keys, a claim per new block, the
    list of tiles with a valid pixel and the status; the integrate pass
    reads the list, the valid pixels' images and those sectors again,
    reads and writes every
    touched accumulator row once (8 B a field) and merges the touched
    blocks' rows (`merge_bound_ms`'s 80 B a row), and, when the frame opens
    `opened` blocks, reads every candidate's mark byte and the misses' keys
    and claims and writes each new block's directory entry, coarse cell,
    coordinates and claim. Returns {"claim": (ms, by), "integrate": (ms,
    by), "rows", "blocks", "sectors", "valid", "tiles"}."""
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
    valid = idx.numel()
    tiles = int(torch.unique(fi.tile_of_pixels(idx, depth.shape[1])).numel())
    ops = (valid * OPS_PER_RAY + int((s.w > 0).sum()) * OPS_PER_SAMPLE
           ) / FP32_PER_S * 1e3

    def bound(nbytes):
        b = nbytes / MEM_BYTES_PER_S * 1e3
        return (b, "bytes") if b >= ops else (ops, "operations")

    claim_out = 5 * misses + 4 * opened + 4 * tiles + 4 * fi.STATUS
    open_bytes = (depth.numel() * fi.samples_per_ray(fcfg) + 8 * misses
                  + 24 * opened) if opened else 0
    return {"claim": bound(depth.numel() * IMAGE_BYTES_PER_PIXEL + 32 * sectors
                           + claim_out),
            "integrate": bound(4 * tiles + valid * IMAGE_BYTES_PER_PIXEL
                               + 32 * sectors + rows * 8 * 5 + open_bytes
                               + merge_bound_ms(blocks * gcfg.voxels_per_block)
                               * MEM_BYTES_PER_S / 1e3),
            "rows": rows, "blocks": blocks, "sectors": sectors, "valid": valid,
            "tiles": tiles}


# FALS normals (`fals_normals`): a pixel reads its depth (4 B), rays (12 B)
# and Q (24 B) and writes its normal (12 B); the separable window sums take
# 2 x window float64 additions a channel, and the rest ~28 float32
# operations (z_inv, 3 products, Q b, norm, 3 divisions). The card's float64
# rate outside the tensor cores (H100 SXM data sheet)
NORMALS_BYTES_PER_PIXEL = 52
NORMALS_F32_OPS_PER_PIXEL = 28
FP64_PER_S = 34e12


def normals_bound_ms(pixels, window):
    """(least ms, "bytes" or "operations") of one frame's FALS normals."""
    b = pixels * NORMALS_BYTES_PER_PIXEL / MEM_BYTES_PER_S * 1e3
    ops = (pixels * 3 * 2 * window / FP64_PER_S
           + pixels * NORMALS_F32_OPS_PER_PIXEL / FP32_PER_S) * 1e3
    return (b, "bytes") if b >= ops else (ops, "operations")


def _ulps(a, b):
    """Per element |a - b| in units in the last place (float32 bit patterns
    as ordered integers), 0 where both are NaN."""
    import torch

    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    d = (ordered(a) - ordered(b)).abs()
    return torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(d), d)


def normals_vs_plain(cache, depths, fcfg):
    """`fals_normals` against its plain version on the card, frame by frame
    (`depths` card tensors): per frame, the window sums b and the normals
    (NaN where the plain version's are: compared as bits) as the count of
    differing values and the largest difference in ulps, and the pixels
    that pass fusion's gates (`fusion._pixel_rays`) with each: the count of
    pixels gated otherwise. Returns [{...}] a frame."""
    import torch
    from gradient_sdf_tpu_torch.ops import fusion
    from gradient_sdf_tpu_torch.ops.kernels import fals_normals as fn

    out = []
    for depth in depths:
        n, b = fn.fals_normals(cache, depth, with_sums=True)
        n_ref, b_ref = fn.fals_normals_reference(cache, depth)
        ub, un = _ulps(b, b_ref), _ulps(n, n_ref)
        g = fusion._pixel_rays(depth, n, cache, fcfg).valid
        g_ref = fusion._pixel_rays(depth, n_ref, cache, fcfg).valid
        err = (n - n_ref).abs().nan_to_num(0.0).max()
        out.append({"b_diff": int((ub > 0).sum()), "b_ulps": int(ub.max()),
                    "max_abs_err": float(err),
                    "n_diff": int((un > 0).sum()), "n_ulps": int(un.max()),
                    "nan": int(torch.isnan(n_ref).any(-1).sum()),
                    "gated": int(g_ref.sum()),
                    "gate_diff": int((g != g_ref).sum())})
    torch.cuda.synchronize()
    return out


def normals_times(cache, depth):
    """Device ms of `fals_normals` on one frame beside its plain version
    (`compute_normals`), the plain version's float64 box sums alone
    (`normals.box_filter` on the stacked products), its launch floor (an
    empty kernel at its launch), its bound, and the host microseconds a
    wrapper call takes."""
    import torch
    from gradient_sdf_tpu_torch.ops import normals
    from gradient_sdf_tpu_torch.ops.kernels import _build
    from gradient_sdf_tpu_torch.ops.kernels import fals_normals as fn

    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream

    def empty():
        if lib.gsdf_fals_normals_empty(*depth.shape, cache.window, stream):
            raise AssertionError("the empty launch failed")

    z_inv = torch.where(depth != 0.0, 1.0 / depth, torch.zeros_like(depth))
    img = torch.stack([cache.x0_n_sq_inv * z_inv, cache.y0_n_sq_inv * z_inv,
                       cache.n_sq_inv * z_inv])
    bound = normals_bound_ms(depth.numel(), cache.window)
    return {"ms": median_ms(lambda: fn.fals_normals(cache, depth)),
            "plain_ms": median_ms(lambda: normals.compute_normals(cache, depth)),
            "box_filter_ms": median_ms(
                lambda: normals.box_filter(img, cache.window)),
            "launch_floor_ms": median_ms(empty),
            "host_us": host_us(lambda: fn.fals_normals(cache, depth)),
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}


# The normals kernel taken apart (`normals_split`): one-switch builds of a
# copy of a tree's `csrc/fals_normals.cu`, made like SPLIT_SWITCHES. Per
# design (a string only its source holds): switch name -> edits. A build
# that stops early keeps its last stage's results live through a store
# that does not happen.
_NSINK = "  if ({} == -1.5e30f) out[0] = 0.0f;\n  return;\n"
NORMALS_SWITCHES = {
    "32 x 16 tiles, float32 halo": ("constexpr int kTileX = 32;", {
        "empty kernel at its grid": [(
            "  extern __shared__ double smem[];",
            "  return;\n  extern __shared__ double smem[];")],
        "stage 1 only (halo products)": [(
            "  // 2. each halo row's", _NSINK.format("a[tid]")
            + "  // 2. each halo row's")],
        "stages 1-2 (+ row sums)": [(
            "  // 3. the column sums", _NSINK.format("(float)hsum[tid]")
            + "  // 3. the column sums")],
        "stage 2 converting once (float64 halo)": [
            ("  float* a = reinterpret_cast<float*>(smem + 3 * rows * kTileX);",
             "  double* a = smem + 3 * rows * kTileX;"),
            ("    const float* src = a + c", "    const double* src = a + c"),
            ("3 * rows * cols * sizeof(float);",
             "3 * rows * cols * sizeof(double);")],
    }),
    "64 x 16 tiles, float64 halo, running sums": (
        "constexpr int kTileX = 64;", {
        "empty kernel at its grid": [(
            "  extern __shared__ double smem[];",
            "  return;\n  extern __shared__ double smem[];")],
        "step 1's loads alone": [
            ("          const float zi = d[j] != 0.0f ? 1.0f / d[j] : 0.0f;\n"
             "          double* dst = P + hy * pitch + hx;\n"
             "          dst[0] = static_cast<double>(u[j] * zi);\n"
             "          dst[plane] = static_cast<double>(v[j] * zi);\n"
             "          dst[2 * plane] = static_cast<double>(w[j] * zi);",
             "          if (d[j] + u[j] + v[j] + w[j] == -1.5e30f) "
             "out[0] = 0.0f;"),
            ("  // the Q of this thread's step-4 pixels",
             "  return;\n  // the Q of this thread's step-4 pixels")],
        "step 1 (halo products), no Q loads": [(
            "  // the Q of this thread's step-4 pixels",
            "  __syncthreads();\n" + _NSINK.format("(float)P[tid]")
            + "  // the Q of this thread's step-4 pixels")],
        "steps 1-2 (+ column sums)": [(
            "  // 3. along each output row",
            _NSINK.format("(float)P[tid] + q[0][0].x")
            + "  // 3. along each output row")],
        "steps 1-3 (+ row sums)": [(
            "  // 4. n = Q b", _NSINK.format("B[tid] + q[0][0].x")
            + "  // 4. n = Q b")],
        "steps 1-3, every Q value awaited": [(
            "  // 4. n = Q b",
            "  { float s_ = B[tid];\n    for (int k = 0; k < kPixels; ++k)\n"
            "      for (int m = 0; m < 3; ++m) s_ += q[k][m].x + q[k][m].y;\n"
            + _NSINK.format("s_") + "  }\n  // 4. n = Q b")],
        "steps 1-4 (+ normals into shared memory)": [(
            "  // 5. the rows out", _NSINK.format("N[tid]")
            + "  // 5. the rows out")],
    }),
}
NORMALS_FUNCS = ("gsdf_fals_normals_f32",)


def normals_split(roots):
    """Step 0 of the normals kernel, and its designs side by side: for each
    tree root in `roots`, its `csrc/fals_normals.cu` built as it is and
    under each switch of its design (NORMALS_SWITCHES), launched through
    this package's wrapper on golden frame 5 (window 11) and timed with
    `median_ms`; the unswitched builds first held to the plain version (b
    and normals bit for bit) and timed in turns (roots in order, then in
    reverse). Returns a dict."""
    import torch
    from gradient_sdf_tpu_torch.data import synth
    from gradient_sdf_tpu_torch.ops import normals
    from gradient_sdf_tpu_torch.ops.kernels import fals_normals as fn

    dev = torch.device("cuda")
    jobs, designs = switch_jobs(roots, "fals_normals.cu", NORMALS_SWITCHES,
                                NORMALS_FUNCS)
    built = build_all(jobs)
    _, depths, _ = golden_protocol()
    cache = normals.build_cache(640, 480, synth.KINECT_K, window=11,
                                device=dev)
    depth = torch.as_tensor(depths[5], device=dev)
    n_ref, b_ref = fn.fals_normals_reference(cache, depth)
    out = {"trees": []}
    for k, root in enumerate(roots):
        lib = built[(k, "as it is")][0]
        n, b = with_lib(lib, lambda: fn.fals_normals(cache, depth,
                                                     with_sums=True))
        same = (torch.equal(b, b_ref)
                and torch.equal(n.nan_to_num(7.0), n_ref.nan_to_num(7.0)))
        ms = {name: median_ms(lambda: with_lib(lib_, lambda: fn.fals_normals(
                  cache, depth)))
              for (kk, name), (lib_, _) in built.items() if kk == k}
        out["trees"].append({
            "root": root, "design": designs[k], "bit_equal": same, "ms": ms,
            "host_us": with_lib(lib, lambda: host_us(
                lambda: fn.fals_normals(cache, depth))),
            "ptxas": {name: ptxas_lines(log, "fals_normals")
                      for (kk, name), (_, log) in built.items() if kk == k}})
    order = list(range(len(roots)))
    turns = order + order[::-1]
    out["turns"] = [(roots[k], median_ms(lambda: with_lib(
        built[(k, "as it is")][0], lambda: fn.fals_normals(cache, depth))))
        for k in turns]
    out["bound"] = normals_bound_ms(depth.numel(), cache.window)
    return out


def normals_split_report(res, smi):
    for t in res["trees"]:
        log(f"fals_normals of {t['root']} ({t['design']}), golden frame 5, "
            f"window 11 [{smi}]: b and normals bit-equal to plain: "
            f"{t['bit_equal']}; host {t['host_us']:.1f} us a wrapper call; "
            + "; ".join(f"{k} {v:.4f} ms" for k, v in t["ms"].items()))
        for name, lines in t["ptxas"].items():
            for k, v in lines.items():
                log(f"  ptxas ({name}) {k}: {v}")
    log(f"fals_normals in turns [{smi}]: "
        + "; ".join(f"{r} {ms:.4f} ms" for r, ms in res["turns"])
        + f"; bound {res['bound'][0]:.5f} ms ({res['bound'][1]})")


STRUCTURE = ("directory", "coarse_occ", "block_coords", "num_active",
             "overflow", "oob_samples")


def grid_snapshot(grid):
    """A copy of the grid's structure (what a claim changes), and a
    function that writes it back into the grid's own tensors."""
    snap = {k: getattr(grid, k).clone() for k in STRUCTURE}

    def restore():
        for k, v in snap.items():
            getattr(grid, k).copy_(v)

    return restore


def scratch_idle(m):
    """Put the kernel's scratch back to its values between frames after a
    claim pass that no integrate pass followed (a timing loop of the claim
    alone): the claims it listed back to INT32_MAX, the candidate marks to
    0. Touches nothing else, so the frame's images stay in the L2."""
    from gradient_sdf_tpu_torch.ops import voxel_grid as vg

    sc = m.scratch
    sc.claims[sc.new_keys[:int(sc.status[3])].long()] = vg.INT32_MAX
    sc.cand_mark.zero_()


def fuse_kernel_times(m, depth, R, t):
    """Device times (ms) of the two launches on the map `m` before the
    frame (`depth`, `R`, `t`) is fused, each beside its plain version: the
    claim pass (`reset_ms`, the scratch put back to idle before each
    launch; its plain version compacts, a host sync timed with it); the
    integrate pass opening the frame's blocks (`reset_ms`, the map's
    structure, the scratch and the claim pass put back before each launch;
    plain: `claim_alloc_reference` + `integrate_merge_reference`); then,
    with the blocks claimed and the claim pass run again (it opens
    nothing), the integrate pass on a copy of the map's fields (repeated
    integration of the same frame is the same work) and its plain version;
    an empty cooperative launch at the integrate pass's grid. Leaves `m`
    with the frame's blocks claimed and nothing integrated."""
    import torch
    from gradient_sdf_tpu_torch.ops import fusion
    from gradient_sdf_tpu_torch.ops.kernels import _build
    from gradient_sdf_tpu_torch.ops.kernels import fuse_integrate as fi

    gcfg, fcfg = m.cfg.grid, m.cfg.fusion
    nrm = fusion.compute_normals(m.cache, depth).contiguous()
    args = (depth, nrm, m.cache, R, t)
    restore = grid_snapshot(m.grid)

    def claim():
        return fi.claim_pass(*args, m.grid, gcfg, fcfg, m.scratch)

    def idle():
        restore()
        scratch_idle(m)

    def reset():
        idle()
        claim()

    out = {"claim_ms": reset_ms(claim, idle),
           "claim_plain_ms": median_ms(lambda: fi.claim_pass_reference(
               *args, m.grid, gcfg, fcfg))}
    idle()
    misses = int(claim()[0][0])

    def spare():
        """The map's grid with a copy of its fields (its structure shared)."""
        return m.grid._replace(**{k: getattr(m.grid, k).clone() for k in (
            "weight", "dist", "grad_x", "grad_y", "grad_z")})

    g = spare()
    out["integrate_open_ms"] = reset_ms(
        lambda: fi.integrate_merge(*args, g, gcfg, fcfg, m.acc, m.scratch),
        reset)

    def plain_open():
        _, mark, keys = fi.claim_pass_reference(*args, g, gcfg, fcfg)
        fi.integrate_merge_reference(
            *args, fi.claim_alloc_reference(g, mark, keys, gcfg), gcfg, fcfg,
            m.acc)

    out["integrate_open_plain_ms"] = reset_ms(plain_open, restore, reps=5)
    idle()
    before = int(m.grid.num_active)
    claim()
    g = spare()
    fi.integrate_merge(*args, g, gcfg, fcfg, m.acc, m.scratch)
    opened = int(m.grid.num_active) - before
    out["bounds_open"] = fuse_bounds(m, depth, R, t, misses, opened)
    out["bounds"] = fuse_bounds(m, depth, R, t, 0)
    claim()
    out["integrate_ms"] = median_ms(
        lambda: fi.integrate_merge(*args, g, gcfg, fcfg, m.acc, m.scratch))
    g = spare()
    out["integrate_plain_ms"] = median_ms(lambda: fi.integrate_merge_reference(
        *args, g, gcfg, fcfg, m.acc))
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream

    def empty():
        if lib.gsdf_fuse_coop_empty(stream) != 0:
            raise AssertionError("the empty cooperative launch failed")

    out.update(coop_empty_ms=median_ms(empty), misses=misses, opened=opened,
               shape=fi.integrate_shape(5))
    return out


def count_fuse_frame(m, depth, R, t):
    """`fusion.fuse_frame` on the card for one frame of the map `m`
    (updated as the map's `update` would fuse it), with its launches and
    host syncs counted: each kernel's launch counter, the CUDA kernels,
    memsets and copies under the profiler and its `nonzero` calls, the
    calls of `voxel_grid.insert_new` and `fusion.claim_blocks`, and the
    syncs at a line of `fusion.fuse_frame`, inside `voxel_grid.insert_new`,
    and anywhere else (`track_bench.count_syncs`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from gradient_sdf_tpu_torch.ops import fusion
    from gradient_sdf_tpu_torch.ops import voxel_grid as vg
    from gradient_sdf_tpu_torch.ops.kernels import fals_normals as fn
    from gradient_sdf_tpu_torch.ops.kernels import fuse_integrate as fi
    from gradient_sdf_tpu_torch.ops.kernels import merge_clear as mc
    from gradient_sdf_tpu_torch.ops.kernels import scatter_add as sa
    from gradient_sdf_tpu_torch.tools.track_bench import _lines, count_syncs

    for mod in (fn, fi, mc, sa):
        mod.reset_launch_count()
    calls = {"insert_new": 0, "claim_blocks": 0}
    real = {"insert_new": vg.insert_new, "claim_blocks": fusion.claim_blocks}

    def counting(name):
        def fn(*a, **k):
            calls[name] += 1
            return real[name](*a, **k)
        return fn

    torch.cuda.synchronize()

    def fuse():
        m.grid = fusion.fuse_frame(m.grid, depth, m.cache, R, t, m.cfg.grid,
                                   m.cfg.fusion, acc=m.acc, scratch=m.scratch)

    vg.insert_new = counting("insert_new")
    fusion.claim_blocks = counting("claim_blocks")
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, syncs = count_syncs(fuse)
            torch.cuda.synchronize()
    finally:
        vg.insert_new = real["insert_new"]
        fusion.claim_blocks = real["claim_blocks"]
    where = {"status": _lines(fusion.fuse_frame),
             "insert_new": _lines(real["insert_new"])}
    n = {k: sum(f == file and line in lines for f, line, _ in syncs)
         for k, (file, lines) in where.items()}
    return {"normals": fn.launch_count, "claim": fi.claim_launch_count,
            "integrate": fi.launch_count,
            "scatter_add": sa.launch_count, "merge_clear": mc.launch_count,
            "device_ops": sum(e.count for e in prof.key_averages()
                              if e.device_type == DeviceType.CUDA),
            "nonzero": nonzero_calls(prof),
            "status_syncs": n["status"], "insert_syncs": n["insert_new"],
            "other_syncs": len(syncs) - sum(n.values()),
            "insert_calls": calls["insert_new"],
            "claim_blocks_calls": calls["claim_blocks"]}


def nonzero_calls(prof):
    """The `nonzero` calls (`aten::nonzero`, and `nonzero_static`) a
    profiler with CPU activity recorded."""
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith("aten::nonzero"))


def fuse_frames_without_sync(m, depths, poses):
    """`fusion.fuse_frame` on the card for each frame (device tensors; R,
    t float32) into the map `m`, under PyTorch's sync debug mode "error",
    which raises at any host sync. Returns the block count after."""
    import torch
    from gradient_sdf_tpu_torch.ops import fusion

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for d, (R, t) in zip(depths, poses):
            m.grid = fusion.fuse_frame(m.grid, d, m.cache, R, t, m.cfg.grid,
                                       m.cfg.fusion, acc=m.acc,
                                       scratch=m.scratch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return int(m.grid.num_active)


SPLIT_ROUNDS = 5   # fresh maps fused over frames 0-5, after one warm-up


def fuse_parts(m, depth, R, t):
    """The imported package's single-card `fuse_frame` (no visibility
    bits, the map's accumulator) written out as [(part, fn)], run in
    order; the map's grid is updated as `fuse_frame` would. The package
    with `ops/kernels/fuse_integrate.py` takes its path: normals (the
    `fals_normals` kernel where the package has it), claim
    pass, integrate-and-merge launch (which claims the blocks), or, before
    the claim moved onto the card, normals, claim pass and status read,
    block claim, integrate-and-merge launch; an earlier one the plain walk
    (normals, pixel gates and compaction, sample walk, lookup,
    `need.any()`, claim insert, scatter, `merge_clear`). A `vis` part ORs a keyframe bit into a spare bitfield
    (the PhotoBA map's extra; the app's map has none)."""
    import importlib.util

    import torch
    from gradient_sdf_tpu_torch.ops import fusion
    from gradient_sdf_tpu_torch.ops import voxel_grid as vg

    gcfg, fcfg = m.cfg.grid, m.cfg.fusion
    st = {}

    if importlib.util.find_spec(
            "gradient_sdf_tpu_torch.ops.kernels.fals_normals") is not None:
        from gradient_sdf_tpu_torch.ops.kernels.fals_normals import (
            fals_normals as normals_of)
    else:
        normals_of = fusion.compute_normals

    def normals():
        st["nrm"] = normals_of(m.cache, depth)

    if importlib.util.find_spec(
            "gradient_sdf_tpu_torch.ops.kernels.fuse_integrate") is not None:
        from gradient_sdf_tpu_torch.ops.kernels import fuse_integrate as fi

        if hasattr(fi, "claim_alloc_reference"):   # the claim on the card
            def claim_pass():
                fi.claim_pass(depth, st["nrm"], m.cache, R, t, m.grid, gcfg,
                              fcfg, m.scratch)

            def integrate_open():
                fi.integrate_merge(depth, st["nrm"], m.cache, R, t, m.grid,
                                   gcfg, fcfg, m.acc, m.scratch)

            return [("normals", normals), ("claim pass", claim_pass),
                    ("integrate + merge (with the block claim)",
                     integrate_open)]

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


# The fusion kernels taken apart (`kernel_split`): one-switch builds of a
# copy of `csrc/fuse_integrate.cu` under the build directory. A switch is a
# text edit of the copy, made here and never in the source; each build
# carries one. Per design (a string only its source holds): switch name ->
# [(text, replacement)], each text found exactly once.
_SINK = ("{ float s_ = 0.0f; for (int f = 0; f < F; ++f) s_ += x[f]; "
         "if (s_ == -1.0e30f) p.acc[0] = s_; }")
_SAME_GRID = ("    s.ctas_per_sm = n;",
              "    s.ctas_per_sm = n < @CTAS@ ? n : @CTAS@;")
SPLIT_SWITCHES = {
    "host block claim": ("stays plain PyTorch\n// between the two launches", {
        "claim, no directory lookup": [(
            "} else if (__ldg(p.directory + s.key) < 0) {",
            "} else if (s.key == -7) {")],
        "integrate, phase A only": [_SAME_GRID, (
            "  cg::this_grid().sync();\n  int64_t active",
            "  return;\n  cg::this_grid().sync();\n  int64_t active")],
        "integrate, phase A + barrier": [_SAME_GRID, (
            "  cg::this_grid().sync();\n  int64_t active",
            "  cg::this_grid().sync();\n  return;\n  int64_t active")],
        "integrate, phase A without its reductions": [_SAME_GRID, (
            "gsdf::reduce_row<F, true>(p.acc + static_cast<int64_t>(i) * 8, x);",
            _SINK)],
    }),
    "card block claim": ("in two launches and\n// no host sync", {
        "claim, no directory lookup": [(
            "if (key[j] >= 0) slot[j] = __ldg(p.directory + key[j]);",
            "if (key[j] == -7) slot[j] = 0;")],
        "integrate, phase 0 only": [_SAME_GRID, (
            "  // phase A: walk the valid pixels",
            "  return;\n  // phase A: walk the valid pixels")],
        "integrate, phases 0 + A": [_SAME_GRID, (
            "  grid.sync();\n\n  // phase B", "  return;\n  // phase B")],
        "integrate, phases 0 + A + barrier": [_SAME_GRID, (
            "  grid.sync();\n\n  // phase B",
            "  grid.sync();\n  return;\n  // phase B")],
        "integrate, phase A without its reductions": [_SAME_GRID, (
            "gsdf::reduce_row<F, true>(p.acc + static_cast<int64_t>(i) * 8, x);",
            _SINK)],
        "integrate, warp_aggregate's loop in place of warp_merge": [
            _SAME_GRID, ("        if (warp_merge<F>(i, x)) {",
                         "        if (gsdf::warp_aggregate<F>(i, x)) {")],
    }),
}
FUSE_FUNCS = ("gsdf_fuse_claim_f32", "gsdf_fuse_integrate_f32",
              "gsdf_fuse_integrate_shape", "gsdf_fuse_coop_empty")


def ptxas_lines(build_log, key):
    """{kernel entry: "registers, smem ...; spills"} of the entry functions
    whose mangled name holds `key`, from an `nvcc -Xptxas -v` log."""
    import re

    out, entry = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1) if key in m.group(1) else None
            continue
        if entry and ("Used" in line or "spill" in line):
            text = line.split(":", 1)[-1].strip()
            out[entry] = f"{out[entry]}; {text}" if entry in out else text
    return out


def build_switched(text, name, edits, ctas=0, fname="fuse_integrate.cu",
                   funcs=FUSE_FUNCS, tag=""):
    """`text` (a `fname` source, `fuse_integrate.cu` by default) with
    `edits` applied, built by itself under the build directory (in a
    directory named after `fname`, `tag` and `name`); `ctas` stands for
    @CTAS@ in the edits (the unswitched integrate kernel's CTAs an SM, so
    that a switched build launches the same grid). Returns (ctypes library
    with the entry points `funcs` declared as the package's, compiler
    output)."""
    import ctypes
    import glob
    import re
    import shutil

    from gradient_sdf_tpu_torch.ops.kernels import _build

    for old, new in edits:
        if text.count(old) != 1:
            raise AssertionError(f"switch {name!r}: its anchor is not in the "
                                 f"source exactly once")
        text = text.replace(old, new.replace("@CTAS@", str(ctas)))
    sub = "split" if fname == "fuse_integrate.cu" else f"split-{fname[:-3]}"
    out_dir = os.path.join(_build.BUILD_ROOT, sub,
                           re.sub(r"\W+", "-", f"{tag}{name}"))
    os.makedirs(out_dir, exist_ok=True)
    for header in glob.glob(os.path.join(_build.CSRC, "*.cuh")):
        shutil.copy(header, out_dir)
    src = os.path.join(out_dir, fname)
    with open(src, "w") as f:
        f.write(text)
    target = os.path.join(out_dir, "lib.so")
    log = _build._compile([src], out_dir, target)
    lib, real = ctypes.CDLL(target), _build.load()
    for fn in funcs:
        getattr(lib, fn).argtypes = getattr(real, fn).argtypes
        getattr(lib, fn).restype = getattr(real, fn).restype
    return lib, log


def switch_jobs(roots, fname, table, funcs):
    """The builds that take `fname` of each tree root in `roots` apart:
    ([((k, switch name), args, keywords) for `build_all`], {k: design}),
    the source built as it is and under each switch of its design in
    `table` (design -> (a string only its source holds, {switch name:
    edits}))."""
    jobs, designs = [], {}
    for k, root in enumerate(roots):
        with open(os.path.join(root, "gradient_sdf_tpu_torch", "csrc",
                               fname)) as f:
            text = f.read()
        design = next(d for d, (mark, _) in table.items() if mark in text)
        designs[k] = design
        for name, edits in {"as it is": [], **table[design][1]}.items():
            jobs.append(((k, name), (text, name, edits),
                         {"fname": fname, "funcs": funcs, "tag": f"t{k}-"}))
    return jobs, designs


def build_all(jobs):
    """`build_switched(*args, **kw)` for each (key, args, kw) of `jobs`,
    the builds running together. Returns {key: (library, compiler
    output)}."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {k: ex.submit(build_switched, *a, **kw) for k, a, kw in jobs}
        return {k: f.result() for k, f in futs.items()}


def host_us(fn, calls=200):
    """Host microseconds one `fn()` takes to return (the wrapper's checks,
    ctypes and the launch's enqueue): the mean over `calls` back-to-back
    calls, queued behind a device-side spin so that no call waits for the
    device."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def with_lib(lib, fn):
    """fn() with the package's wrappers launching from `lib`."""
    from gradient_sdf_tpu_torch.ops.kernels import _build

    saved = _build._lib
    _build._lib = lib
    try:
        return fn()
    finally:
        _build._lib = saved


def reduction_counts(m, depth, R, t):
    """What the scatter of this frame asks of the L2 under the host-claim
    design's layout (a warp = 32 consecutive pixels, one reduction per
    distinct row of a warp and step k), counted from the plain walk after
    the claim: live samples in the map, their distinct accumulator rows,
    the reductions."""
    import torch
    from gradient_sdf_tpu_torch.ops import fusion
    from gradient_sdf_tpu_torch.ops import voxel_grid as vg
    from gradient_sdf_tpu_torch.ops.kernels import fuse_integrate as fi

    gcfg, fcfg = m.cfg.grid, m.cfg.fusion
    nrm = fusion.compute_normals(m.cache, depth).contiguous()
    idx, s = fi.frame_walk(depth, nrm, m.cache, R, t, gcfg, fcfg)
    k = fi.samples_per_ray(fcfg)
    slot = vg.lookup_keys(m.grid, s.keys, gcfg)
    ok = slot >= 0
    nvox = m.grid.num_blocks * gcfg.voxels_per_block
    row = (slot.long() * gcfg.voxels_per_block + s.local_lin)[ok]
    warp_step = ((idx // 32)[:, None] * k + torch.arange(k, device=idx.device)
                 ).reshape(-1)[ok]
    return {"samples": int(ok.sum()), "rows": int(torch.unique(row).numel()),
            "reductions": int(torch.unique(warp_step * nvox + row).numel())}


def kernel_split():
    """Step 0 for the imported tree: its fusion kernels' ptxas report, and
    on golden frame 0 (an empty map: every live sample misses) and frame 5
    (after frames 0-4) the claim pass and the integrate pass timed whole
    and under each of its design's switches (SPLIT_SWITCHES; the switched
    integrate builds launch the unswitched kernel's grid), beside an empty
    cooperative launch. The claim pass is timed with `reset_ms`, the map's
    oob counter (and the scratch, where the card claims the blocks) put
    back before each launch. The integrate pass is timed after the frame's
    blocks are claimed (and the claim pass run again: it opens nothing), on
    a copy of the map's fields; where the card claims the blocks, also
    while it opens them (`reset_ms`, the map's structure, the scratch and
    the claim pass put back before each launch). Then `reduction_counts`.
    Returns a dict."""
    import torch
    from gradient_sdf_tpu_torch.data import synth
    from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap
    from gradient_sdf_tpu_torch.ops import fusion
    from gradient_sdf_tpu_torch.ops.kernels import _build
    from gradient_sdf_tpu_torch.ops.kernels import fuse_integrate as fi

    dev = torch.device("cuda")
    real = _build.load()
    with open(os.path.join(_build.CSRC, "fuse_integrate.cu")) as f:
        text = f.read()
    design = next(d for d, (mark, _) in SPLIT_SWITCHES.items() if mark in text)
    switches = SPLIT_SWITCHES[design][1]
    shape = fi.integrate_shape(5)
    built = build_all([(name, (text, name, edits, shape[0]), {})
                       for name, edits in switches.items()])
    out = {"design": design, "ptxas": ptxas_lines(_build.build_log, "fuse_"),
           "ptxas_switched": {n: ptxas_lines(log, "fuse_integrate")
                              for n, (_, log) in built.items()
                              if n.startswith("integrate")},
           "shape": shape, "frames": {}}
    cfg, depths, poses = golden_protocol()
    K = synth.KINECT_K
    stream = torch.cuda.current_stream().cuda_stream

    def empty():
        if real.gsdf_fuse_coop_empty(stream) != 0:
            raise AssertionError("the empty cooperative launch failed")

    def each(kind, fn):
        """{name: fn()} unswitched and under every switch of `kind`."""
        res = {kind: fn()}
        for name, (lib, _) in built.items():
            if name.startswith(kind):
                res[name] = with_lib(lib, fn)
        return res

    for n in (0, 5):
        m = GradSdfMap(cfg, device=dev)
        for i in range(n):
            m.update(depths[i], K, poses[i])
        m.ensure_cache(K, 640, 480)
        gcfg, fcfg = m.cfg.grid, m.cfg.fusion
        d = torch.as_tensor(depths[n], device=dev)
        R, t = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                for a in poses[n])
        nrm = fusion.compute_normals(m.cache, d).contiguous()
        args = (d, nrm, m.cache, R, t)
        restore = grid_snapshot(m.grid)

        def claim():
            return fi.claim_pass(*args, m.grid, gcfg, fcfg, m.scratch)

        def idle():
            restore()
            if design != "host block claim":
                scratch_idle(m)

        ms = each("claim", lambda: reset_ms(claim, idle))
        idle()
        status, mark, keys = claim()
        misses = int(status[0])
        before = int(m.grid.num_active)
        if design == "host block claim":
            m.grid = fusion.claim_blocks(m.grid, mark, keys, misses,
                                         int(status[1]), gcfg)
        else:
            def reset():
                idle()
                claim()

            opening = each("integrate", lambda: reset_ms(
                lambda: fi.integrate_merge(*args, m.grid, gcfg, fcfg, m.acc,
                                           m.scratch), reset))
            ms.update({f"{k}, opening the frame's blocks": v
                       for k, v in opening.items() if "without" not in k})
            m.acc.zero_()   # the switched builds stop before the merge
            m.scratch.marks.zero_()
            reset()
        g = m.grid._replace(**{k: getattr(m.grid, k).clone() for k in (
            "weight", "dist", "grad_x", "grad_y", "grad_z")})

        def integrate():
            fi.integrate_merge(*args, g, gcfg, fcfg, m.acc, m.scratch)

        integrate()
        opened = int(m.grid.num_active) - before
        claim()
        ms.update(each("integrate", lambda: median_ms(integrate)))
        m.acc.zero_()
        m.scratch.marks.zero_()
        ms["empty cooperative launch"] = median_ms(empty)
        out["frames"][n] = {
            "ms": ms, "misses": misses, "opened": opened,
            "counts": reduction_counts(m, d, R, t)}
    return out


def split_report(res, smi, tag):
    """Print `kernel_split`'s result."""
    log(f"{tag}: fusion kernels of the {res['design']} design taken apart by "
        f"one-switch builds [{smi}]")
    for k, v in res["ptxas"].items():
        log(f"  ptxas {k}: {v}")
    for name, lines in res["ptxas_switched"].items():
        for k, v in lines.items():
            log(f"  ptxas ({name}) {k}: {v}")
    for n, r in res["frames"].items():
        c = r["counts"]
        log(f"  golden frame {n} ({r['misses']} missing samples, {r['opened']} "
            f"blocks opened): " + "; ".join(f"{k} {v:.4f} ms"
                                            for k, v in r["ms"].items()))
        log(f"    {c['samples']} live samples in the map into {c['rows']} "
            f"distinct rows; {c['reductions']} global reductions with warps "
            f"of 32 pixels in a row")


# ---------------------------------------------------------------------------
# the mesh's merge step (`--mesh-merge`)
# ---------------------------------------------------------------------------

MESH_RANKS, MESH_BLOCKS = 4, 2   # 2 rays x 2 blocks, chip_smoke's phase 15
MERGE_ROW_BYTES = 3 * 5 * 4      # red read, fields read and written, a row
_FIELDS_EARLY = "    Voxel old{};\n    if (v < rows) old = load_voxel(f, r, with_grad);\n"
_FIELDS_USE = "    __syncthreads();\n    if (v < rows) {\n      const float* a"
_FIELDS_LATE = [(_FIELDS_EARLY, "    Voxel old{};\n"),
                (_FIELDS_USE, "    __syncthreads();\n    if (v < rows) old = "
                              "load_voxel(f, r, with_grad);\n    if (v < rows) {"
                              "\n      const float* a")]
# one-switch builds of csrc/merge_clear.cu that take merge_touched's design
# back step by step: {switch name: [(anchor, replacement)]}
MERGE_SWITCHES = {
    "fields loaded after the stage": _FIELDS_LATE,
    "the first design (fields after the stage, a stage's loads and stores "
    "in turn)": _FIELDS_LATE + [(
        "    if (k0 < n4) x0 = __ldg(p4 + k0);\n"
        "    if (k1 < n4) x1 = __ldg(p4 + k1);\n"
        "    if (k0 < n4) stage[k0] = x0;\n"
        "    if (k1 < n4) stage[k1] = x1;\n",
        "    for (int k = k0; k < n4; k += blockDim.x) stage[k] = __ldg(p4 + k);"
        "\n    (void)x1; (void)k1;\n")],
}
MERGE_FUNCS = ("gsdf_merge_touched_f32",)


def keep_owned_rows(acc, red, tidx, lo: int, m: int, vpb: int):
    """The mesh's merge step before `merge_touched` took it over, kept to
    time it against: copy the summed compact rows `red` [cap * B^3, 5] of
    the blocks this rank owns (slots [lo, lo + m)) into a persistent
    [m * B^3, 8] accumulator, which `merge_clear` then merges over the
    shard's allocated slots (`shard_active`) and clears."""
    own = (tidx >= lo) & (tidx < lo + m)
    acc.view(m, vpb, -1)[tidx[own] - lo, :, :5] = (
        red.view(-1, vpb, 5)[:tidx.shape[0]][own])


def shard_active(num_active, lo: int, m: int):
    """The shard's allocated slots for `merge_clear`, int32 on the device."""
    import torch

    return torch.clamp(num_active - lo, 0, m).to(torch.int32)


def old_merge_step(acc, red, tidx, lo: int, fields, num_active):
    """The replaced merge step: `keep_owned_rows`, then `merge_clear` over
    the shard's allocated slots (the fields f32 [m, B^3] each)."""
    from gradient_sdf_tpu_torch.ops.kernels import merge_clear as mc

    m, vpb = fields[0].shape
    keep_owned_rows(acc, red, tidx, lo, m, vpb)
    mc.merge_clear(acc, *fields, shard_active(num_active, lo, m))


def merge_bound_touched_ms(owned_rows: int, n_list: int) -> float:
    """Least time for the bytes `merge_touched` must move: per row of an
    owned touched block 20 B of the summed rows read and 20 B of fields
    read and written, and the list read."""
    return (owned_rows * MERGE_ROW_BYTES + n_list * 8) / MEM_BYTES_PER_S * 1e3


def mesh_merge_inputs(mesh, grid, depth, cache, R, t, gcfg, fcfg):
    """`sharding.sharded_fuse_frame`'s steps for one frame up to its merge
    (compact path, cap = the touched blocks), on this rank: the grid with
    the frame's blocks claimed, and {red, tidx, lo, num_active, the scatter's
    inputs lin_c, fields, rows and its kernel's accumulator acc}."""
    from gradient_sdf_tpu_torch.ops import fusion
    from gradient_sdf_tpu_torch.ops.kernels import scatter_add as sa
    from gradient_sdf_tpu_torch.parallel import mesh as mesh_mod
    from gradient_sdf_tpu_torch.parallel import sharding

    s = fusion.frame_samples(depth, cache, R, t, gcfg, fcfg)
    grid, lin, ok = fusion._alloc_slots(grid, s, gcfg)
    nb, vpb = grid.num_blocks, gcfg.voxels_per_block
    lo, _ = sharding.block_range(mesh, nb)
    lin, slot, local, fields = sharding.rank_samples(mesh, s, lin, ok, vpb, nb)
    tidx = sharding.touched_blocks(mesh, slot, nb)
    rows = tidx.shape[0] * vpb
    lin_c = sharding.compact_index(slot, local, tidx, nb, vpb, tidx.shape[0])
    acc = sa.new_accumulator(rows, grid.device)
    sa.scatter_add_fields(lin_c, fields, rows, acc=acc[:, :5])
    red = mesh_mod.psum(acc[:, :5].contiguous(), mesh, count=False)
    return grid, {"red": red, "tidx": tidx, "lo": lo,
                  "num_active": grid.num_active.clone(), "lin_c": lin_c,
                  "fields": fields, "rows": rows, "acc": acc}


def save_merge_inputs(path, grid, inp):
    """A rank's merge inputs as CPU tensors in `path`: red, tidx, lo,
    num_active, num_blocks and the shard's fields cut to its allocated
    slots (`load_merge_inputs` pads them back with zeros)."""
    import torch

    m = grid.dist.shape[0]
    na = int(shard_active(inp["num_active"], inp["lo"], m))
    torch.save({"red": inp["red"].cpu(), "tidx": inp["tidx"].cpu(),
                "lo": inp["lo"], "m": m, "num_blocks": grid.num_blocks,
                "num_active": inp["num_active"].cpu(),
                "fields": [getattr(grid, f)[:na].cpu() for f in
                           ("weight", "dist", "grad_x", "grad_y", "grad_z")]},
               path)


def load_merge_inputs(path, device):
    import torch

    d = torch.load(path)
    m = d["m"]
    d["fields"] = [torch.cat([f, f.new_zeros((m - f.shape[0], f.shape[1]))])
                   .to(device) for f in d["fields"]]
    for k in ("red", "tidx", "num_active"):
        d[k] = d[k].to(device)
    return d


def _bits_equal(a, b):
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def mesh_merge_check(d):
    """`merge_touched` on a rank's inputs `d` (`load_merge_inputs`) held to
    its plain version bit for bit, with and without gradients and at the
    full path's source indexing (the summed rows at the blocks' slots),
    and to the replaced step (`old_merge_step`) on the touched blocks it
    owns, bit for bit; a touched block it does not own and an untouched one
    keep their bits. Raises on a difference; returns {owned blocks, list
    length, voxels of untouched allocated blocks that the replaced step's
    dense merge moved by its (d W) / W rounding}."""
    import torch
    from gradient_sdf_tpu_torch.ops.kernels import merge_clear as mc
    from gradient_sdf_tpu_torch.ops.kernels import scatter_add as sa

    red, tidx, lo, fields = d["red"], d["tidx"], d["lo"], d["fields"]
    m, vpb = fields[0].shape
    own = (tidx >= lo) & (tidx < lo + m)
    owned = (tidx[own] - lo).long()
    red_full = torch.zeros((d["num_blocks"] * vpb, 5), device=red.device)
    red_full.view(-1, vpb, 5)[tidx] = red.view(-1, vpb, 5)[:tidx.shape[0]]
    results = {}
    for name, src, full, grad in (("compact", red, False, True),
                                  ("compact, no gradients", red, False, False),
                                  ("full", red_full, True, True)):
        got = [f.clone() for f in fields]
        want = [f.clone() for f in fields]
        mc.merge_touched(src, tidx, lo, *got, full=full, with_grad=grad)
        mc.merge_touched_reference(src, tidx, lo, *want, full=full,
                                   with_grad=grad)
        for k, (a, b) in enumerate(zip(got, want)):
            if not _bits_equal(a, b):
                raise AssertionError(f"merge_touched ({name}) field {k}: "
                                     f"kernel vs plain differ")
        results[name] = got
    for a, b in zip(results["compact"], results["full"]):
        if not _bits_equal(a, b):
            raise AssertionError("merge_touched: the full path's indexing "
                                 "gives other bits than the compact path's")
    old = [f.clone() for f in fields]
    acc = sa.new_accumulator(m * vpb, red.device)
    old_merge_step(acc, red, tidx, lo, old, d["num_active"])
    kept = torch.ones(m, dtype=torch.bool, device=red.device)
    kept[owned] = False
    drift = 0
    for k, (new, was, before) in enumerate(zip(results["compact"], old,
                                               fields)):
        if not _bits_equal(new[owned], was[owned]):
            raise AssertionError(f"merge_touched field {k}: the touched "
                                 f"blocks differ from the replaced step's")
        if not _bits_equal(new[kept], before[kept]):
            raise AssertionError(f"merge_touched field {k} wrote a block "
                                 f"the list does not give this rank")
        drift += int((was[kept] != before[kept]).sum())
    if bool(acc.any()):
        raise AssertionError("the replaced step left its accumulator dirty")
    return {"owned": int(owned.numel()), "n_list": int(tidx.shape[0]),
            "dense_drift_voxels": drift}


def _count_step(fn, tries=3):
    """(device ops under the profiler, `nonzero` calls, host syncs,
    `merge_clear` launches) of one `fn()`. A trace that holds no device op
    although `merge_clear` counted a launch has lost its device events (seen
    once on an H100 in `chip_smoke.py`'s phase 15e, for a kernel that the
    run's other traces caught), so `fn()` is counted again, up to `tries`
    times; the counts returned are those of the last trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from gradient_sdf_tpu_torch.ops.kernels import merge_clear as mc
    from gradient_sdf_tpu_torch.tools.track_bench import count_syncs

    for _ in range(tries):
        torch.cuda.synchronize()
        mc.reset_launch_count()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, syncs = count_syncs(fn)
            torch.cuda.synchronize()
        out = (sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
               nonzero_calls(prof), len(syncs), mc.launch_count)
        if out[0] or not out[3]:
            return out
    return out


def mesh_merge_times(d, old_lib=None, variants=None):
    """Times of the merge step on a rank's inputs `d`, on the card: the
    kernel (`median_ms`, and events around each launch as
    `track_bench.event_ms` takes them), an empty kernel at its grid, its
    byte bound, the plain version, the host microseconds a wrapper call
    takes, and the replaced step (`old_merge_step`: device ms, ops, host
    syncs) with this tree's `merge_clear` and, given `old_lib` (an earlier
    tree's `merge_clear.cu` built alone, `build_switched`), with that
    kernel; `variants` {name: library} are switched builds of this
    kernel (`MERGE_SWITCHES`), each first held to the plain version bit
    for bit. All in turns (old, new, variants, new, variants, old)."""
    import ctypes

    import torch
    from gradient_sdf_tpu_torch.ops.kernels import _build
    from gradient_sdf_tpu_torch.ops.kernels import merge_clear as mc
    from gradient_sdf_tpu_torch.ops.kernels import scatter_add as sa
    from gradient_sdf_tpu_torch.tools.track_bench import event_ms

    red, tidx, lo, fields = d["red"], d["tidx"], d["lo"], d["fields"]
    m, vpb = fields[0].shape
    n = int(tidx.shape[0])
    owned = int(((tidx >= lo) & (tidx < lo + m)).sum())
    spare = [f.clone() for f in fields]
    acc = sa.new_accumulator(m * vpb, red.device)
    lib = _build.load()
    shape = (ctypes.c_int * 2)()
    lib.gsdf_merge_launch_shape(n, vpb, 0, ctypes.addressof(shape))
    ctas, threads = shape[0], shape[1]
    stream = torch.cuda.current_stream().cuda_stream

    def new():
        mc.merge_touched(red, tidx, lo, *spare)

    def empty():
        if lib.gsdf_empty_launch(ctas, threads, stream) != 0:
            raise AssertionError("the empty kernel did not launch")

    def old():
        old_merge_step(acc, red, tidx, lo, spare, d["num_active"])

    def old_parent():
        with_lib(old_lib, old)

    def variant(lib):
        got = [f.clone() for f in fields]
        want = [f.clone() for f in fields]
        with_lib(lib, lambda: mc.merge_touched(red, tidx, lo, *got))
        mc.merge_touched_reference(red, tidx, lo, *want)
        if not all(_bits_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("a switched merge_touched differs from plain")
        return lambda: with_lib(lib, new)

    olds = [("old", old)] + ([("old, parent kernel", old_parent)]
                              if old_lib is not None else [])
    others = [(k, variant(lib)) for k, lib in (variants or {}).items()]
    turns = {}
    for name, fn in [*olds, ("new", new), *others, ("new", new),
                     *others[::-1], *olds[::-1]]:
        turns.setdefault(name, []).append(median_ms(fn))
    out = {"n_list": n, "owned": owned, "ctas": ctas, "threads": threads,
           "turns": turns, "ms": min(turns["new"]),
           "event_ms": event_ms(new), "floor_ms": median_ms(empty),
           "floor_event_ms": event_ms(empty),
           "plain_ms": median_ms(lambda: mc.merge_touched_reference(
               red, tidx, lo, *spare)),
           "bound_ms": merge_bound_touched_ms(owned * vpb, n),
           "host_us": host_us(new), "old_host_us": host_us(old),
           "ops": _count_step(new), "old_ops": _count_step(old)}
    if bool(acc.any()):
        raise AssertionError("the replaced step left its accumulator dirty")
    return out


def mesh_merge_rank(spec):
    """One rank of `--mesh-merge`: golden frames 0-4 fused from their poses
    through `sharded_fuse_frame`, then frame 5's merge inputs saved to
    spec["out"]/rank<r>.pt."""
    import torch
    from gradient_sdf_tpu_torch.data import synth
    from gradient_sdf_tpu_torch.ops import normals
    from gradient_sdf_tpu_torch.ops import voxel_grid as vg
    from gradient_sdf_tpu_torch.parallel import mesh as mesh_mod
    from gradient_sdf_tpu_torch.parallel import sharding

    mesh = mesh_mod.make_mesh(MESH_RANKS, MESH_BLOCKS, spec["device"])
    dev = mesh.device
    cfg, depths, poses = spec["protocol"]
    gcfg, fcfg = cfg.grid, cfg.fusion
    cache = normals.build_cache(640, 480, synth.KINECT_K, fcfg.normal_window,
                                dev)
    grid = sharding.shard_grid(mesh, vg.create(gcfg, dev))

    def frame(i):
        return [torch.as_tensor(a, dtype=torch.float32, device=dev)
                for a in (depths[i], *poses[i])]

    for i in range(5):
        depth, R, t = frame(i)
        grid = sharding.sharded_fuse_frame(mesh, grid, depth, cache, R, t,
                                           gcfg, fcfg)
    depth, R, t = frame(5)
    grid, inp = mesh_merge_inputs(mesh, grid, depth, cache, R, t, gcfg, fcfg)
    save_merge_inputs(os.path.join(spec["out"], f"rank{mesh.rank}.pt"), grid,
                      inp)


def mesh_merge_report(out_dir, smi, old_lib=None, variants=None,
                      tag="mesh merge"):
    """`mesh_merge_check` and `mesh_merge_times` on every rank's saved
    inputs in `out_dir`, one line each. Returns {rank: times and checks}."""
    import torch

    res = {}
    for r in range(MESH_RANKS):
        d = load_merge_inputs(os.path.join(out_dir, f"rank{r}.pt"),
                              torch.device("cuda"))
        chk = mesh_merge_check(d)
        tm = mesh_merge_times(d, old_lib, variants)
        res[r] = {**chk, **tm}
        ops, nz, syncs, launches = tm["ops"]
        ops_o, nz_o, syncs_o, _ = tm["old_ops"]
        if (ops, nz, syncs, launches) != (1, 0, 0, 1):
            raise AssertionError(f"merge_touched made {ops} device ops, {nz} "
                                 f"nonzero calls, {syncs} host syncs, "
                                 f"{launches} launches; want one launch and "
                                 f"nothing else")
        turns = "; ".join(f"{k} " + ", ".join(f"{x:.5f}" for x in v)
                          for k, v in tm["turns"].items())
        log(f"{tag} rank {r} (slots [{d['lo']}, {d['lo'] + d['fields'][0].shape[0]}), "
            f"golden frame 5, [{smi}]): {chk['owned']} of the {chk['n_list']} "
            f"touched blocks owned; merge_touched = plain bit for bit "
            f"(compact, no gradients, full-path indexing) = the replaced step "
            f"on the owned blocks; {chk['dense_drift_voxels']} voxels of "
            f"untouched allocated blocks moved by the replaced dense merge; "
            f"kernel {tm['ms']:.5f} ms (events {tm['event_ms']:.5f}) at "
            f"{tm['ctas']} x {tm['threads']}, an empty kernel there "
            f"{tm['floor_ms']:.5f} (events {tm['floor_event_ms']:.5f}), bound "
            f"{tm['bound_ms']:.6f}, plain {tm['plain_ms']:.5f}, host "
            f"{tm['host_us']:.1f} us a call; {ops} device op(s), {nz} nonzero, "
            f"{syncs} host sync(s); replaced step (keep_owned_rows + "
            f"merge_clear): {ops_o} device ops, {nz_o} nonzero, {syncs_o} host "
            f"syncs, host {tm['old_host_us']:.1f} us; ms in turns: {turns}")
    return res


def mesh_merge_main(parent, smi):
    """`--mesh-merge`: the ranks' inputs made by a group of MESH_RANKS
    ranks on this card, then the report, with the parent's `merge_clear`
    kernel in the replaced step if `parent` is given."""
    import shutil

    from gradient_sdf_tpu_torch.parallel import mesh as mesh_mod

    out = os.path.join(OWN_ROOT, "smoke_out", "fusion_bench_mesh_merge")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    mesh_mod.launch(mesh_merge_rank, MESH_RANKS,
                    {"protocol": golden_protocol(), "out": out,
                     "device": "cuda"}, device="cuda", join_timeout_s=600)
    with open(os.path.join(OWN_ROOT, "gradient_sdf_tpu_torch", "csrc",
                           "merge_clear.cu")) as f:
        text = f.read()
    jobs = [(name, (text, name, edits), {"fname": "merge_clear.cu",
                                         "funcs": MERGE_FUNCS})
            for name, edits in MERGE_SWITCHES.items()]
    if parent:
        with open(os.path.join(parent, "gradient_sdf_tpu_torch", "csrc",
                               "merge_clear.cu")) as f:
            jobs.append(("parent", (f.read(), "parent", []),
                         {"fname": "merge_clear.cu",
                          "funcs": ("gsdf_merge_clear_f32",),
                          "tag": "parent-"}))
    built = {k: lib for k, (lib, _) in build_all(jobs).items()}
    old_lib = built.pop("parent", None)
    mesh_merge_report(out, smi, old_lib, built)


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
    ap.add_argument("--kernels", metavar="DIR", nargs="?", const=OWN_ROOT,
                    help="only the fusion kernels of the tree in DIR (this "
                         "one by default) taken apart (`kernel_split`)")
    ap.add_argument("--mesh-merge", action="store_true",
                    help="only the mesh's merge step on golden frame 5, "
                         "each rank's inputs, beside the replaced step "
                         "(with --parent: its kernel too)")
    ap.add_argument("--mesh-merge-report", metavar="DIR",
                    help="only the mesh merge report on the ranks' inputs "
                         "saved in DIR (chip_smoke.py phase 15e); rank 0's "
                         "numbers as the last line")
    ap.add_argument("--normals", metavar="DIR", nargs="*",
                    help="only the normals kernel of each tree DIR (this one "
                         "if none) taken apart and timed in turns "
                         "(`normals_split`)")
    args = ap.parse_args()
    root = (args.tree[0] if args.tree
            else (args.split_tree or args.kernels or OWN_ROOT))
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
    if args.kernels:
        split_report(kernel_split(), smi, f"tree {args.kernels}")
        return 0
    if args.mesh_merge_report:
        res = mesh_merge_report(args.mesh_merge_report, smi,
                                tag="phase15e merge_touched")
        print(json.dumps(res[0]), flush=True)
        return 0
    if args.mesh_merge:
        mesh_merge_main(args.parent and os.path.abspath(args.parent), smi)
        log(smi)
        return 0
    if args.normals is not None:
        normals_split_report(normals_split(
            [os.path.abspath(r) for r in args.normals] or [OWN_ROOT]), smi)
        log(smi)
        return 0
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
