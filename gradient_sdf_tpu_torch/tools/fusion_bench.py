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
    world = synth.random_spheres(seed=2)
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
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree[0] if args.tree else OWN_ROOT))
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
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
