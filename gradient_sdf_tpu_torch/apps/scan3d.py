"""Scan3D: 3D scanning from depth — tracking + fusion CLI (PyTorch port).

Port of `gradient_sdf_tpu/apps/scan3d.py` (reference
`cpp/depth_scanning/src/main_scan_3d.cpp:62-319`), with the same parser so
every reference flag parses, plus `--device` (default `cuda`). Flow: if a
GT pose file loads, run fusion-only with GT poses (:250-254); otherwise
the first frame initializes the map with identity pose and later frames
run GN tracking, fusing only converged frames (:256-266). Per-frame poses
go to `<results>/_poses.txt` in TUM format (:267-280); teardown writes
mesh + oriented point cloud PLYs and optional sparse SDF dumps (:288-311).

`--scan-type base-sdf` runs the trilinear TSDF ablation (`PixelSdfMap`,
trilinear tracking, no point cloud). `--checkpoint-every K` writes
`<results>/checkpoint.npz` whenever the fused-frame counter is a multiple of
K after a frame, and `--resume FILE` picks a run up from such a file (from
either package). `--profile DIR` writes a `torch.profiler` Chrome trace of
the third processed frame into DIR.

`--metrics-json` and `--profile` turn on the port's tracing
(`utils/trace`): each `frame_log` entry of the metrics then carries the
frame's spans in ms (`track_launch_ms`, `track_read_ms`, `fuse_launch_ms`,
`fuse_read_ms`), its device-to-host reads (`host_reads`), whether
`GradSdfMap.update` captured its fusion as a CUDA graph and replayed it
(`graph_captures`, `graph_replays`: 0 or 1, always 0 on the CPU and on a
mesh) and its kernel launches (`launches`), and the Chrome trace names the
host's idle gaps of the device by the same `gsdf.*` spans.

The loop is synchronous and reference-exact: each frame's convergence and
growth flags are read before the next frame starts, so `--merged-step` and
`--sync-growth-checks` are accepted as no-ops.

`--devices N` (N > 1, grad-sdf only) runs the reconstruction on a
(rays x blocks) mesh of N ranks (`parallel/`): tracking residuals split
over the ray axis, the volume's per-voxel storage over `--block-parallel`
ranks of the block axis (auto: 2 when N is even, else 1). A process that
is already a rank of a group of N (`parallel.mesh.launch`, or torchrun's
environment variables, `parallel.distributed.init`) runs as that rank;
otherwise the app starts N local ranks itself. Every rank loads its own
frames; rank 0 writes the poses, PLYs, dumps and metrics, and the metrics
gain a `mesh` record (backend, ranks per card, kernel launches summed over
the ranks, collectives).

Usage:  python -m gradient_sdf_tpu_torch.apps.scan3d --input <dir> [...]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import numpy as np
import torch

from .. import config as cfg_mod
from ..data import loaders
from ..models import tracker as tracker_mod
from ..models.grad_sdf import GradSdfMap
from ..models.pixel_sdf import PixelSdfMap
from ..utils import checkpoint as ckpt
from ..utils import device as device_mod
from ..utils import trace, tumio
from ..utils.timer import Timer


def build_parser():
    p = argparse.ArgumentParser(
        "scan3d", description="3D scanning from depth (gradient-SDF, PyTorch)"
    )
    p.add_argument("--input", required=True, help="path to input data")
    p.add_argument("--results", default="./", help="folder to store results")
    p.add_argument("--pose-file", dest="pose_file", default="pose.txt",
                   help="GT trajectory file relative to --input; if it loads, "
                        "tracking is bypassed (fusion-only)")
    p.add_argument("--first", type=int, default=0, help="first frame index")
    p.add_argument("--last", type=int, default=-1, help="last frame index (inclusive)")
    p.add_argument("--scan-type", dest="scan_type", default="grad-sdf",
                   choices=["grad-sdf", "base-sdf"])
    p.add_argument("--data-type", dest="data_type", default="tum",
                   choices=["tum", "synth", "printed", "rw", "redwood"])
    p.add_argument("--voxel-size", dest="voxel_size", type=float, default=0.01)
    p.add_argument("--trunc", type=float, default=5.0,
                   help="truncation distance in multiples of voxel size")
    p.add_argument("--zmax", type=float, default=3.5, help="maximum depth")
    p.add_argument("--sampling", type=int, default=0,
                   help="tracking pixel stride; 0 = dense (1), the reference "
                        "optimize() default")
    p.add_argument("--fusion-stride", dest="fusion_stride", type=int,
                   default=1,
                   help="integrate every s-th pixel's ray walk (1 = every "
                        "pixel like the reference)")
    p.add_argument("--fast", action="store_true",
                   help="preset (non-parity): stride-2 fusion + stride-3 "
                        "tracking with a 2e-3 convergence gate, at VGA+ "
                        "only; explicit --sampling/--fusion-stride win")
    p.add_argument("--eval-gt", dest="eval_gt", default="groundtruth.txt",
                   help="TUM-format GT trajectory (relative to --input) used "
                        "only for ATE evaluation; ignored if absent")
    p.add_argument("--save-sdf", dest="save_sdf", action="store_true")
    p.add_argument("--metrics-json", default=None,
                   help="optional path for per-run structured metrics, with "
                        "each frame's program spans, host reads and kernel "
                        "launches")
    p.add_argument("--checkpoint-every", dest="checkpoint_every", type=int,
                   default=0, help="checkpoint every N integrated frames (0=off)")
    p.add_argument("--resume", default=None, help="checkpoint .npz to resume from")
    p.add_argument("--profile", default=None,
                   help="directory for a torch.profiler Chrome trace of the "
                        "third processed frame, its host time named by the "
                        "program's gsdf.* spans")
    p.add_argument("--sync-growth-checks", dest="lagged_flags",
                   action="store_false",
                   help="no-op: the loop always resolves each frame's flags "
                        "before the next frame")
    p.add_argument("--warm-start", dest="warm_alpha", nargs="?",
                   const=0.5, type=float, default=None,
                   help="constant-velocity tracking warm start: GN starts "
                        "from T_prev * exp(ALPHA * log(delta_prev)); bare "
                        "flag = 0.5. Default: off (reference init)")
    p.add_argument("--no-warm-start", dest="no_warm", action="store_true",
                   help="force the warm start off")
    p.add_argument("--cosine-fusion", dest="cosine_fusion",
                   action="store_true",
                   help="scale fused sample distances by the incidence "
                        "cosine (point-to-plane TSDF; non-parity)")
    p.add_argument("--devices", type=int, default=0,
                   help="run on a (rays x blocks) mesh of N ranks "
                        "(torch.distributed): tracking residuals split over "
                        "rays, the volume's per-voxel storage over blocks "
                        "(1/D_b per rank). grad-sdf only. 0/1 = one device")
    p.add_argument("--block-parallel", dest="block_parallel", type=int,
                   default=0,
                   help="ranks on the block (grid-storage) axis; must divide "
                        "--devices. 0 = auto (2 when --devices is even, "
                        "else 1); the rest go to the ray axis")
    p.add_argument("--merged-step", dest="merged_step", action="store_true",
                   help="no-op: tracking and fusion already run back to "
                        "back with identical semantics")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; the run "
                        "fails rather than fall back if it is missing)")
    return p


def _device(name: str) -> torch.device:
    return device_mod.require(name)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_scan(args, *, check_replicated: bool = False) -> dict:
    """Run Scan3D; returns the metrics (rank 0's on a mesh).
    `check_replicated` (mesh runs) holds the ranks' replicated state equal
    after every frame (`sharding.check_replicated`); the tests and the
    card's smoke use it."""
    if args.devices <= 1:
        return _run(args, None, check_replicated)
    if args.scan_type != "grad-sdf":
        raise SystemExit("--devices requires --scan-type grad-sdf "
                         "(sharded tracking is the gradient path)")
    bp = args.block_parallel or (2 if args.devices % 2 == 0 else 1)
    if args.devices % bp:
        raise SystemExit(f"--block-parallel {bp} does not divide --devices "
                         f"{args.devices}")
    from ..parallel import distributed
    from ..parallel import mesh as mesh_mod

    if mesh_mod.in_group():
        return _run(args, bp, check_replicated)
    if distributed.init(device=args.device):
        try:
            return _run(args, bp, check_replicated)
        finally:
            torch.distributed.destroy_process_group()
    return mesh_mod.launch(_run, args.devices, args, bp, check_replicated,
                           device=args.device)


def _run(args, block_parallel, check_replicated) -> dict:
    """The frame loop, on one device (`block_parallel` None) or as one rank
    of a mesh of `args.devices` ranks."""
    mesh = None
    if block_parallel is not None:
        import contextlib

        from ..parallel import mesh as mesh_mod

        mesh = mesh_mod.make_mesh(args.devices, block_parallel, args.device)
        if mesh.rank != 0:   # one rank speaks
            with open(os.devnull, "w") as quiet, \
                    contextlib.redirect_stdout(quiet):
                return _loop(args, mesh, check_replicated)
    return _loop(args, mesh, check_replicated)


def _loop(args, mesh, check_replicated) -> dict:
    """`_scan`, traced where the run reports its frames (`frame_log` in
    `--metrics-json`, the Chrome trace of `--profile`)."""
    with trace.tracing(bool(args.metrics_json or args.profile)):
        return _scan(args, mesh, check_replicated)


# a frame_log entry's keys for the program's spans (`utils/trace`)
SPAN_KEYS = {"gsdf.track.launch": "track_launch_ms",
             "gsdf.track.read": "track_read_ms",
             "gsdf.fuse.launch": "fuse_launch_ms",
             "gsdf.fuse.read": "fuse_read_ms"}


def _scan(args, mesh, check_replicated) -> dict:
    if mesh is not None:
        from ..parallel import mesh as mesh_mod
        from ..parallel import sharding

        dev = mesh.device
        launches0 = trace.launches()
        coll0 = (mesh_mod.calls, mesh_mod.nbytes)
    else:
        dev = _device(args.device)
    writes = mesh is None or mesh.rank == 0
    T = Timer()
    cfg = cfg_mod.preset(args.data_type)
    fusion_stride = max(1, args.fusion_stride)
    # --fast's stride-2 fusion engages at the first frame, VGA+ only;
    # explicit --fusion-stride wins
    fast_fusion = args.fast and fusion_stride == 1
    cfg = dataclasses.replace(
        cfg,
        grid=dataclasses.replace(cfg.grid, voxel_size=args.voxel_size),
        fusion=dataclasses.replace(
            cfg.fusion, trunc_voxels=args.trunc, z_max=args.zmax,
            fusion_stride=fusion_stride,
            cosine_correction=args.cosine_fusion,
        ),
        parallel=dataclasses.replace(
            cfg.parallel, num_devices=mesh.size if mesh is not None else None),
    )

    loader = loaders.make_loader(args.data_type, args.input)
    K = loader.load_intrinsics("intrinsics.txt")
    if K is None:
        raise SystemExit(f"No intrinsics file found in {args.input}!")
    print("K:\n", K)

    gt = loader.load_poses(args.pose_file)
    gt_mode = gt is not None
    if gt_mode:
        print(f"{len(gt)} GT poses are loaded!")
    else:
        print("No GT poses are available!")

    if args.scan_type == "grad-sdf":
        sdf_map = GradSdfMap(cfg, device=dev)
        track_mode = "grad"
    else:
        sdf_map = PixelSdfMap(cfg, device=dev)
        track_mode = "trilinear"
    os.makedirs(args.results, exist_ok=True)
    pose_path = os.path.join(args.results, "_poses.txt")
    pose_entries = []

    def on_dev(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    R_cur, t_cur = on_dev(np.eye(3)), on_dev(np.zeros(3))
    # pose one frame older than (R_cur, t_cur), for the warm start
    R_pp, t_pp = R_cur, t_cur
    warm_alpha = 0.0 if args.no_warm else float(args.warm_alpha or 0.0)
    invalid_frames = []
    # per frame: host timings (track_frame and update each end in a read
    # that waits for the device), GN iterations, and the program's spans,
    # reads and kernel launches (`SPAN_KEYS`; None where not traced)
    frame_log = []
    last = None if args.last < 0 else args.last + 1
    tracker_set = False
    n_frames = 0

    first = args.first
    resumed = False
    if args.resume:
        state = ckpt.load_state(args.resume, dev)
        gc = state["grid_cfg"]
        # the checkpoint's (possibly grown) geometry and voxel size win over
        # the command line's; legacy files lack the voxel size
        if math.isnan(gc.voxel_size):
            gc = dataclasses.replace(gc, voxel_size=cfg.grid.voxel_size)
        cfg = dataclasses.replace(cfg, grid=gc)
        sdf_map.restore(state["grid"], gc, vis=state["vis"],
                        counter=state["counter"])
        resumed = state["counter"] > 0
        pose_entries.extend(state["poses"])
        if state["poses"]:
            R_cur, t_cur = (on_dev(a) for a in state["poses"][-1][1:])
            R_pp, t_pp = ((on_dev(a) for a in state["poses"][-2][1:])
                          if len(state["poses"]) >= 2 else (R_cur, t_cur))
        # poses are recorded per processed frame (fused or not): they, not
        # the fusion counter, say where to pick up
        first = args.first + (len(state["poses"]) or state["counter"])
        print(f"Resumed at frame {first} ({state['counter']} frames integrated)")
    if mesh is not None:
        # after a possible resume, so that the restored grid is sharded
        sdf_map.attach_mesh(mesh)
        print(f"Mesh: {mesh.describe()}")
    ckpt_path = os.path.join(args.results, "checkpoint.npz")

    t_loop = t_end = None   # asking for frame 1; the end of the last frame
    for frame, t_ask, t_got in loaders.timed(loader.frames(first, last)):
        load_ms = T.record("Load data", t_got - t_ask) * 1e3
        if n_frames == 1:
            t_loop = t_ask
        i = frame.index
        if not tracker_set:
            # dense tracking by default (sampling=1, the reference optimize()
            # default); --fast uses stride 3 and a 2e-3 gate at VGA+
            fast_ok = args.fast and frame.depth.shape[1] >= 640
            s = args.sampling or (3 if fast_ok else 1)
            conv = (2e-3 if (fast_ok and not args.sampling)
                    else cfg.tracker.conv_threshold)
            cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(
                cfg.tracker, sampling=s, conv_threshold=conv))
            if fast_fusion and frame.depth.shape[1] >= 640:
                new_f = dataclasses.replace(sdf_map.cfg.fusion, fusion_stride=2)
                cfg = dataclasses.replace(cfg, fusion=new_f)
                sdf_map.cfg = dataclasses.replace(sdf_map.cfg, fusion=new_f)
            tracker_set = True
        print(f"Working on frame: {i}")
        # the third processed frame is traced: lazy initialisation is behind it
        prof = None
        if args.profile and n_frames == 2:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        trace.take()   # what lies between frames is no frame's
        launched0 = trace.launches()
        t_frame = time.perf_counter()
        if mesh is not None:
            coll_frame = (mesh_mod.calls, mesh_mod.nbytes)
        with trace.span("gsdf.frame.upload"):
            depth = on_dev(frame.depth)
        entry = {"frame": i, "load_ms": load_ms, "track_ms": None,
                 "fuse_ms": None, "gn_iters": None}
        fresh = i == first and not resumed   # the frame that starts the map
        if gt_mode or fresh:
            if gt_mode:
                # the first frame of a fresh run takes GT pose 0, as in the
                # JAX app
                g = gt[0] if fresh else gt[i]
                R_cur, t_cur = on_dev(g[1]), on_dev(g[2])
            T.tic()
            sdf_map.update(depth, K, (R_cur, t_cur))
            entry["fuse_ms"] = T.toc("Integrate depth data into Sdf") * 1e3
        else:
            T.tic()
            if warm_alpha > 0.0:
                R_init, t_init = tracker_mod.extrapolate_pose(
                    R_cur, t_cur, R_pp, t_pp, warm_alpha)
            else:
                R_init, t_init = R_cur, t_cur
            # grid/fusion config come from the map: growth changes them
            if mesh is not None:
                res = sharding.sharded_track_frame(
                    mesh, sdf_map.grid, depth, K, R_init, t_init,
                    sdf_map.cfg.grid, sdf_map.cfg.fusion, cfg.tracker,
                    compact=sdf_map.track_buffer(depth.shape,
                                                 cfg.tracker.sampling))
            else:
                res = tracker_mod.track_frame(
                    sdf_map.grid, depth, K, R_init, t_init,
                    sdf_map.cfg.grid, sdf_map.cfg.fusion, cfg.tracker,
                    mode=track_mode, compact=sdf_map.track_buffer(
                        depth.shape, cfg.tracker.sampling))
            entry["track_ms"] = T.toc("Point optimization") * 1e3
            entry["gn_iters"] = res.num_iters
            R_pp, t_pp = R_cur, t_cur
            R_cur, t_cur = res.R, res.t
            if res.converged:
                T.tic()
                sdf_map.update(depth, K, (R_cur, t_cur))
                entry["fuse_ms"] = T.toc("Integrate depth data into Sdf") * 1e3
            else:
                invalid_frames.append(i)
        entry["frame_ms"] = (time.perf_counter() - t_frame) * 1e3
        if mesh is not None:
            entry["collective_calls"] = mesh_mod.calls - coll_frame[0]
            entry["collective_bytes"] = mesh_mod.nbytes - coll_frame[1]
            if check_replicated:
                sharding.check_replicated(
                    mesh, sdf_map.grid, R_cur, t_cur,
                    flags=(i in invalid_frames, sdf_map.counter))
        frame_log.append(entry)
        with trace.span("gsdf.frame.pose_read"):
            pose_entries.append((frame.timestamp, R_cur.cpu().numpy(),
                                 t_cur.cpu().numpy()))
        trace.count("gsdf.reads", 2)
        rec = trace.take()
        for name, key in SPAN_KEYS.items():
            entry[key] = (rec.spans[name] * 1e3 if name in rec.spans
                          else None)
        entry["host_reads"] = rec.counters.get("gsdf.reads")
        for key in ("graph_captures", "graph_replays"):
            entry[key] = rec.counters.get(f"gsdf.fuse.{key}", 0)
        entry["launches"] = trace.launched(launched0)
        n_frames += 1
        if prof is not None:
            _sync(dev)
            prof.stop()
            os.makedirs(args.profile, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(args.profile, f"frame_{i}.trace.json"))
        k = args.checkpoint_every
        if k and sdf_map.counter % k == 0:
            ckpt.save_state(ckpt_path, sdf_map.grid, vis=sdf_map.vis,
                            counter=sdf_map.counter, poses=pose_entries,
                            grid_cfg=sdf_map.cfg.grid, mesh=mesh)
        t_end = time.perf_counter()

    if writes:
        tumio.write_trajectory(pose_path, pose_entries)

    prefix = os.path.join(args.results, "gradient_sdf")
    T.tic()
    if not sdf_map.extract_mesh(prefix + "_mesh_final.ply"):
        print("Could not save mesh!")
    T.toc("Save mesh to disk")
    if track_mode == "grad":   # the baseline map has no oriented cloud
        T.tic()
        sdf_map.extract_pc(prefix + "_cloud_final.ply")
        T.toc("Save point cloud to disk")
    if args.save_sdf:
        T.tic()
        sdf_map.save_sdf(prefix)
        T.toc("Save sdf txt files to disk")

    metrics = {
        "frames": n_frames,
        "invalid_frames": invalid_frames,
        "num_blocks_active": int(sdf_map.grid.num_active),
        "overflow": bool(sdf_map.grid.overflow),
        "growth_events": list(sdf_map.growth_events),
        "timers": T.summary(),
        "device": str(dev),
        "frame_log": frame_log,
        # frames after the first over the wall time from asking for frame 1
        # to the end of the last frame: load, track and fuse, as users pay
        "loop_fps": ((n_frames - 1) / (t_end - t_loop)
                     if t_loop is not None else None),
        "reader": _reader_stats(loader),
    }
    if mesh is not None:
        # kernel launches of this run, summed over the ranks
        names = sorted(launches0)
        now = trace.launches()
        counts = torch.tensor([now[k] - launches0[k] for k in names],
                              dtype=torch.int64, device=dev)
        counts = mesh_mod.psum(counts, mesh, count=False).tolist()
        metrics["mesh"] = {
            "devices": mesh.size, "rays": mesh.shape[0],
            "blocks": mesh.shape[1], "backend": mesh.backend,
            "ranks_per_card": mesh.ranks_per_card(),
            "kernel_launches": dict(zip(names, counts)),
            "collective_calls": mesh_mod.calls - coll0[0],
            "collective_bytes": mesh_mod.nbytes - coll0[1],
        }

    # ATE vs an evaluation-only GT trajectory (main_scan_3d.cpp:278-280)
    if not gt_mode and args.eval_gt:
        gt_eval = loader.load_poses(args.eval_gt)
        if gt_eval:
            from ..utils import ate as ate_mod

            est = [(ts, t) for ts, _, t in pose_entries]
            ref = [(ts, np.asarray(t)) for ts, _, t in gt_eval]
            res = ate_mod.evaluate_ate(est, ref)
            if res is not None:
                metrics["ate_rmse"] = float(res.rmse)
                metrics["ate_pairs"] = int(res.num_pairs)
                print(f"ATE RMSE vs {args.eval_gt}: {res.rmse:.4f} m "
                      f"({res.num_pairs} pairs)")
    if args.metrics_json and writes:
        with open(args.metrics_json, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics


def _reader_stats(loader) -> dict | None:
    """The decode-ahead reader's settings and peak of resident images."""
    r = loader.reader
    return None if r is None else {"n_threads": r.n_threads, "window": r.window,
                                   "peak_resident": r.peak_resident}


def main(argv=None, *, check_replicated: bool = False):
    # float32 throughout, as the JAX package (which pins Precision.HIGHEST)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = build_parser().parse_args(argv)
    return run_scan(args, check_replicated=check_replicated)


if __name__ == "__main__":
    main()
