#!/usr/bin/env python3
"""Card measurements of a replayed TUM folder, decoded ahead and synchronously (needs one CUDA card).

    python3 gradient_sdf_tpu_torch/tools/replay_bench.py [--parent DIR] [--frames 60]

Writes the noisy sequence of `chip_smoke.py` phase 14 (`make_synth`, 640x480
spheres seed 2 with Kinect noise over 120 degrees) as a TUM RGB-D folder whose
PNG rows cycle through filters 0-4 (`tum_replay_folder`, which phase 16
uses too), then runs `scan3d --data-type tum` on it on the card, decoding
ahead (the loaders' default: 2 threads, a window of 16 images) and
synchronously (`frames(n_threads=0)`), in turns: ahead, sync, sync, ahead,
all in one process per tree after a warm-up run. Per run: `load_ms`
median and p90 over frames 1-59, the `track_ms` and `fuse_ms` medians over
the same frames, and `loop_fps` (load included). The ahead/sync ratio of
the medians is what the decoding threads cost the frame loop (the GIL).

With `--parent DIR` (an earlier checkout whose loaders take `n_threads`),
that tree's process runs in turns with this tree's: parent, this, this,
parent. `--tree DIR FOLDER` is what the script passes to itself: it
imports the package from DIR and measures it alone on FOLDER.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
OWN_ROOT = os.path.dirname(os.path.dirname(HERE))
MODES = ("ahead", "sync", "sync", "ahead")
DEVICE = "cuda"


def log(msg):
    print(msg, flush=True)


def tum_replay_folder(src, dst):
    """A `make_synth` folder as a TUM RGB-D folder (`associated.txt`,
    `rgb/`, `depth/` at 5000 per metre, the stamps of `gt_poses.txt`),
    every PNG re-encoded with its rows cycling through filters 0-4, as a
    libpng-written TUM file is filtered. Returns the number of frames."""
    import numpy as np
    from gradient_sdf_tpu_torch.data import png
    from gradient_sdf_tpu_torch.utils import tumio

    gt = tumio.read_trajectory(os.path.join(src, "gt_poses.txt"))
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(dst, sub), exist_ok=True)
    lines = []
    for i, (ts, _, _) in enumerate(gt):
        rgb = png.read_png(os.path.join(src, "rgb", f"{i + 1:03d}.png"))
        mm = png.read_png(os.path.join(src, "depth", f"{i + 1:03d}.png"))
        if int(mm.max()) * 5 > 65535:
            raise ValueError(f"frame {i}: depth {mm.max()} mm overflows 16 bits at 5000/m")
        filters = np.arange(rgb.shape[0]) % 5
        png.write_png(os.path.join(dst, "rgb", f"{ts}.png"), rgb, filters=filters)
        png.write_png(os.path.join(dst, "depth", f"{ts}.png"),
                      (mm.astype(np.uint32) * 5).astype(np.uint16), filters=filters)
        lines.append(f"{ts} rgb/{ts}.png {ts} depth/{ts}.png\n")
    with open(os.path.join(dst, "associated.txt"), "w") as f:
        f.writelines(lines)
    for name in ("intrinsics.txt", "gt_poses.txt"):
        shutil.copy(os.path.join(src, name), os.path.join(dst, name))
    return len(gt)


def run_scan(folder, results, mode):
    """`scan3d --data-type tum` on the card over `folder`, decoding ahead or
    synchronously; returns its metrics."""
    import functools

    from gradient_sdf_tpu_torch.apps import scan3d
    from gradient_sdf_tpu_torch.data import loaders

    orig = loaders.ImageLoader.frames
    if mode == "sync":
        loaders.ImageLoader.frames = functools.partialmethod(orig, n_threads=0)
    path = os.path.join(results, "metrics.json")
    try:
        scan3d.main(["--input", folder, "--results", results, "--data-type", "tum",
                     "--voxel-size", "0.02", "--trunc", "5", "--device", DEVICE,
                     "--pose-file", "none", "--eval-gt", "gt_poses.txt",
                     "--metrics-json", path])
    finally:
        loaders.ImageLoader.frames = orig
    with open(path) as f:
        return json.load(f)


def summary(m):
    import numpy as np

    fl = m["frame_log"][1:]

    def med(key):
        xs = [e[key] for e in fl if e[key] is not None]
        return float(np.median(xs)) if xs else None

    loads = [e["load_ms"] for e in fl]
    return {"load_ms_median": float(np.median(loads)),
            "load_ms_p90": float(np.percentile(loads, 90)),
            "track_ms_median": med("track_ms"), "fuse_ms_median": med("fuse_ms"),
            "loop_fps": m["loop_fps"], "ate_rmse": m.get("ate_rmse"),
            "peak_resident": (m["reader"] or {}).get("peak_resident")}


def tree_runs(folder):
    """This process's package: a warm-up run, then MODES in turns."""
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        run_scan(folder, os.path.join(tmp, "warm"), "ahead")
        for k, mode in enumerate(MODES):
            out.append(dict(mode=mode, **summary(
                run_scan(folder, os.path.join(tmp, f"run{k}"), mode))))
    return out


def run_tree(root, folder):
    cmd = [sys.executable, os.path.abspath(__file__), "--tree", root, folder]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an earlier checkout to run in turns")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--tree", nargs=2, metavar=("DIR", "FOLDER"),
                    help="measure the package in DIR alone on FOLDER")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree[0] if args.tree else OWN_ROOT))
    import torch

    if not torch.cuda.is_available():
        print("replay_bench: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.tree:
        # the app's per-frame prints go to stderr; the last stdout line is ours
        real_stdout, sys.stdout = sys.stdout, sys.stderr
        runs = tree_runs(args.tree[1])
        sys.stdout = real_stdout
        print(json.dumps(runs), flush=True)
        return 0
    from gradient_sdf_tpu_torch.apps import make_synth

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    turns = [("this", OWN_ROOT)]
    if args.parent:
        turns = [("parent", args.parent), ("this", OWN_ROOT),
                 ("this", OWN_ROOT), ("parent", args.parent)]
    with tempfile.TemporaryDirectory() as tmp:
        src, folder = os.path.join(tmp, "noisy"), os.path.join(tmp, "tum")
        real_stdout, sys.stdout = sys.stdout, sys.stderr
        make_synth.main(["--out", src, "--frames", str(args.frames), "--seed", "2",
                         "--width", "640", "--height", "480", "--arc-deg", "120",
                         "--device", "cuda"])
        sys.stdout = real_stdout
        n = tum_replay_folder(src, folder)
        log(f"TUM replay folder: {n} frames 640x480, PNG rows cycling through "
            f"filters 0-4")
        for name, root in turns:
            runs = run_tree(root, folder)
            for k, r in enumerate(runs):
                log(f"tree {name} run {k} {r['mode']}: load_ms median "
                    f"{r['load_ms_median']:.3f} p90 {r['load_ms_p90']:.3f}; "
                    f"track_ms median {r['track_ms_median']:.2f}, fuse_ms median "
                    f"{r['fuse_ms_median']:.2f}; loop_fps {r['loop_fps']:.2f}; "
                    f"ATE {r['ate_rmse'] * 1e3:.3f} mm; peak resident "
                    f"{r['peak_resident']}")
            by = {m: [r for r in runs if r["mode"] == m] for m in ("ahead", "sync")}
            ratio = {key: (sum(r[key] for r in by["ahead"])
                           / sum(r[key] for r in by["sync"]))
                     for key in ("track_ms_median", "fuse_ms_median", "loop_fps")}
            log(f"tree {name}: ahead / sync, track_ms {ratio['track_ms_median']:.3f}, "
                f"fuse_ms {ratio['fuse_ms_median']:.3f}, loop_fps "
                f"{ratio['loop_fps']:.3f} [{smi}]")
    log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
