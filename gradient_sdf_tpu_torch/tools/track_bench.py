#!/usr/bin/env python3
"""Card measurements of GN tracking on the golden protocol (needs one CUDA
card).

    python3 gradient_sdf_tpu_torch/tools/track_bench.py [--parent DIR] [--shapes]

Golden frames 1-5 (640x480 spheres seed 2, 6 frames over a 4 degree arc,
2 cm voxels, trunc 5, app-default 16384-block grid; frame 0 fused at the
identity, each later frame tracked from the previous frame's pose and fused
at the kernel's pose, as Scan3D does). Per frame, in grad and in trilinear
mode, it holds the loop kernel `gn_track` to its plain version at every GN
iteration (`check_loop`): from each iteration's pose the one-pass launch
`gn_residual_reduce` (its count exactly; each of the 29 sums within 2^-18
of the sum of its terms' magnitudes: the residuals are the same bits, only
float32 summation orders differ, each within ~log2(N) 2^-24 of that
magnitude; two runs the same bits), the loop kernel for one iteration (its
E and count those sums', its pose and flags `gn_step`'s on them bit for
bit, and `gn_step_reference`'s: the flags exactly, R and t within
`step_tol`, from the float64 condition number of the system); then the
full loop run twice, each equal bit for bit to the chain of those
single-iteration runs. It holds the compaction kernel `track_compact` to
`compact_points` (count and points bit for bit). Then it tracks the frame
in turns through `track_frame` (the compaction and loop kernels, into the
map's buffer), the plain loop with the packed rows and the plain loop
without them (kernel, packed, unpacked, unpacked, packed, kernel):
track_ms, GN iterations (equal, except where the step that stops one loop
lies within a factor 2 of the stopping threshold), launches, `nonzero`
calls and host syncs of the kernels' path (one launch each, no `nonzero`,
the status's read alone), `launch_track` under PyTorch's sync debug mode
"error" (no sync, the same pose), and the poses' largest difference.
On frame 5 it holds `gn_step` to its plain version on crafted systems (a
normal step, zero residuals, a single plane, a NaN and an inf in g, a
rotation inside the Taylor branch), and times with CUDA events the loop
kernel per frame (from the frame's start pose; per iteration = per frame /
iterations) beside its floor (an empty kernel at its one-cluster launch),
its bound (bytes: the points, and each distinct 32-byte sector of the
directory and the fields that any iteration's residuals read, once;
operations: every iteration's pass at the issue rates of `raycast_bench`,
and its step) and its plain version; the one-pass launch and `gn_step`
beside theirs, and `torch.linalg.solve_ex` on the 6x6 alone; and the
compaction kernel beside its bound (4 B of depth a strided pixel, 12 B a
kept point), its plain version and `pts_cam[mask]` alone (the library
call: `nonzero` and the gather, with their host sync). A full frame
follows, tracked, held and timed the same way: the golden frames before a
backdrop (`FULL_BACKDROP`), all 307,200 pixels of frame 5 valid.

`chip_smoke.py` phase 4b runs `golden_phase` on the frames it rendered.

With `--parent DIR` (a checkout of an earlier commit, e.g. unpacked with
`git archive`) it then
  * tracks golden frames 1-5 and the full frame through `track_frame` of
    each tree, each in a process of its own that imports that tree's
    package (`--tree DIR`), in the order parent, this, this, parent:
    track_ms per frame, and `gn_residual_reduce` and `gn_step` device ms on
    frame 5 and the full frame;
  * diagnoses the parent's residual kernel, where it is the two-kernel
    design's (`csrc/gn_track.cu` with a grid of 264 x 256 threads, one
    partial per CTA and an atomic ticket): its registers and spills
    (ptxas), CTAs per SM and waves of its grid, the empty kernel at its
    launch, and two cut-down instances built here from its source, timed
    on frame 5's points: the gather and residuals only, with no reduction,
    and the reduction only, over zeros;
  * runs the Scan3D app on the golden dataset once per tree, in the same
    order: track_ms and fuse_ms over frames 1-5, GN iterations and
    frames/s (`frame_ms`, the app's clock).
With `--shapes` it builds `csrc/gn_track.cu` at every cluster shape of 8
and 16 CTAs x 256, 512 and 1024 threads (a copy of the source with its two
constants changed, under `smoke_out/`), and once at its own shape with the
app's block shape sent to the instance that divides at run time, and times
each loop kernel per frame, its one-pass launch, its floor and an iteration
over no points on golden frame 5 and on the full frame.

    python3 gradient_sdf_tpu_torch/tools/track_bench.py --compact [DIR ...]

takes the compaction kernel of each tree DIR (this one if none) apart
instead (`compact_split`): one-switch builds of a copy of its
`csrc/track_compact.cu` (COMPACT_SWITCHES), timed on golden frame 5 beside
the unswitched kernels, then those in turns.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
OWN_ROOT = os.path.dirname(os.path.dirname(HERE))
WORK = os.path.join(OWN_ROOT, "smoke_out", "track_bench")

# the sums' tolerance, relative to the sum of their terms' magnitudes
SUM_REL_TOL = 2.0**-18
# one step, crafted systems: a well-conditioned 6x6 LU in another order
STEP_TOL = 2e-6
# the plain loop with and without packed rows: the same fields and the same
# operations, so at most a skipped stopping step apart (chip_smoke's
# PACK_POSE_TOL, the resume gate's floor)
PACK_POSE_TOL = 5e-4
# the kernel's path vs the plain loop: the residual sums are taken in
# another order, and p = R x + t is rounded elementwise where the plain loop
# takes a cuBLAS product, which moves points that lie within an ulp of a
# voxel plane into the neighbouring voxel. GN turns such differences into
# pose differences of the size of its 1e-3 stopping rule: chip_smoke's
# MESH_POSE_TOL, for the sharded pass's other order, and
# tests/test_app_sharded.py's bound
PATH_POSE_TOL = 3e-3
# two loops may stop one iteration apart where the step that stops one of
# them lies within this factor of the threshold (the other loop's step at
# that iteration differs by summation order and the path above)
ITER_EDGE_FACTOR = 2.0
CONV_SQ_CRAFTED = 1e-6
# operations per point, counted from csrc/gn_track.cu (a lower count: an IEEE
# division, a square root and an integer floor division are counted as one
# operation each, though each takes several instructions). Every point:
# float32 transform 18 and voxel index 6; int32 block coordinates 9, offsets
# 6, range checks 6, directory key 7, slot checks 3. A residual that reads
# its voxel: float32 weight test 1, norm 6, clamp 2, reciprocal and scale
# 2, centre offset 9, phi 7, J 3, cross 9, the 29 sums 57; int32 field
# index 3 and addresses 10.
F32_OPS_PER_POINT, INT_OPS_PER_POINT = 24, 31
F32_OPS_PER_RESIDUAL, INT_OPS_PER_RESIDUAL = 96, 13
# the step (`gn_solve_update`), one thread: LU and substitutions of a 6x6
# ~180, flags 19, se3_exp ~110, the pose update 72 (float32 operations)
STEP_OPS = 381
# the cluster shapes `--shapes` times
SHAPES = [(8, 256), (8, 512), (8, 1024), (16, 256), (16, 512), (16, 1024)]
# the full frame: the golden spheres (seed 2) before a backdrop, a sphere
# of radius 40 m whose near side stands 0.75 m behind the origin, so that
# all 640x480 pixels of the golden poses lie 1.34-3.2 m away; frames 0-4
# fused at their poses, frame 5 tracked from frame 4's
FULL_BACKDROP = ((-40.75, 0.0, 0.0), 40.0)


def log(msg):
    print(msg, flush=True)


def reduce_bytes_bound_ms(n_points: int, sectors: int) -> float:
    """Least time for the bytes the residual pass must move: each point
    (12 B) and the pose (48 B) read once, every distinct 32-byte sector of
    the directory and the fields that the residuals read, once, the 29 sums
    written."""
    from gradient_sdf_tpu_torch.tools.raycast_bench import MEM_BYTES_PER_S

    return (12 * n_points + 48 + 32 * sectors + 4 * 29) / MEM_BYTES_PER_S * 1e3


def reduce_ops_bound_ms(n_points: int, n_residuals: int) -> float:
    """Least time for the residual pass's operations at the issue rates of
    `raycast_bench.march_ops_bound_ms`."""
    from gradient_sdf_tpu_torch.tools.raycast_bench import (F32_OPS_PER_S,
                                                            INT_OPS_PER_S)

    f32 = n_points * F32_OPS_PER_POINT + n_residuals * F32_OPS_PER_RESIDUAL
    ints = n_points * INT_OPS_PER_POINT + n_residuals * INT_OPS_PER_RESIDUAL
    return max((f32 + ints) / F32_OPS_PER_S, ints / INT_OPS_PER_S) * 1e3


def step_bound_ms() -> float:
    """Least time for gn_step's work: its bytes (the sums, the pose read and
    written, the status) or its operations, the larger."""
    from gradient_sdf_tpu_torch.tools.raycast_bench import (F32_OPS_PER_S,
                                                            MEM_BYTES_PER_S)

    return max((4 * 29 + 2 * 48 + 16) / MEM_BYTES_PER_S,
               STEP_OPS / F32_OPS_PER_S) * 1e3


def sector_ids(pts, R, t, grid, gcfg):
    """The distinct 32-byte sectors the grad-mode pass reads at (R, t),
    from the plain version's indices: (directory sectors at every in-range
    key, weight sectors at every voxel of an allocated block, sectors of
    `dist` and the three gradient fields at every voxel with weight > 0),
    each a 1-D tensor of sector indices."""
    import torch
    from gradient_sdf_tpu_torch.ops import voxel_grid as vg
    from gradient_sdf_tpu_torch.ops.kernels import gn_track as gt

    p = gt.transform_points(pts, R, t)
    vi = torch.round(gt._divide(p, gcfg.voxel_size)).to(torch.int32)
    block, _ = vg.voxel_to_block(vi, gcfg)
    key = vg.pack_key(block, gcfg)
    row, found = gt.voxel_rows(grid, vi, gcfg, 0, grid.dist.shape[0])
    observed = found & (vg.flat_field(grid.weight)[row] > 0.0)

    def sectors(idx):
        return torch.unique(torch.div(idx, 8, rounding_mode="floor"))

    return (sectors(key[key >= 0]), sectors(row[found]),
            sectors(row[observed]))


def count_sectors(ids) -> int:
    """Sectors of `sector_ids` (the four fields read at observed voxels)."""
    return int(ids[0].numel() + ids[1].numel() + 4 * ids[2].numel())


def touched_sectors(pts, R, t, grid, gcfg) -> int:
    """Distinct 32-byte sectors the grad-mode pass reads at (R, t)."""
    return count_sectors(sector_ids(pts, R, t, grid, gcfg))


def loop_bound(pts, grid, gcfg, poses, residuals) -> dict:
    """The loop kernel's bound over a frame whose iterations started at
    `poses` with `residuals` counted: bytes, each point and every distinct
    sector any iteration reads once, the pose read and written, the status
    written; operations, every iteration's pass and step. Beside it the
    sum over the iterations of one pass's bound and the step's."""
    import torch

    from gradient_sdf_tpu_torch.tools.raycast_bench import (F32_OPS_PER_S,
                                                            INT_OPS_PER_S,
                                                            MEM_BYTES_PER_S)

    ids = [sector_ids(pts, R, t, grid, gcfg) for R, t in poses]
    union = [torch.unique(torch.cat([x[k] for x in ids])) for k in range(3)]
    n = pts.shape[0]
    bytes_ms = ((12 * n + 2 * 48 + 4 * 5 + 32 * count_sectors(union))
                / MEM_BYTES_PER_S * 1e3)
    f32 = sum(n * F32_OPS_PER_POINT + r * F32_OPS_PER_RESIDUAL
              for r in residuals) + STEP_OPS * len(poses)
    ints = sum(n * INT_OPS_PER_POINT + r * INT_OPS_PER_RESIDUAL
               for r in residuals)
    ops_ms = max((f32 + ints) / F32_OPS_PER_S, ints / INT_OPS_PER_S) * 1e3
    per_pass = sum(max(reduce_bytes_bound_ms(n, count_sectors(x)),
                       reduce_ops_bound_ms(n, r)) + step_bound_ms()
                   for x, r in zip(ids, residuals))
    return {"bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "sectors": count_sectors(union), "per_pass_sum_ms": per_pass}


def crafted_systems():
    """(name, H, g) float32: a normal step, zero residuals, a single plane
    (J = [n, p x n], n = z: H of rank 3), a NaN and an inf in g, and a step
    whose rotation lies inside the theta^2 < 1e-8 Taylor branch."""
    import numpy as np

    rng = np.random.default_rng(9)
    J = rng.standard_normal((400, 6)).astype(np.float32)
    Hn = (J.T @ J).astype(np.float32)
    xi = np.array([0.02, -0.01, 0.015, 0.01, -0.02, 0.005], np.float32)
    p = np.concatenate([rng.uniform(-1, 1, (300, 2)), np.ones((300, 1))], 1)
    nrm = np.array([0.0, 0.0, 1.0])
    Jp = np.concatenate([np.tile(nrm, (300, 1)), np.cross(p, nrm)], 1)
    g_nan = (Hn @ xi).astype(np.float32)
    g_nan[2] = np.nan
    g_inf = (Hn @ xi).astype(np.float32)
    g_inf[4] = np.inf
    xi_t = np.array([0.03, -0.02, 0.01, 4e-5, -3e-5, 5e-5], np.float32)
    return [("normal", Hn, (Hn @ xi).astype(np.float32)),
            ("zero", np.zeros((6, 6), np.float32), np.zeros(6, np.float32)),
            ("plane", (Jp.T @ Jp).astype(np.float32),
             (Jp.T @ rng.standard_normal(300) * 0.01).astype(np.float32)),
            ("nan", Hn, g_nan), ("inf", Hn, g_inf),
            ("taylor", Hn, (Hn @ xi_t).astype(np.float32))]


def sums_of_system(H, g, dev, E=2.5, n=1234.0):
    import numpy as np
    import torch
    from gradient_sdf_tpu_torch.ops.kernels import gn_track as gt

    a = [i for i, _ in gt.TRIU]
    b = [j for _, j in gt.TRIU]
    return torch.as_tensor(np.concatenate([[E], g, H[a, b], [n]]).astype(
        np.float32), device=dev)


def step_tol(sums, damping) -> tuple:
    """(pose tolerance, xi in float64) for one step from `sums`: two
    backward-stable float32 LUs of
    the same 6x6 system differ by up to ~2 n cond(A) 2^-24 |xi|, plus the
    pose update's own rounding (1e-6)."""
    import numpy as np
    from gradient_sdf_tpu_torch.ops.kernels import gn_track as gt

    _, g, H, _ = (np.asarray(a.cpu(), np.float64) for a in gt.system_of_sums(sums))
    A = H + 1e-12 * np.eye(6)
    xi = damping * np.linalg.solve(A, g)
    return 1e-6 + 12 * np.linalg.cond(A) * 2.0**-24 * np.abs(xi).max(), xi


def check_loop(grid, pts, R0, t0, gcfg, fcfg, tcfg, mode="grad"):
    """The loop kernel held to its plain version at every iteration from
    (R0, t0), and its full run to the chain of its single-iteration runs
    (module note). Returns (stats, R, t); raises on a mismatch."""
    import torch
    from gradient_sdf_tpu_torch.ops.kernels import gn_track as gt

    conv_sq = tcfg.conv_threshold * tcfg.conv_threshold
    kw = dict(mode=mode, damping=tcfg.damping, conv_sq=conv_sq)
    R, t = R0.clone(), t0.clone()
    st = {"iters": 0, "sum_err": 0.0, "sum_rel": 0.0, "step_err": 0.0,
          "step_tol": 0.0, "count": 0, "first_sums": None, "flag_edge": 0,
          "poses": [], "counts": [], "xi_sq": []}
    status4 = torch.zeros(4, dtype=torch.float32, device=pts.device)
    for it in range(tcfg.num_iterations):
        st["poses"].append((R.clone(), t.clone()))
        a = gt.gn_residual_reduce(pts, R, t, grid, gcfg, fcfg, mode=mode)
        b = gt.gn_residual_reduce(pts, R, t, grid, gcfg, fcfg, mode=mode)
        phi, J, valid = gt.gn_residual_terms(pts, R, t, grid, gcfg, fcfg,
                                             mode=mode)
        want = gt.sums_of_terms(phi, J, valid)
        scale = gt.sums_of_terms(phi.abs(), J.abs(), valid)
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"{mode} iteration {it}: two one-pass runs "
                                 f"differ: {a} / {b}")
        if float(a[-1]) != float(want[-1]):
            raise AssertionError(f"{mode} iteration {it}: count {float(a[-1])} "
                                 f"vs plain {float(want[-1])}")
        err = (a - want).abs()
        if not bool((err <= SUM_REL_TOL * scale).all()):
            raise AssertionError(f"{mode} iteration {it}: sums {a.tolist()} vs "
                                 f"plain {want.tolist()} (terms' magnitudes "
                                 f"{scale.tolist()})")
        st["sum_err"] = max(st["sum_err"], float(err.max()))
        st["sum_rel"] = max(st["sum_rel"], float((err / scale.clamp(
            min=1e-30)).max()))
        st["count"] = int(a[-1])
        st["counts"].append(int(a[-1]))
        if it == 0:
            st["first_sums"] = a.clone()
        Rp, tp, small, bad = gt.gn_step_reference(a, R, t, tcfg.damping, conv_sq)
        tol, xi64 = step_tol(a, tcfg.damping)
        st["xi_sq"].append(float((xi64 ** 2).sum()))
        # the loop kernel, one iteration from this pose; the step kernel on
        # the one-pass sums runs the same device function
        Rk, tk = R.clone(), t.clone()
        s = gt.gn_track(pts, Rk, tk, grid, gcfg, fcfg, num_iterations=1,
                        **kw).tolist()
        Rs, ts = R.clone(), t.clone()
        gt.gn_step(a, Rs, ts, status4, damping=tcfg.damping, conv_sq=conv_sq)
        if not (s[:4] == status4.tolist() and s[4] == 1.0
                and torch.equal(Rk, Rs) and torch.equal(tk, ts)):
            raise AssertionError(
                f"{mode} iteration {it}: the loop kernel's iteration {s} is not "
                f"the one-pass sums and gn_step's step {status4.tolist()}")
        flags, pflags = (s[0] != 0.0, s[1] != 0.0), (bool(small), bool(bad))
        edge = abs(st["xi_sq"][-1] - conv_sq) <= 1e-3 * conv_sq
        if flags != pflags and not edge:
            raise AssertionError(f"{mode} iteration {it}: flags {flags} vs "
                                 f"plain {pflags}")
        st["flag_edge"] += int(flags != pflags)
        d = max(float((Rk - Rp).abs().max()), float((tk - tp).abs().max()))
        if flags == pflags and not d <= tol:
            raise AssertionError(f"{mode} iteration {it}: the step differs "
                                 f"from plain by {d} (tolerance {tol})")
        st["step_err"] = max(st["step_err"], d)
        st["step_tol"] = max(st["step_tol"], tol)
        st["iters"] = it + 1
        R, t = Rk, tk
        if flags[0]:
            break
    # the full loop, twice: the chain above, bit for bit
    for run in range(2):
        Rf, tf = R0.clone(), t0.clone()
        sf = gt.gn_track(pts, Rf, tf, grid, gcfg, fcfg,
                         num_iterations=tcfg.num_iterations, **kw).tolist()
        if not (torch.equal(Rf, R) and torch.equal(tf, t)
                and sf == s[:4] + [float(st["iters"])]):
            raise AssertionError(
                f"{mode}: full loop run {run} {sf} differs from the chain of "
                f"single iterations {s[:4]}, {st['iters']} iterations")
    return st, R, t


def check_crafted(dev, R0, t0):
    """gn_step vs its plain version on `crafted_systems`: flags exactly, the
    pose within STEP_TOL (bit for bit where the step is skipped)."""
    import torch
    from gradient_sdf_tpu_torch.ops.kernels import gn_track as gt

    worst = 0.0
    seen = []
    for name, H, g in crafted_systems():
        sums = sums_of_system(H, g, dev)
        R, t = R0.clone(), t0.clone()
        status = torch.zeros(4, dtype=torch.float32, device=dev)
        gt.gn_step(sums, R, t, status, damping=1.0, conv_sq=CONV_SQ_CRAFTED)
        Rp, tp, small, bad = gt.gn_step_reference(sums, R0, t0, 1.0,
                                                  CONV_SQ_CRAFTED)
        s = status.tolist()
        flags = (s[0] != 0.0, s[1] != 0.0)
        if flags != (bool(small), bool(bad)):
            raise AssertionError(f"crafted {name}: gn_step flags {flags} vs "
                                 f"plain {(bool(small), bool(bad))}")
        d = max(float((R - Rp).abs().max()), float((t - tp).abs().max()))
        skipped = flags[0] or flags[1]
        if skipped and not (torch.equal(R, R0) and torch.equal(t, t0)
                            and torch.equal(Rp, R0) and torch.equal(tp, t0)):
            raise AssertionError(f"crafted {name}: a skipped step moved the pose")
        if not d <= STEP_TOL:
            raise AssertionError(f"crafted {name}: pose differs by {d}")
        worst = max(worst, d)
        seen.append(f"{name} (small {int(flags[0])}, bad {int(flags[1])})")
    return worst, seen


def count_syncs(fn):
    """(fn's result, [(file, line, in_port)] of each host sync it made),
    from PyTorch's sync debug mode, which warns at every synchronizing CUDA
    call; each sync is placed at the innermost line of the port's package
    (outside `tools/`) on the stack at the warning (`in_port`), else at the
    innermost line."""
    import traceback

    import torch

    own = os.sep + "gradient_sdf_tpu_torch" + os.sep
    hits = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if os.path.basename(f.filename) != "warnings.py"]
        mine = [f for f in stack if own in f.filename
                and own + "tools" + os.sep not in f.filename]
        f = mine[-1] if mine else stack[-1]
        hits.append((f.filename, f.lineno, bool(mine)))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        hits.clear()   # a sync inside the switch itself is not fn's
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, hits


def _lines(fn):
    import inspect

    src, first = inspect.getsourcelines(fn)
    return inspect.getsourcefile(fn), range(first, first + len(src))


def count_kernel_path(grid, depth, K, R, t, gcfg, fcfg, tcfg, compact=None):
    """`track_frame` on the card (untimed, after one uncounted call), with
    its launches, `nonzero` calls (the profiler), `_pack_fields` calls and
    host syncs counted: those at a line of `track_compact.compact` (the
    plain compaction), of `tracker.launch_track` (the compaction kernel and
    the loop kernel), of the rest of `tracker.track_frame` (the status
    read), at another line of the port and with no line of the port on the
    stack (`count_syncs`). Returns (result, counts)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gradient_sdf_tpu_torch.models import tracker
    from gradient_sdf_tpu_torch.ops.kernels import gn_track as gt
    from gradient_sdf_tpu_torch.ops.kernels import track_compact as tc
    from gradient_sdf_tpu_torch.tools.fusion_bench import nonzero_calls

    packs = []
    real = tracker._pack_fields

    def counting(g):
        packs.append(1)
        return real(g)

    tracker._pack_fields = counting
    gt.reset_launch_count()
    tc.reset_launch_count()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            res, syncs = count_syncs(lambda: tracker.track_frame(
                grid, depth, K, R, t, gcfg, fcfg, tcfg, compact=compact))
    finally:
        tracker._pack_fields = real
    where = {"compaction": _lines(tc.compact),
             "launch": _lines(tracker.launch_track),
             "status": _lines(tracker.track_frame)}
    port = [(f, l) for f, l, mine in syncs if mine]
    n = {k: sum(f == file and l in lines for f, l in port)
         for k, (file, lines) in where.items()}
    other = sorted({f"{os.path.basename(f)}:{line}" for f, line in port
                    if not any(f == file and line in lines
                               for file, lines in where.values())})
    outside = sorted({f"{f}:{line}" for f, line, mine in syncs if not mine})
    return res, {"compact": tc.launch_count, "loop": gt.loop_launch_count,
                 "reduce": gt.launch_count,
                 "step": gt.step_launch_count, "packs": len(packs),
                 "nonzero": nonzero_calls(prof),
                 "status_syncs": n["status"],
                 "compaction_syncs": n["compaction"] + n["launch"],
                 "other_syncs": len(port) - sum(n.values()),
                 "other_where": other,
                 "outside_syncs": len(syncs) - len(port),
                 "outside_where": outside}


def timed(fn):
    """(fn(), host-clock ms around it, device-synchronized)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def event_ms(fn, reset=None, reps=20):
    """Device time of one `fn()` in ms: the median over `reps` launches of
    the CUDA-event time around each, all enqueued behind a few ms of
    device-side spinning so that the events bracket device work. `reset()`
    runs before each launch, outside the events (for a kernel that updates
    its inputs in place)."""
    import torch

    if reset:
        reset()
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(5_000_000)
    for start, end in ev:
        if reset:
            reset()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in ev)
    return times[len(times) // 2]


def loop_times(lib, grid, pts, R0, t0, gcfg, fcfg, tcfg, mode="grad"):
    """The loop kernel of `lib` from (R0, t0) on one frame: (device ms per
    frame, iterations, one-pass launch ms, empty one-cluster kernel ms,
    ms per iteration of the loop over no points: what an iteration costs
    besides its residuals, i.e. the reductions, the cluster barriers and
    the step, run for all `num_iterations` with conv_sq = 0)."""
    import torch
    from gradient_sdf_tpu_torch.ops.kernels import gn_track as gt

    dev = pts.device
    R, t = R0.clone(), t0.clone()
    status = torch.zeros(gt.STATUS, dtype=torch.float32, device=dev)
    sums = torch.zeros(gt.SUMS, dtype=torch.float32, device=dev)
    kw = dict(mode=mode, slot_lo=0, slot_hi=grid.dist.shape[0])
    conv_sq = tcfg.conv_threshold ** 2

    def reset():
        R.copy_(R0)
        t.copy_(t0)

    frame_ms = event_ms(lambda: gt.launch_loop(
        lib, pts, R, t, grid, gcfg, fcfg, num_iterations=tcfg.num_iterations,
        do_step=True, damping=tcfg.damping, conv_sq=conv_sq, status=status,
        sums=None, **kw), reset)
    iters = int(status[4])
    pass_ms = event_ms(lambda: gt.launch_loop(
        lib, pts, R0, t0, grid, gcfg, fcfg, num_iterations=1, do_step=False,
        damping=0.0, conv_sq=0.0, status=None, sums=sums, **kw))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def empty():
        if lib.gsdf_gn_cluster_empty(stream) != 0:
            raise AssertionError("the empty cluster kernel did not launch")

    fixed_ms = event_ms(lambda: gt.launch_loop(
        lib, pts[:0], R, t, grid, gcfg, fcfg,
        num_iterations=tcfg.num_iterations, do_step=True, damping=tcfg.damping,
        conv_sq=0.0, status=status, sums=None, **kw), reset)
    if int(status[4]) != tcfg.num_iterations:
        raise AssertionError(f"the loop over no points ran {int(status[4])} "
                             f"iterations")
    fixed_ms = (fixed_ms - event_ms(empty)) / tcfg.num_iterations
    return frame_ms, iters, pass_ms, event_ms(empty), fixed_ms


def time_frame(grid, pts, R0, t0, gcfg, fcfg, tcfg, st, smi, what):
    """The loop kernel, its one-pass launch and the step on one frame from
    its start pose (R0, t0), beside floors, bounds, plain versions and
    `solve_ex` (module note); `st`: `check_loop`'s stats from that pose."""
    import torch
    from gradient_sdf_tpu_torch.ops.kernels import _build
    from gradient_sdf_tpu_torch.ops.kernels import gn_track as gt
    from gradient_sdf_tpu_torch.tools.fusion_bench import median_ms

    dev = pts.device
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    conv_sq = tcfg.conv_threshold ** 2
    frame_ms, iters, pass_ms, floor_ms, fixed_ms = loop_times(
        lib, grid, pts, R0, t0, gcfg, fcfg, tcfg)
    if iters != st["iters"]:
        raise AssertionError(f"{what}: the timed loop ran {iters} iterations, "
                             f"the checked one {st['iters']}")
    bound = loop_bound(pts, grid, gcfg, st["poses"], st["counts"])
    sums = st["first_sums"]
    Rs, ts = R0.clone(), t0.clone()
    status = torch.zeros(4, dtype=torch.float32, device=dev)
    _, g6, H6, _ = gt.system_of_sums(sums)
    A6 = H6 + 1e-12 * torch.eye(6, device=dev)

    def empty(blocks, threads):
        if lib.gsdf_empty_launch(blocks, threads, stream) != 0:
            raise AssertionError("the empty kernel did not launch")

    n, nres = pts.shape[0], st["counts"][0]
    sectors = touched_sectors(pts, R0, t0, grid, gcfg)
    out = {
        "points": n, "iterations": iters, "loop_ms": frame_ms,
        "loop_ms_per_iteration": frame_ms / iters, "floor_ms": floor_ms,
        "fixed_ms_per_iteration": fixed_ms,
        "loop_plain_ms": median_ms(lambda: gt.gn_track_reference(
            pts, R0, t0, grid, gcfg, fcfg, num_iterations=tcfg.num_iterations,
            damping=tcfg.damping, conv_sq=conv_sq), reps=3, batches=3),
        "loop_bound": bound, "pass_ms": pass_ms,
        "pass_plain_ms": median_ms(lambda: gt.gn_residual_reduce_reference(
            pts, R0, t0, grid, gcfg, fcfg), reps=5, batches=3),
        "pass_bytes_ms": reduce_bytes_bound_ms(n, sectors),
        "pass_ops_ms": reduce_ops_bound_ms(n, nres),
        "step_ms": median_ms(lambda: gt.gn_step(
            sums, Rs, ts, status, damping=tcfg.damping, conv_sq=conv_sq)),
        "step_plain_ms": median_ms(lambda: gt.gn_step_reference(
            sums, R0, t0, tcfg.damping, conv_sq)),
        "solve_ex_ms": median_ms(lambda: torch.linalg.solve_ex(A6, g6)),
        "step_floor_ms": median_ms(lambda: empty(1, 32)),
        "step_bound_ms": step_bound_ms(), "residuals": nres,
        "sectors": sectors}
    out["pass_bound_ms"] = max(out["pass_bytes_ms"], out["pass_ops_ms"])
    out["pass_bound_by"] = ("bytes" if out["pass_bytes_ms"]
                            >= out["pass_ops_ms"] else "operations")
    shape = gt.cluster_shape()
    log(f"phase4b {what} ({n} points, {nres} residuals at the start pose, "
        f"{iters} GN iterations): gn_track_loop {frame_ms:.4f} ms a frame, "
        f"{frame_ms / iters:.4f} ms an iteration (one cluster of {shape[0]} x "
        f"{shape[1]} threads, {shape[2]} such clusters fit the card; empty "
        f"kernel at that launch {floor_ms:.4f} ms; an iteration over no "
        f"points, above that floor, {fixed_ms:.4f} ms; bound "
        f"{bound['bound_ms']:.5f} ms by {bound['bound_by']}: bytes "
        f"{bound['bytes_ms']:.5f} ({bound['sectors']} distinct sectors over "
        f"the iterations), operations {bound['ops_ms']:.5f}; the sum over the "
        f"iterations of one pass's bound and the step's "
        f"{bound['per_pass_sum_ms']:.5f}; plain loop {out['loop_plain_ms']:.3f} "
        f"ms); one-pass gn_residual_reduce {pass_ms:.4f} ms (plain "
        f"{out['pass_plain_ms']:.3f}; bound {out['pass_bound_ms']:.5f} by "
        f"{out['pass_bound_by']}: bytes {out['pass_bytes_ms']:.5f} "
        f"({sectors} sectors), operations {out['pass_ops_ms']:.5f}); gn_step "
        f"{out['step_ms']:.4f} ms (plain {out['step_plain_ms']:.4f}, "
        f"torch.linalg.solve_ex on the 6x6 alone {out['solve_ex_ms']:.4f}, "
        f"empty kernel at 1 x 32 {out['step_floor_ms']:.4f}, bound "
        f"{out['step_bound_ms']:.7f}) [{smi}]")
    return out


def compact_vs_plain(depth, K, fcfg, tcfg, buf):
    """The compaction kernel into `buf` against `tracker.compact_points` on
    the card: (count, whether the count and the points are equal bit for
    bit)."""
    import torch
    from gradient_sdf_tpu_torch.models import tracker
    from gradient_sdf_tpu_torch.ops.kernels import track_compact as tc

    pts, count = tc.track_compact(depth, K, fcfg.z_min, fcfg.z_max,
                                  tcfg.sampling, buf)
    want = tracker.compact_points(depth, K, fcfg, tcfg)
    n = int(count)
    return n, n == want.shape[0] and torch.equal(pts[:n], want)


def launch_without_sync(grid, depth, K, R, t, gcfg, fcfg, tcfg, buf):
    """`tracker.launch_track` (the compaction and loop kernels) under
    PyTorch's sync debug mode "error", which raises at any host sync; the
    status is read after. Returns (R, t, status list)."""
    import torch
    from gradient_sdf_tpu_torch.models import tracker

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        Rn, tn, status = tracker.launch_track(grid, depth, K, R, t, gcfg,
                                              fcfg, tcfg, compact=buf)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return Rn, tn, status.tolist()


def compact_bound_ms(strided: int, kept: int) -> tuple:
    """(least ms, "bytes") of one compaction: 4 B of depth a strided pixel
    read, 12 B a kept point and the 4-byte count written (its operations,
    two compares a pixel and six float32 operations a point, take far
    less)."""
    from gradient_sdf_tpu_torch.tools.raycast_bench import MEM_BYTES_PER_S

    return (4 * strided + 12 * kept + 4) / MEM_BYTES_PER_S * 1e3, "bytes"


def compact_times(depth, K, fcfg, tcfg, buf):
    """Device ms of the compaction kernel on one frame beside its plain
    version (`track_compact_reference`: backprojection, `pts_cam[mask]`
    and the copy into a buffer, its host sync timed with it), the library
    call `pts_cam[mask]` alone (`nonzero` and the gather, with its sync),
    its launch floor (an empty kernel at its launch), its bound, and the
    host microseconds a wrapper call takes."""
    import torch
    from gradient_sdf_tpu_torch.ops.kernels import _build
    from gradient_sdf_tpu_torch.ops.kernels import track_compact as tc
    from gradient_sdf_tpu_torch.tools.fusion_bench import host_us, median_ms

    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream

    def empty():
        if lib.gsdf_track_compact_empty(*depth.shape, tcfg.sampling, stream):
            raise AssertionError("the empty launch failed")

    args = (depth, K, fcfg.z_min, fcfg.z_max)
    ref = tc.new_buffer(depth.shape, tcfg.sampling, depth.device)
    pts_cam, z = tc.backproject(depth, K, tcfg.sampling)
    mask = (z > fcfg.z_min) & (z < fcfg.z_max)
    kept = int(mask.sum())
    bound = compact_bound_ms(z.numel(), kept)
    return {"ms": event_ms(lambda: tc.track_compact(*args, tcfg.sampling,
                                                    buf)),
            "plain_ms": median_ms(lambda: tc.track_compact_reference(
                *args, ref)),
            "library_ms": median_ms(lambda: pts_cam[mask]),
            "launch_floor_ms": event_ms(empty),
            "host_us": host_us(lambda: tc.track_compact(*args, tcfg.sampling,
                                                        buf)),
            "bound_ms": bound[0], "bound_by": bound[1], "points": kept,
            "pixels": z.numel()}


# The compaction kernel taken apart (`compact_split`): one-switch builds of
# a copy of a tree's `csrc/track_compact.cu`, made as fusion_bench's
# SPLIT_SWITCHES. Per design (a string only its source holds): switch name
# -> edits. Results of a switched build are timings only.
COMPACT_SWITCHES = {
    "2048-pixel tiles from a counter": (
        "constexpr int kTile = kItems * kThreads;", {
            "empty kernel at its grid": [(
                "  __shared__ int tile_sh;",
                "  return;\n  __shared__ int tile_sh;")],
            "tile from blockIdx, no counter": [(
                "if (tid == 0) tile_sh = atomicAdd(next_tile, 1);",
                "if (tid == 0) tile_sh = blockIdx.x;")],
            "without the look-back (tile 0's prefix only)": [(
                "      before_tile = look_back(status, t, epoch);",
                "      before_tile = 0;")],
            "without the point writes": [(
                "    float* p = pts + 3 * (row0 + rows[k * kWarps + warp] + "
                "before[k]);\n    p[0] = x0 * z[k];\n    p[1] = y0 * z[k];\n"
                "    p[2] = z[k];",
                "    if (x0 * z[k] + y0 * z[k] == -1.5e30f) pts[0] = 0.0f;")],
        }),
    "tiles of whole rows, one-read look-back": (
        "constexpr int kTileRows = 4;", {
            "empty kernel at its grid": [(
                "  extern __shared__ float stage[];",
                "  return;\n  extern __shared__ float stage[];")],
            "tile from blockIdx, no counter": [(
                "if (tid == 0) tile_sh = atomicAdd(next_tile, 1);",
                "if (tid == 0) tile_sh = blockIdx.x;")],
            "without the look-back (tile 0's prefix only)": [(
                "    const long long before_tile = "
                "look_back(status, t, epoch);",
                "    const long long before_tile = 0;")],
            "without the points (stage and stores)": [
                ("      if (!((keep[k] >> j) & 1u)) continue;",
                 "      if (keep[k] < 16u) continue;"),
                ("  // the span in 16-byte stores",
                 "  if (total == -7) pts[0] = 0.0f;\n  return;\n"
                 "  // the span in 16-byte stores")],
            "without the 16-byte stores (stage only)": [(
                "  // the span in 16-byte stores",
                "  if (stage[tid] == -1.5e30f) pts[0] = 0.0f;\n  return;\n"
                "  // the span in 16-byte stores")],
        }),
}
COMPACT_FUNCS = ("gsdf_track_compact_f32", "gsdf_track_compact_tiles")


def compact_split(roots):
    """Step 0 of the compaction kernel, and its designs side by side: for
    each tree root in `roots`, its `csrc/track_compact.cu` built as it is
    and under each switch of its design (COMPACT_SWITCHES), launched
    through this package's wrapper (status words as many as that build's
    tiles) on golden frame 5 at stride 1 and timed with `event_ms`; the
    unswitched builds first held to `compact_points` (count and points bit
    for bit) and timed in turns (roots in order, then in reverse). Returns
    a dict."""
    import torch
    from gradient_sdf_tpu_torch.config import PipelineConfig
    from gradient_sdf_tpu_torch.data import synth
    from gradient_sdf_tpu_torch.models import tracker
    from gradient_sdf_tpu_torch.ops.kernels import track_compact as tc
    from gradient_sdf_tpu_torch.tools import fusion_bench as fb

    dev = torch.device("cuda")
    jobs, designs = fb.switch_jobs(roots, "track_compact.cu",
                                   COMPACT_SWITCHES, COMPACT_FUNCS)
    built = fb.build_all(jobs)
    _, depths, _ = fb.golden_protocol()
    cfg = PipelineConfig()
    fcfg, tcfg = cfg.fusion, cfg.tracker
    K = synth.KINECT_K
    depth = torch.as_tensor(depths[5], device=dev)
    H, W = depth.shape
    want = tracker.compact_points(depth, K, fcfg, tcfg)

    def buffer(lib):
        buf = tc.new_buffer(depth.shape, tcfg.sampling, dev)
        buf.status = torch.zeros(lib.gsdf_track_compact_tiles(
            H, W, tcfg.sampling), dtype=torch.int64, device=dev)
        return buf

    def run(lib, buf):
        return fb.with_lib(lib, lambda: tc.track_compact(
            depth, K, fcfg.z_min, fcfg.z_max, tcfg.sampling, buf))

    out = {"trees": [], "points": want.shape[0]}
    for k, root in enumerate(roots):
        lib = built[(k, "as it is")][0]
        buf = buffer(lib)
        pts, count = run(lib, buf)
        n = int(count)
        same = n == want.shape[0] and torch.equal(pts[:n], want)
        ms = {}
        for (kk, name), (lib_, _) in built.items():
            if kk == k:
                b_ = buffer(lib_)
                ms[name] = event_ms(lambda: run(lib_, b_))
        out["trees"].append({
            "root": root, "design": designs[k], "bit_equal": same, "ms": ms,
            "tiles": buf.status.numel(),
            "host_us": fb.host_us(lambda: run(lib, buf)),
            "ptxas": {name: fb.ptxas_lines(log, "track_compact")
                      for (kk, name), (_, log) in built.items() if kk == k}})
    order = list(range(len(roots)))
    out["turns"] = []
    for k in order + order[::-1]:
        lib = built[(k, "as it is")][0]
        buf = buffer(lib)
        out["turns"].append((roots[k], event_ms(lambda: run(lib, buf))))
    out["bound"] = compact_bound_ms(depth.numel(), want.shape[0])
    return out


def compact_split_report(res, smi):
    for t in res["trees"]:
        log(f"track_compact of {t['root']} ({t['design']}, {t['tiles']} "
            f"tiles), golden frame 5 at stride 1, {res['points']} points "
            f"[{smi}]: count and points bit-equal to compact_points: "
            f"{t['bit_equal']}; host {t['host_us']:.1f} us a wrapper call; "
            + "; ".join(f"{k} {v:.4f} ms" for k, v in t["ms"].items()))
        for name, lines in t["ptxas"].items():
            for k, v in lines.items():
                log(f"  ptxas ({name}) {k}: {v}")
    log(f"track_compact in turns [{smi}]: "
        + "; ".join(f"{r} {ms:.4f} ms" for r, ms in res["turns"])
        + f"; bound {res['bound'][0]:.5f} ms ({res['bound'][1]})")


def iteration_edge(st, conv_sq, k_kernel, k_plain) -> bool:
    """Whether two loops that ran k_kernel and k_plain iterations part at a
    step within ITER_EDGE_FACTOR of the threshold (`check_loop`'s xi^2 at
    the iteration where one of them stopped)."""
    if k_kernel == k_plain:
        return False
    j = min(k_kernel, k_plain) - 1
    x = st["xi_sq"][j] if j < len(st["xi_sq"]) else float("inf")
    return conv_sq / ITER_EDGE_FACTOR <= x <= conv_sq * ITER_EDGE_FACTOR


def track_turns(what, grid, depth, K, R, t, gcfg, fcfg, tcfg, st_grad,
                n_turns=2, compact=None):
    """`track_frame` through the compaction and loop kernels (into the
    buffer `compact`) and the plain loop with and without packed rows, in
    turns; the launches and syncs of the kernels' path. Returns (kernel's
    result, stats); raises on a mismatch."""
    import torch
    from gradient_sdf_tpu_torch.models import tracker

    unpacked = dataclasses.replace(tcfg, packed_row_gather=False)
    res, counts = count_kernel_path(grid, depth, K, R, t, gcfg, fcfg, tcfg,
                                    compact)
    if not (counts["compact"] == counts["loop"] == 1
            and counts["reduce"] == counts["step"] == 0
            and counts["status_syncs"] == 1
            and counts["compaction_syncs"] == counts["nonzero"] == 0
            and counts["other_syncs"] == counts["outside_syncs"] == 0
            and counts["packs"] == 0):
        raise AssertionError(
            f"{what}: the kernels' path made {counts} for {res.num_iters} GN "
            f"iterations; want one launch of the compaction kernel and one of "
            f"the loop kernel, no nonzero, the status's host read alone, no "
            f"pack")
    paths = {
        "kernel": lambda: tracker.track_frame(grid, depth, K, R, t, gcfg, fcfg,
                                              tcfg, compact=compact),
        "packed": lambda: tracker.track_points_plain(
            grid, tracker.compact_points(depth, K, fcfg, tcfg), R, t, gcfg,
            fcfg, tcfg),
        "unpacked": lambda: tracker.track_points_plain(
            grid, tracker.compact_points(depth, K, fcfg, tcfg), R, t, gcfg,
            fcfg, unpacked)}
    runs = {w: [] for w in paths}
    order = list(paths)
    for turn in range(n_turns):
        for w in (order if turn % 2 == 0 else order[::-1]):
            runs[w].append(timed(paths[w]))

    def diff(x, y):
        return max(float((x.R - y.R).abs().max()),
                   float((x.t - y.t).abs().max()))

    a = runs["kernel"][0][0]
    conv_sq = tcfg.conv_threshold ** 2
    edges = 0
    for w in runs:
        for r, _ in runs[w]:
            if r.converged != a.converged or r.num_iters != a.num_iters:
                if not iteration_edge(st_grad, conv_sq, a.num_iters, r.num_iters):
                    raise AssertionError(
                        f"{what}: {w} converged {r.converged} in {r.num_iters} "
                        f"iterations, the kernel {a.converged} in {a.num_iters}")
                edges += 1
    plain = [r for w in ("packed", "unpacked") for r, _ in runs[w]]
    path_diff = max(diff(r, a) for r in plain)
    pack_diff = max(diff(r, plain[0]) for r in plain)
    if not (path_diff <= PATH_POSE_TOL and pack_diff <= PACK_POSE_TOL):
        raise AssertionError(
            f"{what}: poses differ by {path_diff} between the kernel's path "
            f"and the plain loop (limit {PATH_POSE_TOL}), by {pack_diff} "
            f"between the plain loop with and without packed rows (limit "
            f"{PACK_POSE_TOL})")
    b = runs["kernel"][1][0]
    if not (torch.equal(a.R, b.R) and torch.equal(a.t, b.t)
            and a.num_iters == b.num_iters):
        raise AssertionError(f"{what}: two runs of the kernel's path differ")
    st = {"ms": {w: [x for _, x in runs[w]] for w in runs},
          "iters": {w: [r.num_iters for r, _ in runs[w]] for w in runs},
          "path_diff": path_diff, "pack_diff": pack_diff, "iter_edges": edges,
          "counts": counts}
    return a, st


def other_block_check(depths, K, poses, block_shape=4):
    """The instances for a block shape other than the app's (divisions at
    run time), held as `check_loop` holds the others: frames 0-4 fused at
    their poses into a map of `block_shape`, frame 5 from pose 4, grad and
    trilinear. Returns {mode: stats}."""
    import torch
    from gradient_sdf_tpu_torch.models import tracker
    from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap
    from gradient_sdf_tpu_torch.tools.fusion_bench import golden_protocol

    cfg = golden_protocol()[0]
    grid_cfg = dataclasses.replace(
        cfg.grid, block_shape=block_shape,
        num_blocks=cfg.grid.num_blocks * (8 // block_shape) ** 3)
    cfg = dataclasses.replace(cfg, grid=grid_cfg)
    dev = depths[0].device
    pose = [tuple(torch.as_tensor(a, device=dev) for a in p) for p in poses]
    m = GradSdfMap(cfg, device=dev)
    for d, p in zip(depths[:-1], pose[:-1]):
        m.update(d, K, p)
    pts = tracker.compact_points(depths[-1], K, m.cfg.fusion, cfg.tracker)
    return {mode: check_loop(m.grid, pts, *pose[-2], m.cfg.grid, m.cfg.fusion,
                             cfg.tracker, mode)[0]
            for mode in ("grad", "trilinear")}


def golden_phase(depths, K, smi, at_last=None):
    """Phase 4b on golden frames `depths` (card tensors, frame 0 first).
    `at_last(grid, pts, R, t, gcfg, fcfg, tcfg)` is called with the last
    frame's points, start pose and the map it is tracked against. Returns
    the stats for chip_smoke's kernels line."""
    import torch
    from gradient_sdf_tpu_torch.models import tracker
    from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap
    from gradient_sdf_tpu_torch.tools.fusion_bench import golden_protocol

    dev = depths[0].device
    cfg = golden_protocol()[0]
    m = GradSdfMap(cfg, device=dev)
    R, t = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    gcfg, fcfg, tcfg = m.cfg.grid, m.cfg.fusion, cfg.tracker
    buf = m.track_buffer(depths[0].shape, tcfg.sampling)
    ms = {"kernel": [], "packed": [], "unpacked": []}
    worst = {"sum_err": 0.0, "sum_rel": 0.0, "step_err": 0.0, "pose": 0.0,
             "pack": 0.0, "flag_edge": 0, "iter_edges": 0}
    iters_total = 0
    for i, depth in enumerate(depths):
        if i == 0:
            m.update(depth, K, (R, t))
            continue
        pts = tracker.compact_points(depth, K, fcfg, tcfg)
        n_kept, same = compact_vs_plain(depth, K, fcfg, tcfg, buf)
        if not same:
            raise AssertionError(f"golden frame {i}: the compaction kernel's "
                                 f"{n_kept} points differ from compact_points'")
        checked = {}
        for mode in ("grad", "trilinear"):
            st, _, _ = check_loop(m.grid, pts, R, t, gcfg, fcfg, tcfg, mode)
            checked[mode] = st
            for k in ("sum_err", "sum_rel", "step_err"):
                worst[k] = max(worst[k], st[k])
            worst["flag_edge"] += st["flag_edge"]
        st = checked["grad"]
        a, tr = track_turns(f"golden frame {i}", m.grid, depth, K, R, t, gcfg,
                            fcfg, tcfg, st, compact=buf)
        Rn, tn, status = launch_without_sync(m.grid, depth, K, R, t, gcfg,
                                             fcfg, tcfg, buf)
        if not (torch.equal(Rn, a.R) and torch.equal(tn, a.t)
                and int(status[4]) == a.num_iters):
            raise AssertionError(f"golden frame {i}: launch_track without a "
                                 f"sync differs from track_frame")
        worst["pose"] = max(worst["pose"], tr["path_diff"])
        worst["pack"] = max(worst["pack"], tr["pack_diff"])
        worst["iter_edges"] += tr["iter_edges"]
        for w in ms:
            ms[w].extend(tr["ms"][w])
        iters_total += a.num_iters
        c = tr["counts"]
        log(f"  phase4b frame {i}: track_ms kernel "
            f"{' / '.join(f'{x:.3f}' for x in tr['ms']['kernel'])}, plain packed "
            f"{' / '.join(f'{x:.2f}' for x in tr['ms']['packed'])}, plain unpacked "
            f"{' / '.join(f'{x:.2f}' for x in tr['ms']['unpacked'])}; GN iters "
            f"{tr['iters']}; kernels' path: {c['compact']} track_compact "
            f"({n_kept} points = compact_points' bit for bit), "
            f"{c['loop']} gn_track_loop, "
            f"{c['reduce']} one-pass and {c['step']} gn_step launches, "
            f"{c['nonzero']} nonzero calls, host "
            f"syncs {c['compaction_syncs']} in the compaction + "
            f"{c['status_syncs']} status read + {c['other_syncs']} elsewhere "
            f"in the port {c['other_where']} (+{c['outside_syncs']} with no "
            f"line of the port on the stack {c['outside_where']}), "
            f"{c['packs']} _pack_fields calls; launch_track under sync debug "
            f"mode \"error\": no sync, the same pose and iterations; checked "
            f"loop, grad: {st['iters']} iterations, count {st['count']}, sums "
            f"max |err| {st['sum_err']:.3g} ({st['sum_rel']:.3g} of the terms' "
            f"magnitudes), step max |err| {st['step_err']:.3g} (tolerance "
            f"{st['step_tol']:.3g}); trilinear: {checked['trilinear']['iters']} "
            f"iterations, sums {checked['trilinear']['sum_rel']:.3g} of the "
            f"magnitudes, step {checked['trilinear']['step_err']:.3g}; each "
            f"full loop = its chain of single iterations bit for bit, twice; "
            f"poses: kernel vs plain max |diff| {tr['path_diff']:.3g}, plain "
            f"packed vs unpacked {tr['pack_diff']:.3g}")
        if i == len(depths) - 1:
            # frame 5, against the map it was tracked on: crafted steps, times
            crafted_err, seen = check_crafted(dev, R, t)
            times = time_frame(m.grid, pts, R, t, gcfg, fcfg, tcfg, st, smi,
                               f"golden frame {i}")
            ctimes = compact_times(depth, K, fcfg, tcfg, buf)
            log(f"phase4b golden frame {i} compaction ({ctimes['points']} of "
                f"{ctimes['pixels']} pixels kept): track_compact "
                f"{ctimes['ms']:.4f} ms (launch floor "
                f"{ctimes['launch_floor_ms']:.4f}, host "
                f"{ctimes['host_us']:.1f} us a call; bound "
                f"{ctimes['bound_ms']:.5f}, "
                f"bytes; plain track_compact_reference with its sync "
                f"{ctimes['plain_ms']:.4f}; pts_cam[mask] alone with its "
                f"sync {ctimes['library_ms']:.4f}) [{smi}]")
            if at_last:
                at_last(m.grid, pts, R, t, gcfg, fcfg, tcfg)
        R, t = a.R, a.t
        if a.converged:
            m.update(depth, K, (R, t))
    other = other_block_check(depths, K, golden_protocol()[2])
    for st in other.values():
        for k in ("sum_err", "sum_rel", "step_err"):
            worst[k] = max(worst[k], st[k])
    log(f"phase4b block shape 4 (the instances that divide at run time), "
        f"frame 5 on a map fused at the ground-truth poses: grad "
        f"{other['grad']['iters']} iterations, sums "
        f"{other['grad']['sum_rel']:.3g} of the magnitudes, step "
        f"{other['grad']['step_err']:.3g}; trilinear "
        f"{other['trilinear']['iters']} iterations, sums "
        f"{other['trilinear']['sum_rel']:.3g}, step "
        f"{other['trilinear']['step_err']:.3g}; full loops = their chains bit "
        f"for bit")
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    log(f"phase4b track_ms on golden frames 1-{len(depths) - 1}, in turns: "
        f"loop kernel mean {mean['kernel']:.3f} ms, plain loop with packed "
        f"rows {mean['packed']:.2f}, without {mean['unpacked']:.2f}; "
        f"{iters_total} GN iterations in {len(depths) - 1} loop launches, "
        f"{len(depths) - 1} compaction launches and {len(depths) - 1} status "
        f"reads; poses differ by at most "
        f"{worst['pose']:.3g} between the kernel's path and the plain loop "
        f"(limit {PATH_POSE_TOL}) and {worst['pack']:.3g} between the plain "
        f"loop with and without packed rows (limit {PACK_POSE_TOL}); "
        f"{worst['iter_edges']} runs stopped an iteration apart at the "
        f"threshold's edge; at every iteration, grad and trilinear: counts "
        f"equal, sums max |err| {worst['sum_err']:.3g} "
        f"({worst['sum_rel']:.3g} of the terms' magnitudes, limit "
        f"{SUM_REL_TOL:.3g}), the loop's step = gn_step's bit for bit, vs "
        f"plain max |err| {worst['step_err']:.3g} ({worst['flag_edge']} flag "
        f"differences at the threshold's edge); gn_step on the crafted "
        f"systems {crafted_err:.3g}: {', '.join(seen)} [{smi}]")
    sums_err = worst["sum_err"]
    return {
        "track_ms": mean, "iterations": iters_total, "frame5": times,
        "compact": {"max_abs_err": 0.0, "ms": ctimes["ms"],
                    "launch_floor_ms": ctimes["launch_floor_ms"],
                    "host_us": ctimes["host_us"],
                    "plain_ms": ctimes["plain_ms"],
                    "bound_ms": ctimes["bound_ms"],
                    "bound_by": ctimes["bound_by"],
                    "library_ms": ctimes["library_ms"]},
        "loop": {"max_abs_err": max(sums_err, worst["step_err"]),
                 "ms": times["loop_ms"], "plain_ms": times["loop_plain_ms"],
                 "bound_ms": times["loop_bound"]["bound_ms"],
                 "bound_by": times["loop_bound"]["bound_by"],
                 "library_ms": None, "launch_floor_ms": times["floor_ms"],
                 "ms_per_iteration": times["loop_ms_per_iteration"],
                 "iterations": times["iterations"]},
        "reduce": {"max_abs_err": sums_err, "ms": times["pass_ms"],
                   "plain_ms": times["pass_plain_ms"],
                   "bound_ms": times["pass_bound_ms"],
                   "bound_by": times["pass_bound_by"], "library_ms": None,
                   "launch_floor_ms": times["floor_ms"]},
        "step": {"max_abs_err": max(worst["step_err"], crafted_err),
                 "ms": times["step_ms"], "plain_ms": times["step_plain_ms"],
                 "bound_ms": times["step_bound_ms"], "bound_by": "operations",
                 "library_ms": times["solve_ex_ms"],
                 "launch_floor_ms": times["step_floor_ms"]},
    }


def full_frame_setup(dev):
    """The full frame (FULL_BACKDROP): (map with frames 0-4 fused at their
    poses, frame 5's depth, K, frame 4's pose as the start)."""
    import numpy as np
    import torch
    from gradient_sdf_tpu_torch.data import synth
    from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap
    from gradient_sdf_tpu_torch.tools.fusion_bench import golden_protocol

    spheres = synth.random_spheres(seed=2, device=dev)
    center, radius = FULL_BACKDROP
    world = synth.SphereWorld(
        torch.cat([spheres.centers, torch.tensor([center], device=dev)]),
        torch.cat([spheres.radii, torch.tensor([radius], device=dev)]))
    poses = [tuple(torch.as_tensor(a, device=dev) for a in pose)
             for pose in synth.orbit_poses(n=6, radius=2.0,
                                           arc=np.deg2rad(4.0))]
    depths = [synth.quantize_depth(synth.render_depth(world, R, t))
              for R, t in poses]
    K = synth.KINECT_K
    m = GradSdfMap(golden_protocol()[0], device=dev)
    for d, pose in zip(depths[:-1], poses[:-1]):
        m.update(d, K, pose)
    return m, depths[-1], K, poses[-2]


def full_phase(dev, smi):
    """The full frame held and timed as golden frame 5 is. Returns (times,
    its case for `shape_sweep`)."""
    from gradient_sdf_tpu_torch.models import tracker

    m, depth, K, (R, t) = full_frame_setup(dev)
    gcfg, fcfg, tcfg = m.cfg.grid, m.cfg.fusion, m.cfg.tracker
    pts = tracker.compact_points(depth, K, fcfg, tcfg)
    st, _, _ = check_loop(m.grid, pts, R, t, gcfg, fcfg, tcfg)
    _, tr = track_turns("the full frame", m.grid, depth, K, R, t, gcfg, fcfg,
                        tcfg, st,
                        compact=m.track_buffer(depth.shape, tcfg.sampling))
    log(f"phase4b full frame (the golden spheres before a backdrop, "
        f"{pts.shape[0]} of "
        f"{depth.numel()} pixels valid): track_ms kernel "
        f"{' / '.join(f'{x:.3f}' for x in tr['ms']['kernel'])}, plain packed "
        f"{' / '.join(f'{x:.2f}' for x in tr['ms']['packed'])}, unpacked "
        f"{' / '.join(f'{x:.2f}' for x in tr['ms']['unpacked'])}; GN iters "
        f"{tr['iters']}; checked loop: {st['iters']} iterations, sums "
        f"{st['sum_rel']:.3g} of the magnitudes, step max |err| "
        f"{st['step_err']:.3g}; poses kernel vs plain {tr['path_diff']:.3g}")
    times = time_frame(m.grid, pts, R, t, gcfg, fcfg, tcfg, st, smi,
                       "full frame")
    return times, (m.grid, pts, R, t, gcfg, fcfg, tcfg)


def ptxas_report(build_log, key):
    """[(kernel, registers, spill line)] of the entry functions whose
    mangled name holds `key`, from an `nvcc -Xptxas -v` log."""
    out, entry, props = [], None, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1) if key in m.group(1) else None
            props = None
            if entry:
                out.append([entry, None, None])
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
        elif entry and "spill" in line and props == entry:
            out[-1][2] = line.strip()
        elif entry and "Used" in line:
            out[-1][1] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def tree_frames():
    """For `--tree`: golden frames 1-5 and the full frame through the
    imported tree's `track_frame` (three timed runs a frame after one
    untimed), and its `gn_residual_reduce` and `gn_step` device ms on frame
    5 and the full frame; its GN kernels' ptxas report."""
    import torch
    from gradient_sdf_tpu_torch.data import synth
    from gradient_sdf_tpu_torch.models import tracker
    from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap
    from gradient_sdf_tpu_torch.ops.kernels import _build
    from gradient_sdf_tpu_torch.ops.kernels import gn_track as gt
    from gradient_sdf_tpu_torch.tools.fusion_bench import (golden_protocol,
                                                           median_ms)

    dev = torch.device("cuda")
    cfg, depths, _ = golden_protocol()
    K = synth.KINECT_K
    dd = [torch.as_tensor(d, device=dev) for d in depths]

    def kernels(grid, depth, R, t, gcfg, fcfg, tcfg):
        pts = tracker.compact_points(depth, K, fcfg, tcfg)
        sums = gt.gn_residual_reduce(pts, R, t, grid, gcfg, fcfg)
        Rs, ts = R.clone(), t.clone()
        status = torch.zeros(4, dtype=torch.float32, device=dev)
        conv_sq = tcfg.conv_threshold ** 2
        return {"reduce_ms": median_ms(lambda: gt.gn_residual_reduce(
                    pts, R, t, grid, gcfg, fcfg)),
                "step_ms": median_ms(lambda: gt.gn_step(
                    sums, Rs, ts, status, damping=tcfg.damping,
                    conv_sq=conv_sq))}

    def track(grid, depth, R, t, gcfg, fcfg, tcfg, m):
        # the map's compaction buffer, where the tree has one (as its app)
        kw = ({"compact": m.track_buffer(depth.shape, tcfg.sampling)}
              if hasattr(m, "track_buffer") else {})
        runs = [timed(lambda: tracker.track_frame(grid, depth, K, R, t, gcfg,
                                                  fcfg, tcfg, **kw))
                for _ in range(4)]
        return runs[0][0], [x for _, x in runs[1:]]

    m = GradSdfMap(cfg, device=dev)
    gcfg, fcfg, tcfg = m.cfg.grid, m.cfg.fusion, cfg.tracker
    R, t = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    m.update(dd[0], K, (R, t))
    out = {"golden": []}
    for i in range(1, len(dd)):
        res, ms = track(m.grid, dd[i], R, t, gcfg, fcfg, tcfg, m)
        out["golden"].append({"frame": i, "ms": ms, "iters": res.num_iters})
        if i == len(dd) - 1:
            out["frame5"] = kernels(m.grid, dd[i], R, t, gcfg, fcfg, tcfg)
        R, t = res.R, res.t
        if res.converged:
            m.update(dd[i], K, (R, t))
    del m
    fm, depth, K, (R, t) = full_frame_setup(dev)
    res, ms = track(fm.grid, depth, R, t, gcfg, fcfg, tcfg, fm)
    out["full"] = {"ms": ms, "iters": res.num_iters,
                   **kernels(fm.grid, depth, R, t, gcfg, fcfg, tcfg)}
    _build.load()
    out["ptxas"] = ptxas_report(_build.build_log, "gn_")
    return out


def run_tree(root):
    cmd = [sys.executable, os.path.abspath(__file__), "--tree", root]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          env=dict(os.environ, PYTHONPATH=root))
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def frame_turns(parent, smi):
    """`tree_frames` of the parent and this tree, in turns (module note)."""
    for name, root in [("parent", parent), ("this", OWN_ROOT),
                       ("this", OWN_ROOT), ("parent", parent)]:
        r = run_tree(root)
        golden = [x for f in r["golden"] for x in f["ms"]]
        log(f"phase4b --tree {name}: track_frame ms, golden frames 1-5 "
            + "; ".join(f"{f['frame']}: {' / '.join(f'{x:.3f}' for x in f['ms'])}"
                        f" ({f['iters']} iters)" for f in r["golden"])
            + f" (mean {sum(golden) / len(golden):.3f}); full frame "
            f"{' / '.join(f'{x:.3f}' for x in r['full']['ms'])} "
            f"({r['full']['iters']} iters); gn_residual_reduce "
            f"{r['frame5']['reduce_ms']:.4f} ms on frame 5, "
            f"{r['full']['reduce_ms']:.4f} on the full frame; gn_step "
            f"{r['frame5']['step_ms']:.4f}; ptxas {r['ptxas']} [{smi}]")


# The two-kernel design's residual kernel taken apart (`diagnose_parent`):
# its source is included, so its device functions and constants are the
# parent's
DIAG_SOURCE = r'''
#include "@PARENT@"

namespace {

// the old kernel's gather and residuals, without the reduction: the sums
// stay live through a store that does not happen
__global__ void __launch_bounds__(kThreads)
diag_gather(const float* __restrict__ pts, int64_t n,
            const float* __restrict__ R, const float* __restrict__ t, Grid g,
            float* __restrict__ sink) {
  float r[9], tt[3];
  for (int k = 0; k < 9; ++k) r[k] = __ldg(R + k);
  for (int k = 0; k < 3; ++k) tt[k] = __ldg(t + k);
  float acc[kSums];
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const float x = __ldg(pts + 3 * i), y = __ldg(pts + 3 * i + 1),
                z = __ldg(pts + 3 * i + 2);
    float p[3];
    for (int k = 0; k < 3; ++k)
      p[k] = r[3 * k] * x + r[3 * k + 1] * y + r[3 * k + 2] * z + tt[k];
    float phi, J[6];
    if (!grad_residual(g, p, phi, J)) continue;
    acc[0] += phi * phi;
    for (int a = 0; a < 6; ++a) acc[1 + a] += phi * J[a];
    int k = 7;
    for (int a = 0; a < 6; ++a)
      for (int b = a; b < 6; ++b) acc[k++] += J[a] * J[b];
    acc[kSums - 1] += 1.0f;
  }
  float s = 0.0f;
  for (int k = 0; k < kSums; ++k) s += acc[k];
  if (s == -1.0e30f) sink[blockIdx.x * kThreads + threadIdx.x] = s;
}

// the old kernel's reduction alone, over zeros: CTA sums, partials, the
// ticket, the last CTA's second sum
__global__ void __launch_bounds__(kThreads)
diag_reduce(float* __restrict__ partials, unsigned int* __restrict__ ticket,
            float* __restrict__ sums) {
  __shared__ float smem[kWarps * kSums];
  __shared__ bool last;
  float acc[kSums];
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
  const float part = cta_sum(acc, smem);
  if (threadIdx.x < kSums) partials[blockIdx.x * kSums + threadIdx.x] = part;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float v[kSums];
  for (int k = 0; k < kSums; ++k) v[k] = 0.0f;
  for (int c = threadIdx.x; c < gridDim.x; c += kThreads) {
    for (int k = 0; k < kSums; ++k) v[k] += __ldcg(partials + c * kSums + k);
  }
  const float total = cta_sum(v, smem);
  if (threadIdx.x < kSums) sums[threadIdx.x] = total;
  if (threadIdx.x == 0) *ticket = 0u;
}

__global__ void __launch_bounds__(kThreads) diag_empty() {}

}  // namespace

extern "C" int diag_gather_f32(const void* pts, int64_t n, const void* R,
                               const void* t, const void* directory,
                               const void* dist, const void* weight,
                               const void* gx, const void* gy, const void* gz,
                               void* sink, int dir_dim, int block_shape,
                               int slot_hi, float vs, float grad_scale,
                               void* stream) {
  Grid g = {static_cast<const int32_t*>(directory),
            static_cast<const float*>(dist), static_cast<const float*>(weight),
            static_cast<const float*>(gx), static_cast<const float*>(gy),
            static_cast<const float*>(gz), dir_dim, dir_dim / 2, block_shape,
            block_shape * block_shape * block_shape, 0, slot_hi, vs,
            grad_scale};
  diag_gather<<<kCtas, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), n, static_cast<const float*>(R),
      static_cast<const float*>(t), g, static_cast<float*>(sink));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int diag_reduce_f32(void* partials, void* ticket, void* sums,
                               void* stream) {
  diag_reduce<<<kCtas, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(partials), static_cast<unsigned int*>(ticket),
      static_cast<float*>(sums));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int diag_empty_f32(void* stream) {
  diag_empty<<<kCtas, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// out: the old kernel's CTAs, threads, and CTAs per SM (occupancy)
extern "C" int diag_shape(int* out) {
  out[0] = kCtas;
  out[1] = kThreads;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 2, gn_residual_reduce<kGrad>, kThreads, 0));
}
'''


def build_variant(source_text, tag):
    """Build `source_text` as a `gn_track.cu` (with its flags) into a
    library of its own under WORK/tag. Returns (ctypes library, build
    log)."""
    import ctypes

    from gradient_sdf_tpu_torch.ops.kernels import _build

    out_dir = os.path.join(WORK, tag)
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "gn_track.cu")
    with open(src, "w") as f:
        f.write(source_text)
    target = os.path.join(out_dir, "lib.so")
    build_log = _build._compile([src], out_dir, target)
    return ctypes.CDLL(target), build_log


def diagnose_parent(parent, grid, pts, R, t, gcfg, fcfg, smi):
    """The diagnosis (module note): what held the two-kernel design's
    residual kernel, on golden frame 5's points at its start pose."""
    import ctypes
    import math

    import torch
    from gradient_sdf_tpu_torch.tools.fusion_bench import median_ms

    src = os.path.join(os.path.abspath(parent), "gradient_sdf_tpu_torch",
                       "csrc", "gn_track.cu")
    with open(src) as f:
        text = f.read()
    if not all(k in text for k in ("kCtas", "ticket", "gsdf_gn_residual_reduce_f32")):
        log("phase4b diagnosis: the parent's residual kernel is not the "
            "two-kernel design's (no per-CTA partials and ticket)")
        return None
    lib, build_log = build_variant(DIAG_SOURCE.replace("@PARENT@", src), "diag")
    vp, i64, c_int, c_float = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                               ctypes.c_float)
    lib.diag_gather_f32.argtypes = ([vp, i64] + [vp] * 9 + [c_int] * 3
                                    + [c_float] * 2 + [vp])
    lib.diag_reduce_f32.argtypes = [vp] * 4
    lib.diag_empty_f32.argtypes = [vp]
    lib.diag_shape.argtypes = [vp]
    lib.gsdf_gn_residual_reduce_f32.argtypes = (
        [vp, i64] + [vp] * 11 + [c_int] * 5 + [c_float] * 2 + [vp])
    shape = (ctypes.c_int * 3)()
    if lib.diag_shape(shape) != 0:
        raise AssertionError("occupancy query of the old kernel failed")
    ctas, threads, per_sm = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    waves = math.ceil(ctas / (sms * per_sm)) if per_sm else float("inf")
    dev = pts.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    fields = [f.data_ptr() for f in (grid.dist, grid.weight, grid.grad_x,
                                     grid.grad_y, grid.grad_z)]
    partials = torch.zeros(ctas * 29, device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    sums = torch.zeros(29, device=dev)
    sink = torch.zeros(ctas * threads, device=dev)
    n, nb = pts.shape[0], grid.dist.shape[0]

    def call(rc):
        if rc != 0:
            raise AssertionError(f"a diagnostic launch failed: CUDA error {rc}")

    old = lambda: call(lib.gsdf_gn_residual_reduce_f32(
        pts.data_ptr(), n, R.data_ptr(), t.data_ptr(), grid.directory.data_ptr(),
        *fields, partials.data_ptr(), ticket.data_ptr(), sums.data_ptr(), 0,
        gcfg.dir_dim, gcfg.block_shape, 0, nb, gcfg.voxel_size,
        fcfg.grad_scale, stream))
    gather = lambda: call(lib.diag_gather_f32(
        pts.data_ptr(), n, R.data_ptr(), t.data_ptr(), grid.directory.data_ptr(),
        *fields, sink.data_ptr(), gcfg.dir_dim, gcfg.block_shape, nb,
        gcfg.voxel_size, fcfg.grad_scale, stream))
    reduce = lambda: call(lib.diag_reduce_f32(
        partials.data_ptr(), ticket.data_ptr(), sums.data_ptr(), stream))
    empty = lambda: call(lib.diag_empty_f32(stream))
    ms = {k: median_ms(f) for k, f in (("kernel", old), ("gather", gather),
                                       ("reduce", reduce), ("empty", empty))}
    regs = ptxas_report(build_log, "gn_residual_reduce")
    out = {"ptxas": regs, "ctas": ctas, "threads": threads, "per_sm": per_sm,
           "sms": sms, "waves": waves, **{f"{k}_ms": v for k, v in ms.items()}}
    log(f"phase4b diagnosis of the parent's gn_residual_reduce (the "
        f"two-kernel design) on golden frame 5's {n} "
        f"points: ptxas {regs}; {per_sm} CTAs of {threads} threads per SM, so "
        f"its {ctas}-CTA grid runs in {waves} wave(s) on {sms} SMs; kernel "
        f"{ms['kernel']:.4f} ms, the gather and residuals only (no reduction) "
        f"{ms['gather']:.4f}, the reduction only (over zeros) "
        f"{ms['reduce']:.4f}, the empty kernel at {ctas} x {threads} "
        f"{ms['empty']:.4f} [{smi}]")
    return out


def shape_sweep(cases, smi):
    """`--shapes`: the loop kernel built at each of SHAPES, and at the
    source's own shape with the app's block shape taking the instance that
    divides at run time, timed on `cases` ({name: (grid, pts, R0, t0, gcfg,
    fcfg, tcfg)})."""
    from concurrent.futures import ThreadPoolExecutor

    import ctypes

    from gradient_sdf_tpu_torch.ops.kernels import _build

    with open(os.path.join(_build.CSRC, "gn_track.cu")) as f:
        text = f.read()

    def variant(shape):
        ctas, threads = shape
        if ctas is None:
            v, k = text.replace(
                "const bool fixed = block_shape == kFixedBlock;",
                "const bool fixed = false;"), text.count(
                "const bool fixed = block_shape == kFixedBlock;")
            k2 = 1
        else:
            v, k = re.subn(r"constexpr int kClusterCtas = \d+;",
                           f"constexpr int kClusterCtas = {ctas};", text)
            v, k2 = re.subn(r"constexpr int kThreads = \d+;",
                            f"constexpr int kThreads = {threads};", v)
        if k != 1 or k2 != 1:
            raise AssertionError("the constants to change were not found")
        return build_variant(v, "runtime_block_shape" if ctas is None
                             else f"shape_{ctas}x{threads}")

    shapes = SHAPES + [(None, "run-time block shape")]
    with ThreadPoolExecutor(len(shapes)) as pool:
        libs = list(pool.map(variant, shapes))
    for (ctas, threads), (lib, build_log) in zip(shapes, libs):
        _build.declare_gn_track_loop(lib)
        lib.gsdf_gn_cluster_empty.argtypes = [ctypes.c_void_p]
        lib.gsdf_gn_cluster_shape.argtypes = [ctypes.c_int, ctypes.c_void_p]
        info = (ctypes.c_int * 3)()
        rc = lib.gsdf_gn_cluster_shape(0, info)
        ptx = ptxas_report(build_log, "gn_track_loop")
        if rc != 0:
            log(f"phase4b shape {ctas} x {threads}: cannot be placed (CUDA "
                f"error {rc}); ptxas {ptx}")
            continue
        row = []
        for name, (grid, pts, R0, t0, gcfg, fcfg, tcfg) in cases.items():
            frame_ms, iters, pass_ms, floor_ms, fixed_ms = loop_times(
                lib, grid, pts, R0, t0, gcfg, fcfg, tcfg)
            row.append(f"{name}: loop {frame_ms:.4f} ms ({iters} iters, "
                       f"{frame_ms / iters:.4f} an iteration), one-pass "
                       f"{pass_ms:.4f}, empty cluster {floor_ms:.4f}, an "
                       f"iteration over no points {fixed_ms:.4f}")
        what = (f"shape {ctas} CTAs x {threads} threads" if ctas else
                 "the source's shape, block shape 8 through the instance that "
                 "divides at run time")
        log(f"phase4b {what} ({info[2]} clusters "
            f"fit; ptxas {[(r, s) for _, r, s in ptx]}): " + "; ".join(row)
            + f" [{smi}]")


def app_turns(parent, smi):
    """Scan3D on the golden dataset through each tree's own package, in
    turns (module note)."""
    import json
    import subprocess

    data = os.path.join(OWN_ROOT, "smoke_out", "track_bench", "golden")
    env = dict(os.environ, PYTHONPATH=OWN_ROOT)
    subprocess.run([sys.executable, "-m", "gradient_sdf_tpu_torch.apps.make_synth",
                    "--out", data, "--frames", "6", "--seed", "2", "--width",
                    "640", "--height", "480", "--arc-deg", "4", "--no-noise"],
                   check=True, env=env, capture_output=True, timeout=600)
    for k, (name, root) in enumerate([("parent", parent), ("this", OWN_ROOT),
                                      ("this", OWN_ROOT), ("parent", parent)]):
        out = os.path.join(OWN_ROOT, "smoke_out", "track_bench", f"run{k}")
        metrics = os.path.join(out, "metrics.json")
        subprocess.run([sys.executable, "-m", "gradient_sdf_tpu_torch.apps.scan3d",
                        "--input", data, "--results", out, "--data-type", "synth",
                        "--voxel-size", "0.02", "--trunc", "5", "--pose-file",
                        "none", "--metrics-json", metrics], check=True,
                       cwd=root, env=dict(os.environ, PYTHONPATH=root),
                       capture_output=True, timeout=900)
        with open(metrics) as f:
            fl = json.load(f)["frame_log"][1:]

        def mean(xs):
            return sum(xs) / len(xs)

        track = [e["track_ms"] for e in fl]
        fuse = [e["fuse_ms"] for e in fl if e["fuse_ms"] is not None]
        frame = [e["frame_ms"] for e in fl]
        # frame 1 is the process's first tracked frame: a library's lazy
        # initialization lands there, so frames 2-5 are given apart
        log(f"scan3d golden frames 1-5, {name} tree (run {k}): track_ms mean "
            f"{mean(track):.2f} ({', '.join(f'{x:.2f}' for x in track)}; "
            f"frames 2-5 {mean(track[1:]):.2f}), fuse_ms mean {mean(fuse):.2f} "
            f"({', '.join(f'{x:.2f}' for x in fuse)}; frames 2-5 "
            f"{mean(fuse[1:]):.2f}), "
            f"GN iters {[e['gn_iters'] for e in fl]}, frame_ms "
            f"{', '.join(f'{x:.2f}' for x in frame)}: {1e3 / mean(frame):.2f} "
            f"fps, frames 2-5 {1e3 / mean(frame[1:]):.2f} fps [{smi}]")


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="checkout of an earlier commit to compare")
    ap.add_argument("--shapes", action="store_true",
                    help="time the loop kernel at every cluster shape")
    ap.add_argument("--compact", metavar="DIR", nargs="*",
                    help="only the compaction kernel of each tree DIR (this "
                         "one if none) taken apart and timed in turns "
                         "(`compact_split`)")
    ap.add_argument("--tree", help="track through the package in DIR alone "
                    "and print one JSON line (what --parent runs per tree)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree or OWN_ROOT))
    import torch

    if not torch.cuda.is_available():
        print("track_bench: CUDA is not available; this needs a card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.tree:
        print(json.dumps(tree_frames()), flush=True)
        return 0
    from gradient_sdf_tpu_torch.data import synth
    from gradient_sdf_tpu_torch.tools.fusion_bench import golden_protocol

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    if args.compact is not None:
        compact_split_report(compact_split(
            [os.path.abspath(r) for r in args.compact] or [OWN_ROOT]), smi)
        log(smi)
        return 0
    dev = torch.device("cuda")
    _, depths, _ = golden_protocol()
    cases = {}

    def keep(grid, pts, R, t, gcfg, fcfg, tcfg):
        # a copy: the map is fused in place after the frame is tracked
        grid = type(grid)(*(a.clone() for a in grid))
        cases["golden frame 5"] = (grid, pts, R.clone(), t.clone(), gcfg,
                                   fcfg, tcfg)

    golden_phase([torch.as_tensor(d, device=dev) for d in depths],
                 synth.KINECT_K, smi, at_last=keep)
    cases["full frame"] = full_phase(dev, smi)[1]
    if args.parent:
        grid, pts, R, t, gcfg, fcfg, _ = cases["golden frame 5"]
        diagnose_parent(args.parent, grid, pts, R, t, gcfg, fcfg, smi)
        frame_turns(os.path.abspath(args.parent), smi)
        app_turns(os.path.abspath(args.parent), smi)
    if args.shapes:
        shape_sweep(cases, smi)
    log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
