#!/usr/bin/env python3
"""Card measurements of GN tracking on the golden protocol (needs one CUDA
card).

    python3 gradient_sdf_tpu_torch/tools/track_bench.py

Golden frames 1-5 (640x480 spheres seed 2, 6 frames over a 4 degree arc,
2 cm voxels, trunc 5, app-default 16384-block grid; frame 0 fused at the
identity, each later frame tracked from the previous frame's pose and fused
at the kernels' pose, as Scan3D does). Per frame it:

  1. runs the kernels' GN loop by hand and, at every iteration, holds
     `gn_residual_reduce` to its plain version (the count exactly; each of
     the 29 sums within 2^-18 of the sum of its terms' magnitudes: the
     residuals are the same bits, only float32 summation orders differ,
     each within ~log2(N) 2^-24 of that magnitude), runs it twice (the same
     bits), and holds `gn_step` to its plain version on those sums (the
     flags exactly; R and t within `step_tol`, from the float64 condition
     number of the system);
  2. tracks the frame in turns through `track_frame` (the kernels), the
     plain loop with the packed rows and the plain loop without them
     (kernels, packed, unpacked, unpacked, packed, kernels): track_ms of
     each, GN iterations, kernel launches per iteration, `_pack_fields`
     calls and host syncs of the kernels' path, and the poses' largest
     difference.
On frame 5 it also holds the trilinear instance to its plain version, holds
`gn_step` to its plain version on crafted systems (a normal step, zero
residuals, a single plane, a NaN and an inf in g, a rotation inside the
Taylor branch), and times both kernels with CUDA events (`median_ms`)
beside their plain versions, the empty kernel at their launch shapes, their
bounds (bytes: the points and the distinct 32-byte sectors of the directory
and the fields the residuals read; operations at the issue rates of
`raycast_bench`) and `torch.linalg.solve_ex` on the 6x6 alone.

`chip_smoke.py` phase 4b runs `golden_phase` on the frames it rendered.

With `--parent DIR` (a checkout of an earlier commit, e.g. unpacked with
`git archive`) it then runs the Scan3D app on the golden dataset (written
by this tree's `make_synth`) once per tree, each in a process of its own
that imports that tree's package, in the order parent, this, this,
parent, and prints each run's track_ms and fuse_ms over frames 1-5, GN
iterations and frames/s over frames 1-5 (`frame_ms`, the app's clock).
"""

import dataclasses
import os
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
OWN_ROOT = os.path.dirname(os.path.dirname(HERE))

# the sums' tolerance, relative to the sum of their terms' magnitudes
SUM_REL_TOL = 2.0**-18
# one step, crafted systems: a well-conditioned 6x6 LU in another order
STEP_TOL = 2e-6
# the plain loop with and without packed rows: the same fields and the same
# operations, so at most a skipped stopping step apart (chip_smoke's
# PACK_POSE_TOL, the resume gate's floor)
PACK_POSE_TOL = 5e-4
# the kernels' path vs the plain loop: the residual sums are taken in
# another order, and p = R x + t is rounded elementwise where the plain loop
# takes a cuBLAS product, which moves points that lie within an ulp of a
# voxel plane into the neighbouring voxel. GN turns such differences into
# pose differences of the size of its 1e-3 stopping rule: chip_smoke's
# MESH_POSE_TOL, for the sharded pass's other order, and
# tests/test_app_sharded.py's bound
PATH_POSE_TOL = 3e-3
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
# gn_step, one thread: LU and substitutions of a 6x6 ~180, flags 19,
# se3_exp ~110, the pose update 72 (float32 operations)
STEP_OPS = 381


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


def touched_sectors(pts, R, t, grid, gcfg) -> int:
    """Distinct 32-byte sectors the grad-mode pass reads, counted from the
    plain version's indices: `directory` at every in-range key, `weight` at
    every voxel of an allocated block, `dist` and the three gradient fields
    at every voxel with weight > 0."""
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
        return int(torch.unique(torch.div(idx, 8, rounding_mode="floor")).numel())

    return (sectors(key[key >= 0]) + sectors(row[found])
            + 4 * sectors(row[observed]))


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
    """The kernels' GN loop by hand, every iteration held to the plain
    versions (module note). Returns per-loop stats; raises on a mismatch."""
    import torch
    from gradient_sdf_tpu_torch.ops.kernels import gn_track as gt

    conv_sq = tcfg.conv_threshold * tcfg.conv_threshold
    R, t = R0.clone(), t0.clone()
    status = torch.zeros(4, dtype=torch.float32, device=pts.device)
    st = {"iters": 0, "sum_err": 0.0, "sum_rel": 0.0, "step_err": 0.0,
          "step_tol": 0.0, "count": 0, "first_sums": None, "flag_edge": 0}
    for it in range(tcfg.num_iterations):
        a = gt.gn_residual_reduce(pts, R, t, grid, gcfg, fcfg, mode=mode)
        b = gt.gn_residual_reduce(pts, R, t, grid, gcfg, fcfg, mode=mode)
        phi, J, valid = gt.gn_residual_terms(pts, R, t, grid, gcfg, fcfg,
                                             mode=mode)
        want = gt.sums_of_terms(phi, J, valid)
        scale = gt.sums_of_terms(phi.abs(), J.abs(), valid)
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"{mode} iteration {it}: two runs of "
                                 f"gn_residual_reduce differ: {a} / {b}")
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
        if it == 0:
            st["first_sums"] = a.clone()
        Rp, tp, small, bad = gt.gn_step_reference(a, R, t, tcfg.damping, conv_sq)
        tol, xi64 = step_tol(a, tcfg.damping)
        gt.gn_step(a, R, t, status, damping=tcfg.damping, conv_sq=conv_sq)
        s = status.tolist()
        flags, pflags = (s[0] != 0.0, s[1] != 0.0), (bool(small), bool(bad))
        edge = abs(float((xi64 ** 2).sum()) - conv_sq) <= 1e-3 * conv_sq
        if flags != pflags and not edge:
            raise AssertionError(f"{mode} iteration {it}: gn_step flags {flags} "
                                 f"vs plain {pflags}")
        st["flag_edge"] += int(flags != pflags)
        d = max(float((R - Rp).abs().max()), float((t - tp).abs().max()))
        if flags == pflags and not d <= tol:
            raise AssertionError(f"{mode} iteration {it}: gn_step pose differs "
                                 f"from plain by {d} (tolerance {tol})")
        if s[2] != float(a[0]) or s[3] != float(a[-1]):
            raise AssertionError(f"status {s} vs sums E {float(a[0])}, count "
                                 f"{float(a[-1])}")
        st["step_err"] = max(st["step_err"], d)
        st["step_tol"] = max(st["step_tol"], tol)
        st["iters"] = it + 1
        if flags[0]:
            break
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
    """(fn's result, [(file, line)] of each host sync it made), from
    PyTorch's sync debug mode, which warns at every synchronizing CUDA
    call."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [(w.filename, w.lineno) for w in caught
                 if "synchroniz" in str(w.message)]


def _lines(fn):
    import inspect

    src, first = inspect.getsourcelines(fn)
    return inspect.getsourcefile(fn), range(first, first + len(src))


def count_kernel_path(grid, depth, K, R, t, gcfg, fcfg, tcfg):
    """`track_frame` on the card (untimed), with its launches,
    `_pack_fields` calls and host syncs counted: those in `tracker.gn_loop`
    (the GN iterations' reads), in `tracker.compact_points` (the frame's
    compaction) and elsewhere. Returns (result, counts)."""
    import torch
    from gradient_sdf_tpu_torch.models import tracker
    from gradient_sdf_tpu_torch.ops.kernels import gn_track as gt

    packs = []
    real = tracker._pack_fields

    def counting(g):
        packs.append(1)
        return real(g)

    tracker._pack_fields = counting
    gt.reset_launch_count()
    torch.cuda.synchronize()
    try:
        res, syncs = count_syncs(lambda: tracker.track_frame(
            grid, depth, K, R, t, gcfg, fcfg, tcfg))
    finally:
        tracker._pack_fields = real
    where = {"loop": _lines(tracker.gn_loop),
             "compaction": _lines(tracker.compact_points)}
    n = {k: sum(f == file and l in lines for f, l in syncs)
         for k, (file, lines) in where.items()}
    other = sorted({f"{os.path.basename(f)}:{line}" for f, line in syncs
                    if not any(f == file and line in lines
                               for file, lines in where.values())})
    return res, {"reduce": gt.launch_count, "step": gt.step_launch_count,
                 "packs": len(packs), "syncs": n["loop"],
                 "compaction_syncs": n["compaction"],
                 "other_syncs": len(syncs) - sum(n.values()),
                 "other_where": other}


def timed(fn):
    """(fn(), host-clock ms around it, device-synchronized)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def time_kernels(grid, pts, R, t, gcfg, fcfg, tcfg, sums, smi):
    """Frame 5's kernel times beside plain, floor, bound and library."""
    import torch
    from gradient_sdf_tpu_torch.ops.kernels import _build
    from gradient_sdf_tpu_torch.ops.kernels import gn_track as gt
    from gradient_sdf_tpu_torch.tools.fusion_bench import median_ms

    dev = pts.device
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def empty(blocks, threads):
        if lib.gsdf_empty_launch(blocks, threads, stream) != 0:
            raise AssertionError("the empty kernel did not launch")

    conv_sq = tcfg.conv_threshold ** 2
    Rs, ts = R.clone(), t.clone()
    status = torch.zeros(4, dtype=torch.float32, device=dev)
    _, g6, H6, _ = gt.system_of_sums(sums)
    A6 = H6 + 1e-12 * torch.eye(6, device=dev)
    out = {
        "reduce_ms": median_ms(lambda: gt.gn_residual_reduce(
            pts, R, t, grid, gcfg, fcfg)),
        "reduce_plain_ms": median_ms(lambda: gt.gn_residual_reduce_reference(
            pts, R, t, grid, gcfg, fcfg)),
        "step_ms": median_ms(lambda: gt.gn_step(
            sums, Rs, ts, status, damping=tcfg.damping, conv_sq=conv_sq)),
        "step_plain_ms": median_ms(lambda: gt.gn_step_reference(
            sums, R, t, tcfg.damping, conv_sq)),
        "solve_ex_ms": median_ms(lambda: torch.linalg.solve_ex(A6, g6)),
        "floor_reduce_ms": median_ms(lambda: empty(lib.gsdf_gn_ctas(), 256)),
        "floor_step_ms": median_ms(lambda: empty(1, 32)),
    }
    phi, J, valid = gt.gn_residual_terms(pts, R, t, grid, gcfg, fcfg)
    n, nres = pts.shape[0], int(valid.sum())
    sectors = touched_sectors(pts, R, t, grid, gcfg)
    out.update(points=n, residuals=nres, sectors=sectors,
               bytes_bound_ms=reduce_bytes_bound_ms(n, sectors),
               ops_bound_ms=reduce_ops_bound_ms(n, nres),
               step_bound_ms=step_bound_ms())
    out["reduce_bound_ms"] = max(out["bytes_bound_ms"], out["ops_bound_ms"])
    out["reduce_bound_by"] = ("bytes" if out["bytes_bound_ms"]
                              >= out["ops_bound_ms"] else "operations")
    log(f"phase4b kernels on golden frame 5's residuals ({n} points, {nres} "
        f"residuals, {sectors} distinct 32-byte sectors of directory and "
        f"fields): gn_residual_reduce {out['reduce_ms']:.4f} ms (plain "
        f"{out['reduce_plain_ms']:.4f}; empty kernel at its "
        f"{lib.gsdf_gn_ctas()} x 256 launch {out['floor_reduce_ms']:.4f}; bound "
        f"{out['reduce_bound_ms']:.5f} by {out['reduce_bound_by']}: bytes "
        f"{out['bytes_bound_ms']:.5f}, operations {out['ops_bound_ms']:.5f}); "
        f"gn_step {out['step_ms']:.4f} ms (plain {out['step_plain_ms']:.4f}, "
        f"torch.linalg.solve_ex on the 6x6 alone {out['solve_ex_ms']:.4f}, "
        f"empty kernel at 1 x 32 {out['floor_step_ms']:.4f}, bound "
        f"{out['step_bound_ms']:.7f}) [{smi}]")
    return out


def golden_phase(depths, K, smi, n_turns=2):
    """Phase 4b on golden frames `depths` (card tensors, frame 0 first).
    Returns the stats for chip_smoke's kernels line."""
    import torch
    from gradient_sdf_tpu_torch.models import tracker
    from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap
    from gradient_sdf_tpu_torch.tools.fusion_bench import golden_protocol

    dev = depths[0].device
    cfg = golden_protocol()[0]
    m = GradSdfMap(cfg, device=dev)
    R, t = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    gcfg, fcfg, tcfg = m.cfg.grid, m.cfg.fusion, cfg.tracker
    unpacked = dataclasses.replace(tcfg, packed_row_gather=False)
    ms = {"kernels": [], "packed": [], "unpacked": []}
    worst = {"sum_err": 0.0, "sum_rel": 0.0, "step_err": 0.0, "pose": 0.0,
             "pack": 0.0, "flag_edge": 0}
    iters_total = 0
    for i, depth in enumerate(depths):
        if i == 0:
            m.update(depth, K, (R, t))
            continue
        pts = tracker.compact_points(depth, K, fcfg, tcfg)
        st, Rk, tk = check_loop(m.grid, pts, R, t, gcfg, fcfg, tcfg)
        for k in ("sum_err", "sum_rel", "step_err"):
            worst[k] = max(worst[k], st[k])
        worst["flag_edge"] += st["flag_edge"]
        res, counts = count_kernel_path(m.grid, depth, K, R, t, gcfg, fcfg,
                                        tcfg)
        if not (counts["reduce"] == counts["step"] == counts["syncs"]
                == res.num_iters and counts["packs"] == 0):
            raise AssertionError(
                f"frame {i}: the kernels' path made {counts} for "
                f"{res.num_iters} GN iterations; want one launch of each "
                f"kernel and one host read per GN iteration, no pack")
        paths = {
            "kernels": lambda: tracker.track_frame(m.grid, depth, K, R, t,
                                                   gcfg, fcfg, tcfg),
            "packed": lambda: tracker.track_points_plain(
                m.grid, tracker.compact_points(depth, K, fcfg, tcfg), R, t,
                gcfg, fcfg, tcfg),
            "unpacked": lambda: tracker.track_points_plain(
                m.grid, tracker.compact_points(depth, K, fcfg, tcfg), R, t,
                gcfg, fcfg, unpacked)}
        runs = {what: [] for what in paths}
        order = list(paths)
        for turn in range(n_turns):
            for what in (order if turn % 2 == 0 else order[::-1]):
                runs[what].append(timed(paths[what]))
        def diff(x, y):
            return max(float((x.R - y.R).abs().max()),
                       float((x.t - y.t).abs().max()))

        a = runs["kernels"][0][0]
        for what in runs:
            for res, _ in runs[what]:
                if res.converged != a.converged:
                    raise AssertionError(f"frame {i}: {what} converged "
                                         f"{res.converged}, kernels {a.converged}")
        plain = [r for w in ("packed", "unpacked") for r, _ in runs[w]]
        path_diff = max(diff(r, a) for r in plain)
        pack_diff = max(diff(r, plain[0]) for r in plain)
        if not (path_diff <= PATH_POSE_TOL and pack_diff <= PACK_POSE_TOL):
            raise AssertionError(
                f"frame {i}: poses differ by {path_diff} between the kernels' "
                f"path and the plain loop (limit {PATH_POSE_TOL}), by "
                f"{pack_diff} between the plain loop with and without packed "
                f"rows (limit {PACK_POSE_TOL})")
        if not (torch.equal(runs["kernels"][0][0].R, runs["kernels"][1][0].R)
                and torch.equal(runs["kernels"][0][0].t, runs["kernels"][1][0].t)):
            raise AssertionError(f"frame {i}: two runs of the kernels' path "
                                 f"give different poses")
        worst["pose"] = max(worst["pose"], path_diff)
        worst["pack"] = max(worst["pack"], pack_diff)
        for what in ms:
            ms[what].extend(x for _, x in runs[what])
        iters = {w: [r.num_iters for r, _ in runs[w]] for w in runs}
        iters_total += a.num_iters
        log(f"  phase4b frame {i}: track_ms kernels "
            f"{' / '.join(f'{x:.2f}' for _, x in runs['kernels'])}, plain packed "
            f"{' / '.join(f'{x:.2f}' for _, x in runs['packed'])}, plain unpacked "
            f"{' / '.join(f'{x:.2f}' for _, x in runs['unpacked'])}; GN iters "
            f"{iters}; kernels' path: {counts['reduce']} gn_residual_reduce + "
            f"{counts['step']} gn_step launches, {counts['syncs']} host syncs "
            f"in the GN loop (+{counts['compaction_syncs']} in the compaction, "
            f"{counts['other_syncs']} elsewhere {counts['other_where']}), "
            f"{counts['packs']} _pack_fields calls; checked loop: {st['iters']} "
            f"iterations, count {st['count']}, sums max |err| "
            f"{st['sum_err']:.3g} ({st['sum_rel']:.3g} of the terms' "
            f"magnitudes), gn_step max |err| {st['step_err']:.3g} (tolerance "
            f"{st['step_tol']:.3g}); poses: kernels vs plain max |diff| "
            f"{path_diff:.3g}, plain packed vs unpacked {pack_diff:.3g}")
        R, t = a.R, a.t
        if a.converged:
            m.update(depth, K, (R, t))
        last = (m.grid, pts, R, t, st["first_sums"])
    grid, pts, R, t, sums = last
    # frame 5: the trilinear instance, the crafted steps, the times
    st_tri, _, _ = check_loop(grid, pts, R, t, gcfg, fcfg, tcfg, mode="trilinear")
    crafted_err, seen = check_crafted(dev, R, t)
    times = time_kernels(grid, pts, R, t, gcfg, fcfg, tcfg, sums, smi)
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    log(f"phase4b track_ms on golden frames 1-{len(depths) - 1}, in turns: "
        f"kernels mean {mean['kernels']:.2f} ms, plain loop with packed rows "
        f"{mean['packed']:.2f}, without {mean['unpacked']:.2f}; {iters_total} "
        f"GN iterations, each 2 launches and 1 host read; poses differ by at "
        f"most {worst['pose']:.3g} between the kernels' path and the plain loop "
        f"(limit {PATH_POSE_TOL}) and {worst['pack']:.3g} between the plain "
        f"loop with and without packed rows (limit {PACK_POSE_TOL}); "
        f"gn_residual_reduce vs "
        f"plain at every iteration: counts equal, sums max |err| "
        f"{worst['sum_err']:.3g} ({worst['sum_rel']:.3g} of the terms' "
        f"magnitudes, limit {SUM_REL_TOL:.3g}), two runs equal bit for bit; "
        f"trilinear on frame 5: {st_tri['iters']} iterations, sums "
        f"{st_tri['sum_rel']:.3g} of the magnitudes; gn_step vs plain max |err| "
        f"{max(worst['step_err'], st_tri['step_err']):.3g} on real sums "
        f"({worst['flag_edge']} flag differences at the threshold's edge), "
        f"{crafted_err:.3g} on the crafted systems {', '.join(seen)} [{smi}]")
    return {
        "track_ms": mean, "iterations": iters_total,
        "reduce": {"max_abs_err": max(worst["sum_err"], st_tri["sum_err"]),
                   "ms": times["reduce_ms"], "plain_ms": times["reduce_plain_ms"],
                   "bound_ms": times["reduce_bound_ms"],
                   "bound_by": times["reduce_bound_by"], "library_ms": None,
                   "launch_floor_ms": times["floor_reduce_ms"]},
        "step": {"max_abs_err": max(worst["step_err"], st_tri["step_err"],
                                    crafted_err),
                 "ms": times["step_ms"], "plain_ms": times["step_plain_ms"],
                 "bound_ms": times["step_bound_ms"], "bound_by": "operations",
                 "library_ms": times["solve_ex_ms"],
                 "launch_floor_ms": times["floor_step_ms"]},
    }


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
            f"frames 2-5 {mean(track[1:]):.2f}), fuse_ms mean {mean(fuse):.2f}, "
            f"GN iters {[e['gn_iters'] for e in fl]}, frame_ms "
            f"{', '.join(f'{x:.2f}' for x in frame)}: {1e3 / mean(frame):.2f} "
            f"fps, frames 2-5 {1e3 / mean(frame[1:]):.2f} fps [{smi}]")


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="checkout of an earlier commit to compare")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("track_bench: CUDA is not available; this needs a card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, OWN_ROOT)
    import subprocess

    from gradient_sdf_tpu_torch.data import synth
    from gradient_sdf_tpu_torch.tools.fusion_bench import golden_protocol

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    dev = torch.device("cuda")
    _, depths, _ = golden_protocol()
    golden_phase([torch.as_tensor(d, device=dev) for d in depths],
                 synth.KINECT_K, smi)
    if args.parent:
        app_turns(os.path.abspath(args.parent), smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
