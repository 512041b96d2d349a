#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`gradient_sdf_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, checks each against its
plain PyTorch version on the card, checks card fusion against the port on
the CPU, holds fusion's two-launch kernel (`csrc/fuse_integrate.cu`) to its
plain passes frame by frame on the golden protocol, the box world and every
fusion option, and counts a fused frame's launches and host syncs (phase
3b), then drives the Scan3D main path through its CLI entry point on
the golden protocol (640x480 spheres, seed 2, 6 frames over a 4 degree
arc, 2 cm voxels, app-default 16384-block grid) in tracking and in GT-pose
mode, and checks what comes out. Then the second executable: PhotoBA
through its CLI entry point on 14 VGA frames over a 10 degree arc
(tracking + fusion with visibility bits, keyframes, BA, colour upsampling
and the high-resolution exports; phase 6), the same app on textured
spheres from ground-truth poses with BA started from perturbed poses
(phase 6b: BA has to win energy and pose error back), and one BA
alternation at F = 30 keyframes x V = 102400 voxels x 640x480 images, card
against CPU (phase 7). Phase 4b holds the GN loop kernel (one launch a
tracked frame) to its plain version at every iteration of golden frames 1-5,
with its one-pass launch and the mesh's step kernel, and times tracking
through it beside the plain loop with and without the packed rows
(`tools/track_bench.py`); phases 8-9 hold the march kernel to its plain version and
render; phase 10 runs the base-SDF ablation and checkpoint/resume. Phase 11
checks the host PNG and JPEG decoders built here; phase 12 the box world at
VGA (make_synth, Scan3D at 1 cm, the gradient analysis on the card, a
render's march bit for bit); phase 13 Scan3D through the Printed3D and
Redwood loaders; phase 14 a 60-frame noisy sequence, grad-SDF gated on ATE.
Phase 15 runs the mesh: 4 ranks as 2 rays x 2 blocks on the cards this
machine has (on one card they share it under gloo, and say so), in one
group, through the apps' entry points: Scan3D --devices 4 tracking and from
ground-truth poses against phases 4 and 5, a cut and resumed mesh run, a
sharded render of the render scene bit for bit against the unsharded one,
one sharded BA alternation at phase 7's scale point against one card, and
PhotoBA --sharded-ba on phase 6b's textured spheres. Phase 16 replays
phase 14's frames from a TUM folder whose PNGs cycle through filters 0-4:
the folder read synchronously and through the decode-ahead reader (equal
byte for byte), then Scan3D --data-type tum in turns decoding ahead and
synchronously (load_ms, track_ms, fuse_ms, loop_fps, the reader's peak of
resident images, ATE gated as phase 14's); 16b meshes phase 4's map through
the C vertex dedup and through its plain twin, bit for bit.
Every phase raises on failure, which ends the run non-zero. Needs one CUDA
card; fails at once without one. Scratch files go to `smoke_out/` under the
checkout.

Output: one line of numbers per phase; then the card's name and power
limit (`nvidia-smi`), a JSON line `{"kernels": [...]}` with each kernel's
launch count on the main paths (each counted from zero, and named in
`launches_counted_in`; one card's fusion launches the two `fuse_integrate`
passes, the mesh's the scatter kernel and `merge_clear`), its largest error
against the plain version, its
time beside the plain version's, the bound and (for the scatter and its
F = 1 launch, `scatter_add_rows`) the bare `index_add_` as the library
yardstick, on golden frame 5's real samples and, for the march, on the
render scene's rays, for the GN kernels on golden frame 5's points (the
loop kernel per frame from its start pose; `torch.linalg.solve_ex` on the
6x6 as the step's yardstick); phase 2b also times an empty kernel, the
launch floor beside `merge_clear`, and phase 4b beside the GN kernels; and
last
`{"ok": true, "device": {...}}`.
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
# the march kernel vs its plain version on the card: the kernel's source is
# built without fused multiply-adds and applies the plain version's float32
# operations in its order, so every ray must agree bit for bit
MARCH_RAYS_DIFFERING = 0
# a render on the card vs the same grid rendered on the CPU (plain march):
# the marches are the same IEEE operations, but the rays come from a
# [N,3] x [3,3] product and a norm whose sums the two devices order
# differently, and a probe within an ulp of a voxel plane then reads the
# neighbouring voxel. The JAX-vs-port CPU test's allowances are used: hit
# masks on at most 0.5% of the hits, depth median 1e-5 m, 99.5% under 1e-4
# m, the rest under 1.5 voxels.
RENDER_HIT_FLIPS = 0.005
RENDER_DEPTH_MEDIAN, RENDER_DEPTH_TAIL = 1e-5, 1e-4
# a checkpointed, cut and resumed run vs the uninterrupted one, both on the
# card. Float atomics reorder fusion's sums from run to run, so two maps
# differ in their last bits.
# With ground-truth poses nothing amplifies that: the resumed map must hold
# the same observed voxels as the uninterrupted one, with dist equal to
# RESUME_GT_DIST. This is the check of the restored device state (map,
# accumulator, counter).
# With tracking, GN turns the last bits into pose differences of the size of
# its stopping rule: iteration ends once a step is shorter than 1e-3 and that
# step is not applied, so one run may take a last step of up to 1e-3 that the
# other skips, on every frame. Two UNINTERRUPTED runs differ the same way, so
# the gate is RESUME_POSE_FACTOR times the difference between phase 4's
# warm-up and measured run in this same process, or times RESUME_POSE_FLOOR
# (half a stopping step) where those two happen to agree better. The map
# follows the poses: dist p99 within the same bound. The start index and the
# warm start are device-independent code that the CPU test holds bit-exact
# (tests/test_torch_checkpoint.py: one fixed summation order there).
RESUME_GT_SHARED_MIN = 0.9999   # share of observed voxels in both maps
RESUME_GT_DIST = 1e-5           # m, max |err| on the shared voxels
RESUME_POSE_FACTOR = 3.0
RESUME_POSE_FLOOR = 5e-4        # m, and rotation matrix entries
RESUME_SHARED_MIN = 0.99        # tracked runs: share of observed voxels
BASE_SDF_ERR_LIMIT = 0.02       # m, relative translation error
# phase 4b: grad-mode tracking with and without packed rows queries the
# same fields with the same operations; the two poses may part by at most a
# skipped stopping step (the resume gate's floor)
PACK_POSE_TOL = RESUME_POSE_FLOOR
# phase 12: the stored gradients of the VGA box map against the analytic box
# normals, first bin (|D| < one voxel): the JAX package's box stage measured a
# 0.22 degree median at VGA (PARITY.md)
BOX_STORED_MEDIAN_DEG = 1.0
# phase 14: the noisy sequence, at the JAX test's bounds
# (tests/test_long_sequence.py): ATE RMSE and unconverged frames
NOISY_ATE_LIMIT = 0.03          # m
NOISY_FRAMES = 60
NOISY_UNCONVERGED_MAX = NOISY_FRAMES // 2
JPEG_FIXTURES = os.path.join(ROOT, "tests", "data", "jpeg")
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
    """Build the kernels; fail on register spills, and on a scatter kernel
    whose machine code holds no vector reduction."""
    import re
    from gradient_sdf_tpu_torch.ops.kernels import _build

    lib = _build.load()
    for name in ("gsdf_scatter_add_f32", "gsdf_merge_clear_f32",
                 "gsdf_raycast_march_f32", "gsdf_gn_track_loop_f32",
                 "gsdf_gn_step_f32", "gsdf_gn_cluster_shape",
                 "gsdf_fuse_claim_f32", "gsdf_fuse_integrate_f32",
                 "gsdf_fuse_integrate_shape"):
        getattr(lib, name)   # AttributeError if the library lacks a kernel
    ptxas = [l.strip() for l in _build.build_log.splitlines() if "ptxas" in l
             or "spill" in l]
    # each spill line follows the "Function properties for <kernel>" line
    spills = [f"{ptxas[i - 1]}: {l}" for i, l in enumerate(ptxas)
              if re.search(r"[1-9]\d* bytes spill", l)]
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
    return max(errs.values()), errs["rows F=1"]


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
    # `scatter_add_rows` itself on the same weights, against its plain version
    got1 = sa.scatter_add_rows(lin, s.w, nvox)
    want1 = sa.scatter_add_rows_reference(lin, s.w, nvox)
    rows_err = float((got1 - want1).abs().max())
    if not torch.allclose(got1, want1, atol=ATOL, rtol=RTOL):
        raise AssertionError(f"in-situ scatter_add_rows vs plain max |err| {rows_err}")
    del got1, want1
    log(f"phase2b scatter F=1 (scatter_add_rows' launch) in situ, frame 5: "
        f"kernel {rows_ms:.4f} ms, plain {rows_plain:.4f} ms, library_ms "
        f"(index_add_) {rows_lib:.4f}, byte bound {rows_bound:.5f} ms; "
        f"scatter_add_rows vs plain max_abs_err {rows_err:.3g}")
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
    # the launch floor: a kernel that does nothing, timed the same way, at
    # merge_clear's launch shape (its grid-stride loop's blocks x 256) and
    # at one warp
    from gradient_sdf_tpu_torch.ops.kernels import _build

    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    merge_blocks = min(-(-nvox // 256), 132 * 8)

    def empty(blocks, threads):
        if lib.gsdf_empty_launch(blocks, threads, stream) != 0:
            raise AssertionError("the empty kernel did not launch")

    empty_ms = median_ms(lambda: empty(merge_blocks, 256))
    empty_warp_ms = median_ms(lambda: empty(1, 32))
    above = merge_ms - empty_ms
    share = merge_bound / above if above > 0 else float("inf")
    log(f"phase2b launch floor: an empty kernel {empty_ms:.4f} ms at "
        f"merge_clear's {merge_blocks} x 256, {empty_warp_ms:.4f} ms at 1 x 32; "
        f"merge_clear {merge_ms:.4f} ms is {above:.4f} ms above the floor, "
        f"where its byte bound {merge_bound:.5f} ms is {share * 100:.1f}% of it")
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
                  "library_ms": None, "empty_launch_ms": empty_ms},
        "rows": {"max_abs_err": rows_err, "ms": rows_ms,
                 "plain_ms": rows_plain, "bound_ms": rows_bound,
                 "library_ms": rows_lib},
    }


def golden_frame():
    """Frame 0 of the golden protocol, depth rounded to mm as its PNG."""
    import numpy as np
    from gradient_sdf_tpu_torch.data import synth

    world = synth.random_spheres(seed=2, device="cpu")
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


def phase_fuse_integrate(smi):
    """Phase 3b: fusion's kernel (`csrc/fuse_integrate.cu`: a claim pass
    and one cooperative integrate-and-merge launch a frame) against its
    plain versions on the card, frame by frame (`fusion_bench.kernel_vs_twin`:
    claims, slot ids, directory, coarse occupancy, block coordinates, block
    count, overflow, oob and visibility words bit for bit, fields within
    FUSE_TOL, accumulator and marks zero) on golden frames 0-5, the box
    world at 1 cm and every FusionConfig option the walk honours; then its
    times on golden frame 5 beside its bound, its plain versions and its
    launch floor, and a fused frame's launches and host syncs."""
    import dataclasses

    import torch
    from gradient_sdf_tpu_torch.data import synth
    from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap
    from gradient_sdf_tpu_torch.tools import fusion_bench as fb

    dev = torch.device("cuda")
    K = synth.KINECT_K
    cfg, depths, poses = fb.golden_protocol()
    bcfg, bdepths, bposes = fb.box_protocol()

    def fusion_cfg(**kw):
        return dataclasses.replace(cfg, fusion=dataclasses.replace(cfg.fusion, **kw))

    def grid_cfg(**kw):
        return dataclasses.replace(cfg, grid=dataclasses.replace(cfg.grid, **kw))

    few = (depths[:3], poses[:3])
    cases = [("golden frames 0-5", cfg, depths, poses, {}),
             ("box world frames 0-5 at 1 cm", bcfg, bdepths, bposes, {}),
             ("keyframe slot 33", cfg, *few, {"kf_slot": 33}),
             ("fusion_stride 2", fusion_cfg(fusion_stride=2), *few, {}),
             ("cosine_correction", fusion_cfg(cosine_correction=True), *few, {}),
             ("no gradients", cfg, *few, {"accumulate_gradients": False}),
             ("median blur", fusion_cfg(median_blur_depth=True), *few, {}),
             ("64-block capacity", grid_cfg(num_blocks=64), *few, {}),
             ("dir_dim 8", grid_cfg(dir_dim=8), *few, {})]
    err = {"weight": 0.0, "dist": 0.0, "grad": 0.0}
    for name, c, d, p, kw in cases:
        r = fb.kernel_vs_twin(c, d, p, K, dev, FUSE_TOL, **kw)
        if name == "64-block capacity" and not r["overflow"]:
            raise AssertionError(f"{name}: {r['blocks']} blocks, no overflow")
        if name == "dir_dim 8" and r["oob"] <= 0:
            raise AssertionError(f"{name}: no sample outside the directory")
        for k in err:
            err[k] = max(err[k], r[k])
        vis = "keyframe words, " if "kf_slot" in kw else ""
        log(f"  phase3b {name}: {r['frames']} frames, {r['misses']} missing "
            f"samples claimed, {r['oob']} oob, {r['blocks']} blocks; claims, "
            f"slots, directory, coarse_occ, {vis}overflow, oob equal; max "
            f"|err| weight {r['weight']:.3g} dist {r['dist']:.3g} grad "
            f"{r['grad']:.3g}")

    def golden_map(n):
        m = GradSdfMap(cfg, device=dev)
        for i in range(n):
            m.update(depths[i], K, poses[i])
        return m

    d5 = torch.as_tensor(depths[5], device=dev)
    R5, t5 = (torch.as_tensor(a, dtype=torch.float32, device=dev)
              for a in poses[5])
    tm = fb.fuse_kernel_times(golden_map(5), d5, R5, t5)
    b = tm["bounds"]
    # a fused frame's launches and syncs: frame 5 opens blocks, the same
    # frame fused again opens none
    m = golden_map(5)
    before = int(m.grid.num_active)
    grew = fb.count_fuse_frame(m, d5, R5, t5)
    opened = int(m.grid.num_active) - before
    again = fb.count_fuse_frame(m, d5, R5, t5)
    if int(m.grid.num_active) != before + opened:
        raise AssertionError("fusing a frame again opened blocks")
    for c, want_insert in ((grew, opened > 0), (again, False)):
        if not (c["claim"] == c["integrate"] == 1
                and c["scatter_add"] == c["merge_clear"] == 0
                and c["status_syncs"] == 1 and c["other_syncs"] == 0
                and (c["insert_syncs"] > 0) == want_insert):
            raise AssertionError(f"fused frame: {c}, {opened} blocks opened")
    log(f"phase3b times, golden frame 5 ({tm['misses']} missing samples, "
        f"{b['sectors']} directory sectors, {b['rows']} touched rows in "
        f"{b['blocks']} blocks; integrate grid {tm['shape'][0]} x "
        f"{tm['shape'][1]} CTAs of {tm['shape'][2]}) [{smi}]: claim "
        f"{tm['claim_ms']:.4f} ms (bound {b['claim'][0]:.5f}, {b['claim'][1]}; "
        f"plain {tm['claim_plain_ms']:.4f}), integrate + merge "
        f"{tm['integrate_ms']:.4f} ms (bound {b['integrate'][0]:.5f}, "
        f"{b['integrate'][1]}; plain {tm['integrate_plain_ms']:.4f}; empty "
        f"cooperative launch {tm['coop_empty_ms']:.4f})")
    log(f"phase3b a fused frame: {grew['claim']} claim + {grew['integrate']} "
        f"integrate launches, scatter_add {grew['scatter_add']}, merge_clear "
        f"{grew['merge_clear']}; {grew['device_ops']} device ops and "
        f"{grew['status_syncs']} + {grew['insert_syncs']} host syncs (status "
        f"read + insert_new) opening {opened} blocks; {again['device_ops']} "
        f"device ops and {again['status_syncs']} + {again['insert_syncs']} "
        f"host syncs opening none")
    stats = {"claim": {"max_abs_err": 0.0, "ms": tm["claim_ms"],
                       "plain_ms": tm["claim_plain_ms"],
                       "bound_ms": b["claim"][0], "bound_by": b["claim"][1],
                       "library_ms": None},
             "integrate": {"max_abs_err": max(err.values()),
                           "ms": tm["integrate_ms"],
                           "plain_ms": tm["integrate_plain_ms"],
                           "bound_ms": b["integrate"][0],
                           "bound_by": b["integrate"][1], "library_ms": None,
                           "empty_launch_ms": tm["coop_empty_ms"]}}
    return stats


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


def run_app(data, results, extra, data_type="synth", voxel_size="0.02"):
    from gradient_sdf_tpu_torch.apps import scan3d

    metrics_path = os.path.join(results, "metrics.json")
    scan3d.main(["--input", data, "--results", results, "--data-type", data_type,
                 "--voxel-size", voxel_size, "--trunc", "5", "--device", "cuda",
                 "--metrics-json", metrics_path] + extra)
    with open(metrics_path) as f:
        return json.load(f)


def kernel_modules():
    from gradient_sdf_tpu_torch.ops.kernels import fuse_integrate as fi
    from gradient_sdf_tpu_torch.ops.kernels import gn_track as gt
    from gradient_sdf_tpu_torch.ops.kernels import merge_clear as mc
    from gradient_sdf_tpu_torch.ops.kernels import raycast_march as rm
    from gradient_sdf_tpu_torch.ops.kernels import scatter_add as sa

    return {"scatter_add": sa, "merge_clear": mc, "raycast_march": rm,
            "gn_residual_reduce": gt, "fuse_integrate": fi}


def reset_launch_counts():
    for mod in kernel_modules().values():
        mod.reset_launch_count()


def launch_counts():
    counts = {name: mod.launch_count for name, mod in kernel_modules().items()}
    counts["scatter_add_rows"] = kernel_modules()["scatter_add"].rows_launch_count
    gt = kernel_modules()["gn_residual_reduce"]
    counts["gn_step"] = gt.step_launch_count
    counts["gn_track_loop"] = gt.loop_launch_count
    counts["fuse_claim"] = kernel_modules()["fuse_integrate"].claim_launch_count
    return counts


# one card fuses a frame in the two launches of fuse_integrate.cu (claim
# pass, integrate-and-merge pass) and launches neither the scatter kernel
# nor merge_clear; each rank of a mesh scatters and merges its shard with
# those two and launches no fuse_integrate pass
FUSION_KERNELS = ("fuse_claim", "fuse_integrate")
MESH_FUSION_KERNELS = ("scatter_add", "merge_clear")
# one card tracks a frame in one launch of the loop kernel; a mesh rank runs
# the one-pass launch and the step kernel once per GN iteration
TRACKED = FUSION_KERNELS + ("gn_track_loop",)
MESH_TRACKED = MESH_FUSION_KERNELS + ("gn_residual_reduce", "gn_step")


def check_fusion_launches(launches, fused, ranks=1):
    """One card: each fuse_integrate launch once per fused frame, the
    scatter kernel and merge_clear never; a mesh of `ranks`: the scatter
    kernel and merge_clear once per fused frame and rank, fuse_integrate
    never."""
    on, off = ((FUSION_KERNELS, MESH_FUSION_KERNELS) if ranks == 1
               else (MESH_FUSION_KERNELS, FUSION_KERNELS))
    if (fused <= 0 or any(launches[k] != ranks * fused for k in on)
            or any(launches[k] != 0 for k in off)):
        raise AssertionError(
            f"kernel launches {launches} for {fused} fused frames on {ranks} "
            f"rank(s): want {on} once per frame and rank, {off} never")


def check_track_launches(m, launches, ranks=1):
    """On one card a tracked run launches the GN loop kernel once per
    tracked frame and neither the one-pass launch nor the step kernel; on
    each rank of a mesh it launches the one-pass launch and the step kernel
    once per GN iteration and the loop kernel never."""
    frames = sum(e["gn_iters"] is not None for e in m["frame_log"])
    iters = ranks * sum(e["gn_iters"] or 0 for e in m["frame_log"])
    if ranks == 1:
        ok = (frames > 0 and launches["gn_track_loop"] == frames
              and launches["gn_residual_reduce"] == launches["gn_step"] == 0)
        want = f"one loop launch per frame for {frames} tracked frames"
    else:
        ok = (iters > 0 and launches["gn_track_loop"] == 0
              and launches["gn_residual_reduce"] == launches["gn_step"] == iters)
        want = (f"one one-pass and one step launch per GN iteration and rank "
                f"for {iters}")
    if not ok:
        raise AssertionError(f"kernel launches {launches}; want {want}")


def check_outputs(m, results, launches, n_frames, cloud=True):
    from gradient_sdf_tpu_torch.utils.ply import load_ply

    if m["invalid_frames"]:
        raise AssertionError(f"invalid frames {m['invalid_frames']}")
    if m["overflow"] or m["num_blocks_active"] <= 0 or m["frames"] != n_frames:
        raise AssertionError(f"bad map state {m}")
    fused = sum(1 for e in m["frame_log"] if e["fuse_ms"] is not None)
    # the main path launches each fusion kernel exactly once per fused frame
    check_fusion_launches(launches, fused)
    mesh = load_ply(os.path.join(results, "gradient_sdf_mesh_final.ply"))
    cloud_path = os.path.join(results, "gradient_sdf_cloud_final.ply")
    n_faces = len(mesh.get("face", []))
    n_pts = len(load_ply(cloud_path)["vertex"]) if cloud else None
    if not cloud and os.path.exists(cloud_path):
        raise AssertionError("a point cloud was written where none is due")
    if n_faces <= 0 or (cloud and n_pts <= 0):
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
    m = run_app(data, results, ["--pose-file", "none", "--save-sdf"])
    launches = launch_counts()
    fused, n_faces, n_pts = check_outputs(m, results, launches, n_frames)
    check_track_launches(m, launches)
    errs = rel_translation_errors(results, data)
    if not max(errs) < 0.01:
        raise AssertionError(f"relative translation errors {errs} (limit 1 cm)")
    fps, fps_steady = frame_summary("track", m)
    log(f"phase4 scan3d tracking: {m['frames']} frames, {fused} fused, "
        f"{m['num_blocks_active']} blocks, {n_faces} faces, {n_pts} cloud "
        f"points, kernel launches {launches}, max rel. translation error "
        f"{max(errs) * 1e3:.3f} mm; {fps:.2f} fps all frames, "
        f"{fps_steady:.2f} fps frames 1-{n_frames - 1}")
    return launches, m, max(errs)


def phase_gt(data, n_frames):
    results = os.path.join(WORK, "gt")
    reset_launch_counts()
    m = run_app(data, results, ["--pose-file", "gt_poses.txt", "--save-sdf"])
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
    check_fusion_launches(launches, fused)
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
                     "--gray-texture", "--device", "cuda"])
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
    return ms


def same_march(got, want, what):
    """Kernel result `got` against the plain version's `want`: every ray's
    found, s_mid, s_star (and, for a counting launch, probe and sector
    counts and the sector marks) equal bit for bit."""
    import torch

    differ = ((got.found != want.found) | (got.s_mid != want.s_mid)
              | (got.s_star != want.s_star))
    if got.stats is not None:
        differ |= (got.stats != want.stats).any(dim=1)
    marks = int((got.touched != want.touched).sum()) if got.touched is not None else 0
    if int(differ.sum()) > MARCH_RAYS_DIFFERING or marks > MARCH_RAYS_DIFFERING:
        raise AssertionError(f"raycast_march {what}: {int(differ.sum())} of "
                             f"{differ.numel()} rays and {marks} sector marks "
                             f"differ from the plain version; want bit equality")
    if not bool(torch.equal(got.found, want.found)):
        raise AssertionError(f"raycast_march {what}: found differs")


def march_shapes_check(scene):
    """The shift-and-mask instances for block shapes 2, 4, 16 and 32 and the
    runtime-divisor instance (6) on grids fused at those shapes from the
    render scene's world (4 frames at 320x240, 1 cm voxels, the same voxel
    capacity): counting and timed launch, rays in their order and tiled,
    against the plain version. Returns one note per shape."""
    import dataclasses

    import numpy as np
    import torch
    from gradient_sdf_tpu_torch.data import synth
    from gradient_sdf_tpu_torch.ops import fusion, normals, raycast
    from gradient_sdf_tpu_torch.ops import voxel_grid as vg
    from gradient_sdf_tpu_torch.ops.kernels import raycast_march as rm
    from gradient_sdf_tpu_torch.tools import raycast_bench as rb

    _, gcfg, fcfg, world, poses = scene
    dev = torch.device("cuda")
    notes = []

    def check_all(args, gcfg_, width, what):
        want = rm.raycast_march_reference(*args, gcfg_, fcfg, stats=True)
        for w in (None, width):
            for stats in (True, False):
                got = rm.raycast_march(*args, gcfg_, fcfg, stats=stats, width=w)
                torch.cuda.synchronize()
                same_march(got, want, f"{what}, {'tiled' if w else 'flat'}, "
                           f"{'counting' if stats else 'timed'} instance")
        return int(want.found.sum()), float(want.stats[:, 0].float().mean())

    w, h = rb.W // 2, rb.H // 2
    K = np.array(synth.KINECT_K, dtype=np.float32)
    K[:2] *= 0.5
    cache = normals.build_cache(w, h, K, fcfg.normal_window, dev)
    for b in (2, 4, 16, 32, 6):
        g_cfg = dataclasses.replace(gcfg, block_shape=b,
                                    num_blocks=gcfg.num_blocks * 512 // b**3,
                                    dir_dim=256 if b <= 4 else 128)
        g = vg.create(g_cfg, dev)
        acc = fusion.new_accumulator(g)
        for R, t in poses[::4]:
            depth = synth.render_depth(world, R, t, K, w, h)
            g = fusion.fuse_frame(g, depth, cache, torch.as_tensor(R, device=dev),
                                  torch.as_tensor(t, device=dev), g_cfg, fcfg, acc=acc)
        if bool(g.overflow):
            raise AssertionError(f"block shape {b}: the grid overflowed")
        R, t = poses[4]
        o, d, _ = raycast.camera_rays(K, R, t, w, h, device=dev)
        n = o.shape[0]
        args = (o.contiguous(), d.contiguous(), torch.full((n,), rb.S_MIN, device=dev),
                torch.full((n,), rb.S_MAX, device=dev), g.directory, g.coarse_occ,
                g.dist, g.weight)
        found, probes = check_all(args, g_cfg, w, f"block shape {b}")
        if not 0.1 * n < found < 0.9 * n:
            raise AssertionError(f"block shape {b}: march found {found} of {n} rays")
        notes.append(f"block shape {b} ({int(g.num_active)} blocks): {found} of {n} "
                     f"found, {probes:.2f} probes per ray, 0 differ")
        del g, acc
    return notes


def phase_march():
    """`raycast_march` vs `raycast_march_reference` on the card on every ray
    of the render scene's pose 4, unwindowed and inside the raster windows,
    with the rays in their order and in the pixel tiles a render uses: both
    instances (counting and timed) bit for bit; then the kernel timed, with
    its machine code, the SM clock and the issue slots per warp-probe; then
    every other instance (`march_shapes_check`). Returns (scene, the numbers
    of the tiled unwindowed pass: the render's full-resolution launch)."""
    import torch
    from gradient_sdf_tpu_torch.ops.kernels import _build
    from gradient_sdf_tpu_torch.ops.kernels import raycast_march as rm
    from gradient_sdf_tpu_torch.tools import raycast_bench as rb

    t0 = time.perf_counter()
    scene = rb.render_scene(torch.device("cuda"))
    torch.cuda.synchronize()
    grid, gcfg, fcfg, _, poses = scene
    log(f"phase8 render scene: 16 frames 640x480 fused at 1 cm into "
        f"{int(grid.num_active)} of {grid.num_blocks} blocks in "
        f"{time.perf_counter() - t0:.2f} s")
    code = [c for c in rb.march_code(_build.lib_path, _build.build_log, rm.THREADS)
            if not c["stats"]]
    main_code = next(c for c in code if c["log2_block"] == 3)
    args = rb.march_args(grid, gcfg, *poses[4], False)
    mhz = rb.sm_clock_while(lambda: rm.raycast_march(*args, gcfg, fcfg, width=rb.W))
    log(f"phase8 march code: block shape 8 instance {main_code['registers']} "
        f"registers ({main_code['warps_per_sm']} warps per SM at "
        f"{rm.THREADS} threads), {main_code['sass']} SASS instructions, "
        f"{main_code['sass_loop']} in the march loop; all timed instances: "
        + ", ".join(f"log2 {c['log2_block']}: {c['registers']} reg, loop "
                    f"{c['sass_loop']}" for c in code)
        + f"; SM clock while it runs {mhz[0]:.0f}-{mhz[2]:.0f} MHz")
    out = {}
    for windowed in (False, True):
        for width in (None, rb.W):
            r = rb.march_check_and_time(grid, gcfg, fcfg, *poses[4], windowed,
                                        width, plain=width is None)
            if (r["rays_differing"] > MARCH_RAYS_DIFFERING
                    or r["touched_differing"] > MARCH_RAYS_DIFFERING):
                raise AssertionError(
                    f"raycast_march vs plain, windowed={windowed} width={width}: "
                    f"{r['rays_differing']} of {r['rays']} rays differ "
                    f"({r['found_differing']} in found), max |s_star err| "
                    f"{r['max_abs_err']}, {r['touched_differing']} sector marks "
                    f"differ; want bit equality")
            if not 0.1 * r["rays"] < r["found"] < 0.9 * r["rays"]:
                raise AssertionError(f"march found {r['found']} of {r['rays']} rays")
            slots = rb.issue_slots_per_warp_probe(r["ms"], r["warp_probes"],
                                                  mhz[1] * 1e6)
            plain = (f"plain {r['plain_ms']:.1f} ms (one call, host clock)"
                     if r["plain_ms"] is not None else "plain as above")
            log(f"phase8 raycast_march vs plain, "
                f"{'raster windows' if windowed else 'unwindowed'}, "
                f"{'8x4 pixel tiles' if width else 'rays in order'}: {r['rays']} rays, "
                f"{r['found']} found, {r['rays_differing']} rays differ (found, s_mid, "
                f"s_star, probe counts; counting and timed instance; bit equality), "
                f"max_abs_err {r['max_abs_err']:.3g}; probes per ray mean "
                f"{r['probes_mean']:.2f} p99 {r['probes_p99']:.0f} max "
                f"{r['probes_max']}, {r['sectors']} gathers of a 32 B sector, "
                f"{r['distinct_sectors']} distinct sectors; kernel {r['ms']:.4f} ms "
                f"({r['gathered_gb_per_s']:.0f} GB/s gathered), {plain}, bound_ms "
                f"{r['bound_ms']:.5f} by {r['bound_by']} (bytes, ray state + each "
                f"distinct sector once: {r['bytes_bound_ms']:.5f}; operations of the "
                f"probes made at the issue rates: {r['ops_bound_ms']:.5f}; "
                f"{r['bound_ms'] / r['ms']:.1%} reached), warp lanes in use "
                f"{r['warp_lane_use']:.3f}, {r['warp_probes']:.0f} warp-probes, "
                f"{slots:.0f} issue slots per warp-probe at {mhz[1]:.0f} MHz "
                f"(the loop is {main_code['sass_loop']} SASS instructions), "
                f"library_ms null")
            out[windowed, width] = r
    for note in march_shapes_check(scene):
        log(f"phase8 every instance vs plain: {note}")
    keys = ("max_abs_err", "ms", "bound_ms", "bound_by", "library_ms")
    stats = {k: out[False, rb.W][k] for k in keys}
    stats["plain_ms"] = out[False, None]["plain_ms"]
    stats["max_abs_err"] = max(r["max_abs_err"] for r in out.values())
    return scene, stats


def same_render(got, want, what, voxel):
    """The two renders' hit masks and depths within RENDER_*; returns a
    summary for the log."""
    import numpy as np

    (dg, hg), (dw, hw) = got, want
    n_hit = max(int(hw.sum()), 1)
    flips = int((hg ^ hw).sum())
    both = hg & hw
    err = np.abs(dg[both] - dw[both])
    rest = int((err >= RENDER_DEPTH_TAIL).sum())
    if (flips > RENDER_HIT_FLIPS * n_hit or np.median(err) >= RENDER_DEPTH_MEDIAN
            or np.quantile(err, 0.995) >= RENDER_DEPTH_TAIL
            or err.max() >= 1.5 * voxel):
        raise AssertionError(
            f"{what}: {flips} of {n_hit} hits differ, depth median "
            f"{np.median(err)}, {rest} beyond {RENDER_DEPTH_TAIL}, max {err.max()}")
    return (f"{flips} of {n_hit} hits differ, depth median {np.median(err):.3g} "
            f"max {err.max():.3g} m, {rest} beyond {RENDER_DEPTH_TAIL}")


def phase_render(scene):
    """`render_depth_normal` on the render scene in its four modes, with the
    gates of the JAX package's tests; the card's render against the CPU's."""
    import numpy as np
    import torch
    from gradient_sdf_tpu_torch.data import synth
    from gradient_sdf_tpu_torch.ops import voxel_grid as vg
    from gradient_sdf_tpu_torch.tools import raycast_bench as rb

    grid, gcfg, fcfg, world, poses = scene
    R, t = poses[4]
    vs = gcfg.voxel_size

    def host(res):
        return res[0].cpu().numpy(), res[2].cpu().numpy()

    reset_launch_counts()
    renders = {name: rb.render(grid, gcfg, fcfg, R, t, **kw)
               for name, kw in rb.RENDER_MODES.items()}
    renders["incremental"] = rb.render(grid, gcfg, fcfg, R, t,
                                       depth_prior=renders["stride4"][0],
                                       **rb.INCREMENTAL)
    torch.cuda.synchronize()
    launches = launch_counts()
    if launches["raycast_march"] != 5:   # two for the stride prior, one each else
        raise AssertionError(f"five marches expected, counted {launches}")
    normal = renders["stride4"][1]
    if not bool(torch.isfinite(normal).all()) or normal.shape != (rb.H, rb.W, 3):
        raise AssertionError("normal image malformed")
    d = {k: host(v) for k, v in renders.items()}

    # against the analytic depth of the same world (tests/test_raycast.py:47-51)
    gt = synth.render_depth(world, R, t, synth.KINECT_K, rb.W, rb.H).cpu().numpy()
    depth, hit = d["stride4"]
    overlap = hit & (gt > 0)
    med = float(np.median(np.abs(depth[overlap] - gt[overlap])))
    if not overlap.sum() > 0.7 * (gt > 0).sum() or not med < vs:
        raise AssertionError(f"render vs analytic: {overlap.sum()} of "
                             f"{(gt > 0).sum()} hits, median |err| {med}")
    # the windowed renders against the unwindowed one, and the incremental
    # render against the render its prior came from, with the gates of
    # tests/test_raycast.py (:99-106, test_raster_prior_matches_full_march,
    # test_depth_prior_tight_margin). One gate of that single-sphere test
    # does not carry over to the stride prior here: its bound on the LARGEST
    # depth difference (10 voxels). This scene has occlusion boundaries, and
    # a silhouette ray whose coarse neighbourhood saw only the far sphere
    # starts its window behind the near one (what `prior_miss_skip`'s note
    # calls geometry thinner than the prior stride); such rays are counted
    # and bounded by the 99.5% gate instead. The exact raster windows keep it.
    d0, h0 = d["no_prior"]
    notes = []
    for name, (dr, hr) in (("stride4", (d0, h0)), ("raster", (d0, h0)),
                           ("incremental", d["stride4"])):
        d1, h1 = d[name]
        both = hr & h1
        err = np.abs(d1[both] - dr[both])
        q = 0.99 if name == "incremental" else 0.995
        ok = np.quantile(err, q) < 1.5 * vs
        if name == "stride4":
            ok &= (hr ^ h1).sum() <= 0.02 * max(both.sum(), 1)
        elif name == "raster":   # exact culling: no hit lost, none invented
            ok &= not (hr & ~h1).any() and err.max() < 10 * vs
            ok &= (h1 & ~hr).sum() <= 0.005 * max(hr.sum(), 1)
        else:                    # holes stay misses, the prior's hits are kept
            ok &= not (h1 & ~hr).any() and both.sum() > 0.93 * hr.sum()
        off = int((err >= 1.5 * vs).sum())
        note = (f"{name} {int(h1.sum())} hits, {int((hr ^ h1).sum())} differ, depth "
                f"p{q * 100:g} {np.quantile(err, q):.3g} max {err.max():.3g} m, "
                f"{off} rays beyond 1.5 voxels")
        if not ok:
            raise AssertionError(f"render gates: {note}")
        notes.append(note)
    # the card against the CPU (plain march) on the same grid
    t0 = time.perf_counter()
    cpu_grid = vg.VoxelGrid(*(a.cpu() for a in grid))
    cpu = host(rb.render(cpu_grid, gcfg, fcfg, R, t))
    cpu_s = time.perf_counter() - t0
    if launch_counts()["raycast_march"] != 5:
        raise AssertionError("the CPU render launched the CUDA kernel")
    vs_cpu = same_render(d["stride4"], cpu, "card vs CPU render", vs)
    log(f"phase9 render_depth_normal {rb.W}x{rb.H}, 1 cm voxels: {int(hit.sum())} hits, "
        f"{int(overlap.sum())} of {int((gt > 0).sum())} analytic hits found, median "
        f"|depth err| {med * 1e3:.3f} mm (limit one voxel, {vs * 1e3:.0f} mm); vs "
        f"unwindowed (incremental: vs its prior's render): {'; '.join(notes)}; "
        f"card vs CPU (plain march, {cpu_s:.1f} s): "
        f"{vs_cpu}; raycast_march launches {launches['raycast_march']}")
    for name, kw in list(rb.RENDER_MODES.items()) + [
            ("incremental", dict(depth_prior=renders["stride4"][0], **rb.INCREMENTAL))]:
        r = rb.time_render(grid, gcfg, fcfg, R, t, **kw)
        log(f"  phase9 {name}: {r['ms']:.3f} ms per render (host clock, median of "
            f"5), {r['mrays_per_s']:.2f} Mrays/s, "
            f"{r['march_launches_per_render']} march launches")
    return launches


def sdf_dump(prefix):
    """--save-sdf dump -> {linear voxel index: dist}, with its grid_info."""
    import numpy as np

    with open(prefix + "_grid_info.txt") as f:
        info = f.read()
    a = np.loadtxt(prefix + "_sdf_d.txt", ndmin=2)
    return info, dict(zip(a[:, 0].astype(np.int64).tolist(), a[:, 1].tolist()))


def map_diff(prefix_a, prefix_b):
    """Two --save-sdf dumps: (observed voxels of a, of b, share of voxels in
    both, |dist a - dist b| on those)."""
    import numpy as np

    info_a, da = sdf_dump(prefix_a)
    info_b, db = sdf_dump(prefix_b)
    shared = sorted(set(da) & set(db)) if info_a == info_b else []
    frac = len(shared) / max(len(da), len(db), 1)
    err = np.abs(np.array([da[k] for k in shared]) - np.array([db[k] for k in shared]))
    return len(da), len(db), frac, err


def pose_diff(p, q):
    """Largest |difference| of rotation entries and translations between two
    trajectories, pose by pose in order."""
    import numpy as np

    return max(max(np.abs(x[1] - y[1]).max(), np.abs(x[2] - y[2]).max())
               for x, y in zip(p, q))


def cut_and_resume(data, results, pose_file, extra=()):
    """Scan3D through frame 3 with a checkpoint every 3 fused frames, then a
    second run resumed from that file. Returns (poses in the checkpoint, the
    resumed run's metrics)."""
    import numpy as np

    run_app(data, results, ["--pose-file", pose_file, "--last", "3",
                            "--checkpoint-every", "3"])
    ckpt = os.path.join(results, "checkpoint.npz")
    with np.load(ckpt) as z:
        counter, done = int(z["counter"]), len(z["pose_stamps"])
    # the last save of the cut run: 3 fused frames, after frame 2 or (had a
    # frame been rejected) frame 3
    if counter != 3 or not 3 <= done <= 4:
        raise AssertionError(f"checkpoint holds counter {counter}, {done} poses")
    return done, run_app(data, results, ["--pose-file", pose_file, "--save-sdf",
                                         "--resume", ckpt, *extra])


def phase_ablation_and_resume(data, n_frames, straight, straight_err):
    """Through the Scan3D CLI on the golden dataset: the base-SDF ablation
    with tracking; then grad-SDF checkpointed every 3 fused frames and cut
    after frame 3, resumed from the checkpoint, and compared with the
    uninterrupted run: from ground-truth poses with phase 5's, with
    tracking with phase 4's (`straight`, its metrics)."""
    import numpy as np
    from gradient_sdf_tpu_torch.utils import tumio

    results = os.path.join(WORK, "base_sdf")
    reset_launch_counts()
    m = run_app(data, results, ["--pose-file", "none", "--scan-type", "base-sdf"])
    launches = launch_counts()
    fused, n_faces, _ = check_outputs(m, results, launches, n_frames, cloud=False)
    check_track_launches(m, launches)
    errs = rel_translation_errors(results, data)
    if not max(errs) < BASE_SDF_ERR_LIMIT:
        raise AssertionError(f"base-sdf relative translation errors {errs}")
    track = [e["track_ms"] for e in m["frame_log"][1:]]
    log(f"phase10 scan3d --scan-type base-sdf: {m['frames']} frames, {fused} "
        f"fused (the integrate pass with F=2, its merge without gradients), "
        f"{m['num_blocks_active']} blocks, {n_faces} faces, no cloud, kernel "
        f"launches {launches}, max rel. translation error {max(errs) * 1e3:.3f} "
        f"mm (grad-sdf in phase 4: {straight_err * 1e3:.3f} mm), track "
        f"{min(track):.2f}-{max(track):.2f} ms")

    cut_gt = os.path.join(WORK, "resume_gt")
    done, m1 = cut_and_resume(data, cut_gt, "gt_poses.txt")
    na, nb, frac, err = map_diff(os.path.join(WORK, "gt", "gradient_sdf"),
                                 os.path.join(cut_gt, "gradient_sdf"))
    if not (m1["frames"] == n_frames - done and frac >= RESUME_GT_SHARED_MIN
            and err.max() <= RESUME_GT_DIST):
        raise AssertionError(
            f"resumed vs uninterrupted at ground-truth poses: {m1['frames']} "
            f"frames, shared voxels {frac:.6f} ({na} / {nb}), dist max |err| "
            f"{err.max() if len(err) else None}")
    log(f"phase10 ground-truth poses, checkpoint after 3 fused frames, resumed for "
        f"frames {done}-{n_frames - 1}: observed voxels {nb} vs {na} uninterrupted "
        f"(phase 5), shared {frac:.6f} (>= {RESUME_GT_SHARED_MIN}), dist max |err| "
        f"{err.max():.3g} m (<= {RESUME_GT_DIST})")

    cut = os.path.join(WORK, "resume")
    prof_dir = os.path.join(cut, "profile")
    done, m2 = cut_and_resume(data, cut, "none", ("--profile", prof_dir))
    # --profile: a Chrome trace of the resumed run's third frame, holding the
    # card's kernels (fusion's integrate kernel among them)
    traces = os.listdir(prof_dir) if os.path.isdir(prof_dir) else []
    if m2["frames"] >= 3:
        if len(traces) != 1:
            raise AssertionError(f"--profile wrote {traces}")
        with open(os.path.join(prof_dir, traces[0])) as f:
            trace = f.read()
        if '"cat": "kernel"' not in trace or "fuse_integrate" not in trace:
            raise AssertionError("the profile trace holds no device kernels")
    want_invalid = [i for i in straight["invalid_frames"] if i >= done]
    if m2["frames"] != n_frames - done or m2["invalid_frames"] != want_invalid:
        raise AssertionError(f"resumed run: {m2['frames']} frames, invalid "
                             f"{m2['invalid_frames']}")
    a = tumio.read_trajectory(os.path.join(WORK, "track", "_poses.txt"))
    b = tumio.read_trajectory(os.path.join(cut, "_poses.txt"))
    if [e[0] for e in a] != [e[0] for e in b] or len(b) != n_frames:
        raise AssertionError("resumed trajectory has other frames")

    pose_err = pose_diff(a, b)
    twice = pose_diff(a, tumio.read_trajectory(
        os.path.join(WORK, "warm", "_poses.txt")))
    na, nb, frac, err = map_diff(os.path.join(WORK, "track", "gradient_sdf"),
                                 os.path.join(cut, "gradient_sdf"))
    p99 = float(np.quantile(err, 0.99)) if len(err) else float("inf")
    tol = RESUME_POSE_FACTOR * max(twice, RESUME_POSE_FLOOR)
    if not (pose_err <= tol and frac >= RESUME_SHARED_MIN and p99 <= tol):
        raise AssertionError(
            f"resumed vs uninterrupted: poses max |err| {pose_err}, dist p99 "
            f"{p99} (tolerance {tol}; two uninterrupted runs differ by {twice}), "
            f"shared voxels {frac:.5f} ({na} / {nb})")
    log(f"phase10 tracking, checkpoint after 3 fused frames, cut after frame 3, "
        f"resumed for frames {done}-{n_frames - 1}: poses vs the uninterrupted run "
        f"max |err| {pose_err:.3g}, dist p99 |err| {p99:.3g} m (tolerance {tol:.3g} "
        f"= {RESUME_POSE_FACTOR:g} x the larger of {RESUME_POSE_FLOOR} and what two "
        f"uninterrupted runs differ by, {twice:.3g}), observed voxels {nb} vs {na}, "
        f"shared {frac:.6f} (>= {RESUME_SHARED_MIN}), invalid frames "
        f"{m2['invalid_frames']}; --profile trace {traces}")
    return launches


def synth_cfg(voxel_size):
    """The Scan3D app's configuration for `--data-type synth --voxel-size
    <voxel_size> --trunc 5`."""
    import dataclasses
    from gradient_sdf_tpu_torch import config as cfg_mod

    cfg = cfg_mod.preset("synth")
    return dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, voxel_size=voxel_size),
        fusion=dataclasses.replace(cfg.fusion, trunc_voxels=5.0))


def phase_pack(data, n_frames, smi):
    """Phase 4b: golden frames 1-5 through `tools/track_bench.golden_phase`:
    in grad and trilinear mode, at every GN iteration the loop kernel held
    to its plain version (its one-pass launch's sums, and itself, bit for
    bit; its step = the step kernel's bit for bit), its full run to the
    chain of its single iterations bit for bit; the step kernel on crafted
    systems; then each frame tracked in turns through the loop kernel and
    the plain loop with and without the packed rows (track_ms, one launch
    and two host reads a frame, no row pack on the card; the plain loop's
    two settings within PACK_POSE_TOL of each other, the kernel's path
    within MESH_POSE_TOL of them: its sums go in another order, as the
    sharded pass's do), and the three kernels timed beside their plain
    versions, bounds and launch floors."""
    import torch
    from gradient_sdf_tpu_torch.data import loaders
    from gradient_sdf_tpu_torch.tools import track_bench

    if (track_bench.PACK_POSE_TOL, track_bench.PATH_POSE_TOL) != (
            PACK_POSE_TOL, MESH_POSE_TOL):
        raise AssertionError("track_bench's pose tolerances are not phase "
                             "4b's and 15a's")
    dev = torch.device("cuda")
    loader = loaders.make_loader("synth", data)
    depths = [torch.as_tensor(f.depth, device=dev)
              for f in loader.frames(0, n_frames)]
    return track_bench.golden_phase(depths, loader.load_intrinsics(), smi)


def host_ms(fn, reps=5):
    """Median host-clock ms of `reps` calls of `fn` after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def phase_codecs():
    """Phase 11: the host decoders built on this machine. PNG: 640x480
    images whose rows cycle through all five filters, 8-bit RGB and 16-bit
    grey, read by `read_png` (native unfilter) and by `read_png` over the
    plain Python unfilter, equal to each other and to the image, with the
    ms of each. JPEG: the committed fixtures equal to PIL's stored decode."""
    import numpy as np
    from gradient_sdf_tpu_torch.data import jpeg, png

    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:480, 0:640]
    rgb = ((np.stack([x * 0.37 + y * 0.11 + 60 * k for k in range(3)], -1)
            + rng.integers(0, 12, (480, 640, 3))) % 256).astype(np.uint8)
    depth, _, _ = golden_frame()
    grey16 = np.round(depth * 1000.0).astype(np.uint16)
    grey16 += rng.integers(0, 3, grey16.shape).astype(np.uint16)
    filters = np.arange(480) % 5
    notes = []
    for name, img in (("8-bit RGB", rgb), ("16-bit grey", grey16)):
        path = os.path.join(WORK, "codec.png")
        png.write_png(path, img, filters=filters)
        got = png.read_png(path)
        native_ms = host_ms(lambda: png.read_png(path))
        native = png.unfilter
        png.unfilter = png._unfilter     # read_png over the plain version
        try:
            plain = png.read_png(path)
            plain_ms = host_ms(lambda: png.read_png(path), reps=3)
        finally:
            png.unfilter = native
        if not (np.array_equal(got, img) and np.array_equal(plain, img)):
            raise AssertionError(f"PNG {name}: read_png differs from the image")
        notes.append(f"{name} {native_ms:.2f} ms (plain unfilter {plain_ms:.1f} ms)")
    with np.load(os.path.join(JPEG_FIXTURES, "pil_decodes.npz")) as z:
        stored = {k: z[k] for k in z.files}
    for name, want in sorted(stored.items()):
        path = os.path.join(JPEG_FIXTURES, name)
        got = jpeg.read_jpeg(path)
        differ = int((got != want).sum()) if got.shape == want.shape else -1
        if differ:
            raise AssertionError(f"JPEG {name}: {differ} samples differ from PIL's")
        notes.append(f"{name} {'x'.join(map(str, want.shape))} "
                     f"{host_ms(lambda: jpeg.read_jpeg(path)):.2f} ms, 0 samples "
                     f"differ from PIL's")
    log("phase11 codecs, decode ms per 640x480 image (host clock, median of 5; "
        "PNG rows cycle through filters 0-4): " + "; ".join(notes))


def box_map(data, n_frames, voxel_size):
    """The box dataset fused from its ground-truth poses on the card, as
    `scan3d --pose-file gt_poses.txt` fuses it: (map, poses, intrinsics)."""
    import torch
    from gradient_sdf_tpu_torch.data import loaders
    from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap

    dev = torch.device("cuda")
    loader = loaders.make_loader("synth", data)
    K = loader.load_intrinsics()
    gt = loader.load_poses("gt_poses.txt")
    m = GradSdfMap(synth_cfg(voxel_size), device=dev)
    for f in loader.frames(0, n_frames):
        m.update(torch.as_tensor(f.depth, device=dev), K,
                 tuple(torch.as_tensor(a, device=dev) for a in gt[f.index][1:]))
    return m, gt, K


def phase_box(n_frames=6):
    """Phase 12: the box world at VGA. make_synth --world box on the card;
    Scan3D from ground-truth poses at 1 cm with --save-sdf; the gradient
    analysis on the card (stored gradients gated against the analytic box
    normals and against central differences); Scan3D with tracking on the
    same frames (printed, not gated: neither the reference nor the JAX
    package converges at 1e-3 on this scene, PARITY.md); then the march
    kernel against its plain version on every ray of a render of that map."""
    import numpy as np
    import torch
    from gradient_sdf_tpu_torch.apps import analyze, make_synth
    from gradient_sdf_tpu_torch.data import synth
    from gradient_sdf_tpu_torch.ops import raycast
    from gradient_sdf_tpu_torch.tools import raycast_bench as rb

    data = os.path.join(WORK, "box")
    make_synth.main(["--out", data, "--frames", str(n_frames), "--seed", "2",
                     "--width", "640", "--height", "480", "--arc-deg", "4",
                     "--no-noise", "--world", "box", "--device", "cuda"])
    results = os.path.join(WORK, "box_gt")
    reset_launch_counts()
    m = run_app(data, results, ["--pose-file", "gt_poses.txt", "--save-sdf"],
                voxel_size="0.01")
    gt_launches = launch_counts()
    fused, n_faces, n_pts = check_outputs(m, results, gt_launches, n_frames)
    t0 = time.perf_counter()
    res = analyze.main(["--sdf-prefix", os.path.join(results, "gradient_sdf"),
                        "--boxes", os.path.join(data, "boxes.txt"), "--device",
                        "cuda", "--json", os.path.join(results, "analysis.json")])
    analysis_s = time.perf_counter() - t0
    stored, central = res["stored"][0], res["central"][0]
    if not (stored["count"] > 1000 and stored["median"] < BOX_STORED_MEDIAN_DEG
            and stored["median"] < central.get("median", float("inf"))):
        raise AssertionError(f"box analysis, first bin: stored {stored}, "
                             f"central {central}")
    log(f"phase12 box world 640x480, {n_frames} frames, GT poses at 1 cm: {fused} "
        f"fused, {m['num_blocks_active']} blocks, {n_faces} faces, {n_pts} cloud "
        f"points, kernel launches {gt_launches}; analyze --boxes on the card "
        f"{analysis_s * 1e3:.0f} ms (dump parse included), first bin "
        f"|D| < {stored['bin'][1] * 1e3:.0f} mm: stored median "
        f"{stored['median']:.3f} deg over {stored['count']} voxels (limit "
        f"{BOX_STORED_MEDIAN_DEG}), central FD "
        f"{central.get('median', float('nan')):.3f}, forward "
        f"{res['forward'][0].get('median', float('nan')):.3f}, backward "
        f"{res['backward'][0].get('median', float('nan')):.3f} deg")

    track = os.path.join(WORK, "box_track")
    reset_launch_counts()
    mt = run_app(data, track, ["--pose-file", "none"], voxel_size="0.01")
    track_launches = launch_counts()
    check_track_launches(mt, track_launches)
    errs = rel_translation_errors(track, data)
    log(f"phase12 box world with tracking (not gated): invalid frames "
        f"{mt['invalid_frames']}, relative translation errors "
        f"{[round(e * 1e3, 2) for e in errs]} mm, kernel launches {track_launches}")

    bm, gt, K = box_map(data, n_frames, 0.01)
    gcfg, fcfg = bm.cfg.grid, bm.cfg.fusion
    R, t = gt[n_frames // 2][1:]
    world = synth.default_boxes(seed=2, device=torch.device("cuda"))
    reset_launch_counts()
    depth, _, hit = rb.render(bm.grid, gcfg, fcfg, R, t, prior_stride=0)
    torch.cuda.synchronize()
    render_launches = launch_counts()
    truth = synth.render_depth_boxes(world, R, t, K, rb.W, rb.H)
    both = hit & (truth > 0)
    med = float((depth - truth).abs()[both].median())
    # fusion drops a pixel seen at more than 60 degrees from its normal
    # (`view_angle_cos_sq`): most of the floor, here. The render is held to
    # the analytic pixels that pass that gate.
    o, dirs, inv_hnorm = raycast.camera_rays(K, R, t, rb.W, rb.H,
                                             device=truth.device)
    _, normal = synth.box_sdf(world, o + dirs * (truth.reshape(-1)
                                                 / inv_hnorm)[:, None])
    seen = ((dirs * normal).sum(-1) ** 2 >= fcfg.view_angle_cos_sq).reshape(
        truth.shape) & (truth > 0)
    if not (int(both.sum()) > 0.9 * int(seen.sum()) and med < gcfg.voxel_size):
        raise AssertionError(f"box render: {int(both.sum())} of "
                             f"{int((truth > 0).sum())} analytic hits "
                             f"({int(seen.sum())} within fusion's view angle), "
                             f"median |err| {med}")
    r = rb.march_check_and_time(bm.grid, gcfg, fcfg, R, t, False, rb.W)
    if r["rays_differing"] or r["touched_differing"]:
        raise AssertionError(f"box render: {r['rays_differing']} of {r['rays']} "
                             f"rays and {r['touched_differing']} sector marks "
                             f"differ from the plain march")
    log(f"phase12 box render (no prior) of the GT map from frame "
        f"{n_frames // 2}'s pose: {int(both.sum())} of {int((truth > 0).sum())} "
        f"analytic hits ({int(seen.sum())} within fusion's view angle), "
        f"median |depth err| {med * 1e3:.3f} mm; raycast_march "
        f"vs plain, unwindowed, 8x4 pixel tiles: {r['rays']} rays, {r['found']} "
        f"found, 0 rays and 0 sector marks differ (bit equality); probes per "
        f"ray mean {r['probes_mean']:.2f} p99 {r['probes_p99']:.0f} max "
        f"{r['probes_max']}, warp lanes in use {r['warp_lane_use']:.3f}, "
        f"{r['distinct_sectors']} distinct sectors; kernel {r['ms']:.4f} ms, "
        f"plain {r['plain_ms']:.1f} ms (host clock), bound_ms "
        f"{r['bound_ms']:.5f} by {r['bound_by']} (bytes "
        f"{r['bytes_bound_ms']:.5f}, march_ops_bound_ms {r['ops_bound_ms']:.5f}; "
        f"{r['bound_ms'] / r['ms']:.1%} reached)")
    return {"phase 12 (box scan3d GT poses)": (gt_launches, FUSION_KERNELS),
            "phase 12 (box scan3d tracking)": (track_launches, TRACKED),
            "phase 12 (box render)": (render_launches, ("raycast_march",))}


def phase_loaders(data, n_frames):
    """Phase 13: phase 4's golden dataset laid out as a Printed3D folder
    (the PNGs renamed) and as a Redwood one (the depth PNGs, and the
    committed 4:2:0 JPEG as every frame's colour), tracked by Scan3D through
    those loaders on the card; the poses must equal phase 4's, frame by
    frame, within phase 10's resume gate (3x what two uninterrupted runs
    differ by, at least 5e-4)."""
    from gradient_sdf_tpu_torch.utils import tumio

    src = os.path.join(data, "{}", "{:03d}.png")
    layouts = {
        "printed": [(src.format("depth", i + 1), f"depth_{i:06d}.png")
                    for i in range(n_frames)]
        + [(src.format("rgb", i + 1), f"color_{i:06d}.png") for i in range(n_frames)],
        "rw": [(src.format("depth", i + 1), f"depth/{i:05d}.png")
               for i in range(n_frames)]
        + [(os.path.join(JPEG_FIXTURES, "golden_420.jpg"), f"rgb/{i:05d}.jpg")
           for i in range(n_frames)],
    }
    straight = tumio.read_trajectory(os.path.join(WORK, "track", "_poses.txt"))
    twice = pose_diff(straight, tumio.read_trajectory(
        os.path.join(WORK, "warm", "_poses.txt")))
    tol = RESUME_POSE_FACTOR * max(twice, RESUME_POSE_FLOOR)
    paths = {}
    for data_type, files in layouts.items():
        root = os.path.join(WORK, f"layout_{data_type}")
        for a, b in files + [(os.path.join(data, "intrinsics.txt"), "intrinsics.txt")]:
            os.makedirs(os.path.dirname(os.path.join(root, b)), exist_ok=True)
            shutil.copy(a, os.path.join(root, b))
        results = os.path.join(WORK, f"loader_{data_type}")
        reset_launch_counts()
        t0 = time.perf_counter()
        m = run_app(root, results, ["--pose-file", "none"], data_type=data_type)
        wall = time.perf_counter() - t0
        launches = launch_counts()
        fused, _, _ = check_outputs(m, results, launches, n_frames)
        poses = tumio.read_trajectory(os.path.join(results, "_poses.txt"))
        err = pose_diff(poses, straight)
        if len(poses) != n_frames or not err <= tol:
            raise AssertionError(f"--data-type {data_type}: {len(poses)} poses, "
                                 f"max |err| vs phase 4 {err} (tolerance {tol})")
        log(f"phase13 scan3d --data-type {data_type} on the golden frames: "
            f"{fused} fused, stamps {poses[0][0]}..{poses[-1][0]}, poses vs phase 4 "
            f"max |err| {err:.3g} (tolerance {tol:.3g}; two phase-4 runs differ "
            f"by {twice:.3g}), kernel launches {launches}, app wall {wall:.2f} s")
        check_track_launches(m, launches)
        paths[f"phase 13 (scan3d --data-type {data_type})"] = (launches,
                                                               TRACKED)
    return paths


def phase_noisy():
    """Phase 14: make_synth with Kinect noise, 60 frames at 640x480 over a
    120 degree arc (2 degrees per frame, tests/test_long_sequence.py's
    protocol), tracked by Scan3D with --eval-gt, grad-SDF gated at the JAX
    test's bounds, base-SDF measured."""
    from gradient_sdf_tpu_torch.apps import make_synth

    data = os.path.join(WORK, "noisy")
    make_synth.main(["--out", data, "--frames", str(NOISY_FRAMES), "--seed", "2",
                     "--width", "640", "--height", "480", "--arc-deg", "120",
                     "--device", "cuda"])
    out = {}
    paths = {}
    for scan_type in ("grad-sdf", "base-sdf"):
        results = os.path.join(WORK, f"noisy_{scan_type}")
        reset_launch_counts()
        m = run_app(data, results, ["--pose-file", "none", "--eval-gt",
                                    "gt_poses.txt", "--scan-type", scan_type])
        launches = launch_counts()
        fused, _, _ = check_outputs(dict(m, invalid_frames=[]), results, launches,
                                    NOISY_FRAMES, cloud=scan_type == "grad-sdf")
        track = sorted(e["track_ms"] for e in m["frame_log"][1:])
        out[scan_type] = m
        log(f"phase14 noisy sequence, {scan_type}: ATE RMSE "
            f"{m['ate_rmse'] * 1e3:.3f} mm over {m['ate_pairs']} frames, "
            f"{len(m['invalid_frames'])} unconverged, {fused} fused, track_ms "
            f"median {track[len(track) // 2]:.2f}, kernel launches {launches}")
        check_track_launches(m, launches)
        paths[f"phase 14 (scan3d {scan_type}, noisy)"] = (launches, TRACKED)
    g = out["grad-sdf"]
    if not (g["ate_rmse"] < NOISY_ATE_LIMIT
            and len(g["invalid_frames"]) <= NOISY_UNCONVERGED_MAX):
        raise AssertionError(f"noisy grad-sdf: ATE {g['ate_rmse']} m (limit "
                             f"{NOISY_ATE_LIMIT}), {len(g['invalid_frames'])} "
                             f"unconverged (limit {NOISY_UNCONVERGED_MAX})")
    return paths, g


# ---------------------------------------------------------------------------
# phase 15: the mesh (4 ranks as 2 rays x 2 blocks)
# ---------------------------------------------------------------------------

MESH_RANKS, MESH_BLOCKS = 4, 2
# 15a: scan3d on the mesh vs phase 4 on one card, tests/test_app_sharded.py's
# bounds: the sharded and unsharded residual passes sum in other orders and GN
# turns that into pose noise at its 1e-3 stopping rule
MESH_POSE_TOL = 3e-3
MESH_SHARED_MIN = 0.99
MESH_DIST_MEDIAN, MESH_DIST_P99 = 2e-4, 3e-3
# the render's active-prefix cap: num_active rounded up to this
ACTIVE_CAP_RUNG = 256


def save_grid_prefix(grid, path):
    """The grid's arrays as .npy files, its five fields cut to the allocated
    slots (the rest is zero): what the ranks of phase 15 load."""
    import numpy as np
    from gradient_sdf_tpu_torch.utils import interop

    na = int(grid.num_active)
    os.makedirs(path, exist_ok=True)
    for k, v in interop.grid_to_numpy(grid).items():
        np.save(os.path.join(path, k + ".npy"),
                v[:na] if k in ("dist", "weight", "grad_x", "grad_y", "grad_z")
                else v)


def load_grid_prefix(path, device):
    import numpy as np
    from gradient_sdf_tpu_torch.utils import interop

    d = {k[:-4]: np.load(os.path.join(path, k)) for k in os.listdir(path)}
    nb = d["block_coords"].shape[0]
    for k in ("dist", "weight", "grad_x", "grad_y", "grad_z"):
        a = d[k]
        d[k] = np.concatenate([a, np.zeros((nb - len(a),) + a.shape[1:], a.dtype)])
    return interop.grid_from_numpy(d, device)


def _bits(a):
    """A tensor's bytes, for bit-for-bit comparisons (-0.0 differs from 0.0)."""
    import torch

    a = a.contiguous()
    return a.view(torch.uint8) if a.dtype != torch.bool else a.to(torch.uint8)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _same_bits(a, b):
    import torch

    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def mesh_render_case(spec):
    """15c on this rank: the render scene's grid (saved by the parent) sharded
    over the blocks, one sharded render with the active-prefix cap (its march
    launches counted), and the checks of it. Returns rank 0's numbers."""
    import torch
    from gradient_sdf_tpu_torch.data import synth
    from gradient_sdf_tpu_torch.ops import raycast
    from gradient_sdf_tpu_torch.ops.kernels import raycast_march as rm
    from gradient_sdf_tpu_torch.parallel import mesh as mesh_mod
    from gradient_sdf_tpu_torch.parallel import sharding
    from gradient_sdf_tpu_torch.tools import raycast_bench as rb

    mesh = mesh_mod.make_mesh(MESH_RANKS, MESH_BLOCKS, spec["device"])
    grid, gcfg, fcfg = (load_grid_prefix(spec["scene"], mesh.device),
                        spec["scene_gcfg"], spec["scene_fcfg"])
    R, t = spec["scene_pose"]
    shard = sharding.shard_grid(mesh, grid)
    na = int(grid.num_active)
    cap = -(-na // ACTIVE_CAP_RUNG) * ACTIVE_CAP_RUNG
    kw = dict(s_min=rb.S_MIN, s_max=rb.S_MAX, active_cap=cap)
    # warm-up, then the counted and timed render
    sharding.sharded_render_depth_normal(mesh, shard, synth.KINECT_K, R, t,
                                         rb.W, rb.H, gcfg, fcfg, **kw)
    _sync(mesh.device)
    march0, coll0 = rm.launch_count, (mesh_mod.calls, mesh_mod.nbytes)
    t0 = time.perf_counter()
    d, n, h = sharding.sharded_render_depth_normal(
        mesh, shard, synth.KINECT_K, R, t, rb.W, rb.H, gcfg, fcfg, **kw)
    _sync(mesh.device)
    ms = (time.perf_counter() - t0) * 1e3
    launches = torch.tensor([rm.launch_count - march0], device=mesh.device)
    coll = (mesh_mod.calls - coll0[0], mesh_mod.nbytes - coll0[1])
    mesh_mod.psum(launches, mesh, count=False)

    # the assembled fields equal the grid's rows, bit for bit
    full = sharding.assemble_fields(mesh, shard, cap)
    fields_equal = all(_same_bits(getattr(full, f), getattr(grid, f)[:cap])
                       for f in sharding.FIELDS)
    # the single-card raycast of the same rays over the whole grid
    o, dirs, inv = raycast.camera_rays(synth.KINECT_K, R, t, rb.W, rb.H,
                                       device=mesh.device)
    ref = raycast.raycast(grid, o, dirs, gcfg, fcfg, s_min=rb.S_MIN,
                          s_max=rb.S_MAX)
    render_equal = (_same_bits(d, (ref.depth * inv).reshape(rb.H, rb.W))
                    and _same_bits(n, ref.normal.reshape(rb.H, rb.W, 3))
                    and _same_bits(h, ref.hit.reshape(rb.H, rb.W)))
    # this rank's march (its slice of the rays) vs the plain version
    mine = mesh_mod.shard_rows(o.shape[0], mesh)
    s0 = torch.full((mine.stop - mine.start,), rb.S_MIN, device=mesh.device)
    args = (o[mine].contiguous(), dirs[mine].contiguous(), s0,
            torch.full_like(s0, rb.S_MAX), full.directory, full.coarse_occ,
            full.dist, full.weight)
    got = rm.raycast_march(*args, gcfg, fcfg)
    want = rm.raycast_march_reference(*args, gcfg, fcfg)
    march_equal = all(_same_bits(a, b) for a, b in zip(got[:3], want[:3]))
    flags = torch.tensor([fields_equal, render_equal, march_equal],
                         dtype=torch.int32, device=mesh.device)
    mesh_mod.psum(flags, mesh, op=torch.distributed.ReduceOp.MIN, count=False)
    try:
        sharding.assemble_fields(mesh, shard, na - 1)
        raised = None
    except ValueError as e:
        raised = str(e)
    return {"num_active": na, "cap": cap, "ms": ms, "hits": int(h.sum()),
            "launches": int(launches), "collectives": coll,
            "fields_equal": bool(flags[0]), "render_equal": bool(flags[1]),
            "march_equal": bool(flags[2]), "found": int(got.found.sum()),
            "slice": mine.stop - mine.start, "cap_below_raises": raised}


def mesh_ba_case(device):
    """15d on this rank: one sharded BA alternation at phase 7's scale point,
    timed (median of 5 after a warm-up), and rank 0 holds it to the
    single-card alternation by phase 7's tolerances."""
    import numpy as np
    import torch
    from gradient_sdf_tpu_torch.parallel import mesh as mesh_mod
    from gradient_sdf_tpu_torch.parallel import sharding
    from gradient_sdf_tpu_torch.tools import ba_bench
    from gradient_sdf_tpu_torch.utils import interop

    mesh = mesh_mod.make_mesh(MESH_RANKS, MESH_BLOCKS, device)
    arrays = ba_bench.bench_arrays()
    gcfg, pcfg = ba_bench.bench_configs()
    problem = interop.problem_from_numpy(arrays[0], mesh.device)
    state = interop.state_from_numpy(arrays[1], mesh.device)
    p_l, s_l = sharding.shard_ba(mesh, problem, state)
    times = []
    for _ in range(6):
        _sync(mesh.device)
        coll0 = (mesh_mod.calls, mesh_mod.nbytes)
        t0 = time.perf_counter()
        new, e_pose, e_dist = sharding.sharded_ba_step(mesh, p_l, s_l, gcfg, pcfg)
        e_pose, e_dist = float(e_pose), float(e_dist)
        _sync(mesh.device)
        times.append((time.perf_counter() - t0) * 1e3)
        coll = (mesh_mod.calls - coll0[0], mesh_mod.nbytes - coll0[1])
    got = interop.state_to_numpy(sharding.gather_ba_state(mesh, new))
    if mesh.rank != 0:
        return None
    ref, r_pose, r_dist = ba_bench.alternation(problem, state, gcfg, pcfg)
    ref = interop.state_to_numpy(ref)
    miss = np.abs(got["dist"] - ref["dist"]) > (BA_DIST_ATOL + BA_DIST_RTOL
                                                * np.abs(ref["dist"]))
    times = sorted(times[1:])
    return {"F": arrays[0]["vis"].shape[1], "V": arrays[0]["vis"].shape[0],
            "energies": (e_pose, e_dist), "ref_energies": (r_pose, r_dist),
            "pose_err": float(max(np.abs(got["R"] - ref["R"]).max(),
                                  np.abs(got["t"] - ref["t"]).max())),
            "dist_miss": int(miss.sum()),
            "dist_err": float(np.abs(got["dist"] - ref["dist"])[~miss].max()),
            "ms": times[len(times) // 2], "runs": times, "collectives": coll}


def mesh_fusion_case(spec):
    """15e on this rank: golden frames 0-4 fused from ground-truth poses
    through `sharded_fuse_frame` into a block-sharded grid, then frame 5
    through the same steps one by one, with the scatter kernel held to its
    plain version on this rank's compact sample slice and `merge_clear` on
    its shard (bit for bit). Returns rank 0's numbers, each the worst over
    the ranks."""
    import dataclasses

    import torch
    from gradient_sdf_tpu_torch import config as cfg_mod
    from gradient_sdf_tpu_torch.data import loaders
    from gradient_sdf_tpu_torch.ops import fusion, normals
    from gradient_sdf_tpu_torch.ops import voxel_grid as vg
    from gradient_sdf_tpu_torch.ops.kernels import merge_clear as mc
    from gradient_sdf_tpu_torch.ops.kernels import scatter_add as sa
    from gradient_sdf_tpu_torch.parallel import mesh as mesh_mod
    from gradient_sdf_tpu_torch.parallel import sharding

    mesh = mesh_mod.make_mesh(MESH_RANKS, MESH_BLOCKS, spec["device"])
    dev = mesh.device
    cfg = cfg_mod.preset("synth")
    gcfg = dataclasses.replace(cfg.grid, voxel_size=0.02)
    fcfg = dataclasses.replace(cfg.fusion, trunc_voxels=5.0)
    loader = loaders.make_loader("synth", spec["data"])
    K = loader.load_intrinsics("intrinsics.txt")
    gt = loader.load_poses("gt_poses.txt")
    frames = list(loader.frames(0, None))
    cache = normals.build_cache(640, 480, K, fcfg.normal_window, dev)
    grid = sharding.shard_grid(mesh, vg.create(gcfg, dev))
    acc = fusion.new_accumulator(grid)

    def inputs(f):
        return [torch.as_tensor(a, dtype=torch.float32, device=dev)
                for a in (f.depth, gt[f.index][1], gt[f.index][2])]

    for f in frames[:-1]:
        grid = sharding.sharded_fuse_frame(mesh, grid, *inputs(f)[:1], cache,
                                           *inputs(f)[1:], gcfg, fcfg, acc=acc)
    depth, R, t = inputs(frames[-1])
    s = fusion.frame_samples(depth, cache, R, t, gcfg, fcfg)
    grid, lin, ok = fusion._alloc_slots(grid, s, gcfg)
    nb, vpb = grid.num_blocks, gcfg.voxels_per_block
    lo, m = sharding.block_range(mesh, nb)
    lin, slot, local, fields = sharding.rank_samples(mesh, s, lin, ok, vpb, nb)
    tidx = sharding.touched_blocks(mesh, slot, nb)
    cap = tidx.shape[0]
    lin_c = sharding.compact_index(slot, local, tidx, nb, vpb, cap)
    acc_k = sa.new_accumulator(cap * vpb, dev)
    sa.scatter_add_fields(lin_c, fields, cap * vpb, acc=acc_k[:, :5])
    acc_p = sa.scatter_add_multi_reference(lin_c, torch.stack(fields, -1),
                                           cap * vpb)
    scatter_err = (acc_k[:, :5] - acc_p).abs().max()
    scatter_ok = torch.allclose(acc_k[:, :5], acc_p, rtol=RTOL, atol=ATOL)
    red = mesh_mod.psum(acc_k[:, :5].contiguous(), mesh, count=False)
    sharding.keep_owned_rows(acc, red, tidx, lo, m, vpb)
    na = sharding.shard_active(grid, lo, m)
    state = [grid.weight, grid.dist, grid.grad_x, grid.grad_y, grid.grad_z]
    kern = [a.clone() for a in [acc] + state]
    plain = [a.clone() for a in [acc] + state]
    mc.merge_clear(*kern, na)
    mc.merge_clear_reference(*plain, na)
    merge_equal = all(_same_bits(a, b) for a, b in zip(kern, plain))
    worst = torch.tensor([float(scatter_err), float(not scatter_ok),
                          float(not merge_equal)], device=dev)
    mesh_mod.psum(worst, mesh, op=torch.distributed.ReduceOp.MAX, count=False)
    return {"blocks": cap, "samples": int(lin_c.shape[0]),
            "na_local": int(na), "scatter_err": float(worst[0]),
            "scatter_ok": not worst[1], "merge_equal": not worst[2]}


def phase15_rank(spec):
    """One rank of phase 15: 15a-15d in one group of 4 ranks. Every rank
    runs the same calls; rank 0 returns what they found."""
    import torch
    from gradient_sdf_tpu_torch.apps import photoba, scan3d

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data, mesh_flags = spec["data"], ["--devices", str(MESH_RANKS),
                                      "--block-parallel", str(MESH_BLOCKS)]

    def scan(results, extra):
        return scan3d.main(
            ["--input", data, "--results", results, "--data-type", "synth",
             "--voxel-size", "0.02", "--trunc", "5", "--device", spec["device"],
             "--metrics-json", os.path.join(results, "metrics.json")]
            + mesh_flags + extra, check_replicated=True)

    out = {}
    t0 = time.perf_counter()
    out["track"] = scan(spec["track"], ["--pose-file", "none", "--save-sdf"])
    out["gt"] = scan(spec["gt"], ["--pose-file", "gt_poses.txt", "--save-sdf"])
    scan(spec["cut"], ["--pose-file", "gt_poses.txt", "--last", "2",
                       "--checkpoint-every", "1"])
    out["resumed"] = scan(spec["cut"], [
        "--pose-file", "gt_poses.txt", "--save-sdf", "--resume",
        os.path.join(spec["cut"], "checkpoint.npz")])
    out["scan_s"] = time.perf_counter() - t0
    out["fusion"] = mesh_fusion_case(spec)
    out["render"] = mesh_render_case(spec)
    out["ba"] = mesh_ba_case(spec["device"])
    metrics = os.path.join(spec["photoba"], "metrics.json")
    os.makedirs(spec["photoba"], exist_ok=True)
    photoba.main(["--input", spec["textured"], "--results", spec["photoba"],
                  "--data-type", "synth", "--voxel-size", "0.02", "--trunc", "5",
                  "--key-frame", "4", "--pose-file", "gt_poses.txt",
                  "--ba-init-pose-file", "ba_init.txt", "--sharded-ba",
                  "--device", spec["device"], "--metrics-json", metrics])
    return out if torch.distributed.get_rank() == 0 else None


def phase_mesh(data, straight, ba_ms_7, scene, device="cuda"):
    """Phase 15: scan3d --devices 4 --block-parallel 2 through `main` on the
    golden dataset (tracking vs phase 4, GT poses vs phase 5, a cut and
    resumed mesh run vs the uninterrupted one), a sharded render of the
    render scene, one sharded BA alternation at phase 7's scale point and
    photoba --sharded-ba on phase 6b's textured data, in one group of 4
    ranks on the card(s) this machine has; and the fusion kernels held to
    their plain versions on a rank's inputs of the mesh path (15e).
    `scene`: where the render scene's grid was saved (`save_grid_prefix`),
    its configs and pose 4. Returns the counted paths, and the largest
    error of each kernel against its plain version in this phase."""
    import numpy as np
    import torch
    from gradient_sdf_tpu_torch.parallel import mesh as mesh_mod
    from gradient_sdf_tpu_torch.tools import raycast_bench as rb
    from gradient_sdf_tpu_torch.utils import tumio

    spec = {"data": data, "track": os.path.join(WORK, "mesh_track"),
            "gt": os.path.join(WORK, "mesh_gt"),
            "cut": os.path.join(WORK, "mesh_resume"),
            "photoba": os.path.join(WORK, "mesh_photoba"),
            "textured": os.path.join(WORK, "textured"),
            "scene": scene["path"], "scene_gcfg": scene["gcfg"],
            "scene_fcfg": scene["fcfg"], "scene_pose": scene["pose"],
            "device": device}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = mesh_mod.launch(phase15_rank, MESH_RANKS, spec, device=device,
                          join_timeout_s=600)
    wall = time.perf_counter() - t0
    m = out["track"]
    mesh = m["mesh"]
    log(f"phase15 mesh: {mesh['devices']} ranks as {mesh['rays']} rays x "
        f"{mesh['blocks']} blocks, backend {mesh['backend']}, "
        f"{min(MESH_RANKS, torch.cuda.device_count())} card(s) in use, "
        f"{mesh['ranks_per_card']} rank(s) per card"
        + (" (the ranks share one card: no multi-card result)"
           if mesh["ranks_per_card"] > 1 else "") + f"; wall {wall:.1f} s")

    # 15a: tracking vs phase 4 on one card
    if not (m["frames"] == straight["frames"]
            and m["invalid_frames"] == straight["invalid_frames"]
            and m["num_blocks_active"] == straight["num_blocks_active"]):
        raise AssertionError(f"mesh run: {m['frames']} frames, invalid "
                             f"{m['invalid_frames']}, {m['num_blocks_active']} "
                             f"blocks; phase 4: {straight['frames']}, "
                             f"{straight['invalid_frames']}, "
                             f"{straight['num_blocks_active']}")
    pose_err = pose_diff(*(tumio.read_trajectory(os.path.join(r, "_poses.txt"))
                           for r in (os.path.join(WORK, "track"), spec["track"])))
    na, nb, frac, err = map_diff(os.path.join(WORK, "track", "gradient_sdf"),
                                 os.path.join(spec["track"], "gradient_sdf"))
    med, p99 = float(np.median(err)), float(np.quantile(err, 0.99))
    if not (pose_err < MESH_POSE_TOL and frac > MESH_SHARED_MIN
            and med < MESH_DIST_MEDIAN and p99 < MESH_DIST_P99):
        raise AssertionError(f"mesh vs phase 4: poses {pose_err}, shared voxels "
                             f"{frac} ({na} / {nb}), dist median {med} p99 {p99}")
    fused = sum(e["fuse_ms"] is not None for e in m["frame_log"])
    launches = mesh["kernel_launches"]
    check_fusion_launches(launches, fused, ranks=MESH_RANKS)
    check_track_launches(m, launches, ranks=MESH_RANKS)
    log(f"phase15a scan3d --devices {MESH_RANKS} --block-parallel {MESH_BLOCKS} "
        f"vs phase 4: {m['frames']} frames, {fused} fused, invalid "
        f"{m['invalid_frames']}, {m['num_blocks_active']} blocks; poses max "
        f"|err| {pose_err:.3g} (< {MESH_POSE_TOL}), voxels shared {frac:.6f} "
        f"({nb} vs {na}), dist median {med:.3g} p99 {p99:.3g} m; replicated "
        f"state equal after every frame; kernel launches over the ranks "
        f"{launches}")
    for e, e4 in zip(m["frame_log"], straight["frame_log"]):
        iters = e["gn_iters"] or 0
        per_iter = ("" if not iters else
                    f", {(e['collective_calls'] - 2 * (e['fuse_ms'] is not None)) / iters:.0f} "
                    f"per GN iteration (116 B each: the 29 sums)")
        fmt = lambda x: "-" if x is None else f"{x:.2f}"
        log(f"  phase15a frame {e['frame']}: track {fmt(e['track_ms'])} ms "
            f"(phase 4 {fmt(e4['track_ms'])}), GN iters {e['gn_iters']} "
            f"(phase 4 {e4['gn_iters']}), fuse {fmt(e['fuse_ms'])} ms (phase 4 "
            f"{fmt(e4['fuse_ms'])}); collectives {e['collective_calls']} calls, "
            f"{e['collective_bytes']} bytes{per_iter}")

    # 15b: GT poses vs phase 5, then cut + resume vs the mesh run
    for what, a, b, frames in (
            ("GT poses vs phase 5", os.path.join(WORK, "gt"), spec["gt"], None),
            ("cut after frame 2 and resumed vs the uninterrupted mesh run",
             spec["gt"], spec["cut"], out["resumed"]["frames"])):
        na, nb, frac, err = map_diff(os.path.join(a, "gradient_sdf"),
                                     os.path.join(b, "gradient_sdf"))
        if not (frac >= RESUME_GT_SHARED_MIN and err.max() <= RESUME_GT_DIST):
            raise AssertionError(f"mesh {what}: shared {frac} ({na} / {nb}), "
                                 f"dist max |err| {err.max()}")
        log(f"phase15b mesh {what}: observed voxels {nb} vs {na}, shared "
            f"{frac:.6f} (>= {RESUME_GT_SHARED_MIN}), dist max |err| "
            f"{err.max():.3g} m (<= {RESUME_GT_DIST})"
            + ("" if frames is None else f"; resumed for {frames} frames"))
    log(f"phase15 scan3d runs (4 of them) {out['scan_s']:.1f} s")

    # 15c: the sharded render
    r = out["render"]
    if not (r["fields_equal"] and r["render_equal"] and r["march_equal"]
            and r["launches"] == MESH_RANKS and r["cap_below_raises"]
            and r["hits"] > 0.1 * rb.W * rb.H):
        raise AssertionError(f"sharded render: {r}")
    log(f"phase15c sharded render of the render scene (pose 4, {rb.W}x{rb.H}): "
        f"{r['num_active']} blocks, active_cap {r['cap']}; assembled fields = "
        f"the grid's rows bit for bit; depth, normal, hit = the single-card "
        f"raycast of the same rays bit for bit ({r['hits']} hits); each rank's "
        f"march of its {r['slice']} rays = the plain version bit for bit; "
        f"{r['launches']} march launches over the ranks; a cap below num_active "
        f"raises; {r['ms']:.2f} ms per render (host clock), collectives "
        f"{r['collectives'][0]} calls, {r['collectives'][1]} bytes")

    # 15d: BA
    b = out["ba"]
    e_ok = all(abs(x - y) <= BA_E_RTOL * abs(y)
               for x, y in zip(b["energies"], b["ref_energies"]))
    if not (e_ok and b["pose_err"] <= BA_POSE_ATOL
            and b["dist_miss"] <= BA_OUTLIERS * b["V"]):
        raise AssertionError(f"sharded BA vs single card: {b}")
    log(f"phase15d sharded BA alternation F={b['F']} V={b['V']} over "
        f"{MESH_RANKS} ranks vs one card: energies {b['energies'][0]:.6g} / "
        f"{b['energies'][1]:.6g} vs {b['ref_energies'][0]:.6g} / "
        f"{b['ref_energies'][1]:.6g} (rtol {BA_E_RTOL}), poses max |err| "
        f"{b['pose_err']:.3g} (atol {BA_POSE_ATOL}), dist max |err| "
        f"{b['dist_err']:.3g} with {b['dist_miss']} voxels beyond atol "
        f"{BA_DIST_ATOL} + rtol {BA_DIST_RTOL}; {b['ms']:.2f} ms per "
        f"alternation (median of {[float(f'{x:.2f}') for x in b['runs']]}; "
        f"phase 7 on one card {ba_ms_7:.2f} ms); collectives "
        f"{b['collectives'][0]} calls, {b['collectives'][1]} bytes")
    with open(os.path.join(spec["photoba"], "metrics.json")) as f:
        pm = json.load(f)
    es = pm["ba_energies"]
    if not (pm["mesh"]["devices"] == MESH_RANKS and es[-1] < 0.9 * es[0]
            and all(np.isfinite(es))):
        raise AssertionError(f"photoba --sharded-ba: {pm}")
    log(f"phase15d photoba --sharded-ba on the textured spheres: "
        f"{pm['keyframes']} keyframes, {(len(es) - 1) // 2} BA iterations in "
        f"{timer_ms(pm, 'Photometric BA'):.1f} ms, energy {es[0]:.6g} -> "
        f"{es[-1]:.6g}")
    # 15e: the fusion kernels on a rank's real inputs
    fz = out["fusion"]
    if not (fz["scatter_ok"] and fz["merge_equal"]):
        raise AssertionError(f"mesh fusion kernels vs plain: {fz}")
    log(f"phase15e the fusion kernels on the mesh path, golden frame 5 from "
        f"ground-truth poses: each rank's {fz['samples']} samples (its quarter) "
        f"into the compact accumulator of the frame's {fz['blocks']} touched "
        f"blocks, scatter kernel vs plain max |err| {fz['scatter_err']:.3g} "
        f"(atol {ATOL} + rtol {RTOL}); merge_clear on each rank's shard "
        f"({fz['na_local']} allocated slots on rank 0) = plain bit for bit")

    paths = {f"phase 15 (scan3d --devices {MESH_RANKS})": (launches,
                                                           MESH_TRACKED),
             "phase 15 (sharded render)": ({"raycast_march": r["launches"]},
                                           ("raycast_march",))}
    return paths, {"scatter": fz["scatter_err"], "merge": 0.0, "march": 0.0}


# ---------------------------------------------------------------------------
# phase 16: a replayed TUM folder, decoded ahead
# ---------------------------------------------------------------------------

def frame_digest(frame):
    import hashlib

    h = hashlib.sha256()
    for a in (frame.color, frame.depth):
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def decode_threads():
    import threading

    return [t for t in threading.enumerate() if t.name.startswith("gsdf-decode")]


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def mesh_parity(data, smi, device="cuda"):
    """16b: phase 4's map (the golden frames fused at phase 4's poses) meshed
    through `extract_mesh` (the C dedup) and through the plain twin on the
    same triangle soup, with a seeded colour field: vertices, faces and
    colours equal bit for bit. Host-clock times of both dedups and of
    `np.unique` (the port's former dedup) on that soup."""
    import numpy as np
    import torch
    from gradient_sdf_tpu_torch.data import loaders
    from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap
    from gradient_sdf_tpu_torch.ops import marching_cubes as mc
    from gradient_sdf_tpu_torch.utils import tumio

    dev = torch.device(device)
    poses = tumio.read_trajectory(os.path.join(WORK, "track", "_poses.txt"))
    loader = loaders.make_loader("synth", data)
    K = loader.load_intrinsics()
    m = GradSdfMap(synth_cfg(0.02), device=dev)
    for f in loader.frames():
        m.update(torch.as_tensor(f.depth, device=dev), K,
                 tuple(torch.as_tensor(a, device=dev) for a in poses[f.index][1:]))
    gcfg = m.cfg.grid
    gen = torch.Generator(device=dev).manual_seed(16)
    cf = torch.rand((gcfg.num_blocks, gcfg.block_shape ** 3, 3), device=dev,
                    generator=gen)
    verts, faces, cols = mc.extract_mesh(m.grid, gcfg, color_field=cf)
    soup, _, soup_cols = mc.extract_mesh(m.grid, gcfg, dedup=False, color_field=cf)
    q = gcfg.voxel_size * 1e-4
    pv, pf, pc = mc.weld(soup, soup_cols, q, mc.dedup_vertices_reference)
    equal = {"vertices": np.array_equal(verts, pv), "faces": np.array_equal(faces, pf),
             "colours": np.array_equal(cols, pc)}
    if not all(equal.values()) or len(faces) == 0:
        raise AssertionError(f"mesh dedup C vs plain twin: {equal}, {len(faces)} faces")
    c_ms = host_ms(lambda: mc.dedup_vertices(soup, q))
    plain_ms = host_ms(lambda: mc.dedup_vertices_reference(soup, q), reps=1)
    unique_ms = host_ms(lambda: np.unique(np.round(soup / q).astype(np.int64), axis=0,
                                          return_index=True, return_inverse=True))
    log(f"phase16b mesh of phase 4's map ({int(m.grid.num_active)} blocks): "
        f"{len(soup)} soup vertices -> {len(verts)} vertices, {len(faces)} faces; "
        f"extract_mesh (C dedup) = plain twin bit for bit (vertices, faces, "
        f"colours); dedup ms (host clock, median of 5; plain: one call): C "
        f"{c_ms:.2f}, plain twin {plain_ms:.1f}, np.unique {unique_ms:.2f} [{smi}]")


def phase_replay(noisy14, smi):
    """Phase 16: phase 14's 60 noisy VGA frames replayed from a TUM folder
    whose PNGs cycle through filters 0-4. The folder is read synchronously
    (decode ms per image and per frame) and through the decode-ahead reader
    (every frame byte-equal to the synchronous read); then `scan3d
    --data-type tum` runs it in turns decoding ahead and synchronously:
    load_ms, track_ms and fuse_ms beside phase 14's, loop_fps beside the
    synchronous-equivalent fps, the reader's peak of resident images;
    grad-SDF ATE gated as phase 14's. No reader thread may outlive a run."""
    from gradient_sdf_tpu_torch.data import loaders
    from gradient_sdf_tpu_torch.tools import replay_bench as rb

    folder = os.path.join(WORK, "tum_replay")
    t0 = time.perf_counter()
    n = rb.tum_replay_folder(os.path.join(WORK, "noisy"), folder)
    write_s = time.perf_counter() - t0
    loader = loaders.make_loader("tum", folder)
    specs = loader._frame_specs(0, None)
    col_ms, dep_ms = [], []
    for _, _, cp, dp in specs:
        t0 = time.perf_counter()
        loaders.load_color_png(cp)
        t1 = time.perf_counter()
        loaders.load_depth_png(dp, loader.unit)
        col_ms.append((t1 - t0) * 1e3)
        dep_ms.append((time.perf_counter() - t1) * 1e3)
    sync_frame_ms, want = [], []
    for frame, t_ask, t_got in loaders.timed(loader.frames(n_threads=0)):
        sync_frame_ms.append((t_got - t_ask) * 1e3)
        want.append(frame_digest(frame))
    got = [frame_digest(f) for f in loader.frames()]
    if len(want) != n or got != want:
        differ = [k for k, (a, b) in enumerate(zip(got, want)) if a != b]
        raise AssertionError(f"decode-ahead frames vs synchronous: {len(got)} / "
                             f"{len(want)} frames, frames {differ} differ")
    if decode_threads():
        raise AssertionError(f"reader threads alive after frames(): {decode_threads()}")
    log(f"phase16 TUM replay folder: {n} VGA frames (phase 14's noisy spheres), "
        f"PNG rows cycling through filters 0-4, written in {write_s:.1f} s; "
        f"synchronous decode (host clock, median over the {n} frames): colour "
        f"{median(col_ms):.2f} ms, depth {median(dep_ms):.2f} ms, per frame "
        f"{median(sync_frame_ms):.2f} ms (n_threads=0); the decode-ahead reader's "
        f"{n} frames = the synchronous read byte for byte [{smi}]")

    # in turns: frames() decoding ahead (the default: 2 threads, a window of
    # 16 images) and synchronously (n_threads=0)
    s14 = rb.summary(noisy14)
    paths = {}
    for k, mode in enumerate(rb.MODES):
        results = os.path.join(WORK, f"replay_{mode}_{k}")
        reset_launch_counts()
        m = rb.run_scan(folder, results, mode)
        launches = launch_counts()
        check_outputs(dict(m, invalid_frames=[]), results, launches, n)
        if decode_threads():
            raise AssertionError(f"reader threads alive after the app: {decode_threads()}")
        if not (m["ate_rmse"] < NOISY_ATE_LIMIT
                and len(m["invalid_frames"]) <= NOISY_UNCONVERGED_MAX):
            raise AssertionError(f"replay {mode}: ATE {m['ate_rmse']} m (limit "
                                 f"{NOISY_ATE_LIMIT}), {len(m['invalid_frames'])} "
                                 f"unconverged (limit {NOISY_UNCONVERGED_MAX})")
        check_track_launches(m, launches)
        paths[f"phase 16 (scan3d --data-type tum, {mode}, run {k})"] = (
            launches, TRACKED)
        r = rb.summary(m)
        fl = m["frame_log"]
        # the same run's frames had each paid its synchronous decode
        sync_fps = len(fl) / (sum(e["frame_ms"] for e in fl) + sum(sync_frame_ms)) * 1e3
        reader = m["reader"]
        log(f"phase16 scan3d --data-type tum, {mode} (run {k}; reader "
            f"{reader['n_threads']} threads, window {reader['window']}, peak "
            f"resident {reader['peak_resident']} images): load_ms median "
            f"{r['load_ms_median']:.3f} p90 {r['load_ms_p90']:.3f} (frames "
            f"1-{n - 1}), frame 0 {fl[0]['load_ms']:.2f}, frame 1 "
            f"{fl[1]['load_ms']:.3f}; track_ms median {r['track_ms_median']:.2f}, "
            f"fuse_ms median {r['fuse_ms_median']:.2f} (phase 14, same call: "
            f"{s14['track_ms_median']:.2f} / {s14['fuse_ms_median']:.2f}); "
            f"loop_fps {m['loop_fps']:.2f}, with each frame's synchronous decode "
            f"added to its frame_ms {sync_fps:.2f} fps; ATE "
            f"{m['ate_rmse'] * 1e3:.3f} mm, {len(m['invalid_frames'])} "
            f"unconverged; kernel launches {launches} [{smi}]")
    if decode_threads():
        raise AssertionError(f"reader threads alive: {decode_threads()}")
    return paths


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
    synth_err, synth_rows_err = phase_kernel()
    kstats = phase_merge_and_in_situ()
    kstats["scatter"]["max_abs_err"] = max(kstats["scatter"]["max_abs_err"],
                                           synth_err)
    kstats["rows"]["max_abs_err"] = max(kstats["rows"]["max_abs_err"],
                                        synth_rows_err)
    phase_fusion()
    fstats = phase_fuse_integrate(smi)

    from gradient_sdf_tpu_torch.apps import make_synth

    data = os.path.join(WORK, "golden")
    n_frames = 6
    # datasets are rendered on the card (make_synth's default device)
    make_synth.main(["--out", data, "--frames", str(n_frames), "--seed", "2",
                     "--width", "640", "--height", "480", "--arc-deg", "4",
                     "--no-noise", "--device", "cuda"])
    launches, straight, straight_err = phase_app(data, n_frames)
    track = phase_pack(data, n_frames, smi)
    kstats["loop"], kstats["reduce"], kstats["step"] = (
        track["loop"], track["reduce"], track["step"])
    phase_gt(data, n_frames)

    # PhotoBA: the JAX app test's protocol at full VGA width
    ba_data = os.path.join(WORK, "photoba_data")
    ba_frames = 14
    make_synth.main(["--out", ba_data, "--frames", str(ba_frames), "--seed", "2",
                     "--width", "640", "--height", "480", "--arc-deg", "10",
                     "--no-noise", "--device", "cuda"])
    ba_launches = phase_photoba(ba_data, ba_frames)
    phase_photoba_recovery()
    ba_ms = phase_ba_scale()
    scene, kstats["march"] = phase_march()
    render_launches = phase_render(scene)
    # phase 15's ranks load the render scene's grid from here
    mesh_scene = {"path": os.path.join(WORK, "scene_grid"), "gcfg": scene[1],
                  "fcfg": scene[2], "pose": scene[4][4]}
    save_grid_prefix(scene[0], mesh_scene["path"])
    del scene
    torch.cuda.empty_cache()
    base_launches = phase_ablation_and_resume(data, n_frames, straight,
                                              straight_err)
    phase_codecs()
    # each main path was counted from zero and launched its kernels
    paths = {"phase 4 (scan3d)": (launches, TRACKED),
             "phase 6 (photoba)": (ba_launches, TRACKED),
             "phase 9 (renders)": (render_launches, ("raycast_march",)),
             "phase 10 (scan3d base-sdf)": (base_launches, TRACKED)}
    paths.update(phase_box())
    paths.update(phase_loaders(data, n_frames))
    noisy_paths, noisy14 = phase_noisy()
    paths.update(noisy_paths)
    mesh_paths, mesh_errs = phase_mesh(data, straight, ba_ms, mesh_scene)
    paths.update(mesh_paths)
    t16 = time.perf_counter()
    paths.update(phase_replay(noisy14, smi))
    mesh_parity(data, smi)
    log(f"phase16 {time.perf_counter() - t16:.1f} s")
    for k, err in mesh_errs.items():
        kstats[k]["max_abs_err"] = max(kstats[k]["max_abs_err"], err)
    for path, (counts, kernels) in paths.items():
        if any(counts[k] <= 0 for k in kernels):
            raise AssertionError(f"{path} launched no kernel: {counts}")

    def counted_in(kernel):
        names = [p for p, (_, ks) in paths.items() if kernel in ks]
        return (sum(paths[p][0][kernel] for p in names),
                " + ".join(f"{p}: {paths[p][0][kernel]}" for p in names))

    log(smi_line())
    log(json.dumps({"kernels": [{
        "name": "fuse_claim",
        "route": "cuda",
        "source": "gradient_sdf_tpu_torch/csrc/fuse_integrate.cu",
        "replaces": "gradient_sdf_tpu/ops/fusion.py:131",
        "launches": counted_in("fuse_claim")[0],
        "launches_counted_in": counted_in("fuse_claim")[1],
        "timed_on": "phase 3b: golden frame 5 after frames 0-4 (the claim "
                    "pass of one card's fusion: gates, walk, lookup)",
        **fstats["claim"],
    }, {
        "name": "fuse_integrate",
        "route": "cuda",
        "source": "gradient_sdf_tpu_torch/csrc/fuse_integrate.cu",
        "replaces": "gradient_sdf_tpu/ops/pallas/scatter_add.py:103",
        "also_replaces": "gradient_sdf_tpu/ops/fusion.py:330 and :362 (the "
                         "scatter and merge of one card's fusion)",
        "launches": counted_in("fuse_integrate")[0],
        "launches_counted_in": counted_in("fuse_integrate")[1],
        "timed_on": "phase 3b: golden frame 5 after frames 0-4 and its claim "
                    "(one cooperative launch: walk, lookup, scatter, merge)",
        **fstats["integrate"],
    }, {
        "name": "scatter_add_multi",
        "route": "cuda",
        "source": "gradient_sdf_tpu_torch/csrc/scatter_add.cu",
        "replaces": "gradient_sdf_tpu/ops/pallas/scatter_add.py:103",
        "launches": counted_in("scatter_add")[0],
        "launches_counted_in": counted_in("scatter_add")[1],
        "bound_by": "bytes",
        **kstats["scatter"],
    }, {
        "name": "scatter_add_rows",
        "route": "cuda",
        "source": "gradient_sdf_tpu_torch/csrc/scatter_add.cu",
        "replaces": "gradient_sdf_tpu/ops/pallas/scatter_add.py:177",
        "launches": sum(c.get("scatter_add_rows", 0) for c, _ in paths.values()),
        "launches_counted_in": "the F = 1 launches of every main path above "
                               "(no app calls scatter_add_rows; phases 2 and 2b "
                               "launch it and hold it against its plain version)",
        "bound_by": "bytes",
        **kstats["rows"],
    }, {
        "name": "merge_clear",
        "route": "cuda",
        "source": "gradient_sdf_tpu_torch/csrc/merge_clear.cu",
        "replaces": "gradient_sdf_tpu/ops/fusion.py:362",
        "launches": counted_in("merge_clear")[0],
        "launches_counted_in": counted_in("merge_clear")[1],
        "bound_by": "bytes",
        **kstats["merge"],
    }, {
        "name": "raycast_march",
        "route": "cuda",
        "source": "gradient_sdf_tpu_torch/csrc/raycast_march.cu",
        "replaces": "gradient_sdf_tpu/ops/raycast.py:178",
        "launches": counted_in("raycast_march")[0],
        "launches_counted_in": counted_in("raycast_march")[1],
        "timed_on": "phase 8: the render scene's 307,200 full-resolution rays, "
                    "unwindowed, in 8x4 pixel tiles",
        **kstats["march"],
    }, {
        "name": "gn_track_loop",
        "route": "cuda",
        "source": "gradient_sdf_tpu_torch/csrc/gn_track.cu",
        "replaces": "gradient_sdf_tpu/models/tracker.py:201",
        "launches": counted_in("gn_track_loop")[0],
        "launches_counted_in": counted_in("gn_track_loop")[1],
        "timed_on": "phase 4b: golden frame 5's compacted points, the whole "
                    "GN loop from the frame's start pose, grad mode (ms a "
                    "frame; ms_per_iteration beside it)",
        **kstats["loop"],
    }, {
        "name": "gn_residual_reduce",
        "route": "cuda",
        "source": "gradient_sdf_tpu_torch/csrc/gn_track.cu",
        "replaces": "gradient_sdf_tpu/models/tracker.py:80",
        "launches": counted_in("gn_residual_reduce")[0],
        "launches_counted_in": counted_in("gn_residual_reduce")[1],
        "timed_on": "phase 4b: golden frame 5's compacted points at its "
                    "start pose, grad mode (the loop kernel's one-pass "
                    "launch, which the mesh runs)",
        **kstats["reduce"],
    }, {
        "name": "gn_step",
        "route": "cuda",
        "source": "gradient_sdf_tpu_torch/csrc/gn_track.cu",
        "replaces": "gradient_sdf_tpu/models/tracker.py:206",
        "launches": counted_in("gn_step")[0],
        "launches_counted_in": counted_in("gn_step")[1],
        "timed_on": "phase 4b: golden frame 5's first GN iteration's sums "
                    "(the update applied; the mesh's step)",
        **kstats["step"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
