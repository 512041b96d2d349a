#!/usr/bin/env python3
"""Card measurements of the raycast renderer (needs one CUDA card).

    python3 gradient_sdf_tpu_torch/tools/raycast_bench.py [--parent DIR]

The scene is the JAX benchmark's render scene: 1 cm voxels, 2^15 blocks,
the five spheres of seed 3, the 16 frames of a radius-2 orbit fused at
640x480 from their ground-truth poses; the rays are pose 4's, s in
[0.1, 3.5]. It prints, one JSON line each:

  1. `raycast_march` against `raycast_march_reference` on the card on all
     307,200 rays, unwindowed and inside the block-raster windows, with the
     rays in their order and in the 8 x 4 pixel tiles a render uses: rays
     whose `found`, `s_mid`, `s_star` or probe counts differ (bit equality
     is expected: the kernel is built without fused multiply-adds), device
     time of kernel and plain version by CUDA events (`median_ms` of
     `fusion_bench`), probes per ray (mean, p99, max), the 32-byte sectors
     the probes gathered (every gather counted) and the distinct ones among
     them, the bound on these rays (the larger of bytes: ray state plus each
     distinct sector once, and operations: those of the probes made, priced
     at the card's issue rates), the share of a warp's lanes that still
     probe while its slowest ray does, and the issue slots the card had per
     warp-probe (time x SM clock x 132 SMs x 4 schedulers / warp-probes);
  2. the march kernel's machine code: per instance, registers (ptxas), the
     blocks and warps an SM holds at 128 threads, SASS instructions in all
     and in the march loop (between the loop's head and its backward
     branch); and the SM clock that `nvidia-smi` reads while the kernel
     runs back to back;
  3. `render_depth_normal` through its entry point in four modes (stride-4
     prior, no prior, raster windows, the previous render as depth prior
     with holes skipped and a 4-voxel margin): ms per render on the host
     clock around device-synchronized calls, Mrays/s, march launches;
  4. the stride-4 and the no-prior render under `torch.profiler`: kernels
     launched, device-busy ms and share, host syncs, the march kernel's own
     device time (`profile_call` of `ba_bench`);
  5. with `--parent DIR` (a checkout of an earlier commit, e.g. unpacked
     with `git archive`): per tree, each in a process of its own that
     imports that tree's package and fuses the scene itself, in the order
     parent, this, this, parent: the march kernel's ms (rays in their order,
     and tiled where the tree can), the four render modes' ms and their
     launches and syncs (`render_counts`).
     `--tree DIR` is what the script passes to itself for that.

Each render mode's device operations, `cudaLaunchKernel` calls, `nonzero`
calls and host syncs (with the line of each) follow part 3, with R, t
handed over as host arrays and as tensors on the card (`render_counts`).

    python3 gradient_sdf_tpu_torch/tools/raycast_bench.py --windows --finish \
        [--parent DIR]

replaces parts 1-2 with part 6: the window kernels (`render_windows` in
each form the render takes, at the `active_cap` escape, with the camera
inside the band, at 1920x1080 and 3840x2160 and at 4096 synthetic active
blocks; `prior_windows` in both modes and both miss rules) held bit for
bit to their plain versions, tile grid included, and the finish
(`ray_finish`, render and `raycast` forms, `finish_values` against the
kernel, and d(mean depth)/dt through its backward) to its plain version,
then each timed by CUDA events beside its plain version, an empty launch
at its grid, its bound and (the stride prior) a 3x3 `max_pool2d` as the
library yardstick; `render_windows` over the scene's and 4096 active
blocks at VGA, 1920x1080 and 3840x2160 (`windows_sweep`); the two window
kernels taken apart by one-switch builds (`windows_split`:
RENDER_WINDOWS_SWITCHES, PRIOR_WINDOWS_SWITCHES, one `nvcc` a build,
started together); and each render mode through the kernels against the
same render with the plain passes (`render_vs_plain`). Either flag alone
runs its half. It exits 1 if a check of what ran fails. With `--windows
--parent DIR` the turns (parent, this, this, parent; a process each)
time each tree's window kernels over the same sweep, both priors, and the
render modes' ms, launches and syncs (`tree_window_times`) instead of
part 5.

`chip_smoke.py` runs the same functions as its phases 8 and 9 and adds the
checks against the analytic depth and the CPU.
"""

import argparse
import contextlib
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import time
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
OWN_ROOT = os.path.dirname(os.path.dirname(HERE))
W, H = 640, 480
S_MIN, S_MAX = 0.1, 3.5
MEM_BYTES_PER_S = 3.35e12   # the card's memory rate (H100 SXM data sheet)
SMS = 132
BOOST_HZ = 1.98e9           # the H100 SXM's highest SM clock
# Issue rates, lanes per SM per clock: a float32 add, multiply, compare,
# select or conversion 128 (the data sheet's 67 Tflop/s counts an FMA as two
# flops; the march has no FMAs), an int32 operation 64.
F32_OPS_PER_S = 128 * SMS * BOOST_HZ    # 33.5e12
INT_OPS_PER_S = 64 * SMS * BOOST_HZ     # 16.7e12
# Operations of one probe of the march loop, counted from the kernel's
# source (a probe that reads a voxel; one that reads coarse_occ instead
# does four integer operations fewer), per thread:
#   float32: position 6, voxel index 6 (multiply, round-convert), the DDA
#   34 (per axis add, multiply, floor, add, multiply, two subtracts,
#   multiply; two mins, compare, select, add, max; the cell's two selects),
#   step and crossing 8;
#   int32: block coordinate and offset 6, range checks 4, directory key 3,
#   voxel offset and index 6, weight and dist addresses 3, loop 3.
# The count of the kernel before the redesign was ~100 per probe (~35 of
# them integer, six IEEE divisions in the DDA, three runtime integer
# divisions), priced at 67e12 operations per second.
F32_OPS_PER_PROBE = 54
INT_OPS_PER_PROBE = 25
OPS_PER_HIT = 40            # s_mid, the two centre projections, the secant
RENDER_MODES = {
    "stride4": dict(),
    "no_prior": dict(prior_stride=0),
    "raster": dict(prior_mode="raster"),
}
INCREMENTAL = dict(depth_prior_holes="skip", prior_margin_voxels=4.0)


def render_scene(device):
    """(grid, gcfg, fcfg, world, poses): 16 orbit frames fused on `device`."""
    import torch
    from gradient_sdf_tpu_torch.config import FusionConfig, GridConfig
    from gradient_sdf_tpu_torch.data import synth
    from gradient_sdf_tpu_torch.ops import fusion, normals
    from gradient_sdf_tpu_torch.ops import voxel_grid as vg

    gcfg = GridConfig(voxel_size=0.01, num_blocks=2**15)
    fcfg = FusionConfig(trunc_voxels=5.0)
    world = synth.random_spheres(seed=3, device=device)
    poses = synth.orbit_poses(n=16, radius=2.0)
    cache = normals.build_cache(W, H, synth.KINECT_K, fcfg.normal_window, device)
    grid = vg.create(gcfg, device)
    acc = fusion.new_accumulator(grid)
    for R, t in poses:
        depth = synth.render_depth(world, R, t, synth.KINECT_K, W, H)
        grid = fusion.fuse_frame(
            grid, depth, cache, torch.as_tensor(R, device=device),
            torch.as_tensor(t, device=device), gcfg, fcfg, acc=acc)
    if bool(grid.overflow):
        raise AssertionError("the render scene overflowed its 2^15 blocks")
    return grid, gcfg, fcfg, world, poses


def march_args(grid, gcfg, R, t, windowed: bool):
    """The tensors `raycast` hands the march for a full-resolution pass:
    unwindowed, or inside the block-raster windows."""
    import torch
    from gradient_sdf_tpu_torch.data import synth
    from gradient_sdf_tpu_torch.ops import raycast

    dev = grid.device
    o, d, _ = raycast.camera_rays(synth.KINECT_K, R, t, W, H, device=dev)
    n = o.shape[0]
    if windowed:
        lo, hi = raycast.block_raster_windows(grid, synth.KINECT_K, R, t, W, H, gcfg)
        s0, s_end = torch.clamp(lo, min=S_MIN), torch.clamp(hi, max=S_MAX)
    else:
        s0 = torch.full((n,), S_MIN, device=dev)
        s_end = torch.full((n,), S_MAX, device=dev)
    return (o.contiguous(), d.contiguous(), s0.contiguous(), s_end.contiguous(),
            grid.directory, grid.coarse_occ, grid.dist, grid.weight)


def march_bound_ms(n: int, distinct_sectors: int) -> float:
    """Least time for these rays on the card, bytes: the ray state read once
    (origin, direction, window: 32 B) and written once (found, s_mid,
    s_star: 9 B), plus every 32-byte sector of directory, coarse_occ, dist
    and weight that some probe of this pass read, once: what neighbouring
    rays share need come from memory only once."""
    return (n * (32 + 9) + 32 * distinct_sectors) / MEM_BYTES_PER_S * 1e3


def march_ops_bound_ms(probes: int, hits: int) -> float:
    """Least time for the probes these rays needed, operations: every
    operation takes an issue slot of 128 lanes per SM and clock, and the
    integer ones go through a 64-lane pipe besides; the larger of the two."""
    f32 = probes * F32_OPS_PER_PROBE + hits * OPS_PER_HIT
    ints = probes * INT_OPS_PER_PROBE
    return max((f32 + ints) / F32_OPS_PER_S, ints / INT_OPS_PER_S) * 1e3


def warp_probes(probes, width):
    """(sum over warps of the slowest lane's probes, share of lanes in use)
    for the kernel's mapping of the rays to warps (`ray_order`)."""
    import torch

    if width is None:
        per = torch.nn.functional.pad(probes, (0, -probes.numel() % 32))
    else:
        from gradient_sdf_tpu_torch.ops.kernels import raycast_march as rm

        order = rm.ray_order(probes.numel(), width).to(probes.device)
        per = torch.where(order >= 0, probes[order.clamp(min=0)], 0)
    per = per.reshape(-1, 32)
    total = float(per.max(dim=1).values.sum())
    return total, float(probes.sum()) / (32 * total)


def march_check_and_time(grid, gcfg, fcfg, R, t, windowed: bool,
                         width=None, plain=True) -> dict:
    """Kernel vs plain version on one pass's rays, then both timed. `width`
    W marches the rays in pixel tiles; `plain=False` skips the plain
    version's timing (its check runs all the same)."""
    import torch
    from gradient_sdf_tpu_torch.ops.kernels import raycast_march as rm
    from gradient_sdf_tpu_torch.tools.fusion_bench import median_ms

    args = march_args(grid, gcfg, R, t, windowed)
    n = args[0].shape[0]
    got = rm.raycast_march(*args, gcfg, fcfg, stats=True, width=width)
    fast = rm.raycast_march(*args, gcfg, fcfg, width=width)
    torch.cuda.synchronize()
    want = rm.raycast_march_reference(*args, gcfg, fcfg, stats=True)
    differ = ((got.found != want.found) | (got.s_mid != want.s_mid)
              | (got.s_star != want.s_star)
              | (got.stats != want.stats).any(dim=1)
              | (fast.found != want.found) | (fast.s_mid != want.s_mid)
              | (fast.s_star != want.s_star))
    touched_differing = int((got.touched != want.touched).sum())
    hit = got.found & want.found
    err = float((got.s_star - want.s_star)[hit].abs().max()) if bool(hit.any()) else 0.0
    probes = got.stats[:, 0].float()
    marched = probes > 0
    sectors = int(got.stats[:, 1].sum())
    distinct = int(got.touched.sum())
    wp, lanes = warp_probes(probes, width)
    bytes_ms = march_bound_ms(n, distinct)
    ops_ms = march_ops_bound_ms(int(probes.sum()), int(got.found.sum()))
    ms = median_ms(lambda: rm.raycast_march(*args, gcfg, fcfg, width=width))
    plain_ms = None
    if plain:
        t0 = time.perf_counter()
        rm.raycast_march_reference(*args, gcfg, fcfg)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    return {
        "windowed": windowed, "tiled": width is not None, "rays": n,
        "rays_differing": int(differ.sum()),
        "found_differing": int((got.found != want.found).sum()),
        "max_abs_err": err, "found": int(got.found.sum()),
        "rays_marched": int(marched.sum()),
        "probes": int(probes.sum()),
        "probes_mean": float(probes.mean()),
        "probes_mean_marched": float(probes[marched].mean()),
        "probes_p99": float(torch.quantile(probes, 0.99)),
        "probes_max": int(probes.max()), "sectors": sectors,
        "distinct_sectors": distinct, "touched_differing": touched_differing,
        "gathered_gb_per_s": 32 * sectors / ms / 1e6,
        "warp_probes": wp, "warp_lane_use": lanes,
        "ms": ms, "plain_ms": plain_ms,
        "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def issue_slots_per_warp_probe(ms: float, warp_probes_total: float,
                               clock_hz: float) -> float:
    """Issue slots the card had per warp-probe in `ms`: 132 SMs with four
    schedulers that each issue one warp instruction per clock."""
    return ms * 1e-3 * clock_hz * SMS * 4 / warp_probes_total


def sm_clock_while(fn, seconds=1.5):
    """SM clocks (MHz) that `nvidia-smi` reads every 100 ms while `fn()`
    runs back to back for `seconds`: (min, median, max) of the samples."""
    import torch

    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
         "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    mhz = sorted(float(x) for x in out.split() if x.strip().replace(".", "").isdigit())
    if not mhz:
        raise RuntimeError("nvidia-smi read no SM clock")
    return mhz[0], mhz[len(mhz) // 2], mhz[-1]


def _sass_functions(lib_path):
    """{mangled name: [(address, instruction)]} of a library's SASS."""
    from gradient_sdf_tpu_torch.ops.kernels import _build

    dump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([dump, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def _registers(build_log):
    """{mangled name: registers} from a build's ptxas report."""
    regs, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: |$)",
                      line)
        if m:
            cur = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            regs[cur] = int(m.group(1))
    return regs


def resident(registers: int, threads: int):
    """(blocks, warps) an SM holds: 65,536 registers allocated 256 at a time
    per warp, at most 64 warps and 32 blocks (the march uses no shared
    memory)."""
    per_warp = -(-registers * 32 // 256) * 256
    warps = threads // 32
    blocks = min(65536 // (per_warp * warps), 64 // warps, 32)
    return blocks, blocks * warps


def march_code(lib_path, build_log, threads: int) -> list:
    """Per march instance: template arguments, registers, residency, SASS
    instructions in all and in the march loop (the largest span between a
    backward branch and its target)."""
    regs = _registers(build_log)
    out = []
    for name, code in _sass_functions(lib_path).items():
        m = re.search(r"march_raysI((?:Li\w+?E)*)Lb([01])E", name)
        if not m:
            continue
        shape = re.match(r"Li(n?\d+)E", m.group(1))
        loop = 0
        for addr, ins in code:
            b = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins)
            if b and int(b.group(1), 16) < addr:
                start = int(b.group(1), 16)
                loop = max(loop, sum(1 for a, _ in code if start <= a <= addr))
        r = regs.get(name)
        blocks, warps = resident(r, threads) if r else (None, None)
        out.append({
            "log2_block": int(shape.group(1).replace("n", "-")) if shape else None,
            "stats": m.group(2) == "1", "registers": r,
            "blocks_per_sm": blocks, "warps_per_sm": warps,
            "sass": len(code), "sass_loop": loop})
    out.sort(key=lambda e: (e["stats"], e["log2_block"] or 0))
    return out


def render(grid, gcfg, fcfg, R, t, **kw):
    from gradient_sdf_tpu_torch.data import synth
    from gradient_sdf_tpu_torch.ops import raycast

    return raycast.render_depth_normal(grid, synth.KINECT_K, R, t, W, H, gcfg,
                                       fcfg, s_min=S_MIN, s_max=S_MAX, **kw)


def time_render(grid, gcfg, fcfg, R, t, reps=5, **kw) -> dict:
    """ms per render on the host clock (each call ends synchronized), the
    median of `reps` after one warm-up call, with the march launch count."""
    import torch
    from gradient_sdf_tpu_torch.ops.kernels import raycast_march as rm

    render(grid, gcfg, fcfg, R, t, **kw)
    torch.cuda.synchronize()
    times = []
    before = rm.launch_count
    for _ in range(reps):
        t0 = time.perf_counter()
        render(grid, gcfg, fcfg, R, t, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    ms = times[len(times) // 2]
    return {"ms": ms, "mrays_per_s": W * H / ms / 1e3,
            "march_launches_per_render": (rm.launch_count - before) // reps}


def mode_kwargs(grid, gcfg, fcfg, R, t) -> dict:
    """{mode: render keywords} for the four modes: those of RENDER_MODES,
    and the stride-4 render as the incremental mode's depth prior."""
    out = dict(RENDER_MODES)
    prev = render(grid, gcfg, fcfg, R, t)[0]
    out["incremental"] = dict(depth_prior=prev, **INCREMENTAL)
    return out


def render_times(grid, gcfg, fcfg, R, t) -> dict:
    """{mode: time_render(...)} for the four modes."""
    return {name: time_render(grid, gcfg, fcfg, R, t, **kw)
            for name, kw in mode_kwargs(grid, gcfg, fcfg, R, t).items()}


# ---------------------------------------------------------------------------
# the passes around the march: windows and finish (`--windows`, `--finish`)
# ---------------------------------------------------------------------------

# the plain versions `render_depth_normal` takes in `plain_passes()`, by the
# names `ops/raycast.py` calls them
PLAIN_PASSES = {
    "render_windows": ("render_windows", "render_windows_reference"),
    "stride_windows": ("prior_windows", "stride_windows_reference"),
    "depth_prior_windows": ("prior_windows", "depth_prior_windows_reference"),
    "ray_finish": ("ray_finish", "ray_finish_reference"),
}
# operations of one hit's finish, counted from csrc/ray_finish.cu: the
# point 6, voxel index 6, block and key 20 (integer), norm and scale 8,
# centre offset 6, phi 7, G 3, denominator 5, s_ift and s_hit 5, normal 9,
# outputs 5
FINISH_OPS_PER_HIT = 80
# a block's projection and cull in csrc/render_windows.cu, float32
RASTER_OPS_PER_BLOCK = 60
# relative depth and point error allowed between the finish kernel and its
# plain version on the card: the plain version sums G . d and |G|^2 in an
# order PyTorch picks, and an ulp of the denominator moves s_ift by an ulp,
# which (m + s_ift) - s_ift rounds into s_hit: about an ulp of the depth
# (points: relative to the largest depth, as o + s d near the origin is a
# difference of larger numbers)
FINISH_REL_TOL = 2e-7
FINISH_NORMAL_TOL = 1e-6
GRAD_REL_TOL = 1e-5


@contextlib.contextmanager
def plain_passes():
    """`render_depth_normal` with its windows and its finish in their plain
    versions, on any device (the march stays the kernel)."""
    import importlib

    from gradient_sdf_tpu_torch.ops import raycast

    saved = {name: getattr(raycast, name) for name in PLAIN_PASSES}
    try:
        for name, (mod, ref) in PLAIN_PASSES.items():
            module = importlib.import_module(
                f"gradient_sdf_tpu_torch.ops.kernels.{mod}")
            setattr(raycast, name, getattr(module, ref))
        yield
    finally:
        for name, fn in saved.items():
            setattr(raycast, name, fn)


def device_camera(R, t, device):
    """K, R, t as float32 tensors on the card: a render that takes them
    uploads nothing."""
    import torch
    from gradient_sdf_tpu_torch.data import synth

    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in (synth.KINECT_K, R, t))


def scaled_camera(K, width, height):
    """K of a VGA camera scaled to a width x height image (the focal
    lengths by the width's ratio, the principal point to the centre)."""
    K = K.clone()
    K[0, 0] *= width / W
    K[1, 1] *= width / W
    K[0, 2], K[1, 2] = 0.5 * (width - 1), 0.5 * (height - 1)
    return K


def render_counts(grid, gcfg, fcfg, R, t, **kw) -> dict:
    """One render on the card (after an uncounted one) under the profiler
    and the sync debug mode (`track_bench.count_syncs`): its device
    operations (kernels, copies, memsets), `cudaLaunchKernel` calls,
    `nonzero` calls, host syncs and the line of the port at each; with R,
    t as host arrays (the upload included) and as tensors already on the
    card (`device_` keys)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from gradient_sdf_tpu_torch.tools.track_bench import count_syncs

    def one(R_, t_, K_=None):
        from gradient_sdf_tpu_torch.data import synth
        from gradient_sdf_tpu_torch.ops import raycast

        K_ = synth.KINECT_K if K_ is None else K_
        render = lambda: raycast.render_depth_normal(  # noqa: E731
            grid, K_, R_, t_, W, H, gcfg, fcfg, s_min=S_MIN, s_max=S_MAX, **kw)
        render()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, syncs = count_syncs(render)
            torch.cuda.synchronize()
        syncs = [f"{os.path.basename(f)}:{line}" for f, line, _ in syncs]
        ev = prof.key_averages()
        return {"device_ops": sum(e.count for e in ev
                                  if e.device_type == DeviceType.CUDA),
                "launches": sum(e.count for e in ev
                                if e.key == "cudaLaunchKernel"),
                "nonzero": sum(e.count for e in ev
                               if e.key.startswith("aten::nonzero")),
                "syncs": len(syncs), "sync_at": sorted(set(syncs))}

    out = one(R, t)
    K_d, R_d, t_d = device_camera(R, t, grid.device)
    out.update({f"device_{k}": v for k, v in one(R_d, t_d, K_d).items()})
    return out


def _equal_bits(a, b) -> int:
    """Entries of a and b that differ (NaN equal to NaN, -0 to +0 unequal
    only through their value: == is exact otherwise)."""
    import torch

    return int((~((a == b) | (torch.isnan(a) & torch.isnan(b)))).sum())


def windows_bound_ms(blocks: int, n_out: int) -> tuple:
    """(bound ms, by) of one `render_windows` call: bytes, 12 B a live
    block slot, K, R, t and the count, 8 B a window written; operations, a
    block's projection once (the kernel repeats it in every CTA; the bound
    counts the function's work)."""
    b = (12 * blocks + 4 * 22 + 8 * n_out) / MEM_BYTES_PER_S * 1e3
    o = RASTER_OPS_PER_BLOCK * blocks / F32_OPS_PER_S * 1e3
    return max(b, o), "bytes" if b >= o else "operations"


def prior_bound_ms(bytes_in: int, n_out: int) -> tuple:
    """(bound ms, by): the inputs once, 8 B a window written (the few
    comparisons a window are far below)."""
    return (bytes_in + 8 * n_out) / MEM_BYTES_PER_S * 1e3, "bytes"


def finish_bound(found, s_star, o, d, grid, gcfg, points: bool) -> dict:
    """The finish's least time on these rays: bytes, 33 B of ray state a
    ray (found, s_star, origin, direction, inv_hnorm), 20 B written (depth,
    normal, camera-z depth; 12 more with points), and per hit each distinct
    32-byte sector of the directory and of the five fields its lookup
    reads, once; operations, FINISH_OPS_PER_HIT a hit."""
    import torch
    from gradient_sdf_tpu_torch.ops import voxel_grid as vg

    hit = torch.nonzero(found).reshape(-1)
    p = o[hit] + s_star[hit, None] * d[hit]
    vi = vg.point_to_voxel(p, gcfg.voxel_size)
    block, local = vg.voxel_to_block(vi, gcfg)
    key = vg.pack_key(block, gcfg)
    inside = key >= 0
    slot = grid.directory[key[inside].long()]
    lin = slot[slot >= 0].long() * gcfg.voxels_per_block + local[inside][slot >= 0]
    dir_sectors = int(torch.unique(key[inside] // 8).numel())
    field_sectors = int(torch.unique(lin // 8).numel())
    n, hits = found.shape[0], hit.numel()
    nbytes = n * (33 + 20 + (12 if points else 0)) + 32 * (dir_sectors
                                                             + 5 * field_sectors)
    b = nbytes / MEM_BYTES_PER_S * 1e3
    ops = FINISH_OPS_PER_HIT * hits / F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "hits": hits, "directory_sectors": dir_sectors,
            "field_sectors": field_sectors, "bound_ms": max(b, ops),
            "bound_by": "bytes" if b >= ops else "operations"}


def _empty_ms(fn_name, *args):
    """CUDA-event ms of the empty kernel(s) `fn_name` launches (the launch
    floor at a kernel's grid)."""
    import torch
    from gradient_sdf_tpu_torch.ops.kernels import _build
    from gradient_sdf_tpu_torch.tools.fusion_bench import median_ms

    lib = _build.load()

    def run():
        rc = getattr(lib, fn_name)(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{fn_name}: CUDA error {rc}")

    return median_ms(run)


def render_windows_floor_ms(width: int, height: int, n_out: int,
                            tile: int = 16) -> float:
    """The launch floor of a `render_windows` call of the imported tree:
    one empty kernel at the patch grid of a width x height image (a tree
    with `gsdf_render_windows_shape`), else the two empty kernels of the
    earlier two-launch design (its one-CTA raster launch and its expansion
    of n_out windows)."""
    from gradient_sdf_tpu_torch.ops.kernels import _build

    if hasattr(_build.load(), "gsdf_render_windows_shape"):
        return _empty_ms("gsdf_render_windows_empty", width, height, tile)
    return _empty_ms("gsdf_render_windows_empty", n_out)


def prior_windows_floor_ms(depth: bool, width: int, height: int,
                           stride: int) -> float:
    """The launch floor of a `prior_windows` call of the imported tree: one
    empty kernel at its grid (the earlier kernel's: a thread a pixel)."""
    from gradient_sdf_tpu_torch.ops.kernels import _build

    fn = _build.load().gsdf_prior_windows_empty
    if len(fn.argtypes) == 2:
        return _empty_ms("gsdf_prior_windows_empty", width * height)
    return _empty_ms("gsdf_prior_windows_empty", int(depth), width, height,
                     stride)


def render_windows_launch(width: int, height: int, tile: int = 16) -> dict:
    """This tree's `render_windows` launch for an image: patch tiles, CTAs,
    threads."""
    import ctypes

    from gradient_sdf_tpu_torch.ops.kernels import _build

    out = (ctypes.c_int * 4)()
    rc = _build.load().gsdf_render_windows_shape(width, height, tile, out)
    if rc != 0:
        raise RuntimeError(f"gsdf_render_windows_shape: CUDA error {rc}")
    return {"patch_tiles": [out[0], out[1]], "ctas": out[2], "threads": out[3]}


# `render_windows`' sweep: the scene's active blocks and SWEEP_BLOCKS
# synthetic ones, at each image size (the VGA camera's field of view)
SWEEP_BLOCKS = 4096
SWEEP_SIZES = ((640, 480), (1920, 1080), (3840, 2160))


def synthetic_grid(grid, blocks: int, seed: int = 19):
    """The render scene's grid with `blocks` active block slots: its own
    active blocks, then seeded ones drawn uniformly from their bounding box
    (so that they project on screen, near and far, small and wide)."""
    import numpy as np
    import torch

    na = int(grid.num_active)
    if blocks <= na:
        return grid
    bc = grid.block_coords.clone()
    act = bc[:na].cpu().numpy()
    rng = np.random.default_rng(seed)
    extra = rng.integers(act.min(0), act.max(0) + 1, size=(blocks - na, 3))
    bc[na:blocks] = torch.from_numpy(extra.astype(np.int32)).to(bc.device)
    return grid._replace(block_coords=bc, num_active=torch.tensor(
        blocks, dtype=torch.int32, device=bc.device))


def windows_sweep(grid, gcfg, R, t) -> dict:
    """`render_windows` of the imported tree, every pixel clamped (the
    raster render's form) and the stride-4 coarse pixels, at the scene's
    active blocks and SWEEP_BLOCKS, at each of SWEEP_SIZES: ms by CUDA
    events beside the launch floor and the bound."""
    from gradient_sdf_tpu_torch.ops.kernels import render_windows as rw
    from gradient_sdf_tpu_torch.tools.fusion_bench import median_ms

    K_d, R_d, t_d = device_camera(R, t, grid.device)
    out = {}
    for blocks in (int(grid.num_active), SWEEP_BLOCKS):
        g = synthetic_grid(grid, blocks)
        for w, h in SWEEP_SIZES:
            k = K_d if (w, h) == (W, H) else scaled_camera(K_d, w, h)
            for form, kw in (("every pixel", {}), ("stride-4 coarse",
                                                   dict(stride=4, offset=2))):
                n_out = w * h if not kw else (h // 4) * (w // 4)
                bound, by = windows_bound_ms(blocks, n_out)
                out[f"{blocks} blocks, {w}x{h}, {form}"] = {
                    "ms": median_ms(lambda: rw.render_windows(
                        g, k, R_d, t_d, w, h, gcfg, s_min=S_MIN, s_max=S_MAX,
                        **kw)),
                    "launch_floor_ms": render_windows_floor_ms(w, h, n_out),
                    "bound_ms": bound, "bound_by": by}
    return out


def prior_inputs(grid, gcfg, fcfg, R, t) -> dict:
    """The priors' inputs at this pose: the stride-4 coarse march's s_mid
    and found, the stride-4 render's camera-z depth and the rays'
    inv_hnorm, the margins, and the masked coarse image that `max_pool2d`
    (the library yardstick of the stride prior's max half) takes."""
    import torch
    from gradient_sdf_tpu_torch.ops import raycast
    from gradient_sdf_tpu_torch.ops.kernels import raycast_march as rm
    from gradient_sdf_tpu_torch.ops.kernels import render_windows as rw

    dev = grid.device
    K_d, R_d, t_d = device_camera(R, t, dev)
    stride, off = 4, 2
    hc, wc = H // stride, W // stride
    o, d, inv_hnorm = raycast.camera_rays(K_d, R_d, t_d, W, H, device=dev)

    def coarse(a):
        img = a.reshape((H, W) + tuple(a.shape[1:]))
        return img[off::stride, off::stride].reshape(
            (-1,) + tuple(a.shape[1:])).contiguous()

    lo_c, hi_c = rw.render_windows(grid, K_d, R_d, t_d, W, H, gcfg, stride=stride,
                                   offset=off, s_min=S_MIN, s_max=S_MAX)
    res_c = rm.raycast_march(coarse(o), coarse(d), lo_c, hi_c, grid.directory,
                             grid.coarse_occ, grid.dist, grid.weight, gcfg, fcfg,
                             width=wc)
    vs = gcfg.voxel_size
    return {"s_mid": res_c.s_mid, "found": res_c.found,
            "prior": render(grid, gcfg, fcfg, R_d, t_d)[0].reshape(-1),
            "inv_hnorm": inv_hnorm, "hc": hc, "wc": wc, "stride": stride,
            "margin": fcfg.trunc_voxels * vs + 2 * vs, "margin4": 4 * vs,
            "masked": torch.where(res_c.found, res_c.s_mid, -float("inf")
                                  ).reshape(1, 1, hc, wc)}


def prior_calls(p) -> dict:
    """{case: (kernel wrapper, plain version, args, keywords)} of the two
    priors in both miss rules."""
    from gradient_sdf_tpu_torch.ops.kernels import prior_windows as pw

    clamps = dict(s_min=S_MIN, s_max=S_MAX)
    sw = dict(hc=p["hc"], wc=p["wc"], stride=p["stride"], margin=p["margin"],
              **clamps)
    dw = dict(margin=p["margin4"], **clamps)
    stride_pair = (pw.stride_windows, pw.stride_windows_reference,
                   (p["s_mid"], p["found"]))
    depth_pair = (pw.depth_prior_windows, pw.depth_prior_windows_reference,
                  (p["prior"], p["inv_hnorm"]))
    return {
        "stride prior, misses skipped": (*stride_pair, dict(sw, skip=True)),
        "stride prior, misses marched": (*stride_pair, dict(sw, skip=False)),
        "depth prior, holes skipped, 4-voxel margin": (
            *depth_pair, dict(dw, skip=True)),
        "depth prior, holes marched, default margin": (
            *depth_pair, dict(dw, margin=p["margin"], skip=False)),
    }


def prior_times(p) -> dict:
    """The imported tree's `prior_windows` in both modes (stride: misses
    skipped; depth: the incremental mode's holes skipped, 4-voxel margin):
    ms, plain ms, launch floor, bound and (stride) a 3x3 `max_pool2d` of
    the masked coarse image, the library yardstick of its max half."""
    import torch
    from gradient_sdf_tpu_torch.tools.fusion_bench import median_ms

    calls = prior_calls(p)
    timed = {"stride": calls["stride prior, misses skipped"],
             "depth": calls["depth prior, holes skipped, 4-voxel margin"]}
    out = {}
    for form, (kern, ref, args, kw) in timed.items():
        bytes_in = 5 * p["hc"] * p["wc"] if form == "stride" else 8 * H * W
        bound, by = prior_bound_ms(bytes_in, H * W)
        out[form] = {
            "ms": median_ms(lambda: kern(*args, **kw)),
            "plain_ms": median_ms(lambda: ref(*args, **kw), reps=5),
            "launch_floor_ms": prior_windows_floor_ms(form == "depth", W, H,
                                                      p["stride"]),
            "bound_ms": bound, "bound_by": by,
            "library_ms": (median_ms(lambda: torch.nn.functional.max_pool2d(
                p["masked"], 3, 1, 1)) if form == "stride" else None)}
    return out


def windows_check_and_time(grid, gcfg, fcfg, R, t) -> dict:
    """`render_windows` and `prior_windows` against their plain versions
    on the card, bit for bit (tile grid and windows), in every form the
    render takes, at the escapes, at 1920x1080 and 3840x2160 and at
    SWEEP_BLOCKS synthetic active blocks; then each timed beside its plain
    version, the launch floor (an empty kernel at its grid), its bound and,
    for the stride prior, the library yardstick of its max half (a 3x3
    `max_pool2d` of the masked coarse image); and `render_windows` over
    the sweep of active blocks and image sizes (`windows_sweep`)."""
    import torch
    from gradient_sdf_tpu_torch.ops.kernels import render_windows as rw
    from gradient_sdf_tpu_torch.tools.fusion_bench import median_ms

    dev = grid.device
    K_d, R_d, t_d = device_camera(R, t, dev)
    stride, off = 4, 2
    clamps = dict(s_min=S_MIN, s_max=S_MAX)
    na = int(grid.num_active)
    # a camera inside the band: blocks straddle its plane (the global range)
    bs, vs = gcfg.block_shape, gcfg.voxel_size
    c0 = (grid.block_coords[0].float() * bs + 0.5 * (bs - 1)) * vs
    vga = (W, H, K_d)
    # larger images, the VGA camera's field of view: the render's own tile
    # and span, and spans of up to 64 tiles rasterized
    big = {w_h: (*w_h, scaled_camera(K_d, *w_h)) for w_h in ((1920, 1080),
                                                            (3840, 2160))}
    many = synthetic_grid(grid, SWEEP_BLOCKS)
    cases = {
        "raster (every pixel, clamped)": (dict(**clamps), t_d, vga, grid),
        "stride-4 coarse pixels, clamped": (dict(stride=stride, offset=off,
                                                 **clamps), t_d, vga, grid),
        "block_raster_windows (every pixel)": (dict(), t_d, vga, grid),
        f"active_cap {na // 2} < {na} blocks (the escape)": (
            dict(active_cap=na // 2), t_d, vga, grid),
        "camera inside the band (near blocks)": (dict(), c0, vga, grid),
        "1920x1080, every pixel": (dict(), t_d, big[1920, 1080], grid),
        "3840x2160, every pixel, spans to 64 tiles": (
            dict(max_span=64), t_d, big[3840, 2160], grid),
        f"{SWEEP_BLOCKS} synthetic blocks, every pixel, clamped": (
            dict(**clamps), t_d, vga, many),
        f"{SWEEP_BLOCKS} synthetic blocks, 3840x2160, spans to 64 tiles": (
            dict(max_span=64), t_d, big[3840, 2160], many),
    }
    out = {"render_windows": {"cases": {}, "launch": {
               f"{w}x{h}": render_windows_launch(w, h) for w, h in SWEEP_SIZES}},
           "prior_windows": {"cases": {}}}
    for what, (kw, tt, (w, h, k), g) in cases.items():
        got = rw.render_windows(g, k, R_d, tt, w, h, gcfg, **kw)
        want = rw.render_windows_reference(g, k, R_d, tt, w, h, gcfg, **kw)
        # the finished tile grid: one window a tile, unclamped
        tkw = dict(kw, stride=16, offset=0, s_min=None, s_max=None)
        tiles = rw.render_windows(g, k, R_d, tt, w, h, gcfg, **tkw)
        tiles_want = rw.render_windows_reference(g, k, R_d, tt, w, h, gcfg, **tkw)
        torch.cuda.synchronize()
        lo_t = tiles_want[0]
        out["render_windows"]["cases"][what] = {
            "windows": want[0].numel(),
            "windows_differing": _equal_bits(got[0], want[0])
            + _equal_bits(got[1], want[1]),
            "tiles_differing": _equal_bits(tiles[0], tiles_want[0])
            + _equal_bits(tiles[1], tiles_want[1]),
            "covered_tiles": int(torch.isfinite(lo_t).sum()),
            "tiles": lo_t.numel(),
            "empty_windows": int((want[0] > want[1]).sum())}
    for form, kw in (("raster", dict(**clamps)),
                     ("stride4", dict(stride=stride, offset=off, **clamps))):
        n_out = H * W if form == "raster" else (H // stride) * (W // stride)
        bound, by = windows_bound_ms(min(na, 4096), n_out)
        out["render_windows"][form] = {
            "ms": median_ms(lambda kw=kw: rw.render_windows(
                grid, K_d, R_d, t_d, W, H, gcfg, **kw)),
            "plain_ms": median_ms(lambda kw=kw: rw.render_windows_reference(
                grid, K_d, R_d, t_d, W, H, gcfg, **kw), reps=5),
            "launch_floor_ms": render_windows_floor_ms(W, H, n_out),
            "bound_ms": bound, "bound_by": by, "library_ms": None}
    bound, by = windows_bound_ms(SWEEP_BLOCKS, H * W)
    out["render_windows"][f"raster_{SWEEP_BLOCKS}_blocks"] = {
        "ms": median_ms(lambda: rw.render_windows(many, K_d, R_d, t_d, W, H,
                                                  gcfg, **clamps)),
        "launch_floor_ms": render_windows_floor_ms(W, H, H * W),
        "bound_ms": bound, "bound_by": by}
    out["render_windows"]["sweep"] = windows_sweep(grid, gcfg, R, t)

    # the stride prior on the coarse march of this pose; the depth prior on
    # the stride-4 render
    p = prior_inputs(grid, gcfg, fcfg, R, t)
    for what, (kern, ref, args, kw) in prior_calls(p).items():
        got, want = kern(*args, **kw), ref(*args, **kw)
        torch.cuda.synchronize()
        out["prior_windows"]["cases"][what] = {
            "windows": want[0].numel(),
            "windows_differing": _equal_bits(got[0], want[0])
            + _equal_bits(got[1], want[1]),
            "empty_windows": int((want[0] > want[1]).sum())}
    out["prior_windows"].update(prior_times(p))
    out["coarse_hits"] = int(p["found"].sum())
    return out


# The window kernels taken apart (`windows_split`): one-switch builds of a
# copy of this tree's `csrc/render_windows.cu` and `csrc/prior_windows.cu`,
# made like fusion_bench.SPLIT_SWITCHES (each anchor in its source exactly
# once). A build that stops early keeps its last stage's results live
# through a store that does not happen.
_RW_READS = ("na + b0 + b1 + b2 == -7 && fx + cx + fy + cy + R00 + R01 + R02 "
             "+ R10 + R11 + R12 + R20 + R21 + R22 + tx + ty + tz == -1.5e30f")
_RW_LOOP = "    for (; i < n; i += kThreads) {\n"
RENDER_WINDOWS_SWITCHES = {
    "patches, a CTA projects every block": (_RW_LOOP, {
        "empty kernel at its grid": [(
            "  extern __shared__ int smem[];   // the patch",
            "  return;\n  extern __shared__ int smem[];   // the patch")],
        "reads alone": [(
            "  const bool over = na > a.cap;\n",
            f"  if ({_RW_READS}) lo[0] = 0.f;\n  return;\n"
            "  const bool over = na > a.cap;\n")],
        "reads and stores (no projection)": [(
            "  if (!over) {\n    // 2. the projection",
            "  if (false) {\n    // 2. the projection")],
        "no atomics (projection into a sink)": [
            ("    const int n = min(na, a.cap);\n",
             "    const int n = min(na, a.cap);\n    int sink = 0;\n"),
            ("              atomicMin(lo_s + k, lo_bits);\n"
             "              atomicMax(hi_s + k, hi_bits);\n",
             "              sink += k + (lo_bits ^ hi_bits);\n"),
            ("    if ((tid & 31) == 0 && g_lo != kInfBits) atomicMin(glob, g_lo);\n"
             "    if ((tid & 31) == 0 && g_hi != kNegInfBits) atomicMax(glob + 1, g_hi);\n",
             "    if (sink + g_lo + g_hi == 123456789) lo[0] = 0.f;\n")],
        "no stores (reads, projection, atomics)": [(
            "  // 4. the stores: the output rows",
            "  if (lo_s[tid % np] == 7 && glob[0] == 7) lo[0] = 0.f;\n  return;\n"
            "  // 4. the stores: the output rows")],
        "one slot a thread (the first 1024 blocks)": [(
            _RW_LOOP, "    for (; i < min(n, kThreads); i += kThreads) {\n")],
        "behind and near tests alone (every block, no division)": [(
            "      if (!glob_block) {\n        const float u = fx * qx / qz + cx;",
            "      if (!glob_block && qz == -1.5e30f) {\n"
            "        const float u = fx * qx / qz + cx;")],
        "512 threads a CTA": [("constexpr int kThreads = 1024;",
                               "constexpr int kThreads = 512;")],
    }),
}
PRIOR_WINDOWS_SWITCHES = {
    "32 x 8 cells staged, float4 rows": ("constexpr int kCellsX = 32", {
        "empty kernel at its grid": [(
            "  __shared__ float s_mn[kHaloY][kHaloX];",
            "  return;\n  __shared__ float s_mn[kHaloY][kHaloX];")],
        "staging alone": [(
            "  // 2. the cell pass: a thread a cell\n",
            "  if (s_mn[tid / kHaloX % kHaloY][tid % kHaloX] == -1.5e30f && "
            "s_ok[0][tid % kHaloX]) lo[0] = 0.f;\n  return;\n"
            "  // 2. the cell pass: a thread a cell\n")],
        "staging and cell pass (no stores)": [(
            "  // 3. the stores: a group of lanes a pixel row\n",
            "  if (cell[tid / kCellsX][tid % kCellsX].x == -1.5e30f) lo[0] = 0.f;\n"
            "  return;\n  // 3. the stores: a group of lanes a pixel row\n")],
        "cell pass and stores (no staging loads)": [(
            "  for (int k = tid; k < kHaloY * kHaloX; k += kThreads) {",
            "  for (int k = tid; k < 0; k += kThreads) {")],
        "16 x 8 cells a CTA of 128": [
            ("constexpr int kThreads = 256;", "constexpr int kThreads = 128;"),
            ("constexpr int kCellsX = 32", "constexpr int kCellsX = 16")],
    }),
}
RENDER_WINDOWS_FUNCS = ("gsdf_render_windows_f32",)
PRIOR_WINDOWS_FUNCS = ("gsdf_prior_windows_f32",)


def windows_split(grid, gcfg, fcfg, R, t) -> dict:
    """Step 0 of the two window kernels: this tree's `render_windows.cu`
    and `prior_windows.cu` built as they are and under each switch of
    their designs (RENDER_WINDOWS_SWITCHES, PRIOR_WINDOWS_SWITCHES; one
    `nvcc` a build, started together), each launched through this
    package's wrapper and timed (`median_ms`): `render_windows` every pixel
    and coarse at the scene's blocks and every pixel at SWEEP_BLOCKS (VGA);
    `prior_windows` in stride mode (its switches cut the stride kernel) and
    depth mode; with each build's ptxas report and its kernels' SASS
    instructions and CALLs (the IEEE division's and square root's slow
    paths)."""
    from gradient_sdf_tpu_torch.ops.kernels import render_windows as rw
    from gradient_sdf_tpu_torch.tools.fusion_bench import (
        build_all, median_ms, ptxas_lines, switch_jobs, with_lib)

    jobs_r, design_r = switch_jobs([OWN_ROOT], "render_windows.cu",
                                   RENDER_WINDOWS_SWITCHES, RENDER_WINDOWS_FUNCS)
    jobs_p, design_p = switch_jobs([OWN_ROOT], "prior_windows.cu",
                                   PRIOR_WINDOWS_SWITCHES, PRIOR_WINDOWS_FUNCS)
    built = build_all([((f"render_windows", k[1]), a, kw) for k, a, kw in jobs_r]
                      + [((f"prior_windows", k[1]), a, kw) for k, a, kw in jobs_p])
    K_d, R_d, t_d = device_camera(R, t, grid.device)
    many = synthetic_grid(grid, SWEEP_BLOCKS)
    clamps = dict(s_min=S_MIN, s_max=S_MAX)
    rcases = {
        f"{int(grid.num_active)} blocks, every pixel": (grid, clamps),
        f"{int(grid.num_active)} blocks, stride-4 coarse": (
            grid, dict(clamps, stride=4, offset=2)),
        f"{SWEEP_BLOCKS} blocks, every pixel": (many, clamps),
    }
    p = prior_inputs(grid, gcfg, fcfg, R, t)
    calls = prior_calls(p)
    pcases = {"stride": calls["stride prior, misses skipped"],
              "depth": calls["depth prior, holes skipped, 4-voxel margin"]}
    out = {"render_windows": {"design": design_r[0]},
           "prior_windows": {"design": design_p[0]}}
    for (kernel, name), (lib, log) in built.items():
        if kernel == "render_windows":
            ms = {what: median_ms(lambda g=g, kw=kw: with_lib(
                lib, lambda: rw.render_windows(g, K_d, R_d, t_d, W, H, gcfg, **kw)))
                  for what, (g, kw) in rcases.items()}
        else:
            ms = {form: median_ms(lambda c=c: with_lib(
                lib, lambda: c[0](*c[2], **c[3])))
                  for form, c in pcases.items()}
        code = [v for k, v in _sass_functions(lib._name).items()
                if kernel in k and "empty" not in k]
        out[kernel][name] = {
            "ms": ms, "ptxas": ptxas_lines(log, "windows"),
            "sass": [{"instructions": len(c),
                      "calls": sum(ins.startswith("CALL") for _, ins in c)}
                     for c in code]}
    return out


def finish_check_and_time(grid, gcfg, fcfg, R, t) -> dict:
    """`ray_finish` against its plain version on the card on every ray of
    this pose, marched unwindowed: in the render's form (camera-z depth, no
    points) and in `raycast`'s (points): depth, points and camera-z depth
    relative, normals absolute; d(mean depth)/dt of a render without prior
    through the kernel's backward against the plain autograd; then timed
    beside its plain version, the launch floor and its bound."""
    import torch
    from gradient_sdf_tpu_torch.ops import raycast
    from gradient_sdf_tpu_torch.ops.kernels import ray_finish as rf
    from gradient_sdf_tpu_torch.ops.kernels import raycast_march as rm
    from gradient_sdf_tpu_torch.tools.fusion_bench import median_ms

    dev = grid.device
    K_d, R_d, t_d = device_camera(R, t, dev)
    o, d, inv_hnorm = raycast.camera_rays(K_d, R_d, t_d, W, H, device=dev)
    o = o.contiguous()
    n = o.shape[0]
    res = rm.raycast_march(o, d, torch.full((n,), S_MIN, device=dev),
                           torch.full((n,), S_MAX, device=dev), grid.directory,
                           grid.coarse_occ, grid.dist, grid.weight, gcfg, fcfg,
                           width=W)
    args = (res.found, res.s_star, o, d)

    def rel(a, b):
        return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())

    def rel_depth(a, b, depth):
        # a point o + s d near the origin is a difference of larger numbers:
        # an ulp of s moves it by an ulp of s, so it is held relative to the
        # largest depth
        return float((a - b).abs().max() / depth.abs().max())

    out = {"rays": n, "hits": int(res.found.sum())}
    for form, ih, pts in (("render", inv_hnorm, False), ("raycast", None, True)):
        got = rf.ray_finish(*args, ih, grid, gcfg, fcfg, points=pts)
        want = rf.ray_finish_reference(*args, ih, grid, gcfg, fcfg, points=pts)
        torch.cuda.synchronize()
        row = {"depth_rel_err": rel(got.depth, want.depth),
               "depth_differing": _equal_bits(got.depth, want.depth),
               "normal_abs_err": float((got.normal - want.normal).abs().max()),
               "hit_differing": int(((got.depth != 0) != (want.depth != 0)).sum())}
        if ih is not None:
            row["zdepth_rel_err"] = rel(got.zdepth, want.zdepth)
        if pts:
            row["points_rel_err"] = rel_depth(got.points, want.points, want.depth)
        out[form] = row

    # `finish_values` (the kernel's arithmetic in torch, which the CPU tests
    # of the backward run) against the kernel, outputs and saved state
    out["finish_values"] = finish_values_vs_kernel(args, inv_hnorm, grid, gcfg,
                                                   fcfg)

    # d(mean depth)/dt through the kernel's backward vs the plain autograd
    def grad_t(plain):
        tt = t_d.clone().requires_grad_(True)
        ctx = plain_passes() if plain else contextlib.nullcontext()
        with ctx:
            depth, _, hit = raycast.render_depth_normal(
                grid, K_d, R_d, tt, W, H, gcfg, fcfg, s_min=S_MIN, s_max=S_MAX,
                prior_stride=0)
        (depth.sum() / hit.sum()).backward()
        return tt.grad

    g_k, g_p = grad_t(False), grad_t(True)
    out["grad_t"] = g_k.tolist()
    out["grad_t_plain"] = g_p.tolist()
    out["grad_rel_err"] = float((g_k - g_p).abs().max() / g_p.abs().max())

    bound = finish_bound(res.found, res.s_star, o, d, grid, gcfg, False)
    call = lambda: rf.ray_finish(*args, inv_hnorm, grid, gcfg, fcfg,  # noqa: E731
                                 points=False)
    out.update(bound)
    out.update({
        "ms": median_ms(call),
        "plain_ms": median_ms(lambda: rf.ray_finish_reference(
            *args, inv_hnorm, grid, gcfg, fcfg, points=False), reps=5),
        "launch_floor_ms": _empty_ms("gsdf_ray_finish_empty", n),
        "library_ms": None})
    return out


def finish_values_vs_kernel(args, inv_hnorm, grid, gcfg, fcfg) -> dict:
    """`ray_finish.finish_values` against the kernel's launch with the
    backward's state, on the same rays: the voxel index and the safe flag
    (entries differing), and every float output and state column (depth,
    points, normal, camera-z depth, g, s, cmp, dc) as its largest
    |difference| over its largest |entry| (`rel_err`, against
    FINISH_REL_TOL) and as entries not bit-equal."""
    import torch
    from gradient_sdf_tpu_torch.ops.kernels import ray_finish as rf

    kw = dict(points=True, state=True)
    got, (lin, safe, aux) = rf._launch(*args, inv_hnorm, grid, gcfg, fcfg, **kw)
    want, (lin_w, safe_w, aux_w) = rf.finish_values(*args, inv_hnorm, grid, gcfg,
                                                    fcfg, **kw)
    torch.cuda.synchronize()
    pairs = list(zip(got, want)) + [(aux[:, k], aux_w[:, k]) for k in range(8)]
    rel, differing = 0.0, 0
    for a, b in pairs:
        scale = float(b.abs().max())
        if scale > 0:
            rel = max(rel, float((a - b).abs().max()) / scale)
        differing += _equal_bits(a, b)
    return {"lin_differing": int((lin != lin_w).sum()),
            "safe_differing": int((safe != safe_w).sum()),
            "rel_err": rel, "values_differing": differing}


def windows_finish_ok(win: Optional[dict], fin: Optional[dict]) -> list:
    """The failures of the checks above, of whichever ran (None: not run):
    windows and tiles bit for bit, the finish within FINISH_REL_TOL (depth,
    points, camera-z depth), FINISH_NORMAL_TOL (normals), no hit differing,
    the gradient within GRAD_REL_TOL."""
    bad = []
    for k in ("render_windows", "prior_windows") if win else ():
        for what, c in win[k]["cases"].items():
            if c["windows_differing"] or c.get("tiles_differing", 0):
                bad.append(f"{k} {what}: {c}")
    if fin is None:
        return bad
    for form in ("render", "raycast"):
        r = fin[form]
        errs = [r["depth_rel_err"], r.get("zdepth_rel_err", 0.0),
                r.get("points_rel_err", 0.0)]
        if (max(errs) > FINISH_REL_TOL or r["normal_abs_err"] > FINISH_NORMAL_TOL
                or r["hit_differing"]):
            bad.append(f"ray_finish {form} form: {r}")
    fv = fin["finish_values"]
    if fv["lin_differing"] or fv["safe_differing"] or not fv["rel_err"] <= FINISH_REL_TOL:
        bad.append(f"ray_finish.finish_values vs the kernel: {fv}")
    if not fin["grad_rel_err"] <= GRAD_REL_TOL:
        bad.append(f"ray_finish d(mean depth)/dt: {fin['grad_t']} vs plain "
                   f"{fin['grad_t_plain']}, rel err {fin['grad_rel_err']}")
    return bad


def render_vs_plain(grid, gcfg, fcfg, R, t) -> dict:
    """Each render mode through the kernels against the same render with
    the windows and the finish in their plain versions (the march kernel in
    both): hit masks bit for bit, depth within FINISH_REL_TOL relative,
    normals within FINISH_NORMAL_TOL."""
    import torch

    def renders():
        out = {name: render(grid, gcfg, fcfg, R, t, **kw)
               for name, kw in RENDER_MODES.items()}
        out["incremental"] = render(grid, gcfg, fcfg, R, t,
                                    depth_prior=out["stride4"][0], **INCREMENTAL)
        return out

    got = renders()
    with plain_passes():
        want = renders()
    torch.cuda.synchronize()
    res = {}
    for name, (dg, ng, hg) in got.items():
        dw, nw, hw = want[name]
        res[name] = {
            "hits": int(hw.sum()), "hit_differing": int((hg != hw).sum()),
            "depth_rel_err": float(((dg - dw).abs()
                                    / dw.abs().clamp(min=1e-30)).max()),
            "normal_abs_err": float((ng - nw).abs().max())}
    return res


def tree_times() -> dict:
    """The imported tree's march kernel and renders on its own fusion of the
    scene (for `--parent`): per pass the kernel's ms with the rays in their
    order (and tiled, where the tree can), its warp-probes and issue slots
    per warp-probe at the SM clock read while it ran; its instances' code."""
    import torch
    from gradient_sdf_tpu_torch.ops.kernels import _build
    from gradient_sdf_tpu_torch.ops.kernels import raycast_march as rm
    from gradient_sdf_tpu_torch.tools.fusion_bench import median_ms

    grid, gcfg, fcfg, _, poses = render_scene(torch.device("cuda"))
    R, t = poses[4]
    tiles = "width" in inspect.signature(rm.raycast_march).parameters
    march = {}
    for windowed in (False, True):
        args = march_args(grid, gcfg, R, t, windowed)
        probes = rm.raycast_march(*args, gcfg, fcfg, stats=True).stats[:, 0].float()
        wp = warp_probes(probes, None)[0]
        ms = median_ms(lambda: rm.raycast_march(*args, gcfg, fcfg))
        mhz = sm_clock_while(lambda: rm.raycast_march(*args, gcfg, fcfg))
        row = {"ms": ms, "probes": float(probes.sum()), "warp_probes": wp,
               "sm_clock_mhz_min_median_max": mhz,
               "issue_slots_per_warp_probe": issue_slots_per_warp_probe(
                   ms, wp, mhz[1] * 1e6)}
        if tiles:
            row["ms_tiled"] = median_ms(
                lambda: rm.raycast_march(*args, gcfg, fcfg, width=W))
        march["windowed" if windowed else "unwindowed"] = row
    modes = mode_kwargs(grid, gcfg, fcfg, R, t)
    return {"march": march,
            # a tree without THREADS has the earlier 256-thread kernel
            "code": [c for c in march_code(_build.lib_path, _build.build_log,
                                           getattr(rm, "THREADS", 256))
                     if not c["stats"]],
            "render_ms": {k: v["ms"] for k, v in
                          render_times(grid, gcfg, fcfg, R, t).items()},
            "render_counts": {k: render_counts(grid, gcfg, fcfg, R, t, **kw)
                              for k, kw in modes.items()}}


def tree_window_times() -> dict:
    """The imported tree's window kernels on its own fusion of the scene
    (for `--windows --parent`): `render_windows` over the sweep
    (`windows_sweep`), `prior_windows` in both modes (`prior_times`), and
    each render mode's ms, launches and syncs."""
    import torch

    grid, gcfg, fcfg, _, poses = render_scene(torch.device("cuda"))
    R, t = poses[4]
    return {"render_windows": windows_sweep(grid, gcfg, R, t),
            "prior_windows": prior_times(prior_inputs(grid, gcfg, fcfg, R, t)),
            "render_ms": {k: v["ms"] for k, v in
                          render_times(grid, gcfg, fcfg, R, t).items()},
            "render_counts": {k: render_counts(grid, gcfg, fcfg, R, t, **kw)
                              for k, kw in mode_kwargs(grid, gcfg, fcfg, R,
                                                       t).items()}}


def run_tree(root, windows: bool = False):
    cmd = [sys.executable, os.path.abspath(__file__), "--tree", root] + (
        ["--windows"] if windows else [])
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout of an earlier commit to compare")
    ap.add_argument("--tree", help="measure the package in DIR alone (part 5)")
    ap.add_argument("--windows", action="store_true",
                    help="the window kernels vs plain, timed (part 6)")
    ap.add_argument("--finish", action="store_true",
                    help="the finish kernel vs plain, timed (part 6)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree or OWN_ROOT))
    import torch

    if not torch.cuda.is_available():
        print("raycast_bench: CUDA is not available; this needs a card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.tree:
        print(json.dumps(tree_window_times() if args.windows else tree_times()),
              flush=True)
        return 0
    from gradient_sdf_tpu_torch.ops.kernels import _build
    from gradient_sdf_tpu_torch.ops.kernels import raycast_march as rm

    print(smi_line(), flush=True)
    dev = torch.device("cuda")
    grid, gcfg, fcfg, _, poses = render_scene(dev)
    R, t = poses[4]
    print(json.dumps({"scene": {"blocks": int(grid.num_active), "rays": W * H}}))
    failures = []
    if args.windows or args.finish:
        win = windows_check_and_time(grid, gcfg, fcfg, R, t) if args.windows else None
        fin = finish_check_and_time(grid, gcfg, fcfg, R, t) if args.finish else None
        if win:
            print(json.dumps({"windows": win}), flush=True)
            print(json.dumps({"windows_split": windows_split(grid, gcfg, fcfg,
                                                             R, t)}), flush=True)
        if fin:
            print(json.dumps({"finish": fin}), flush=True)
        failures += windows_finish_ok(win, fin)
        vs_plain = render_vs_plain(grid, gcfg, fcfg, R, t)
        print(json.dumps({"render_vs_plain_passes": vs_plain}), flush=True)
        failures += [f"{k}: {v}" for k, v in vs_plain.items()
                     if v["hit_differing"] or v["depth_rel_err"] > FINISH_REL_TOL
                     or v["normal_abs_err"] > FINISH_NORMAL_TOL]
    else:
        march = {}
        for windowed in (False, True):
            for width in (None, W):
                r = march_check_and_time(grid, gcfg, fcfg, R, t, windowed, width,
                                         plain=width is None)
                march[windowed, width] = r
                print(json.dumps({"march": r}), flush=True)
        args_u = march_args(grid, gcfg, R, t, False)
        mhz = sm_clock_while(lambda: rm.raycast_march(*args_u, gcfg, fcfg, width=W))
        slots = {f"{'windowed' if w else 'unwindowed'}_{'tiled' if wd else 'flat'}":
                 issue_slots_per_warp_probe(r["ms"], r["warp_probes"], mhz[1] * 1e6)
                 for (w, wd), r in march.items()}
        print(json.dumps({"code": march_code(_build.lib_path, _build.build_log,
                                             rm.THREADS),
                          "sm_clock_mhz_min_median_max": mhz,
                          "issue_slots_per_warp_probe": slots}), flush=True)
    for name, r in render_times(grid, gcfg, fcfg, R, t).items():
        print(json.dumps({"render": name, **r}), flush=True)
    for name, kw in mode_kwargs(grid, gcfg, fcfg, R, t).items():
        print(json.dumps({"render_counts": name,
                          **render_counts(grid, gcfg, fcfg, R, t, **kw)}),
              flush=True)
    from gradient_sdf_tpu_torch.tools.ba_bench import profile_call

    for name in ("stride4", "no_prior"):
        prof = profile_call(lambda: render(grid, gcfg, fcfg, R, t,
                                           **RENDER_MODES[name]), top=1000)
        prof["march_kernel_ms"] = sum(r["ms"] for r in prof["top"]
                                      if "march_rays" in r["name"])
        prof["top"] = prof["top"][:6]
        print(json.dumps({"profile": name, **prof}), flush=True)
    if args.parent:
        del grid
        torch.cuda.empty_cache()
        for name, root in (("parent", args.parent), ("this", OWN_ROOT),
                           ("this", OWN_ROOT), ("parent", args.parent)):
            print(json.dumps({"tree": name, **run_tree(root, args.windows)}),
                  flush=True)
    print(smi_line(), flush=True)
    if failures:
        print("raycast_bench: checks failed:\n" + "\n".join(failures),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
