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
     and tiled where the tree can) and the four render modes' ms.
     `--tree DIR` is what the script passes to itself for that.

`chip_smoke.py` runs the same functions as its phases 8 and 9 and adds the
checks against the analytic depth and the CPU.
"""

import argparse
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import time

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


def render_times(grid, gcfg, fcfg, R, t) -> dict:
    """{mode: time_render(...)} for the four modes."""
    out = {name: time_render(grid, gcfg, fcfg, R, t, **kw)
           for name, kw in RENDER_MODES.items()}
    prev = render(grid, gcfg, fcfg, R, t)[0]
    out["incremental"] = time_render(grid, gcfg, fcfg, R, t, depth_prior=prev,
                                     **INCREMENTAL)
    return out


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
    return {"march": march,
            # a tree without THREADS has the earlier 256-thread kernel
            "code": [c for c in march_code(_build.lib_path, _build.build_log,
                                           getattr(rm, "THREADS", 256))
                     if not c["stats"]],
            "render_ms": {k: v["ms"] for k, v in
                          render_times(grid, gcfg, fcfg, R, t).items()}}


def run_tree(root):
    cmd = [sys.executable, os.path.abspath(__file__), "--tree", root]
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
        print(json.dumps(tree_times()), flush=True)
        return 0
    from gradient_sdf_tpu_torch.ops.kernels import _build
    from gradient_sdf_tpu_torch.ops.kernels import raycast_march as rm

    print(smi_line(), flush=True)
    dev = torch.device("cuda")
    grid, gcfg, fcfg, _, poses = render_scene(dev)
    R, t = poses[4]
    print(json.dumps({"scene": {"blocks": int(grid.num_active), "rays": W * H}}))
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
            print(json.dumps({"tree": name, **run_tree(root)}), flush=True)
    print(smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
