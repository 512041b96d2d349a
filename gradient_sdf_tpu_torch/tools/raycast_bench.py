#!/usr/bin/env python3
"""Card measurements of the raycast renderer (needs one CUDA card).

    python3 gradient_sdf_tpu_torch/tools/raycast_bench.py

The scene is the JAX benchmark's render scene: 1 cm voxels, 2^15 blocks,
the five spheres of seed 3, the 16 frames of a radius-2 orbit fused at
640x480 from their ground-truth poses; the rays are pose 4's, s in
[0.1, 3.5]. It prints, one JSON line each:

  1. `raycast_march` against `raycast_march_reference` on the card on all
     307,200 rays, unwindowed and inside the block-raster windows: rays
     whose `found`, `s_mid`, `s_star` or probe counts differ (bit equality
     is expected: the kernel is built without fused multiply-adds), device
     time of kernel and plain version by CUDA events (`median_ms` of
     `fusion_bench`), probes per ray (mean, p99, max), the 32-byte sectors
     the probes gathered (every gather counted) and the distinct ones among
     them, the bound on these rays (the larger of bytes: ray state plus each
     distinct sector once, and operations: those of the probes made), the
     rate at which the kernel gathered, and the share of a warp's lanes that
     still probe while its slowest ray does;
  2. `render_depth_normal` through its entry point in four modes (stride-4
     prior, no prior, raster windows, the previous render as depth prior
     with holes skipped and a 4-voxel margin): ms per render on the host
     clock around device-synchronized calls, Mrays/s, march launches;
  3. the stride-4 and the no-prior render under `torch.profiler`: kernels
     launched, device-busy ms and share, host syncs, the march kernel's own
     device time (`profile_call` of `ba_bench`).

`chip_smoke.py` runs the same functions as its phases 8 and 9 and adds the
checks against the analytic depth and the CPU.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OWN_ROOT = os.path.dirname(os.path.dirname(HERE))
W, H = 640, 480
S_MIN, S_MAX = 0.1, 3.5
MEM_BYTES_PER_S = 3.35e12   # the card's memory rate (H100 SXM data sheet)
F32_OPS_PER_S = 67e12       # its float32 rate outside the tensor cores
# arithmetic, compare and select operations of one probe of the march loop,
# counted from the kernel's source: position 6, voxel index 6, block, key and
# local index ~35 (integer), one DDA ~42, step and loop conditions ~11; the
# integer ones are priced at the float32 rate too
OPS_PER_PROBE = 100
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
    """Least time for the probes these rays needed, operations."""
    return (probes * OPS_PER_PROBE + hits * OPS_PER_HIT) / F32_OPS_PER_S * 1e3


def march_check_and_time(grid, gcfg, fcfg, R, t, windowed: bool) -> dict:
    """Kernel vs plain version on one pass's rays, then both timed."""
    import torch
    from gradient_sdf_tpu_torch.ops.kernels import raycast_march as rm
    from gradient_sdf_tpu_torch.tools.fusion_bench import median_ms

    args = march_args(grid, gcfg, R, t, windowed)
    n = args[0].shape[0]
    got = rm.raycast_march(*args, gcfg, fcfg, stats=True)
    torch.cuda.synchronize()
    want = rm.raycast_march_reference(*args, gcfg, fcfg, stats=True)
    differ = ((got.found != want.found) | (got.s_mid != want.s_mid)
              | (got.s_star != want.s_star)
              | (got.stats != want.stats).any(dim=1))
    touched_differing = int((got.touched != want.touched).sum())
    hit = got.found & want.found
    err = float((got.s_star - want.s_star)[hit].abs().max()) if bool(hit.any()) else 0.0
    probes = got.stats[:, 0].float()
    marched = probes > 0
    sectors = int(got.stats[:, 1].sum())
    distinct = int(got.touched.sum())
    # a warp (32 consecutive rays) lasts as long as its slowest ray
    per_warp = torch.nn.functional.pad(probes, (0, -n % 32)).reshape(-1, 32)
    warp_max = per_warp.max(dim=1).values
    bytes_ms = march_bound_ms(n, distinct)
    ops_ms = march_ops_bound_ms(int(probes.sum()), int(got.found.sum()))
    ms = median_ms(lambda: rm.raycast_march(*args, gcfg, fcfg))
    t0 = time.perf_counter()
    rm.raycast_march_reference(*args, gcfg, fcfg)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    return {
        "windowed": windowed, "rays": n, "rays_differing": int(differ.sum()),
        "found_differing": int((got.found != want.found).sum()),
        "max_abs_err": err, "found": int(got.found.sum()),
        "rays_marched": int(marched.sum()),
        "probes_mean": float(probes.mean()),
        "probes_mean_marched": float(probes[marched].mean()),
        "probes_p99": float(torch.quantile(probes, 0.99)),
        "probes_max": int(probes.max()), "sectors": sectors,
        "distinct_sectors": distinct, "touched_differing": touched_differing,
        "gathered_gb_per_s": 32 * sectors / ms / 1e6,
        "warp_lane_use": float(probes.sum() / (32 * warp_max.sum())),
        "warp_max_probes_mean": float(warp_max.mean()),
        "ms": ms, "plain_ms": plain_ms,
        "bytes_bound_ms": bytes_ms, "ops_bound_ms": ops_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


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


def main():
    import subprocess

    import torch

    sys.path.insert(0, OWN_ROOT)
    if not torch.cuda.is_available():
        print("raycast_bench: CUDA is not available; this needs a card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    grid, gcfg, fcfg, _, poses = render_scene(dev)
    R, t = poses[4]
    print(json.dumps({"scene": {"blocks": int(grid.num_active), "rays": W * H}}))
    for windowed in (False, True):
        print(json.dumps({"march": march_check_and_time(grid, gcfg, fcfg, R, t,
                                                        windowed)}), flush=True)
    for name, kw in RENDER_MODES.items():
        print(json.dumps({"render": name, **time_render(grid, gcfg, fcfg, R, t, **kw)}),
              flush=True)
    prev = render(grid, gcfg, fcfg, R, t)[0]
    print(json.dumps({"render": "incremental", **time_render(
        grid, gcfg, fcfg, R, t, depth_prior=prev, **INCREMENTAL)}), flush=True)
    from gradient_sdf_tpu_torch.tools.ba_bench import profile_call

    for name in ("stride4", "no_prior"):
        prof = profile_call(lambda: render(grid, gcfg, fcfg, R, t,
                                           **RENDER_MODES[name]), top=1000)
        prof["march_kernel_ms"] = sum(r["ms"] for r in prof["top"]
                                      if "march_rays" in r["name"])
        prof["top"] = prof["top"][:6]
        print(json.dumps({"profile": name, **prof}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
