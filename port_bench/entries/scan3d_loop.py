"""Scan3D's per-frame body as a closed loop: the port's dense tracking and
fusion over a revolution of frames, one frame in flight.

Set-up makes the revolution's frames into host memory and fuses them at
their true poses (the upstream's fusion-only mode with a pose file; the
map's frame is the first camera's, as in the app), growing the grid as the
app does: the room's first pass. The room, its revolution and its depth
noise come from the traffic file's `scene_seed` where it names one, so that
every run's seed gets the same work (the run's seed then draws only the
frames judged); else from the run's seed. The window then goes round the
revolution again and again, each time from that map and the pose of the
revolution's last frame (`Start`), so that every revolution of the window
is the same work: the room's second pass. The window is whole revolutions:
once `seconds` have passed it ends with the revolution in hand, and its
time runs to that revolution's last pose on the host. Set-up makes one such
revolution too, which builds and warms all the window runs, and then puts
the map back. Each frame is the body of
`apps/scan3d._loop` without its prints, timers and loader: the host
array's upload, `models.tracker.track_frame` against `GradSdfMap.grid`,
`GradSdfMap.update` at the refined pose if tracking converged, and the
pose read to the host. A frame whose tracking does not converge counts as
failed.

`correct` holds the program to the plain reference (`port_bench/reference`)
in two ways, each on the answers the program gave:
* the start: the reference fuses set-up's first `start_frames` + 1 frames
  at their true poses into an empty grid on its own, and its grid is
  compared with the program's;
* the window: at frames drawn from the seed the program's state is copied
  before and after the frame; the reference tracks the frame from the copy
  before and the program's previous pose, fuses it at the program's pose,
  and its pose and grid are compared with the program's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import numpy as np
import torch

from port_bench import checks, harness, scene
from port_bench.reference import fusion as RF
from port_bench.reference import grid as RG
from port_bench.reference import normals as RN
from port_bench.reference import tracker as RT

POSE_KEYS = ("pose_t_gap_m", "pose_r_gap_rad")
MAP_KEYS = ("block_mismatch", "dist_gap_m", "weight_gap_rel", "grad_gap_rel")


def program_config(cfg: dict):
    """The program's PipelineConfig: the preset the configuration names,
    with every value the configuration states."""
    from gradient_sdf_tpu_torch import config as pc

    base = pc.preset(cfg["preset"])
    return dataclasses.replace(
        base,
        grid=dataclasses.replace(base.grid, **cfg["grid"]),
        fusion=dataclasses.replace(base.fusion, **cfg["fusion"]),
        tracker=dataclasses.replace(base.tracker, **cfg["tracker"]),
        camera=dataclasses.replace(base.camera, **cfg["camera"]))


class Scene:
    """The cell's inputs, all from the traffic file's `scene_seed`, or from
    the run's seed where the file names none."""

    def __init__(self, cfg, traffic, seed, device):
        seed = traffic.get("scene_seed", seed)
        self.K = scene.intrinsics(cfg)
        self.room = scene.make_room(seed, traffic, device)
        world = scene.circle_poses(traffic, seed)
        self.frames = scene.make_frames(self.room, world, self.K, cfg,
                                        traffic, seed)
        # the map's frame is the first camera's, as in the app
        self.poses = scene.relative_poses(world)
        f = cfg["fusion"]
        self.points = [int(((d > f["z_min"]) & (d < f["z_max"])).sum())
                       for d in self.frames]


class Reference:
    """The plain reference for one configuration on one device."""

    def __init__(self, cfg, K, device, dtype=torch.float32):
        c = cfg["camera"]
        self.cfg, self.K, self.dev, self.dt = cfg, K, device, dtype
        self.cache = RN.build_cache(c["width"], c["height"], K,
                                    cfg["fusion"]["normal_window"], device, dtype)

    def depth(self, d):
        return torch.as_tensor(d, device=self.dev).to(self.dt)

    def pose(self, R, t):
        return (torch.as_tensor(R, device=self.dev).to(self.dt),
                torch.as_tensor(t, device=self.dev).to(self.dt))

    def track(self, grid, depth, R, t):
        f, tr = self.cfg["fusion"], self.cfg["tracker"]
        pts = RT.points(depth, self.K, f["z_min"], f["z_max"], tr["sampling"])
        return RT.track(pts, R, t, grid, tr, f["grad_scale"])

    def fuse(self, grid, depth, R, t, vis=None, kf_slot=-1):
        RF.fuse(grid, depth, self.cache, R, t, self.cfg["fusion"], vis, kf_slot)
        if grid.overflow:
            grid.grow()

    def empty(self):
        g = self.cfg["grid"]
        return RG.Grid.empty(g["num_blocks"], g["dir_dim"], g["block_shape"],
                             g["voxel_size"], self.dev, self.dt)


class Start:
    """The map and the pose that every revolution of the window starts
    from: a copy of set-up's. Without it the map would go on changing over
    the window's hundred-odd revolutions, and with it which frames converge,
    from run to run of one seed."""

    def __init__(self, m, R, t):
        self.grid = type(m.grid)(*(x.clone() for x in m.grid))
        self.cfg = m.cfg.grid
        self.R, self.t = R.clone(), t.clone()

    def reset(self, m):
        """The map back to the copy, in place; returns the pose to start
        from. A revolution that grew the grid grows the copy, once, so
        that the later ones start at the capacity the scan reached."""
        from gradient_sdf_tpu_torch.ops import voxel_grid as vg

        g = m.cfg.grid
        if g.num_blocks != self.cfg.num_blocks and g.dir_dim == self.cfg.dir_dim:
            self.grid, self.cfg = vg.grow(self.grid, self.cfg,
                                          g.num_blocks // self.cfg.num_blocks)
        if g == self.cfg:
            for dst, src in zip(m.grid, self.grid):
                dst.copy_(src)
        else:
            m.restore(type(m.grid)(*(x.clone() for x in self.grid)), self.cfg)
        return self.R.clone(), self.t.clone()


def step_readings(ref: Reference, st_before, depth, R_in, t_in, out) -> dict:
    """One frame judged: the reference tracks `depth` from the state before
    and the program's previous pose, fuses at the program's pose if the
    program fused, and compares (`out`: R, t, converged, state after)."""
    grid = RG.Grid.from_state(st_before, ref.dt)
    d = ref.depth(depth)
    R, t, conv, _, _, _ = ref.track(grid, d, *ref.pose(R_in, t_in))
    rd = checks.pose_gaps(R, t, out["R"], out["t"])
    rd["converged_mismatch"] = int(bool(conv) != bool(out["converged"]))
    if out["converged"]:
        ref.fuse(grid, d, *ref.pose(out["R"], out["t"]))
    rd.update(checks.compare_maps(grid.state(), out["state"]))
    return rd


def start_readings(ref: Reference, sc: Scene, frames: int, st_end) -> list:
    """The start followed by the reference on its own (module note)."""
    grid = ref.empty()
    for k in range(frames + 1):
        ref.fuse(grid, ref.depth(sc.frames[k]), *ref.pose(*sc.poses[k]))
    return [checks.compare_maps(grid.state(), st_end)]


def frame_counts(ref: Reference, depth, R, t) -> dict:
    """The counts `bounds.fuse_integrate_bound_ms` takes, from the frame and
    its pose (every block it touches already allocated)."""
    d = ref.depth(depth)
    nrm = RN.normals(ref.cache, d)
    valid, *_ = RF.gates(d, nrm, ref.cache, ref.cfg["fusion"])
    W = d.shape[1]
    pix = torch.nonzero(valid.reshape(-1)).reshape(-1)
    tiles = torch.unique((pix // W // 4) * 1_000_000 + (pix % W) // 8).numel()
    g = ref.cfg["grid"]
    probe = RG.Grid(torch.zeros(1, dtype=torch.int32, device=ref.dev),
                    torch.zeros((1, 3), dtype=torch.int32, device=ref.dev), 0,
                    [None] * 5, g["dir_dim"], g["block_shape"], g["voxel_size"])
    keys, local, w, *_ = RF.samples(d, nrm, ref.cache, *ref.pose(R, t), probe,
                                    ref.cfg["fusion"])
    live = keys >= 0
    k = keys[live].long()
    return {"valid": int(pix.numel()), "tiles": int(tiles),
            "live": int((w > 0).sum()),
            "sectors": int(torch.unique(k // 8).numel()),
            "rows": int(torch.unique(k * (g["block_shape"] ** 3)
                                     + local[live].long()).numel()),
            "blocks": int(torch.unique(k).numel()),
            "voxels_per_block": g["block_shape"] ** 3}


class FrameFacts:
    """One profiled frame as a kernel's bound counts it (a metric's
    `bound_ms(frame)`): the frame's inputs, the program's answers on it,
    and the reference (`ref`) to work out more; `fusion` is
    `frame_counts`, worked out once a frame."""

    def __init__(self, ref, sc, idx, pose, iters, residuals, fused, cache):
        self.ref, self.cfg, self.K = ref, ref.cfg, sc.K
        self.depth = sc.frames[idx]
        self.height, self.width = self.depth.shape
        self.points = sc.points[idx]      # pixels inside the depth range
        self.pose, self.iters, self.residuals, self.fused = (
            pose, iters, residuals, fused)
        self._idx, self._cache = idx, cache

    @property
    def fusion(self) -> dict:
        if self._idx not in self._cache:
            self._cache[self._idx] = frame_counts(self.ref, self.depth, *self.pose)
        return self._cache[self._idx]


def run(*, cfg, traffic, seed, seconds, trace, device, chips, t_process,
        readers=None):
    from gradient_sdf_tpu_torch.models import tracker
    from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pcfg = program_config(cfg)
    marks = [time.perf_counter()]
    sc = Scene(cfg, traffic, seed, device)
    marks.append(time.perf_counter())
    K, N = sc.K, len(sc.frames)
    sampling = pcfg.tracker.sampling
    chk = traffic["check"]
    C = chk["start_frames"]
    m = GradSdfMap(pcfg, device=device)

    def frame(idx, R, t, mark=contextlib.nullcontext):
        """One frame: (TrackResult, the pose on the host, seconds of the
        whole frame, of tracking, of fusion). Tracking is timed from the
        upload's end to its status read, fusion around `update`."""
        t0 = time.perf_counter()
        with mark("pb.upload"):
            depth = torch.as_tensor(sc.frames[idx], device=device)
        t1 = time.perf_counter()
        with mark("pb.track"):
            res = tracker.track_frame(
                m.grid, depth, K, R, t, m.cfg.grid, m.cfg.fusion, pcfg.tracker,
                mode="grad", compact=m.track_buffer(depth.shape, sampling))
        t2 = time.perf_counter()
        if res.converged:
            with mark("pb.fuse"):
                m.update(depth, K, (res.R, res.t))
        t3 = time.perf_counter()
        with mark("pb.pose"):
            pose = (res.R.cpu().numpy(), res.t.cpu().numpy())
        return res, pose, time.perf_counter() - t0, t2 - t1, t3 - t2

    # -- set-up: the first pass at the true poses (frame 0's the identity)
    st_chain = None
    for i in range(N):
        m.update(sc.frames[i], K, scene.pose_tensors(sc.poses[i], device))
        if i == C:
            st_chain = checks.program_state(m, to_host=True)
    start = Start(m, *scene.pose_tensors(sc.poses[-1], device))
    marks.append(time.perf_counter())
    # one revolution as the window makes it, then the map put back
    R, t, setup_failed = start.R, start.t, 0
    for i in range(N):
        res, *_ = frame(i, R, t)
        setup_failed += not res.converged
        R, t = res.R, res.t
    R, t = start.reset(m)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_process

    # -- the window
    rng = np.random.default_rng([int(seed), 0xC4EC])
    check_at = set(int(x) for x in rng.choice(chk["within_frames"],
                                              chk["window_frames"],
                                              replace=False))
    stretch = harness.Stretch(device) if trace else None
    if stretch is not None:
        stretch.warm()
    prof_from = traffic["trace"]["after_s"]
    prof_frames = traffic["trace"]["frames"]
    frame_s, track_s, fuse_s, iters = [], [], [], []
    profiled, judged = [], []
    failed, n, by_rev = 0, 0, [0]
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        now = time.perf_counter()
        idx = n % N
        if idx == 0 and now >= deadline:
            break
        in_stretch = False
        if stretch is not None and stretch.t1 is None:
            if stretch.prof is None and now - t_start >= prof_from:
                stretch.start()
            if stretch.prof is not None:
                if len(profiled) >= prof_frames:
                    stretch.stop()
                else:
                    in_stretch = True
        if idx == 0 and n > 0:
            R, t = start.reset(m)
            by_rev.append(0)
        st_before = None
        if n in check_at:
            st_before = checks.program_state(m)
            R_in, t_in = R.cpu().numpy(), t.cpu().numpy()
        mark = stretch.mark if in_stretch else contextlib.nullcontext
        res, pose, whole, a, b = frame(idx, R, t, mark)
        frame_s.append(whole)
        if not in_stretch:
            track_s.append(a)
            iters.append(res.num_iters)
            if res.converged:
                fuse_s.append(b)
        if in_stretch:
            profiled.append((idx, pose, res.num_iters, res.num_valid,
                             res.converged))
        failed += not res.converged
        by_rev[-1] += not res.converged
        R, t = res.R, res.t
        if st_before is not None:
            judged.append((idx, st_before, R_in, t_in,
                           {"R": pose[0], "t": pose[1],
                            "converged": res.converged,
                            "state": checks.program_state(m)}))
        n += 1
    t_end = time.perf_counter()
    if stretch is not None and stretch.prof is not None and stretch.t1 is None:
        stretch.stop()
    device_rec = harness.device_record(device, chips)
    window_s = t_end - t_start

    out = {"attempted": n, "failed": failed,
           "e2e": {"setup_s": setup_s, "scan_fps": n / window_s,
                   "frame_p95_ms": harness.percentile(frame_s, 95.0) * 1e3},
           "device": device_rec}
    print(f"scan3d: {n} frames in {window_s:.3f} s, {failed} failed; set-up "
          f"{setup_s:.2f} s (to the scene {marks[0] - t_process:.2f}, the scene "
          f"{marks[1] - marks[0]:.2f}, the first pass {marks[2] - marks[1]:.2f}, "
          f"its revolution {t_start - marks[2]:.2f}; {setup_failed} of {N} "
          f"failed in it); "
          f"failed a revolution {by_rev}; "
          f"{sum(sc.points) / len(sc.points):.0f} points a frame; "
          f"{int(m.grid.num_active)} blocks of {m.cfg.grid.num_blocks}; "
          f"{len(judged)} window frames judged; card "
          f"{harness.power_limit() if device.type == 'cuda' else 'none'}",
          file=sys.stderr)

    # the program's state is freed before the reference runs; the copies
    # the checks need stay
    del m, start
    if trace:
        out["trace"] = traced(stretch, readers or {}, profiled, sc, cfg,
                              device, track_s, fuse_s, iters)
    ref = Reference(cfg, K, device)
    readings = start_readings(ref, sc, C, checks.to_device(st_chain, device))
    for idx, st_b, R_in, t_in, o in judged:
        readings.append(step_readings(ref, st_b, sc.frames[idx], R_in, t_in, o))
    out["checks"] = judge(readings, len(judged), chk)
    out["correct"] = harness.judge(out["checks"])
    return out


def judge(readings, n_window, chk) -> dict:
    """Each compared number (the worst over the judged frames) beside its
    limit (the traffic file's `limits`)."""
    worst = checks.worst(readings, POSE_KEYS + ("converged_mismatch",) + MAP_KEYS)
    lim = chk["limits"]
    out = {k: {"value": worst[k], "limit": lim[k]} for k in worst}
    out["window_frames_judged"] = {"value": n_window,
                                   "limit": [1, chk["window_frames"]]}
    return out


def traced(stretch, readers, profiled, sc, cfg, device, track_s, fuse_s,
           iters) -> dict:
    """The per-layer readings: the host spans outside the profiled stretch,
    and from the stretch the device's busy time, the breakdown, and for
    each metric in `readers` its kernels' time and their bounds over the
    stretch's frames (`harness.rooflines`)."""
    tr = {"spans": {"track_ms": [x * 1e3 for x in track_s],
                    "fuse_ms": [x * 1e3 for x in fuse_s]},
          "counters": {"gn_iters": iters}, "kernel_ms": {}, "bound_ms": {},
          "busy_s": 0.0, "window_s": 0.0,
          "breakdown": {"device_ops": [], "idle_gaps": []}}
    if stretch is None or stretch.prof is None:
        return tr
    ref, cache = Reference(cfg, sc.K, device), {}
    frames = [FrameFacts(ref, sc, idx, pose, n_it, n_res, fused, cache)
              for idx, pose, n_it, n_res, fused in profiled]
    tr.update(harness.rooflines(stretch, readers, frames))
    tr["profiled_frames"] = len(profiled)
    return tr


def control_step(ref_low: Reference, st_before, depth, R_in, t_in) -> dict:
    """The reference in the program's place, in `ref_low`'s lower
    precision: the frame tracked and, if converged, fused at its own pose."""
    grid = RG.Grid.from_state(st_before, ref_low.dt)
    d = ref_low.depth(depth)
    R, t, conv, _, _, _ = ref_low.track(grid, d, *ref_low.pose(R_in, t_in))
    if conv:
        ref_low.fuse(grid, d, R, t)
    return {"R": R.float().cpu().numpy(), "t": t.float().cpu().numpy(),
            "converged": conv, "state": grid.state()}


def calibrate(*, cfg, traffic, seed, device, frames: int, low=torch.bfloat16):
    """Readings of the program and of the control on one seed: set-up as a
    run makes it, then `frames` frames of the next revolution, each judged
    as a run judges it; the control takes the program's state before each
    of those frames. Returns {"program": [readings], "control": [...]}."""
    from gradient_sdf_tpu_torch.models import tracker
    from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pcfg = program_config(cfg)
    sc = Scene(cfg, traffic, seed, device)
    K, N = sc.K, len(sc.frames)
    m = GradSdfMap(pcfg, device=device)
    for i in range(N):
        m.update(sc.frames[i], K, scene.pose_tensors(sc.poses[i], device))
    R, t = scene.pose_tensors(sc.poses[-1], device)
    ref = Reference(cfg, K, device)
    ref_low = Reference(cfg, K, device, low)
    rng = np.random.default_rng([int(seed), 0xCA1])
    pick = set(int(x) for x in rng.choice(N, frames, replace=False))
    out = {"program": [], "control": []}
    for idx in range(N):
        judged = idx in pick
        if judged:
            st = checks.program_state(m)
            R_in, t_in = R.cpu().numpy(), t.cpu().numpy()
        depth = torch.as_tensor(sc.frames[idx], device=device)
        res = tracker.track_frame(m.grid, depth, K, R, t, m.cfg.grid, m.cfg.fusion,
                                  pcfg.tracker, mode="grad",
                                  compact=m.track_buffer(depth.shape,
                                                         pcfg.tracker.sampling))
        if res.converged:
            m.update(depth, K, (res.R, res.t))
        R, t = res.R, res.t
        if judged:
            o = {"R": R.cpu().numpy(), "t": t.cpu().numpy(),
                 "converged": res.converged, "state": checks.program_state(m)}
            out["program"].append(step_readings(ref, st, sc.frames[idx], R_in, t_in, o))
            c = control_step(ref_low, st, sc.frames[idx], R_in, t_in)
            out["control"].append(step_readings(ref, st, sc.frames[idx], R_in, t_in, c))
    return out
