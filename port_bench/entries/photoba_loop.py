"""PhotoBA's decoupled solve as a closed loop: the port's photometric bundle
adjustment over 30 keyframes of the room, one solve in flight.

Set-up is the PhotoBA app's phase 1 in its `--pose-file` mode
(`apps/photoba._run`): the room's revolution of depth frames, made from
the seed, fused at their true poses into a `GradSdfMap` that records
keyframe visibility, a keyframe slot marked by the app's rule without its
sharpness test (the first frame, then a frame once more than
`keyframe_gap` frames passed since the last: every 7th frame); the
keyframes reduced to `max_keyframes` by `apps/photoba.sample_keyframes`;
their colour images rendered at their true poses (`scene_rgb`); the
problem built by `models/photo_ba.build_problem` (band of `band_voxels`).
Then `starts.count` start states from the seed: every keyframe pose of
the truth moved (`scene_rgb.start_states`), the dist as built. One solve
in set-up builds and warms everything the window runs.

The window cycles the starts in order, the same starts in every cycle. A
solve is timed from the copy of its start into a fresh `BAState` until its
final poses are on the host: a `PhotometricOptimizer` (no pose files), then
`optimize()`'s body without its stop tests (the configuration's `reduced`
`stop_rule`): the energy, then `max_iterations` calls of `_iteration()`,
every energy recorded as `optimize()` records it, then `full_state()`'s
poses read to the host as the app reads them. This mirrors `optimize()` as
`scan3d_loop` mirrors `apps/scan3d._loop`. Every solve runs exactly
`max_iterations` alternations (checked); a solve whose last energy is
above its first counts as failed.

`correct` holds the program to the plain reference (`reference/photo_ba`,
`reference/fusion`) on the answers it gave:
* the start: the reference fuses set-up's first `start_frames` + 1 frames
  at their true poses, keyframe slots and all, into an empty grid, and its
  grid and visibility bits are compared with the program's;
* the problem: the reference selects the band's voxels and keyframe bits
  from the program's fused grid on its own, and that is compared with the
  program's problem row for row (and the images and K with the
  benchmark's);
* the window: for `judged_starts` starts drawn from the seed, the last
  solve of each is followed at the alternations `alternations`, each step
  from the program's own state before it (the solve keeps its states
  before and after them, `kept`; every solve keeps them, so that every
  solve is the same work), and its first and last energy are held
  to the reference's own whole solve from the same start.

The traced run profiles `trace.solves` whole solves once `trace.after_s`
seconds have passed. The kernels' bounds (`metrics/ba_*_roofline.py`) take
each profiled solve's `SolveFacts`: after the window the program repeats
that start's solve keeping every state (its kernels give the same bits on
a second run), and the reference counts the pairs of every launch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from port_bench import ba_checks, checks, harness, scene, scene_rgb
from port_bench.reference import fusion as RF
from port_bench.reference import grid as RG
from port_bench.reference import normals as RN
from port_bench.reference import photo_ba as RP


def program_config(cfg: dict):
    """The program's PipelineConfig: the preset the configuration names,
    with every value the configuration states."""
    from gradient_sdf_tpu_torch import config as pc

    base = pc.preset(cfg["preset"])
    return dataclasses.replace(
        base,
        grid=dataclasses.replace(base.grid, **cfg["grid"]),
        fusion=dataclasses.replace(base.fusion, **cfg["fusion"]),
        camera=dataclasses.replace(base.camera, **cfg["camera"]),
        photo_ba=dataclasses.replace(base.photo_ba, **cfg["photo_ba"]))


def keyframe_rule(n_frames: int, gap: int, slots: int) -> list:
    """The slot of each frame (-1 for none) by the app's rule in its
    pose-file mode, without the sharpness test: the first frame, then a
    frame once more than `gap` frames passed since the last keyframe, while
    slots remain."""
    out, since, used = [], 0, 0
    for i in range(n_frames):
        if (i == 0 or since > gap) and used < slots:
            out.append(used)
            used += 1
            since = 0
        else:
            out.append(-1)
            since += 1
    return out


class Setup:
    """What set-up makes: the scene, the fused map, the keyframes, the
    problem and the start states."""

    def __init__(self, cfg, traffic, seed, device):
        from gradient_sdf_tpu_torch.apps.photoba import sample_keyframes
        from gradient_sdf_tpu_torch.models import photo_ba
        from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap

        self.marks = [time.perf_counter()]
        pcfg = program_config(cfg)
        self.pcfg = pcfg.photo_ba
        self.K = K = scene.intrinsics(cfg)
        room = scene.make_room(seed, traffic, device)
        world = scene.circle_poses(traffic, seed)
        frames = scene.make_frames(room, world, K, cfg, traffic, seed)
        poses = scene.relative_poses(world)
        self.marks.append(time.perf_counter())
        C = traffic["check"]["start_frames"]
        slots = keyframe_rule(len(frames), pcfg.photo_ba.keyframe_gap,
                              pcfg.photo_ba.max_recorded_keyframes)
        self.m = m = GradSdfMap(pcfg, with_vis=True, device=device)
        kfs = []
        for i, d in enumerate(frames):
            m.update(d, K, scene.pose_tensors(poses[i], device), kf_slot=slots[i])
            if slots[i] >= 0:
                kfs.append({"index": i, "slot": slots[i]})
            if i == C:
                self.start_state = checks.program_state(m, to_host=True)
                self.start_vis = m.vis[:self.start_state["num_active"]].to(
                    "cpu", copy=True)
        self.start_frames = frames[:C + 1]
        self.start_slots = slots[:C + 1]
        self.start_poses = poses[:C + 1]
        self.n_keyframes = len(kfs)
        kfs = sample_keyframes(kfs, pcfg.photo_ba.max_keyframes)
        self.slots = [k["slot"] for k in kfs]
        self.marks.append(time.perf_counter())
        tex = scene_rgb.Texture(seed, traffic["texture"], device)
        self.images = scene_rgb.keyframe_images(
            room, tex, [world[k["index"]] for k in kfs], K, cfg)
        self.poses = [poses[k["index"]] for k in kfs]
        self.gcfg = m.cfg.grid
        self.problem, state = photo_ba.build_problem(
            m.grid, m.vis, self.slots, self.images, self.poses, K, self.gcfg,
            band_voxels=cfg["band_voxels"])
        self.start_dist = state.dist
        self.starts = scene_rgb.start_states(self.poses, traffic["starts"], seed)
        self.start_tensors = [
            photo_ba.BAState(dist=state.dist,
                             R=torch.as_tensor(np.stack([p[0] for p in s]),
                                               device=device),
                             t=torch.as_tensor(np.stack([p[1] for p in s]),
                                               device=device))
            for s in self.starts]
        self.marks.append(time.perf_counter())


class Solve(NamedTuple):
    energies: list          # as optimize() records them
    states: dict            # alternation -> the program's BAState after it
    R: np.ndarray           # final poses on the host
    t: np.ndarray


def kept(alternations, n_alt: int) -> set:
    """The states a solve keeps: before and after each judged alternation,
    and the last (0, 1, 2, 12, 13, 24, 25 for 1, 2, 13, 25 of 25)."""
    return ({k - 1 for k in alternations} | set(alternations) | {0, n_alt})


def solve(su: Setup, start, n_alt: int, keep,
          mark=contextlib.nullcontext) -> Solve:
    """One solve from `start` (module note); keeps the states after the
    alternations in `keep` (the program makes new tensors at every step,
    so keeping one copies nothing)."""
    from gradient_sdf_tpu_torch.models import photo_ba

    with mark("pb.solve"):
        with mark("pb.start"):
            st = photo_ba.BAState(start.dist.clone(), start.R.clone(),
                                  start.t.clone())
            opt = photo_ba.PhotometricOptimizer(su.problem, st, su.gcfg, su.pcfg,
                                                verbose=False)
        with mark("pb.energy"):
            opt.energies.append(opt._energy())
        states = {0: opt.state}
        for k in range(1, n_alt + 1):
            with mark("pb.alternation"):
                e_pose, e = opt._iteration()
            opt.energies.append(e_pose)
            opt.energies.append(e)
            if k in keep:
                states[k] = opt.state
        with mark("pb.poses"):
            st = opt.full_state()
            R, t = st.R.cpu().numpy(), st.t.cpu().numpy()
    if len(opt.energies) != 1 + 2 * n_alt:
        raise RuntimeError(f"a solve recorded {len(opt.energies)} energies; "
                           f"{n_alt} alternations record {1 + 2 * n_alt}")
    return Solve(opt.energies, states, R, t)


class SolveFacts:
    """One profiled solve as a kernel's bound counts it (a metric's
    `bound_ms(solve)`): V real voxels, F keyframes, and `launches`, each
    (mode, pairs) of one kernel launch: "energy", "dist", "mean" for
    `ba_voxel_sums`, "pose" for `ba_pose_systems`, with the pairs the
    reference counts on the state that launch read."""

    def __init__(self, V: int, F: int, launches: list):
        self.V, self.F, self.launches = V, F, launches


def solve_facts(problem: RP.Problem, s: RP.Settings, sol: Solve) -> SolveFacts:
    """The launches of a solve kept at every alternation: the energy on
    each state, and each alternation's mean and pose systems on the state
    before it, its dist step and energy on the state after its pose step."""
    V, F = problem.vis.shape

    def ref_state(st, dist=None):
        return RP.State((st.dist if dist is None else dist)[:V], st.R, st.t)

    n = len(sol.states) - 1
    full = [RP.pair_counts(problem, ref_state(sol.states[k]), s)
            for k in range(n + 1)]
    launches = [("energy", full[0]["energy"])]
    for k in range(1, n + 1):
        mid = RP.pair_counts(problem, ref_state(sol.states[k],
                                                sol.states[k - 1].dist), s)
        launches += [("mean", full[k - 1]["pose"]), ("pose", full[k - 1]["pose"]),
                     ("energy", mid["energy"]), ("dist", mid["dist"]),
                     ("energy", full[k]["energy"])]
    return SolveFacts(V, F, launches)


def fused_start(cfg, su: Setup, device, dtype=torch.float32):
    """The reference's fusion of set-up's first frames at their true poses,
    keyframe slots and all, into an empty grid: (grid, visibility words)."""
    g = cfg["grid"]
    cache = RN.build_cache(cfg["camera"]["width"], cfg["camera"]["height"],
                           su.K, cfg["fusion"]["normal_window"], device, dtype)
    grid = RG.Grid.empty(g["num_blocks"], g["dir_dim"], g["block_shape"],
                         g["voxel_size"], device, dtype)
    vis = torch.zeros((g["num_blocks"], g["block_shape"] ** 3,
                       su.start_vis.shape[-1]), dtype=torch.int32, device=device)
    for d, pose, slot in zip(su.start_frames, su.start_poses, su.start_slots):
        RF.fuse(grid, torch.as_tensor(d, device=device).to(dtype), cache,
                *scene.pose_tensors(pose, device, dtype), cfg["fusion"], vis, slot)
    return grid, vis


def start_readings(cfg, su: Setup, device, judged=None) -> dict:
    """The start (module note): the reference's fusion of set-up's first
    frames against the program's grid and bits then, or with `judged` (a
    float type) against the reference's own fusion in that type (the
    control)."""
    grid, vis = fused_start(cfg, su, device)
    if judged is None:
        prog = checks.to_device(su.start_state, device)
        pvis = su.start_vis.to(device)
    else:
        g2, v2 = fused_start(cfg, su, device, judged)
        prog, pvis = g2.state(), v2[:g2.num_active]
    out = checks.compare_maps(grid.state(), prog)
    out = {"block_mismatch": out["block_mismatch"],
           "map_dist_gap_m": out["dist_gap_m"],
           "map_weight_gap_rel": out["weight_gap_rel"],
           "map_grad_gap_rel": out["grad_gap_rel"]}
    out["vis_mismatch"] = ba_checks.vis_mismatch(grid.state(), vis, prog, pvis,
                                                 vis.shape[-1])
    return out


def ref_start(dist, pose_list, dtype=torch.float32) -> RP.State:
    """The reference's state at a start: `dist` and the start's poses."""
    dev = dist.device
    return RP.State(dist.to(dtype),
                    torch.as_tensor(np.stack([p[0] for p in pose_list]),
                                    device=dev).to(dtype),
                    torch.as_tensor(np.stack([p[1] for p in pose_list]),
                                    device=dev).to(dtype))


def solve_readings(problem, dist, s, pose_list, sol: Solve, alternations,
                   n_alt, ref_run=None) -> dict:
    """A program's solve judged (module note): the worst of its judged
    steps, and its first and last energy against the reference's whole
    solve (`ref_run`, worked out when not given)."""
    V = problem.vox.shape[0]
    steps = []
    for k in alternations:
        b, a = sol.states[k - 1], sol.states[k]
        before = RP.State(b.dist[:V], b.R, b.t)
        steps.append(ba_checks.step_readings(
            problem, s, before,
            {"R": a.R, "t": a.t, "e_pose": sol.energies[2 * k - 1],
             "dist": a.dist, "e_dist": sol.energies[2 * k]}))
    rd = checks.worst(steps, ba_checks.STEP_KEYS)
    if ref_run is None:
        ref_run = RP.solve(problem, ref_start(dist, pose_list), s, n_alt)[1]
    rd.update(ba_checks.run_readings(sol.energies, ref_run))
    return rd


def run(*, cfg, traffic, seed, seconds, trace, device, chips, t_process,
        readers=None):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chk = traffic["check"]
    su = Setup(cfg, traffic, seed, device)
    n_alt = su.pcfg.max_iterations
    S = len(su.start_tensors)
    keep = kept(chk["alternations"], n_alt)
    warm = solve(su, su.start_tensors[0], n_alt, keep)
    del warm
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    su.marks.append(time.perf_counter())
    setup_s = su.marks[-1] - t_process

    # -- the window
    rng = np.random.default_rng([int(seed), 0xBA7])
    judged = sorted(int(x) for x in rng.choice(S, chk["judged_starts"],
                                               replace=False))
    stretch = harness.Stretch(device) if trace else None
    if stretch is not None:
        stretch.warm()
    prof_from, prof_n = traffic["trace"]["after_s"], traffic["trace"]["solves"]
    latest = [None] * S
    solve_s, profiled = [], []
    failed, n = 0, 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        in_stretch = False
        if stretch is not None and stretch.t1 is None:
            if stretch.prof is None and now - t_start >= prof_from:
                stretch.start()
            if stretch.prof is not None:
                if len(profiled) >= prof_n:
                    stretch.stop()
                else:
                    in_stretch = True
        i = n % S
        mark = stretch.mark if in_stretch else contextlib.nullcontext
        t0 = time.perf_counter()
        sol = solve(su, su.start_tensors[i], n_alt, keep, mark)
        solve_s.append(time.perf_counter() - t0)
        if in_stretch:
            profiled.append(i)
        failed += sol.energies[-1] > sol.energies[0]
        latest[i] = sol
        n += 1
    t_end = time.perf_counter()
    if stretch is not None and stretch.prof is not None and stretch.t1 is None:
        stretch.stop()
    device_rec = harness.device_record(device, chips)
    window_s = t_end - t_start
    V = int(su.problem.vmask.sum())
    out = {"attempted": n, "failed": failed,
           "e2e": {"setup_s": setup_s, "ba_solve_ms": window_s / max(n, 1) * 1e3},
           "device": device_rec}
    mk = su.marks
    ends = [(round(x.energies[0], 4), round(x.energies[-1], 4))
            for x in latest if x]
    print(f"photoba: {n} solves in {window_s:.3f} s, {failed} failed, each "
          f"{n_alt} alternations; solve ms p50 "
          f"{harness.percentile(solve_s, 50.0) * 1e3:.3f} p95 "
          f"{harness.percentile(solve_s, 95.0) * 1e3:.3f}; set-up {setup_s:.2f} s "
          f"(to the scene {mk[0] - t_process:.2f}, the scene {mk[1] - mk[0]:.2f}, "
          f"the fusion {mk[2] - mk[1]:.2f}, images and problem "
          f"{mk[3] - mk[2]:.2f}, the warm solve {mk[4] - mk[3]:.2f}); "
          f"{V} voxels of {su.problem.vmask.numel()}, {len(su.slots)} of "
          f"{su.n_keyframes} keyframes, {int(su.m.grid.num_active)} blocks of "
          f"{su.m.cfg.grid.num_blocks}; first/last energy of each start "
          f"{ends}; judged starts {judged}; card "
          f"{harness.power_limit() if device.type == 'cuda' else 'none'}",
          file=sys.stderr)

    s = RP.Settings.of(cfg)
    # the problem: the reference's selection from the program's grid
    problem, dist = RP.build(checks.program_state(su.m), su.m.vis, su.slots,
                             su.images, su.K, cfg["band_voxels"])
    readings = [{"build_mismatch": ba_checks.problem_mismatch(
        problem, dist, su.problem, su.start_dist, su.images, su.K)}]
    if trace:
        facts = [solve_facts(problem, s, solve(su, su.start_tensors[i], n_alt,
                                               range(n_alt + 1)))
                 for i in profiled]
        out["trace"] = traced(stretch, readers or {}, facts)
    # the program's state is freed before the reference runs; the solves
    # judged keep theirs
    last = [latest[i] for i in judged if latest[i] is not None]
    del su.m, su.problem, su.start_tensors, latest
    readings.append(start_readings(cfg, su, device))
    for i, sol in zip(judged, last):
        readings.append(solve_readings(problem, dist, s, su.starts[i], sol,
                                       chk["alternations"], n_alt))
    out["checks"] = judge(readings, len(last), chk, S)
    out["correct"] = harness.judge(out["checks"])
    return out


def judge(readings, n_judged, chk, S) -> dict:
    """Each compared number (the worst over the readings) beside its limit
    (the traffic file's `limits`)."""
    lim = chk["limits"]
    worst = checks.worst(readings, lim.keys())
    out = {k: {"value": worst[k], "limit": lim[k]} for k in lim}
    out["solves_judged"] = {"value": n_judged,
                            "limit": [chk["judged_starts"], S]}
    return out


def traced(stretch, readers, facts) -> dict:
    """The per-layer readings of the profiled stretch: the device's busy
    time, the breakdown, and for each metric in `readers` its kernels' time
    and their bounds over the profiled solves (`harness.rooflines`)."""
    tr = {"spans": {}, "counters": {}, "kernel_ms": {}, "bound_ms": {},
          "busy_s": 0.0, "window_s": 0.0,
          "breakdown": {"device_ops": [], "idle_gaps": []}}
    if stretch is None or stretch.prof is None:
        return tr
    tr.update(harness.rooflines(stretch, readers, facts))
    tr["profiled_solves"] = len(facts)
    return tr


def control_readings(problem_low, dist, s, pose_list, sol: Solve, alternations,
                     n_alt, prec, problem, ref_run) -> dict:
    """The control: the reference in `prec` put in the program's place, from
    the program's state before each judged step and from the start, judged
    as the program is."""
    V = problem.vox.shape[0]
    dt = prec.dtype
    steps = []
    for k in alternations:
        b = sol.states[k - 1]
        before = RP.State(b.dist[:V].to(dt), b.R.to(dt), b.t.to(dt))
        mid, e_pose, end, e = RP.alternation(problem_low, before, s, prec)
        steps.append(ba_checks.step_readings(
            problem, s, RP.State(b.dist[:V], b.R, b.t),
            {"R": mid.R.float(), "t": mid.t.float(), "e_pose": e_pose,
             "dist": end.dist.float(), "e_dist": e}))
    rd = checks.worst(steps, ba_checks.STEP_KEYS)
    low_run = RP.solve(problem_low, ref_start(dist, pose_list, dt), s, n_alt,
                       prec)[1]
    rd.update(ba_checks.run_readings(low_run, ref_run))
    return rd


def calibrate(*, cfg, traffic, seed, device, frames: int, low="tf32"):
    """Readings of the program and of the controls on one seed: set-up as a
    run makes it, then one solve from each of `frames` starts drawn from
    the seed, each judged as a run judges it. The control (`low`: "tf32",
    the reference with TF32 matrix products, or a float type) takes the
    program's state before each judged step and the start. TF32 reaches
    only the matrix products (the pose systems' sums, R exp(-dw)); for the
    numbers of the elementwise passes a "tf32" calibration also reads the
    reference in bfloat16 (`control_bf16`, its least readings printed as
    one JSON line). Returns {"program": [readings], "control": [...],
    "control_bf16": [...]}."""
    import json

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chk = traffic["check"]
    su = Setup(cfg, traffic, seed, device)
    n_alt = su.pcfg.max_iterations
    s = RP.Settings.of(cfg)
    controls = {"control": (RP.Precision(torch.float32, tf32=True)
                            if low == "tf32" else RP.Precision(low))}
    if low == "tf32":
        controls["control_bf16"] = RP.Precision(torch.bfloat16)
    grid = checks.program_state(su.m)
    problem, dist = RP.build(grid, su.m.vis, su.slots, su.images, su.K,
                             cfg["band_voxels"])
    lows = {k: RP.build(grid, su.m.vis, su.slots, su.images, su.K,
                        cfg["band_voxels"], prec.dtype)[0]
            for k, prec in controls.items()}
    del grid
    rng = np.random.default_rng([int(seed), 0xCA1])
    pick = rng.permutation(len(su.start_tensors))[:frames]
    out = {"program": [], **{k: [] for k in controls}}
    for i in pick:
        sol = solve(su, su.start_tensors[i], n_alt, kept(chk["alternations"], n_alt))
        ref_run = RP.solve(problem, ref_start(dist, su.starts[i]), s, n_alt)[1]
        out["program"].append(solve_readings(problem, dist, s, su.starts[i], sol,
                                             chk["alternations"], n_alt,
                                             ref_run=ref_run))
        for k, prec in controls.items():
            out[k].append(control_readings(lows[k], dist, s, su.starts[i], sol,
                                           chk["alternations"], n_alt, prec,
                                           problem, ref_run))
    # the start, once a seed, in every reading of the seed
    start = {"program": start_readings(cfg, su, device),
             **{k: start_readings(cfg, su, device, prec.dtype)
                for k, prec in controls.items()}}
    for k, rd in out.items():
        for r in rd:
            r.update(start[k])
    if "control_bf16" in out:
        keys = sorted(out["control_bf16"][0])
        print(json.dumps({"seed": seed, "control_bf16_least": {
            k: min(x[k] for x in out["control_bf16"]) for k in keys}}), flush=True)
    return out
