"""The PhotoBA cell, `photoba-room-30kf`, on the CPU: its loop rehearsed at a
small size through the port's CPU paths, the plain reference against the
program on seeded inputs, the faults and the control that must make
`correct` false, and the frozen bounds against the program's tool."""

import copy
import io
import json
import subprocess
import sys
import time
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from conftest import ROOT

KEYS = {"correct", "attempted", "failed", "metrics", "device"}
CELL = "photoba-room-30kf"


def small_ba_cell():
    """The PhotoBA cell at 160x120 with 4 cm voxels on a grid of 2^12
    blocks, 24 frames over a 6 degree sweep (4 keyframes, all of them in
    the problem, ~10,000 voxels), 3 starts and 3 alternations, every one
    judged: every rule of the cell at a size the CPU runs in seconds."""
    from port_bench import harness

    bench = harness.benchmark(ROOT)
    cell = harness.cell(bench, CELL)
    cfg = copy.deepcopy(harness.config_of(bench, cell["config"], ROOT))
    traffic = copy.deepcopy(harness.data_file("traffic", cell["traffic"], ROOT))
    cfg["camera"].update(width=160, height=120, fx=131.25, fy=131.25, cx=79.5,
                         cy=59.5)
    cfg["grid"].update(num_blocks=4096, voxel_size=0.04)
    cfg["photo_ba"].update(max_iterations=3, max_keyframes=4)
    traffic["camera"].update(frames=24, arc_deg=6.0)
    traffic["starts"].update(count=3)
    traffic["check"].update(alternations=[1, 2, 3])
    traffic["trace"].update(after_s=0.2, solves=2)
    return bench, cell, cfg, traffic


def rehearse(trace=False, seconds=2.0, seed=2**31 + 17):
    from port_bench import harness

    bench, cell, cfg, traffic = small_ba_cell()
    loop = harness.entry(traffic["entry"])
    e2e, layer = harness.cell_metrics(bench, cell["name"])
    err = io.StringIO()
    with redirect_stderr(err):
        out = loop.run(cfg=cfg, traffic=traffic, seed=seed, seconds=seconds,
                       trace=trace, device=torch.device("cpu"), chips=1,
                       t_process=time.perf_counter(),
                       readers=harness.kernel_readers(layer))
    buf = io.StringIO()
    with redirect_stdout(buf), redirect_stderr(err):
        harness.emit(harness.assemble(out, e2e, layer, trace), out["checks"])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    return line, err.getvalue(), e2e, layer


def test_ba_untraced_line_is_correct():
    line, err, e2e, _ = rehearse()
    assert KEYS <= set(line) and list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"] for m in e2e} == {"setup_s",
                                                                "ba_solve_ms"}
    for k, v in line["metrics"].items():
        assert v["value"] > 0, k
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 3 and line["failed"] == 0
    summary = [s for s in err.splitlines() if s.startswith("photoba:")][-1]
    assert "each 3 alternations" in summary and "4 of 4 keyframes" in summary
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(s.startswith("check ") and " limit " in s for s in tail)


def test_ba_traced_line_reads_the_layers():
    line, _, _, layer = rehearse(trace=True)
    assert "breakdown" in line and {"busy_s", "window_s"} <= set(line["device"])
    # the CPU has no device trace: the three readers find nothing
    assert set(line["metrics"]) <= {m["name"] for m in layer}
    assert line["correct"] is True, line["checks"]


def _broken(monkeypatch, fault):
    from gradient_sdf_tpu_torch.models import photo_ba

    if fault == "dist step sign flipped":
        orig = photo_ba.solve_dist

        def flipped(problem, state, gcfg, pcfg):
            new = orig(problem, state, gcfg, pcfg)
            return new._replace(dist=2 * state.dist - new.dist)

        monkeypatch.setattr(photo_ba, "solve_dist", flipped)
    elif fault == "pose step skipped":
        monkeypatch.setattr(photo_ba, "solve_pose",
                            lambda problem, state, gcfg, pcfg: state)
    elif fault == "state unchanged":
        monkeypatch.setattr(photo_ba, "solve_dist",
                            lambda problem, state, gcfg, pcfg: state)
    elif fault == "half the voxels":
        # the dist step of the first half of the voxels only
        orig = photo_ba.solve_dist

        def half(problem, state, gcfg, pcfg):
            new = orig(problem, state, gcfg, pcfg)
            h = state.dist.shape[0] // 2
            return new._replace(dist=torch.cat([new.dist[:h], state.dist[h:]]))

        monkeypatch.setattr(photo_ba, "solve_dist", half)
    elif fault == "answer altered":
        # the poses moved by a millimetre where they are produced
        orig = photo_ba.apply_pose_systems

        def moved(state, H, b):
            new = orig(state, H, b)
            return new._replace(t=new.t + 1e-3)

        monkeypatch.setattr(photo_ba, "apply_pose_systems", moved)


@pytest.mark.parametrize("fault", ["dist step sign flipped", "pose step skipped",
                                   "state unchanged", "half the voxels",
                                   "answer altered"])
def test_ba_broken_path_is_not_correct(monkeypatch, fault):
    _broken(monkeypatch, fault)
    line, _, _, _ = rehearse()
    assert line["correct"] is False, (fault, line["checks"])


def test_ba_control_fails_and_program_passes_on_the_small_cell():
    """The control (the plain reference in bfloat16 in the program's place)
    against the same limits as the program."""
    from port_bench import checks, harness

    _, _, cfg, traffic = small_ba_cell()
    loop = harness.entry(traffic["entry"])
    r = loop.calibrate(cfg=cfg, traffic=traffic, seed=2**31 + 19,
                       device=torch.device("cpu"), frames=2, low=torch.bfloat16)
    lim = {k: v for k, v in traffic["check"]["limits"].items()
           if k in r["program"][0]}

    def passes(readings):
        w = checks.worst(readings, lim.keys())
        return all(w[k] <= lim[k] for k in lim)

    assert passes(r["program"]), r["program"]
    assert not passes(r["control"]), r["control"]


def _random_problem(seed=7, V=2048, F=4, H=48, W=64, pad=64):
    """A seeded BA problem of the program's kind: voxels 1-2 m in front of
    cameras near the identity, random unit-scale gradients, random
    visibility and random smooth images."""
    from gradient_sdf_tpu_torch.models import photo_ba
    from port_bench.reference import se3 as RS

    g = torch.Generator().manual_seed(seed)
    vs = 0.01
    xy = (torch.rand((V, 2), generator=g) - 0.5) * 1.2
    z = 1.0 + torch.rand((V, 1), generator=g)
    vox = torch.round(torch.cat([xy * z, z], 1) / vs).to(torch.int32)
    grad = torch.randn((V, 3), generator=g) * 5.0
    weight = 1.0 + 20.0 * torch.rand(V, generator=g)
    dist = (torch.rand(V, generator=g) - 0.5) * 3 * vs
    vis = torch.rand((V, F), generator=g) < 0.8
    yy, xx = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    k = torch.rand((F, 3, 2), generator=g) * 0.5
    images = 0.5 + 0.4 * torch.sin(k[..., 0, None, None] * xx
                                   + k[..., 1, None, None] * yy).permute(0, 2, 3, 1)
    K = torch.tensor([[50.0, 0, 31.5], [0, 50.0, 23.5], [0, 0, 1]])
    R = RS.so3_exp(torch.randn((F, 3), generator=g) * 0.02)
    t = torch.randn((F, 3), generator=g) * 0.02
    pad_rows = lambda a: torch.cat([a, torch.zeros((pad,) + a.shape[1:],
                                                   dtype=a.dtype)])
    problem = photo_ba.BAProblem(
        vox=pad_rows(vox), grad=pad_rows(grad), weight=pad_rows(weight),
        vmask=torch.arange(V + pad) < V, vis=pad_rows(vis),
        images=images.contiguous().float(), K=K)
    state = photo_ba.BAState(pad_rows(dist), R.float(), t.float())
    return problem, state, V


def _reference_of(problem, state, V):
    from port_bench.reference import photo_ba as RP

    p = RP.Problem(problem.vox[:V], problem.grad[:V], problem.weight[:V],
                   problem.vis[:V], problem.images, problem.K)
    return p, RP.State(state.dist[:V], state.R, state.t)


@pytest.mark.parametrize("loss", ["cauchy", "trunc_l2"])
def test_reference_matches_the_program_on_seeded_inputs(loss):
    from gradient_sdf_tpu_torch.config import GridConfig, PhotoBAConfig
    from gradient_sdf_tpu_torch.models import photo_ba
    from port_bench.reference import photo_ba as RP

    problem, state, V = _random_problem()
    gcfg, pcfg = GridConfig(voxel_size=0.01), PhotoBAConfig(loss=loss)
    rp, rs = _reference_of(problem, state, V)
    s = RP.Settings(0.01, pcfg.damping, pcfg.lambda_, pcfg.reg_weight,
                    loss == "trunc_l2")
    e = float(photo_ba.energy(problem, state, gcfg))
    assert e > 0
    assert float(RP.energy(rp, rs, s, block=700)) == pytest.approx(e, rel=1e-5)
    d = photo_ba.solve_dist(problem, state, gcfg, pcfg).dist[:V]
    d_ref = RP.dist_step(rp, rs, s, block=700)
    assert float((d - state.dist[:V]).abs().max()) > 1e-5
    assert float((d - d_ref).abs().max()) < 1e-7
    H, b = photo_ba.pose_systems(problem, state, gcfg, pcfg)
    Hr, br = RP.pose_systems(rp, rs, s, block=700)
    assert float((H - Hr).abs().max()) <= 1e-5 * float(Hr.abs().max())
    assert float((b - br).abs().max()) <= 1e-5 * float(br.abs().max())
    # the 6x6 solves amplify the systems' rounding by their condition
    new = photo_ba.apply_pose_systems(state, H, b)
    ref = RP.apply_pose_systems(rs, Hr, br)
    step_t = float((new.t - state.t).abs().max())
    step_R = float((new.R - state.R).abs().max())
    assert step_t > 1e-3 and step_R > 1e-3
    assert float((new.t - ref.t).abs().max()) <= 1e-3 * step_t
    assert float((new.R - ref.R).abs().max()) <= 1e-3 * step_R


def test_bounds_match_ba_bench():
    """The frozen bounds against `tools/ba_bench` on the same inputs, with
    the reference's pair counts against the tool's."""
    from gradient_sdf_tpu_torch.config import GridConfig, PhotoBAConfig
    from gradient_sdf_tpu_torch.tools import ba_bench
    from port_bench import ba_bounds
    from port_bench.reference import photo_ba as RP

    problem, state, V = _random_problem(seed=11)
    gcfg, pcfg = GridConfig(voxel_size=0.01), PhotoBAConfig()
    rp, rs = _reference_of(problem, state, V)
    s = RP.Settings(0.01, pcfg.damping, pcfg.lambda_, pcfg.reg_weight, False)
    pairs = RP.pair_counts(rp, rs, s, block=500)
    Vp, F = problem.vis.shape
    for mode in ("energy", "dist", "mean"):
        tool = ba_bench.ba_sums_bound_ms(problem, state, gcfg, pcfg, mode)
        n = pairs["pose" if mode == "mean" else mode]
        assert n == tool["pairs"], mode
        assert ba_bounds.ba_sums_bound_ms(Vp, F, n, mode) == pytest.approx(
            tool["bound_ms"], rel=1e-12)
    tool = ba_bench.pose_systems_bound_ms(problem, state, gcfg, pcfg)
    assert pairs["pose"] == tool["pairs"]
    assert ba_bounds.pose_systems_bound_ms(Vp, F, pairs["pose"]) == pytest.approx(
        tool["bound_ms"], rel=1e-12)


def test_the_problem_check_sees_a_changed_row():
    from port_bench import ba_checks

    problem, state, V = _random_problem(seed=3)
    rp, rs = _reference_of(problem, state, V)
    images, K = problem.images.numpy(), problem.K.numpy()
    assert ba_checks.problem_mismatch(rp, rs.dist, problem, state.dist,
                                      images, K) == 0
    vis = problem.vis.clone()
    vis[5, 1] = ~vis[5, 1]
    assert ba_checks.problem_mismatch(rp, rs.dist, problem._replace(vis=vis),
                                      state.dist, images, K) == 1
    dist = state.dist.clone()
    dist[V - 1] += 1e-7
    assert ba_checks.problem_mismatch(rp, rs.dist, problem, dist, images, K) == 1
    short = problem._replace(vmask=problem.vmask.clone())
    short.vmask[V - 1] = False
    assert ba_checks.problem_mismatch(rp, rs.dist, short, state.dist,
                                      images, K) == 2


def test_keyframe_rule_is_the_apps():
    """The app's rule in its pose-file mode: the first frame, then each
    frame after more than `keyframe_gap` (5) frames without one."""
    from port_bench import harness

    loop = harness.entry("photoba_loop")
    slots = loop.keyframe_rule(30, 5, 128)
    assert [i for i, s in enumerate(slots) if s >= 0] == [0, 7, 14, 21, 28]
    assert [s for s in slots if s >= 0] == [0, 1, 2, 3, 4]
    assert [i for i, s in enumerate(loop.keyframe_rule(30, 5, 2)) if s >= 0] == [0, 7]


def test_the_ba_files_load_nothing_of_the_program():
    code = (f"import json, sys; sys.path.insert(0, {ROOT!r});"
            "import port_bench.reference.photo_ba, port_bench.ba_bounds,"
            " port_bench.ba_checks, port_bench.scene_rgb;"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"gradient_sdf_tpu_torch", "gradient_sdf_tpu", "jax",
                       "jaxlib", "flax"}


def test_start_states_move_every_pose_by_the_traffic_sizes():
    from port_bench import scene_rgb
    from port_bench.reference import se3 as RS

    poses = [(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))] * 400
    spec = {"count": 2, "t_sigma_m": 0.003, "r_sigma_deg": 0.2}
    a = scene_rgb.start_states(poses, spec, 2**31 + 5)
    assert len(a) == 2 and len(a[0]) == 400
    again = scene_rgb.start_states(poses, spec, 2**31 + 5)
    assert a[0][3][1].tolist() == again[0][3][1].tolist()
    dt = np.stack([t for _, t in a[1]])
    ang = RS.rotation_angle(torch.eye(3, dtype=torch.float64),
                            torch.as_tensor(np.stack([R for R, _ in a[1]])))
    assert abs(dt.std() - 0.003) < 3e-4
    # |w| of three normal components with 0.2 degrees each: mean 1.6 x 0.2
    assert abs(float(ang.mean()) - np.radians(0.2) * 1.596) < np.radians(0.02)
