"""Each cell's loop rehearsed through the port's CPU paths at a small size:
the result line the contract asks for, `correct` true on the program, and
`correct` false with the timed path broken underneath."""

import io
import json
import time
from contextlib import redirect_stdout, redirect_stderr

import pytest
import torch

from conftest import small_scan_cell

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def rehearse(trace=False, seconds=2.5, seed=2**31 + 11, frames=None):
    from port_bench import harness

    bench, cell, cfg, traffic = small_scan_cell()
    if frames is not None:
        # a shorter revolution, so that the window goes round it
        traffic["camera"].update(frames=frames,
                                 arc_deg=traffic["camera"]["arc_deg"] * frames / 24)
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


def test_scan_untraced_line_has_the_contract_keys():
    line, err, e2e, _ = rehearse()
    assert KEYS <= set(line) and list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"] for m in e2e}
    for k, v in line["metrics"].items():
        assert v["value"] > 0 and isinstance(v["unit"], str), k
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    # every compared number beside its limit, as the last lines of stderr
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(s.startswith("check ") and " limit " in s for s in tail)


def test_scan_window_goes_round_the_revolution_from_the_start():
    line, err, _, _ = rehearse(frames=4, seconds=5.0)
    assert line["correct"] is True, line["checks"]
    summary = [s for s in err.splitlines() if s.startswith("scan3d:")][-1]
    by_rev = summary.split("failed a revolution [")[1].split("]")[0].split(",")
    assert len(by_rev) >= 2 and line["attempted"] > 4, summary
    # the window is whole revolutions
    assert line["attempted"] == 4 * len(by_rev), summary


def test_scene_seed_gives_every_run_the_same_scene():
    """With the traffic file's `scene_seed` two runs' seeds get the same
    frames and poses; without it each seed draws its own room."""
    from port_bench import harness

    _, _, cfg, traffic = small_scan_cell()
    traffic["camera"].update(frames=2)
    loop = harness.entry(traffic["entry"])
    dev = torch.device("cpu")
    assert "scene_seed" in traffic
    a, b = (loop.Scene(cfg, traffic, s, dev) for s in (2**31 + 21, 2**31 + 22))
    for x, y in zip(a.frames + [p[1] for p in a.poses],
                    b.frames + [p[1] for p in b.poses]):
        assert (x == y).all()
    del traffic["scene_seed"]
    c, d = (loop.Scene(cfg, traffic, s, dev) for s in (2**31 + 21, 2**31 + 22))
    assert any((x != y).any() for x, y in zip(c.frames, d.frames))


def test_scan_traced_line_reads_the_layers():
    line, _, _, layer = rehearse(trace=True)
    assert "breakdown" in line and {"busy_s", "window_s"} <= set(line["device"])
    names = {m["name"] for m in layer}
    # the CPU run has spans and counters; the device's readers find nothing
    assert {"track_ms", "gn_iters"} <= set(line["metrics"]) <= names
    assert line["correct"] is True


def _broken(monkeypatch, fault):
    from gradient_sdf_tpu_torch.models import grad_sdf, tracker

    if fault == "state unchanged":
        # a frame's fusion that returns the map as it was
        monkeypatch.setattr(grad_sdf.GradSdfMap, "update",
                            lambda self, depth, K, pose, kf_slot=-1: None)
    elif fault == "half the batch":
        # fusion of the top half of the frame's pixels only
        orig = grad_sdf.GradSdfMap.update

        def half(self, depth, K, pose, kf_slot=-1):
            d = torch.as_tensor(depth).clone()
            d[d.shape[0] // 2:] = 0.0
            return orig(self, d, K, pose, kf_slot)

        monkeypatch.setattr(grad_sdf.GradSdfMap, "update", half)
    elif fault == "answer altered":
        # the tracked pose moved by a millimetre where it is produced
        orig = tracker.track_frame

        def moved(*a, **k):
            r = orig(*a, **k)
            return r._replace(t=r.t + 1e-3)

        monkeypatch.setattr(tracker, "track_frame", moved)


@pytest.mark.parametrize("fault", ["state unchanged", "half the batch",
                                   "answer altered"])
def test_scan_broken_path_is_not_correct(monkeypatch, fault):
    _broken(monkeypatch, fault)
    line, _, _, _ = rehearse()
    assert line["correct"] is False, (fault, line["checks"])


@pytest.mark.parametrize("grown", [False, True])
def test_every_revolution_starts_from_the_set_up_map(grown):
    """`Start.reset` puts the map back to set-up's copy bit for bit, in
    place; a revolution that grew the grid keeps its capacity and gets the
    copy grown to it."""
    from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap
    from port_bench import harness, scene

    _, _, cfg, traffic = small_scan_cell()
    loop = harness.entry(traffic["entry"])
    dev = torch.device("cpu")
    sc = loop.Scene(cfg, traffic, 2**31 + 13, dev)
    m = GradSdfMap(loop.program_config(cfg), device=dev)
    m.update(sc.frames[0], sc.K, scene.pose_tensors(sc.poses[0], dev))
    R, t = scene.pose_tensors(sc.poses[1], dev)
    start = loop.Start(m, R, t)
    before = [x.clone() for x in m.grid]
    na = int(m.grid.num_active)
    m.update(sc.frames[1], sc.K, scene.pose_tensors(sc.poses[1], dev))
    if grown:
        m._grow()
    m.grid.dist[:na] += 1.0
    m.grid.num_active.fill_(na + 7)
    fields = [x for x in m.grid]
    R2, t2 = start.reset(m)
    assert torch.equal(R2, R) and torch.equal(t2, t)
    assert m.cfg.grid.num_blocks == (2 if grown else 1) * cfg["grid"]["num_blocks"]
    for name, a, b, f in zip(m.grid._fields, m.grid, before, fields):
        assert a is f, name          # in place: the map keeps its tensors
        if name in ("block_coords", "dist", "weight", "grad_x", "grad_y",
                    "grad_z"):
            assert torch.equal(a[:b.shape[0]], b), name
            assert not a[b.shape[0]:].any(), name
        else:
            assert torch.equal(a, b), name
