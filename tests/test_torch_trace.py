"""The port's tracing (`gradient_sdf_tpu_torch/utils/trace.py`): the spans
and counters of a Scan3D frame on the CPU path, the shared no-op while
tracing is off, the profiler's copies of the spans, and the one snapshot
of every kernel wrapper's launch count."""

import dataclasses
import importlib
import pkgutil

import numpy as np
import pytest
import torch

from gradient_sdf_tpu_torch import config as cfg_mod
from gradient_sdf_tpu_torch.data import synth
from gradient_sdf_tpu_torch.models import tracker
from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap
from gradient_sdf_tpu_torch.ops import kernels
from gradient_sdf_tpu_torch.utils import trace

W, H = 160, 120
K = synth.KINECT_K.copy()
K[:2] *= 0.25
FRAME_SPANS = {"gsdf.track.launch", "gsdf.track.read", "gsdf.fuse.launch",
               "gsdf.fuse.read"}


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    yield
    trace.disable()


@pytest.fixture(scope="module")
def frames():
    world = synth.random_spheres(seed=2, device="cpu")
    poses = synth.orbit_poses(n=24, radius=1.2)[:6]
    return [(synth.render_depth(world, R, t, K, W, H), R, t) for R, t in poses]


def _map(frames):
    """A CPU map of the first four frames fused at their true poses."""
    cfg = cfg_mod.preset("synth")
    cfg = dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, voxel_size=0.02,
                                      num_blocks=4096),
        tracker=dataclasses.replace(cfg.tracker, conv_threshold=1e-2))
    m = GradSdfMap(cfg, device="cpu")
    for depth, R, t in frames[:4]:
        m.update(depth, K, (R, t))
    return m


def _frame(m, frames, idx, tcfg):
    """The app's frame body: track from the previous true pose, fuse the
    refined pose if tracking converged."""
    depth, _, _ = frames[idx]
    R0, t0 = frames[idx - 1][1:]
    res = tracker.track_frame(m.grid, depth, K, torch.as_tensor(R0),
                              torch.as_tensor(t0), m.cfg.grid, m.cfg.fusion,
                              tcfg)
    if res.converged:
        m.update(depth, K, (res.R, res.t))
    return res


def test_off_span_is_the_shared_noop_and_a_frame_records_nothing(frames):
    m = _map(frames)
    assert trace.span("gsdf.a") is trace.span("gsdf.b")
    trace.count("gsdf.reads")
    res = _frame(m, frames, 4, m.cfg.tracker)
    assert res.converged
    assert trace.take() == ({}, {})


def test_traced_frame_records_each_span_once_and_its_reads(frames):
    m = _map(frames)
    trace.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = _frame(m, frames, 4, m.cfg.tracker)
    rec = trace.take()
    assert res.converged
    assert set(rec.spans) == FRAME_SPANS
    assert all(s > 0 for s in rec.spans.values())
    names = [e.name for e in prof.events() if e.name.startswith("gsdf.")]
    assert sorted(names) == sorted(FRAME_SPANS)
    # the plain loop reads its convergence flag every iteration and E and
    # the count once; update reads its growth flags
    assert rec.counters == {"gsdf.reads": res.num_iters + 2 + 1}
    assert trace.take() == ({}, {})


def test_unconverged_frame_records_no_fuse_span(frames):
    m = _map(frames)
    tcfg = dataclasses.replace(m.cfg.tracker, conv_threshold=0.0,
                               num_iterations=3)
    trace.enable()
    res = _frame(m, frames, 4, tcfg)
    rec = trace.take()
    assert not res.converged and res.num_iters == 3
    assert set(rec.spans) == {"gsdf.track.launch", "gsdf.track.read"}
    assert rec.counters == {"gsdf.reads": 3 + 2}


def test_a_span_shows_in_the_profiler_under_its_name():
    trace.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("gsdf.test.outer"):
            with trace.span("gsdf.test.inner"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"gsdf.test.outer", "gsdf.test.inner"} <= names
    rec = trace.take()
    assert rec.spans["gsdf.test.outer"] >= rec.spans["gsdf.test.inner"] > 0
    # no profiler, no range: the span still times its block
    with trace.span("gsdf.test.outer"):
        pass
    assert set(trace.take().spans) == {"gsdf.test.outer"}


def test_tracing_block_restores_the_state():
    with trace.tracing(False):
        assert not trace.enabled()
    with trace.tracing():
        assert trace.enabled()
        with trace.tracing():
            trace.count("gsdf.reads", 3)
        assert trace.enabled()
        assert trace.take().counters == {"gsdf.reads": 3}
    assert not trace.enabled()


def _launch_counters():
    """(module, attribute) of every launch counter under ops/kernels."""
    out = []
    for info in pkgutil.iter_modules(kernels.__path__):
        mod = importlib.import_module(f"{kernels.__name__}.{info.name}")
        out += [(mod, a) for a in vars(mod) if a.endswith("launch_count")
                and isinstance(getattr(mod, a), int)]
    return out


def test_launches_names_every_wrapper_count_and_a_reset_zeroes_it(
        monkeypatch):
    counters = _launch_counters()
    assert len(counters) == 16
    for i, (mod, attr) in enumerate(counters):
        monkeypatch.setattr(mod, attr, 10 + i)
    snap = trace.launches()
    assert sorted(snap.values()) == list(range(10, 10 + len(counters)))
    assert {"gn_track_loop", "fuse_claim", "scatter_add_rows", "gn_step",
            "ba_pose_systems", "render_windows", "prior_windows",
            "ray_finish"} <= set(snap)
    # one launch more of the loop kernel and of an F = 1 scatter, which
    # scatter_add counts too
    from gradient_sdf_tpu_torch.ops.kernels import gn_track, scatter_add

    monkeypatch.setattr(gn_track, "loop_launch_count",
                        gn_track.loop_launch_count + 1)
    monkeypatch.setattr(scatter_add, "launch_count",
                        scatter_add.launch_count + 1)
    monkeypatch.setattr(scatter_add, "rows_launch_count",
                        scatter_add.rows_launch_count + 1)
    assert trace.launched(snap) == 2
    trace.reset_launches()
    assert set(trace.launches().values()) == {0}
    assert np.all([getattr(mod, attr) == 0 for mod, attr in counters])
