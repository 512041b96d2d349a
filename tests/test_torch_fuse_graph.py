"""`GradSdfMap.update` replaying a fused frame as one CUDA graph
(`models/grad_sdf`): the CPU map's direct path, the graph's key and what
drops it (a stub recorder stands in for the card on the CPU), and on a
card the graph against the direct launches over a revolution of the
benchmark's room, the launch counts and the profiler's kernel names."""

import dataclasses

import numpy as np
import pytest
import torch

from gradient_sdf_tpu_torch import config as cfg_mod
from gradient_sdf_tpu_torch.data import synth
from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap
from gradient_sdf_tpu_torch.models.pixel_sdf import PixelSdfMap
from gradient_sdf_tpu_torch.ops import fusion
from gradient_sdf_tpu_torch.ops import voxel_grid as vg
from gradient_sdf_tpu_torch.ops.kernels import fuse_integrate as fi
from gradient_sdf_tpu_torch.tools import fusion_bench as fb
from gradient_sdf_tpu_torch.utils import trace

W, H = 160, 120
K = synth.KINECT_K.copy()
K[:2] *= 0.25
# the card's fusion tests' tolerance (test_torch_fusion.ATOL), here per
# unit of weight for the weight and the gradient: the sums of a frame in
# another order of float atomics
ATOL = 1e-5
GRAPH = ("gsdf.fuse.graph_captures", "gsdf.fuse.graph_replays")
STRUCTURE = ("directory", "coarse_occ", "block_coords", "num_active",
             "overflow", "oob_samples")


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


def _cfg():
    cfg = cfg_mod.preset("synth")
    return dataclasses.replace(cfg, grid=dataclasses.replace(
        cfg.grid, voxel_size=0.02, num_blocks=1024, dir_dim=32))


def _graph_counts(rec):
    return tuple(rec.counters.get(k, 0) for k in GRAPH)


def _assert_same_grid(a, b):
    assert a.num_blocks == b.num_blocks
    for k, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), k


class StubRecorder:
    """`CudaGraphRecorder` on the CPU: the capture keeps the function and
    runs nothing, a replay calls it."""

    @staticmethod
    def fits(device):
        return True

    def __init__(self, fn, device):
        self.fn = fn

    def replay(self):
        self.fn()

    def wait(self):
        pass


@pytest.fixture
def stub(monkeypatch):
    """The stub recorder for every map, and the CPU's block claim writing
    the grid's block count, overflow flag and oob count in place, as the
    card's passes do: else every CPU frame would hand the grid new
    scalars, and so the graph a new key."""
    monkeypatch.setattr(GradSdfMap, "graph_recorder", StubRecorder)
    plain = fusion.claim_blocks

    def in_place(grid, *args):
        out = plain(grid, *args)
        for k in ("num_active", "overflow", "oob_samples"):
            getattr(grid, k).copy_(getattr(out, k))
        return grid

    monkeypatch.setattr(fusion, "claim_blocks", in_place)


class NoGraph:
    """A recorder that fits no device: the map keeps its direct launches."""

    @staticmethod
    def fits(device):
        return False


def test_cpu_update_never_captures_and_equals_plain_fuse_frame():
    """On the CPU `update` takes the direct path: no capture, no replay,
    and the grid bit-equal to `fusion.fuse_frame` on golden frames 0-1."""
    cfg, depths, poses = fb.golden_protocol()
    m = GradSdfMap(cfg, device="cpu")
    grid = vg.create(cfg.grid, "cpu")
    acc, scratch = fusion.new_accumulator(grid), fi.new_scratch(grid)
    trace.enable()
    for depth, (R, t) in list(zip(depths, poses))[:2]:
        m.update(depth, synth.KINECT_K, (R, t))
        assert _graph_counts(trace.take()) == (0, 0)
        d, R, t = (torch.as_tensor(a, dtype=torch.float32)
                   for a in (depth, R, t))
        grid = fusion.fuse_frame(grid, d, m.cache, R, t, cfg.grid,
                                 cfg.fusion, acc=acc, scratch=scratch)
        _assert_same_grid(m.grid, grid)
    assert m._graph is None and int(grid.num_active) > 0


def _change(m, what):
    """Change the map as growth, a restore, a new camera or a caller
    replacing the grid does."""
    if what == "grow":
        m._grow()
    elif what == "grow_directory":
        m.grid.oob_samples.fill_(1)
        m._grow_directory()
    elif what == "restore":
        m.restore(type(m.grid)(*(a.clone() for a in m.grid)), m.cfg.grid)
    elif what == "camera":
        m.cache = None
    elif what == "grid":
        m.grid = type(m.grid)(*(a.clone() for a in m.grid))


@pytest.mark.parametrize("cls", [GradSdfMap, PixelSdfMap])
def test_graph_key_drops_the_graph_on_every_change(stub, frames, cls):
    """With a stub recorder on the CPU: the first frame runs direct, the
    second captures and replays, the third replays; after growth of the
    capacity or of the directory, a restore, a new camera or a replaced
    grid the next frame runs direct (the stale graph is dropped, never
    replayed), the one after captures anew. The map equals a direct one
    bit for bit after every frame."""
    m, ref = cls(_cfg(), device="cpu"), cls(_cfg(), device="cpu")
    ref.graph_recorder = NoGraph
    trace.enable()
    n = [0]

    def step():
        depth, R, t = frames[n[0] % len(frames)]
        n[0] += 1
        for x in (m, ref):
            x.update(depth, K, (R, t))
        _assert_same_grid(m.grid, ref.grid)
        return _graph_counts(trace.take())

    assert [step() for _ in range(3)] == [(0, 0), (1, 1), (0, 1)]
    for what in ("grow", "grow_directory", "restore", "camera", "grid"):
        graph = m._graph
        for x in (m, ref):
            _change(x, what)
        assert step() == (0, 0) and m._graph is None, what
        assert step() == (1, 1) and m._graph not in (None, graph), what
        assert step() == (0, 1), what
    assert m.cfg.grid.num_blocks == 2048 and m.cfg.grid.dir_dim == 64


def test_visibility_map_never_captures(stub, frames):
    """A map with visibility words takes the direct launches, even where
    the recorder fits its device: its keyframe slot changes by frame."""
    m = GradSdfMap(_cfg(), with_vis=True, device="cpu")
    trace.enable()
    for k, (depth, R, t) in enumerate(frames):
        m.update(depth, K, (R, t), kf_slot=k)
        assert _graph_counts(trace.take()) == (0, 0)
    assert m._graph is None and bool(m.vis.any())


def test_add_launches_moves_a_wrappers_counter():
    before = trace.launches()
    trace.add_launches({"fuse_claim": 2, "fals_normals": 1})
    after = trace.launches()
    trace.add_launches({"fuse_claim": -2, "fals_normals": -1})
    assert after["fuse_claim"] == before["fuse_claim"] + 2
    assert after["fals_normals"] == before["fals_normals"] + 1
    assert trace.launched(before) == 0 and trace.launches() == before


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs and the kernels have no "
                    "CPU mode)")


def _room(seed=2147483921):
    """(PipelineConfig, Scene) of the benchmark's cell scan3d-room-dense:
    a revolution of VGA frames of the room and their true poses."""
    from port_bench import harness
    from port_bench.entries import scan3d_loop

    bench = harness.benchmark()
    cfg = harness.config_of(bench, "scan3d-vga-1cm")
    traffic = harness.data_file("traffic", "room-dense")
    sc = scan3d_loop.Scene(cfg, traffic, seed, torch.device("cuda"))
    return scan3d_loop.program_config(cfg), sc


@pytest.mark.gpu
@pytest.mark.parametrize("num_blocks", [16384, 4096])
def test_cuda_graph_matches_direct_launches_over_a_revolution(num_blocks):
    """A revolution of the room fused at its true poses through the graph
    and, from a copy of the graph map's state before every frame, through
    the direct launches: the directory, coarse occupancy, block
    coordinates, block count, overflow and oob count equal, dist within
    ATOL, weight and gradient within ATOL of max(weight, 1). The first
    frames open blocks; at 4096 blocks the map overflows and grows, and
    the frame after a growth runs direct, the next captures anew."""
    _needs_card()
    pcfg, sc = _room()
    pcfg = dataclasses.replace(pcfg, grid=dataclasses.replace(
        pcfg.grid, num_blocks=num_blocks))
    dev = torch.device("cuda")
    m, direct = GradSdfMap(pcfg, device=dev), GradSdfMap(pcfg, device=dev)
    direct.graph_recorder = NoGraph
    trace.enable()
    log = []
    for depth, pose in zip(sc.frames, sc.poses):
        assert direct.cfg.grid == m.cfg.grid
        for dst, src in zip(direct.grid, m.grid):
            dst.copy_(src)
        grown = len(m.growth_events)
        for x in (m, direct):
            x.update(depth, sc.K, tuple(torch.as_tensor(a, device=dev)
                                        for a in pose))
        log.append(_graph_counts(trace.take())
                   + (len(m.growth_events) > grown,))
        g, d = m.grid, direct.grid
        for k in STRUCTURE:
            assert torch.equal(getattr(g, k), getattr(d, k)), (len(log), k)
        per_weight = d.weight.clamp(min=1.0)
        errs = {"dist": (g.dist - d.dist).abs().max(),
                "weight": ((g.weight - d.weight).abs() / per_weight).max(),
                "grad": max(((getattr(g, c) - getattr(d, c)).abs()
                             / per_weight).max()
                            for c in ("grad_x", "grad_y", "grad_z"))}
        assert all(float(e) <= ATOL for e in errs.values()), (len(log), errs)
    assert log[0][:2] == (0, 0)
    for prev, (cap, rep, _) in zip(log, log[1:]):
        if prev[2]:
            assert (cap, rep) == (0, 0)
        elif prev[:2] == (0, 0):
            assert (cap, rep) == (1, 1)
        else:
            assert (cap, rep) == (0, 1)
    grew = [i for i, e in enumerate(log) if e[2]]
    assert bool(grew) == (num_blocks == 4096)
    assert any(log[i][1] for i in grew) or not grew
    assert len(direct.growth_events) == len(m.growth_events)


@pytest.mark.gpu
def test_cuda_replay_launches_each_fusion_kernel_once_under_its_name():
    """Golden frames fused through `update`: the direct frame, the capture
    and every replay count one launch of each fusion kernel and nothing
    else, and the profiler's trace of a replay names the three kernels
    (the benchmark's rooflines find them by these words)."""
    _needs_card()
    cfg, depths, poses = fb.golden_protocol()
    m = GradSdfMap(cfg, device="cuda")
    trace.enable()
    want = {"fals_normals": 1, "fuse_claim": 1, "fuse_integrate": 1}
    for i, (depth, pose) in enumerate(zip(depths, poses)):
        before = trace.launches()
        if i == len(depths) - 1:
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                m.update(depth, synth.KINECT_K, pose)
                torch.cuda.synchronize()
        else:
            m.update(depth, synth.KINECT_K, pose)
        now = trace.launches()
        assert {k: n - before[k] for k, n in now.items()
                if n != before[k]} == want, i
        assert _graph_counts(trace.take()) == [(0, 0), (1, 1), (0, 1)][
            min(i, 2)], i
    names = " ".join(e.key for e in prof.key_averages())
    for k in want:
        assert k in names, (k, names)


@pytest.mark.gpu
def test_cuda_visibility_map_never_captures():
    """On a card a map with visibility words keeps the direct launches at
    every keyframe slot, and records each slot's bit."""
    _needs_card()
    cfg, depths, poses = fb.golden_protocol()
    m = GradSdfMap(cfg, with_vis=True, device="cuda")
    trace.enable()
    for k, (depth, pose) in enumerate(zip(depths, poses)):
        m.update(depth, synth.KINECT_K, pose, kf_slot=k)
        assert _graph_counts(trace.take()) == (0, 0)
    assert m._graph is None
    words = m.vis[..., 0]
    for k in range(len(depths)):
        assert bool(((words >> k) & 1).any()), k
    assert np.isfinite(float(m.grid.weight.sum()))
