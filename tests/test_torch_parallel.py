"""Port multi-device steps (gradient_sdf_tpu_torch/parallel/) on 4 gloo
ranks against the JAX package's sharded steps on 4 of the suite's 8
virtual CPU devices: the cases of tests/test_parallel.py, in the layouts
(4 rays x 1 block), (2 x 2) and (1 x 4).

One module fixture spawns ONE group of 4 ranks, which runs every case
(`tests/torch_mesh_worker.py`, a torch-only module: a spawned rank imports
its target's module, and this file imports JAX) and returns its results;
each test holds one case to the JAX side. Same inputs: depth frames
rendered once by the JAX package, and the JAX package's fused maps handed
to the port where a case needs a map (tracking, render). JAX fusion takes
the port's FALS normals (the `same_normals` fixture; see
test_torch_fusion.py for why), so fusion is compared on its own.

Tolerances are the JAX tests': weight rtol 1e-5 atol 1e-5; dist rtol 1e-4
atol 1e-6; gradient rtol 1e-4 atol 1e-5; poses 2e-5; BA energy 1e-3
relative. Structure (directory, slots, block coordinates, counters) is
exact. Renders: the port's sharded render is bit-equal to its own
unsharded render of the same map; against the JAX render it takes
test_torch_raycast.py's tolerances (hit masks may differ on 0.5% of the
hits, where a probe lands within rounding of a voxel plane).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gradient_sdf_tpu.config import (FusionConfig, GridConfig, PhotoBAConfig,
                                     TrackerConfig)
from gradient_sdf_tpu.data import synth
from gradient_sdf_tpu.models import photo_ba as jpba
from gradient_sdf_tpu.models import tracker
from gradient_sdf_tpu.ops import fusion, normals
from gradient_sdf_tpu.ops import voxel_grid as vg
from gradient_sdf_tpu.parallel import mesh as jmesh
from gradient_sdf_tpu.parallel import sharding as jsh
from gradient_sdf_tpu_torch.models import tracker as ttracker
from gradient_sdf_tpu_torch.ops import fusion as tfu
from gradient_sdf_tpu_torch.ops import normals as tnorm
from gradient_sdf_tpu_torch.ops import raycast as trc
from gradient_sdf_tpu_torch.ops import voxel_grid as tvg
from gradient_sdf_tpu_torch.parallel import mesh as tmesh
from gradient_sdf_tpu_torch.utils import interop

import torch_mesh_worker

W, H = 64, 48
K = np.array([[52.5, 0, 31.5], [0, 52.5, 23.5], [0, 0, 1]], dtype=np.float32)
GCFG = GridConfig(voxel_size=0.02, num_blocks=2048)
FCFG = FusionConfig(trunc_voxels=5.0)
LAYOUTS = [1, 2, 4]   # block_parallel of a 4-rank mesh
VS = GCFG.voxel_size


@pytest.fixture(scope="module", autouse=True)
def same_normals():
    """JAX fusion takes the port's normals (all frames use the camera K)."""

    def port_normals(cache, depth):
        tc = tnorm.build_cache(depth.shape[1], depth.shape[0], K,
                               window=cache.window, device="cpu")

        def host(d):
            return tnorm.compute_normals(tc, torch.from_numpy(np.array(d))).numpy()

        return jax.pure_callback(
            host, jax.ShapeDtypeStruct(tuple(depth.shape) + (3,), jnp.float32),
            depth)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fusion, "compute_normals", port_normals)
        yield


@pytest.fixture(scope="module")
def scene():
    """Frames 0-2 of the JAX test's orbit as numpy (depth, R, t), and the
    JAX package's maps of the first two and three frames."""
    world = synth.SphereWorld(
        centers=jnp.asarray([[0.0, 0.0, 0.0], [0.3, 0.2, -0.1]], jnp.float32),
        radii=jnp.asarray([0.25, 0.15], jnp.float32),
    )
    cache = normals.build_cache(W, H, K, window=5)
    frames, grids = [], []
    g = vg.create(GCFG)
    for R, t in synth.orbit_poses(n=8, radius=1.5)[:3]:
        d = synth.render_depth(world, jnp.asarray(R), jnp.asarray(t), K, W, H)
        frames.append((np.array(d), np.asarray(R), np.asarray(t)))
        g = fusion.fuse_frame(g, d, cache, jnp.asarray(R), jnp.asarray(t),
                              GCFG, FCFG)
        grids.append(g)
    return {"frames": frames, "cache": cache, "grid2": grids[1],
            "grid3": grids[2]}


def _host(jgrid):
    return {k: np.asarray(v) for k, v in jgrid._asdict().items()}


def _ba_inputs():
    """tests/test_parallel.py's BA problem, its voxel axis padded to a
    multiple of 8 as there."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from test_photo_ba import GCFG as BA_GCFG, PCFG, _make_plane_problem

    problem, state, _ = _make_plane_problem(F=3, seed=7, pose_noise=0.004)
    pad = (-problem.vox.shape[0]) % 8

    def padv(a):
        a = np.asarray(a)
        return np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))

    p = {k: np.asarray(v) for k, v in problem._asdict().items()}
    for k in ("vox", "grad", "weight", "vmask", "vis"):
        p[k] = padv(p[k])
    s = {k: np.asarray(v) for k, v in state._asdict().items()}
    s["dist"] = padv(s["dist"])
    return p, s, BA_GCFG, PCFG


GROWTH_GCFG = dict(voxel_size=0.02, num_blocks=16, dir_dim=8)


def _growth_depth():
    far = synth.SphereWorld(centers=jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32),
                            radii=jnp.asarray([0.3], jnp.float32))
    return np.array(synth.render_depth(
        far, jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32), K, W, H))


@pytest.fixture(scope="module")
def port(scene):
    """Every case, run once by one group of 4 ranks on the CPU."""
    import dataclasses

    p, s, ba_gcfg, pcfg = _ba_inputs()
    inputs = {
        "K": K, "W": W, "H": H, "frames": scene["frames"],
        "gcfg": dataclasses.asdict(GCFG), "fcfg": dataclasses.asdict(FCFG),
        "grid2": _host(scene["grid2"]), "grid3": _host(scene["grid3"]),
        "ba_problem": p, "ba_state": s,
        "ba_gcfg": dataclasses.asdict(ba_gcfg),
        "ba_pcfg": dataclasses.asdict(pcfg),
        "growth_gcfg": GROWTH_GCFG, "growth_depth": _growth_depth(),
    }
    return tmesh.launch(torch_mesh_worker.parallel_cases, 4, inputs,
                        device="cpu", timeout_s=240, join_timeout_s=600)


def _jfuse_sharded(scene, bp, n_frames, **kw):
    mesh = jmesh.make_mesh(4, block_parallel=bp)
    g = jsh.shard_grid(mesh, vg.create(GCFG))
    for d, R, t in scene["frames"][:n_frames]:
        g = jsh.sharded_fuse_frame(mesh, g, jnp.asarray(d), scene["cache"],
                                   jnp.asarray(R), jnp.asarray(t), GCFG, FCFG,
                                   **kw)
    return g


def _assert_same_map(got, want):
    """Port grid (numpy dict) vs a JAX grid, the JAX tests' tolerances."""
    want = _host(want)
    for k in ("directory", "coarse_occ", "num_active", "overflow",
              "oob_samples", "block_coords"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["weight"], want["weight"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["dist"], want["dist"], rtol=1e-4, atol=1e-6)
    for k in ("grad_x", "grad_y", "grad_z"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def _port_single(scene, n_frames):
    tc = tnorm.build_cache(W, H, K, window=5, device="cpu")
    g = tvg.create(GCFG, "cpu")
    for d, R, t in scene["frames"][:n_frames]:
        g = tfu.fuse_frame(g, torch.from_numpy(d), tc, torch.from_numpy(R),
                           torch.from_numpy(t), GCFG, FCFG)
    return g


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bp", LAYOUTS)
def test_mesh_layout_matches_jax(port, bp):
    """Rank r sits where JAX's mesh puts device r: rays-major, [4/bp, bp]."""
    devs = np.asarray(jmesh.make_mesh(4, block_parallel=bp).devices)
    ids = np.vectorize(lambda d: d.id)(devs)
    for rank, ray, block in port[f"layout{bp}"]:
        assert ids[ray, block] == rank


def _fake_mesh(rank, bp, n=4):
    """A Mesh without process groups, for the helpers that need none."""
    layout = np.arange(n).reshape(n // bp, bp)
    (i,), (j,) = np.nonzero(layout == rank)
    return tmesh.Mesh(layout=layout, rank=rank, ray_index=int(i),
                      block_index=int(j), device=torch.device("cpu"),
                      backend="gloo", world=None, rays=None, blocks=None)


@pytest.mark.parametrize("n", [7, 8, 1026])
def test_shard_rows_split_like_tensor_split(n):
    """Each axis splits rows in torch.tensor_split's parts, in the order of
    the rank's position along the axis (rays-major over both)."""
    for bp in LAYOUTS:
        for axes in (tmesh.WORLD, tmesh.RAY_AXIS, tmesh.BLOCK_AXIS):
            for rank in range(4):
                m = _fake_mesh(rank, bp)
                want = torch.tensor_split(torch.arange(n), m.axis_size(axes))
                got = torch.arange(n)[tmesh.shard_rows(n, m, axes)]
                assert torch.equal(got, want[m.axis_index(axes)])


def test_grid_block_specs_match_jax():
    from gradient_sdf_tpu_torch.parallel import sharding as tsh

    want = {k: v != jax.sharding.PartitionSpec()
            for k, v in jsh.grid_block_specs()._asdict().items()}
    got = {k: v is not None for k, v in tsh.grid_block_specs()._asdict().items()}
    assert got == want


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="needs a process group"):
        tmesh.make_mesh(4, 2, "cpu")


def test_backend_and_placement_rules():
    assert tmesh.backend_for("cpu", 4) == "gloo"
    assert tmesh.rank_device("cpu", 3) == torch.device("cpu")
    if not torch.cuda.is_available():
        # no card: gloo, and a CUDA rank is an error, not a move to the CPU
        assert tmesh.backend_for("cuda", 1) == "gloo"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmesh.rank_device("cuda", 0)


def test_collectives_keep_every_bit_and_are_counted(port):
    x = np.array([-0.0, 1.5, np.inf, -2.25, 3.0, -0.0, 7.0], np.float32)
    got = port["gathered"]
    np.testing.assert_array_equal(got.view(np.int32), x.view(np.int32))
    assert port["gather_count"] == (1, 7 * 4)
    # psum_scatter_rows over the world keeps the block rows: ranks 0, 2
    # (block 0) rows 0-1 of the sum, ranks 1, 3 rows 2-3
    total = np.arange(8, dtype=np.float32).reshape(4, 2) * (1 + 2 + 3 + 4)
    want = np.concatenate([total[0:2], total[2:4], total[0:2], total[2:4]])
    np.testing.assert_array_equal(port["scatter_rows"], want)


def test_check_replicated_finds_a_rank_that_differs(port):
    assert "directory" in port["divergence"]


def test_launch_raises_when_a_rank_fails():
    """Rank 1 raises while rank 0 waits in a barrier: the group fails (the
    first error to arrive may be either rank's), it does not hang."""
    from torch.multiprocessing import ProcessRaisedException

    with pytest.raises(ProcessRaisedException, match="rank 1 fails|Connection"):
        tmesh.launch(torch_mesh_worker.fail_on_rank_1, 2, device="cpu",
                     timeout_s=60, join_timeout_s=120)


# ---------------------------------------------------------------------------
# fusion and tracking
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bp", LAYOUTS)
def test_sharded_fusion_matches_single_device(port, scene, bp):
    got = port[f"fusion{bp}"]
    _assert_same_map(got, _jfuse_sharded(scene, bp, 1))
    single = interop.grid_to_numpy(_port_single(scene, 1))
    np.testing.assert_array_equal(got["directory"], single["directory"])
    for k in ("weight", "dist", "grad_x", "grad_y", "grad_z"):
        np.testing.assert_allclose(got[k], single[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_sharded_tracking_matches_single_device(port, scene):
    d, R, t = scene["frames"][1]
    tcfg = TrackerConfig(num_iterations=5)
    mesh = jmesh.make_mesh(4, block_parallel=2)
    Rj, tj, _, _ = jsh.sharded_track_frame(
        mesh, scene["grid3"], jnp.asarray(d), jnp.asarray(K), jnp.asarray(R),
        jnp.asarray(t), GCFG, FCFG, tcfg)
    ref = tracker.track_frame(scene["grid3"], jnp.asarray(d), jnp.asarray(K),
                              jnp.asarray(R), jnp.asarray(t), GCFG, FCFG, tcfg)
    Rp, tp, iters, _ = port["track"]
    for want in ((Rj, tj), (ref.R, ref.t)):
        np.testing.assert_allclose(Rp, np.asarray(want[0]), atol=2e-5)
        np.testing.assert_allclose(tp, np.asarray(want[1]), atol=2e-5)
    # and the port's own single-device tracker on the same map
    from gradient_sdf_tpu_torch import config as tcfg_mod

    own = ttracker.track_frame(
        interop.grid_from_numpy(_host(scene["grid3"])), torch.from_numpy(d), K,
        torch.from_numpy(R), torch.from_numpy(t),
        tcfg_mod.GridConfig(voxel_size=0.02, num_blocks=2048),
        tcfg_mod.FusionConfig(trunc_voxels=5.0),
        tcfg_mod.TrackerConfig(num_iterations=5))
    np.testing.assert_allclose(Rp, own.R.numpy(), atol=2e-5)
    np.testing.assert_allclose(tp, own.t.numpy(), atol=2e-5)


@pytest.mark.parametrize("case", torch_mesh_worker.TRACK_AND_FUSE)
def test_sharded_track_and_fuse_matches_single_device(port, scene, case):
    """Sharded tracking then sharded fusion at the refined pose, against the
    port's single-device `track_and_fuse_frame` on the same map, in a
    converged case (fused) and an unconverged one (not fused)."""
    iters, start, conv = case
    Rp, tp, converged, got = port[f"track_and_fuse{iters}"]
    d = scene["frames"][1][0]
    _, R, t = scene["frames"][start]
    tc = tnorm.build_cache(W, H, K, window=5, device="cpu")
    grid, res = ttracker.track_and_fuse_frame(
        interop.grid_from_numpy(_host(scene["grid3"])), torch.from_numpy(d), K,
        torch.from_numpy(R), torch.from_numpy(t), tc, GCFG, FCFG,
        TrackerConfig(num_iterations=iters, conv_threshold=conv))
    assert converged == res.converged == (start == 1)
    np.testing.assert_allclose(Rp, res.R.numpy(), atol=2e-5)
    np.testing.assert_allclose(tp, res.t.numpy(), atol=2e-5)
    want = interop.grid_to_numpy(grid)
    for k in ("directory", "num_active", "block_coords"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["weight"], want["weight"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["dist"], want["dist"], rtol=1e-4, atol=1e-6)
    fused = not np.array_equal(got["weight"], _host(scene["grid3"])["weight"])
    assert fused == res.converged


def test_sharded_photoba_step_matches_single_device(port):
    """The sharded alternation against the port's unsharded one and the JAX
    package's sharded and unsharded ones: dist to the JAX test's 2e-5 and
    the energy to 1e-3; the poses to test_torch_photo_ba.py's allowance for
    the pose step's conditioning, 1e-5 + cond(H) * 1e-6 * |delta|. The
    summed systems agree with the unsharded ones to ~4e-7 relative (the
    float32 sums of four slices in another order), and cond(H) ~ 1e4 on
    this plane turns that into ~5e-5 of rotation (delta ~ 0.04)."""
    from gradient_sdf_tpu_torch.models import photo_ba as tpba
    from test_torch_photo_ba import _step_atol

    p, s, ba_gcfg, pcfg = _ba_inputs()
    got, e_pose, e_dist = port["ba"]
    tp = interop.problem_from_numpy(p, "cpu")
    ts = interop.state_from_numpy(s, "cpu")
    H, b = tpba.pose_systems(tp, ts, ba_gcfg, pcfg)
    atol = _step_atol(H.numpy(), torch.linalg.solve(H, b).numpy())
    own = tpba.solve_dist(tp, tpba.solve_pose(tp, ts, ba_gcfg, pcfg), ba_gcfg,
                          pcfg)
    e_own = float(tpba.energy(tp, own, ba_gcfg))
    for k in ("R", "t"):
        np.testing.assert_allclose(got[k], getattr(own, k).numpy(), atol=atol,
                                   err_msg=k)
    np.testing.assert_allclose(got["dist"], own.dist.numpy(), atol=2e-5)
    assert abs(e_dist - e_own) < 1e-3 * max(e_own, 1.0)
    assert np.isfinite(e_pose)

    problem = jpba.BAProblem(**{k: jnp.asarray(v) for k, v in p.items()})
    state = jpba.BAState(**{k: jnp.asarray(v) for k, v in s.items()})
    ref = jpba.solve_pose(problem, state, ba_gcfg, pcfg)
    ref = jpba.solve_dist(problem, ref, ba_gcfg, pcfg)
    e_ref = float(jpba.energy(problem, ref, ba_gcfg))
    mesh = jmesh.make_mesh(4, block_parallel=2)
    jstate, _, e_j = jsh.sharded_ba_step(mesh, problem, state, ba_gcfg, pcfg)
    for want, e_want in ((ref, e_ref), (jstate, float(e_j))):
        np.testing.assert_allclose(got["R"], np.asarray(want.R), atol=atol)
        np.testing.assert_allclose(got["t"], np.asarray(want.t), atol=atol)
        np.testing.assert_allclose(got["dist"], np.asarray(want.dist),
                                   atol=2e-5)
        assert abs(e_dist - e_want) < 1e-3 * max(e_want, 1.0)


def test_resident_block_sharding_persists(port, scene):
    """The fields stay nb/4 rows per rank through three frames and the
    volume matches; tracking against the sharded volume matches the JAX
    tracker on the JAX map."""
    rows, got, Rp, tp = port["resident"]
    assert rows == [GCFG.num_blocks // 4] * 3
    ref = vg.create(GCFG)
    for d, R, t in scene["frames"]:
        ref = fusion.fuse_frame(ref, jnp.asarray(d), scene["cache"],
                                jnp.asarray(R), jnp.asarray(t), GCFG, FCFG)
    _assert_same_map(got, ref)
    d, R, t = scene["frames"][1]
    res = tracker.track_frame(ref, jnp.asarray(d), jnp.asarray(K),
                              jnp.asarray(R), jnp.asarray(t), GCFG, FCFG,
                              TrackerConfig(num_iterations=4))
    np.testing.assert_allclose(Rp, np.asarray(res.R), atol=2e-5)
    np.testing.assert_allclose(tp, np.asarray(res.t), atol=2e-5)


@pytest.mark.parametrize("touched_cap", [256, 1])
def test_sharded_fusion_touched_compaction(port, scene, touched_cap):
    """The compact collective and the full fallback (cap 1) both give the
    single-device volume; the fallback moves capacity-sized sums."""
    got, calls, nbytes = port[f"touched{touched_cap}"]
    ref = vg.create(GCFG)
    for d, R, t in scene["frames"]:
        ref = fusion.fuse_frame(ref, jnp.asarray(d), scene["cache"],
                                jnp.asarray(R), jnp.asarray(t), GCFG, FCFG)
    _assert_same_map(got, ref)
    assert calls == 2 * 3   # the touched-block vector and the sums, per frame
    vpb = GCFG.voxels_per_block
    field = (touched_cap if touched_cap == 256 else GCFG.num_blocks) * vpb * 5 * 4
    if touched_cap == 256:
        assert int(np.asarray(ref.num_active)) <= touched_cap
    assert nbytes == 3 * (GCFG.num_blocks * 4 + field)


def test_sharded_fusion_collective_sized_by_touched_cap(port):
    """The counterpart of the JAX test's HLO check: one frame moves the
    [nb] int32 touched vector and ONE [cap * B^3, 5] float32 sum, nothing
    capacity-sized."""
    calls, nbytes = port["cap128"]
    assert (calls, nbytes) == (2, GCFG.num_blocks * 4 + 128 * 512 * 5 * 4)


def test_sharded_growth_reshards(port):
    """Capacity growth on a mesh gathers, doubles and re-slices the fields;
    directory growth keeps the slots. Same events and map as the JAX map."""
    import dataclasses

    from gradient_sdf_tpu import config as jcfg_mod
    from gradient_sdf_tpu.models.grad_sdf import GradSdfMap as JMap

    events, nb, dir_dim, rows, acc, got = port["growth"]
    cfg = jcfg_mod.PipelineConfig()
    cfg = dataclasses.replace(cfg, grid=GridConfig(**GROWTH_GCFG))
    jm = JMap(cfg)
    depth = _growth_depth()
    for _ in range(3):
        jm.update(jnp.asarray(depth), K, (jnp.eye(3), jnp.zeros(3)))
    assert events == jm.growth_events
    assert {e["kind"] for e in events} == {"capacity", "world_range"}
    assert (nb, dir_dim) == (jm.cfg.grid.num_blocks, jm.cfg.grid.dir_dim)
    # a map on a mesh keeps no accumulator: its merge reads the summed rows
    assert rows == nb // 2 and acc is None
    _assert_same_map(got, jm.grid)


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------


def _assert_close_render(got, want, what):
    """Port vs JAX render: test_torch_raycast.py's tolerances."""
    (dt, nt, ht), (dj, nj, hj) = got, [np.asarray(a) for a in want]
    n_hit = max(int(hj.sum()), 1)
    assert n_hit > 100, what
    assert int((ht ^ hj).sum()) <= 0.005 * n_hit, what
    both = ht & hj
    err = np.abs(dt[both] - dj[both])
    assert np.median(err) < 1e-5 and np.quantile(err, 0.995) < 1e-4, what
    assert err.max() < 1.5 * VS, what
    same = both & (np.abs(dt - dj) < 1e-4)
    np.testing.assert_allclose(nt[same], nj[same], atol=1e-4, err_msg=what)


def _port_render(grid_np, R, t):
    d, n, h = trc.render_depth_normal(
        interop.grid_from_numpy(grid_np), K, R, t, W, H, _tg(), _tf(),
        s_max=2.5, prior_stride=0)
    return d.numpy(), n.numpy(), h.numpy()


def _tg():
    from gradient_sdf_tpu_torch.config import GridConfig as TG

    return TG(voxel_size=0.02, num_blocks=2048)


def _tf():
    from gradient_sdf_tpu_torch.config import FusionConfig as TF

    return TF(trunc_voxels=5.0)


def _assert_same_bits(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8))


@pytest.mark.parametrize("bp", LAYOUTS)
def test_sharded_render_matches_single_device(port, scene, bp):
    _, R, t = scene["frames"][1]
    got = port[f"render{bp}"]
    _assert_same_bits(got, _port_render(_host(scene["grid3"]), R, t))
    mesh = jmesh.make_mesh(4, block_parallel=bp)
    want = jsh.sharded_render_depth_normal(
        mesh, jsh.shard_grid(mesh, scene["grid3"]), jnp.asarray(K),
        jnp.asarray(R), jnp.asarray(t), W, H, GCFG, FCFG, s_max=2.5)
    _assert_close_render(got, want, f"layout {bp}")


def test_sharded_render_active_cap(port, scene):
    """With active_cap >= num_active the render moves only the [cap, 5,
    B^3] prefix of the fields (plus the images) and equals the unsharded
    render bit for bit."""
    _, R, t = scene["frames"][0]
    d, n, h, calls, nbytes = port["active_cap"]
    assert int(np.asarray(scene["grid2"].num_active)) <= 128
    _assert_same_bits((d, n, h), _port_render(_host(scene["grid2"]), R, t))
    mesh = jmesh.make_mesh(4, block_parallel=2)
    want = jsh.sharded_render_depth_normal(
        mesh, jsh.shard_grid(mesh, scene["grid2"]), jnp.asarray(K),
        jnp.asarray(R), jnp.asarray(t), W, H, GCFG, FCFG, s_max=2.5,
        active_cap=128)
    _assert_close_render((d, n, h), want, "active_cap")
    assert (calls, nbytes) == (2, 128 * 5 * 512 * 4 + W * H * 5 * 4)


def test_sharded_render_active_cap_below_num_active_raises(port, scene):
    """The JAX function renders the blocks beyond a short cap as empty; the
    port refuses the cap."""
    na = int(np.asarray(scene["grid2"].num_active))
    assert port["cap_below"] == (
        f"active_cap {na - 1} is below num_active {na}: blocks beyond the "
        f"cap would render as empty")
