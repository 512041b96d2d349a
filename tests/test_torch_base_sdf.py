"""The base-SDF ablation of the port (trilinear tracking, `PixelSdfMap`,
`RigidPointOptimizer`, `scan3d --scan-type base-sdf`) against the JAX package.

Tracking is compared on one map, fused once by the JAX package without
gradients (160x120 camera of tests/test_tracker.py) and carried into the
port with utils/interop. The maps are compared with the JAX fusion fed the
port's normals, as tests/test_torch_fusion.py does and for its reason.

Tolerances, with their reasons:
  * one trilinear residual pass: rtol 1e-4 on (E, g, H) — float32 sums over
    ~10k residuals in another order.
  * tracked pose: 1e-5 in cases that stop within <= 4 iterations; a full
    default run sits on the GN noise floor at this resolution, as in grad
    mode (tests/test_torch_tracker.py), and is held to 2 cm / 0.02 rad.
  * `PixelSdfMap.update` vs the JAX map: structure exact, dist 1e-5 and
    weight 2e-5 + 1e-6 relative, gradients exactly zero. Sums in another
    order; tests/test_torch_fusion.py holds weights to 1e-5 at 64x48, but at
    160x120 a voxel's weight reaches ~200, where one float32 ulp is 1.5e-5
    (measured: 1.9e-5 at most, beyond 1e-5 on 28 of 2M voxels), and one
    voxel of weight 0.88 differs by 1.25e-5 (a sample on the weight ramp,
    whose slope amplifies the rounding of its distance).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gradient_sdf_tpu import config as jcfg_mod
torch.backends.cuda.matmul.allow_tf32 = False  # float32, as the JAX package
torch.backends.cudnn.allow_tf32 = False
from gradient_sdf_tpu.config import FusionConfig, GridConfig, TrackerConfig
from gradient_sdf_tpu.data import synth as jsynth
from gradient_sdf_tpu.models import rigid_optimizer as jro
from gradient_sdf_tpu.models import tracker as jtr
from gradient_sdf_tpu.models.grad_sdf import GradSdfMap as JGradMap
from gradient_sdf_tpu.models.pixel_sdf import PixelSdfMap as JPixelMap
from gradient_sdf_tpu.ops import fusion as jfu
from gradient_sdf_tpu.ops import normals as jnorm
from gradient_sdf_tpu.ops import voxel_grid as jvg
from gradient_sdf_tpu.utils import se3 as jse3
from gradient_sdf_tpu_torch.apps import make_synth as tmake
from gradient_sdf_tpu_torch.apps import scan3d as tscan
from gradient_sdf_tpu_torch.models import rigid_optimizer as tro
from gradient_sdf_tpu_torch.models import tracker as ttr
from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap as TGradMap
from gradient_sdf_tpu_torch.models.pixel_sdf import PixelSdfMap as TPixelMap
from gradient_sdf_tpu_torch.ops import normals as tnorm
from gradient_sdf_tpu_torch.utils import interop, tumio
from gradient_sdf_tpu_torch.utils.ply import load_ply

W, H = 160, 120
K = np.array([[132.0, 0, 79.5], [0, 132.0, 59.5], [0, 0, 1]], dtype=np.float32)
GCFG = GridConfig(voxel_size=0.02, num_blocks=4096)
FCFG = FusionConfig(trunc_voxels=5.0)
POSE_TOL = 1e-5
FLOOR = 0.02
XI = np.array([0.01, -0.015, 0.02, 0.01, -0.012, 0.008], np.float32)
WORLD = jsynth.SphereWorld(
    centers=jnp.asarray([[0.0, 0.0, 0.0], [0.3, 0.25, -0.1], [-0.3, 0.1, 0.2]],
                        jnp.float32),
    radii=jnp.asarray([0.25, 0.14, 0.12], jnp.float32),
)


def _depth(R, t):
    return np.array(jsynth.render_depth(WORLD, jnp.asarray(R), jnp.asarray(t),
                                        K, W, H))


@pytest.fixture(scope="module")
def setup():
    """(poses, JAX grid, port grid, depths): 8 frames fused WITHOUT
    gradients by the JAX package."""
    cache = jnorm.build_cache(W, H, K, window=5)
    poses = jsynth.orbit_poses(n=24, radius=1.2)
    jgrid = jvg.create(GCFG)
    for R, t in poses[:8]:
        jgrid = jfu.fuse_frame(jgrid, jnp.asarray(_depth(R, t)), cache,
                               jnp.asarray(R), jnp.asarray(t), GCFG, FCFG,
                               accumulate_gradients=False)
    tgrid = interop.grid_from_numpy({k: np.asarray(v) for k, v in
                                     jgrid._asdict().items()})
    return poses, jgrid, tgrid, {i: _depth(*poses[i]) for i in (4, 5, 8)}


def _perturbed(R, t):
    dR, dt = jse3.se3_exp(jnp.asarray(XI))
    R0, t0 = jse3.se3_mul(dR, dt, jnp.asarray(R), jnp.asarray(t))
    return np.array(R0), np.array(t0)


def test_trilinear_residual_pass_matches_jax(setup):
    poses, jgrid, tgrid, depths = setup
    R0, t0 = _perturbed(*poses[4])
    d = depths[4]
    pj, zj = jtr.backproject_grid(jnp.asarray(d), jnp.asarray(K), 1)
    Ej, gj, Hj, nj = jtr._residual_pass(
        jgrid, pj, (zj > FCFG.z_min) & (zj < FCFG.z_max), jnp.asarray(R0),
        jnp.asarray(t0), GCFG, FCFG, mode="trilinear")
    pt, zt = ttr.backproject_grid(torch.from_numpy(d), K, 1)
    Et, gt, Ht, nt = ttr._residual_pass(
        tgrid, pt, (zt > FCFG.z_min) & (zt < FCFG.z_max), torch.from_numpy(R0),
        torch.from_numpy(t0), GCFG, FCFG, mode="trilinear")
    assert int(nt) == int(nj) > 1000
    np.testing.assert_allclose(float(Et), float(Ej), rtol=1e-4)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4,
                               atol=1e-4 * float(np.abs(np.asarray(gj)).max()))
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=1e-4,
                               atol=1e-4 * float(np.abs(np.asarray(Hj)).max()))
    with pytest.raises(ValueError, match="tracking mode"):
        ttr._residual_pass(tgrid, pt, zt > 0, torch.from_numpy(R0),
                           torch.from_numpy(t0), GCFG, FCFG, mode="cubic")


# (frame, start perturbed?, config, expect converged?)
CASES = {
    "perturbed": (4, True, TrackerConfig(conv_threshold=5e-3), True),
    "gt_start": (5, False, TrackerConfig(conv_threshold=5e-3), True),
    "stride2_cap": (4, True, TrackerConfig(sampling=2, num_iterations=3), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_trilinear_track_frame_matches_jax(setup, case):
    idx, perturb, tcfg, converges = CASES[case]
    poses, jgrid, tgrid, depths = setup
    R0, t0 = _perturbed(*poses[idx]) if perturb else poses[idx]
    d = depths[idx]
    rj = jtr.track_frame(jgrid, jnp.asarray(d), jnp.asarray(K), jnp.asarray(R0),
                         jnp.asarray(t0), GCFG, FCFG, tcfg, mode="trilinear")
    rt = ttr.track_frame(tgrid, torch.from_numpy(d), K, torch.from_numpy(R0),
                         torch.from_numpy(t0), GCFG, FCFG, tcfg, mode="trilinear")
    assert rt.converged == bool(rj.converged) == converges
    assert rt.num_iters == int(rj.num_iters) <= 4
    assert rt.num_valid == int(rj.num_valid) > 250
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=POSE_TOL)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=POSE_TOL)


def test_trilinear_default_tracking_ends_at_the_noise_floor(setup):
    poses, jgrid, tgrid, depths = setup
    R0, t0 = _perturbed(*poses[4])
    d = depths[4]
    tcfg = TrackerConfig()
    rj = jtr.track_frame(jgrid, jnp.asarray(d), jnp.asarray(K), jnp.asarray(R0),
                         jnp.asarray(t0), GCFG, FCFG, tcfg, mode="trilinear")
    rt = ttr.track_frame(tgrid, torch.from_numpy(d), K, torch.from_numpy(R0),
                         torch.from_numpy(t0), GCFG, FCFG, tcfg, mode="trilinear")
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=FLOOR)
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=FLOOR)
    np.testing.assert_allclose(rt.t.numpy(), poses[4][1], atol=FLOOR)


def test_trilinear_track_and_fuse_frame_matches_jax(setup):
    """Converged trilinear tracking fuses WITHOUT gradients, in both."""
    poses, jgrid, tgrid, depths = setup
    jcache = jnorm.build_cache(W, H, K, window=5)
    tcache = tnorm.build_cache(W, H, K, 5, "cpu")
    tcfg = TrackerConfig(conv_threshold=5e-3)
    R0, t0 = poses[7]
    d = depths[8]
    jg, rj = jtr.track_and_fuse_frame(
        jgrid, jnp.asarray(d), jnp.asarray(K), jnp.asarray(R0), jnp.asarray(t0),
        jcache, GCFG, FCFG, tcfg, mode="trilinear")
    tg = interop.grid_from_numpy(interop.grid_to_numpy(tgrid))   # a copy
    w0 = float(tg.weight.sum())
    tg, rt = ttr.track_and_fuse_frame(
        tg, torch.from_numpy(d), K, torch.from_numpy(R0), torch.from_numpy(t0),
        tcache, GCFG, FCFG, tcfg, mode="trilinear")
    assert rt.converged and bool(rj.converged)
    assert rt.num_iters == int(rj.num_iters)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-4)
    assert float(tg.weight.sum()) > w0 and not tg.grad_x.any()
    assert abs(int(tg.num_active) - int(jg.num_active)) <= 2
    assert not np.asarray(jg.grad_x).any()


@pytest.mark.parametrize("kind", ["base", "grad"])
def test_rigid_point_optimizer_picks_the_mode_from_the_map(setup, kind):
    """The class-style wrapper against the JAX package's, both map types:
    same convergence, same iterations, same pose."""
    poses, jgrid, tgrid, depths = setup
    cfg = jcfg_mod.PipelineConfig(grid=GCFG, fusion=FCFG)
    jm = (JPixelMap if kind == "base" else JGradMap)(cfg)
    tm = (TPixelMap if kind == "base" else TGradMap)(cfg, device="cpu")
    if kind == "grad":
        # a gradient for the semi-implicit query: the dist field's x-slope
        gx = np.ones_like(np.asarray(jgrid.dist))
        jgrid = jgrid._replace(grad_x=jnp.asarray(gx))
        tgrid = tgrid._replace(grad_x=torch.from_numpy(gx.copy()))
    jm.grid, tm.grid = jgrid, tgrid
    jo = jro.RigidPointOptimizer(jm, num_iterations=3, conv_threshold=5e-3)
    to = tro.RigidPointOptimizer(tm, num_iterations=3, conv_threshold=5e-3)
    R0, t0 = _perturbed(*poses[4])
    jo.set_pose(R0, t0)
    to.set_pose(R0, t0)
    to.set_damping(1.0)
    got = to.optimize_sampled(depths[4], K, 2)
    want = jo.optimize_sampled(depths[4], K, 2)
    assert got == want
    assert to.last_result.num_iters == int(jo.last_result.num_iters)
    assert to.last_result.num_valid == int(jo.last_result.num_valid) > 250
    np.testing.assert_allclose(to.pose()[0].numpy(), np.asarray(jo.pose()[0]),
                               atol=POSE_TOL)
    np.testing.assert_allclose(to.pose()[1].numpy(), np.asarray(jo.pose()[1]),
                               atol=POSE_TOL)
    to.set_num_iterations(1)
    to.set_conv_threshold(1e-3)
    assert (to.tcfg.num_iterations, to.tcfg.conv_threshold) == (1, 1e-3)
    assert to.optimize(depths[4], K) is False and to.last_result.num_iters == 1


# ---------------------------------------------------------------------------
# the map
# ---------------------------------------------------------------------------


@pytest.fixture
def same_normals(monkeypatch):
    """JAX fusion takes the port's normals (see tests/test_torch_fusion.py)."""

    def port_normals(cache, depth):
        tc = tnorm.build_cache(depth.shape[1], depth.shape[0], K, cache.window, "cpu")

        def host(d):
            return tnorm.compute_normals(tc, torch.from_numpy(np.array(d))).numpy()

        return jax.pure_callback(
            host, jax.ShapeDtypeStruct(tuple(depth.shape) + (3,), jnp.float32), depth)

    monkeypatch.setattr(jfu, "compute_normals", port_normals)


def test_pixel_sdf_map_update_matches_jax_voxel_for_voxel(setup, same_normals):
    poses = setup[0]
    cfg = jcfg_mod.PipelineConfig(
        grid=GCFG, fusion=jcfg_mod.FusionConfig(trunc_voxels=5.0, normal_window=5))
    jm, tm = JPixelMap(cfg), TPixelMap(cfg, device="cpu")
    jm.setup(jnp.asarray(_depth(*poses[0])), K, (jnp.asarray(poses[0][0]),
                                                jnp.asarray(poses[0][1])))
    tm.setup(_depth(*poses[0]), K, poses[0])
    for R, t in poses[1:3]:
        jm.update(jnp.asarray(_depth(R, t)), K, (jnp.asarray(R), jnp.asarray(t)))
        tm.update(_depth(R, t), K, (R, t))
        assert not tm.acc.any()
    assert tm.counter == jm.counter == 3
    a = interop.grid_to_numpy(tm.grid)
    b = {k: np.asarray(v) for k, v in jm.grid._asdict().items()}
    for k in ("directory", "coarse_occ", "num_active", "overflow", "oob_samples",
              "block_coords"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert int(a["num_active"]) > 30
    np.testing.assert_allclose(a["weight"], b["weight"], atol=2e-5, rtol=1e-6)
    np.testing.assert_allclose(a["dist"], b["dist"], atol=1e-5)
    for k in ("grad_x", "grad_y", "grad_z"):
        assert not a[k].any() and not b[k].any()
    # the map's queries are the trilinear ones
    pts = np.random.default_rng(41).uniform(-0.4, 0.4, (2000, 3)).astype(np.float32)
    jphi, jgrad = jm.tsdf(pts)
    tphi, tgrad = tm.tsdf(pts)
    np.testing.assert_allclose(tphi.numpy(), np.asarray(jphi), atol=1e-5)
    np.testing.assert_allclose(tgrad.numpy() * 0.02, np.asarray(jgrad) * 0.02, atol=1e-5)
    np.testing.assert_allclose(tm.weights(pts).numpy(), np.asarray(jm.weights(pts)),
                               atol=1e-5)
    assert (tm.weights(pts).numpy() > 0).sum() > 50


def test_pixel_sdf_map_exports(setup, tmp_path):
    """Two dump files beside grid_info (not the gradient map's five), a
    mesh, and no oriented point cloud."""
    poses = setup[0]
    cfg = jcfg_mod.PipelineConfig(
        grid=GCFG, fusion=jcfg_mod.FusionConfig(trunc_voxels=5.0, normal_window=5))
    tm = TPixelMap(cfg, device="cpu")
    assert tm.save_sdf(str(tmp_path / "empty")) is False
    for R, t in poses[:2]:
        tm.update(_depth(R, t), K, (R, t))
    assert tm.save_sdf(str(tmp_path / "m")) is True
    assert sorted(os.listdir(tmp_path)) == ["m_grid_info.txt", "m_sdf_d.txt",
                                            "m_sdf_weight.txt"]
    rows = np.loadtxt(tmp_path / "m_sdf_weight.txt")
    assert len(rows) == int((tm.grid.weight > 0).sum()) > 1000
    assert rows[:, 1].min() > 0
    assert tm.extract_mesh(str(tmp_path / "mesh.ply")) is True
    assert len(load_ply(str(tmp_path / "mesh.ply"))["vertex"]) > 50
    with pytest.raises(NotImplementedError):
        tm.extract_pc(str(tmp_path / "cloud.ply"))
    assert tm.vis is None


def test_pixel_sdf_map_grows_like_the_jax_map(same_normals):
    """Capacity and world-range growth, with the accumulator regrown."""
    import dataclasses

    cfg = jcfg_mod.PipelineConfig()
    cfg = dataclasses.replace(cfg, grid=dataclasses.replace(
        cfg.grid, voxel_size=0.02, num_blocks=16, dir_dim=8),
        fusion=dataclasses.replace(cfg.fusion, normal_window=5))
    far = jsynth.SphereWorld(centers=jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32),
                             radii=jnp.asarray([0.3], jnp.float32))
    R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    depth = np.array(jsynth.render_depth(far, jnp.asarray(R), jnp.asarray(t), K, W, H))
    jm, tm = JPixelMap(cfg), TPixelMap(cfg, device="cpu")
    for _ in range(3):
        jm.update(jnp.asarray(depth), K, (jnp.asarray(R), jnp.asarray(t)))
        tm.update(depth, K, (R, t))
        assert not tm.acc.any()
    assert tm.growth_events == jm.growth_events
    assert {e["kind"] for e in tm.growth_events} == {"capacity", "world_range"}
    assert tm.cfg.grid == jm.cfg.grid
    assert tm.acc.shape[0] == tm.grid.num_blocks * tm.grid.voxels_per_block
    np.testing.assert_array_equal(tm.grid.directory.numpy(),
                                  np.asarray(jm.grid.directory))
    np.testing.assert_allclose(tm.grid.weight.numpy(), np.asarray(jm.grid.weight),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the app
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("synth"))
    tmake.main(["--out", out, "--frames", "5", "--seed", "2", "--width", "320",
                "--height", "240", "--arc-deg", "4", "--no-noise", "--device", "cpu"])
    return out


def test_scan3d_base_sdf_ablation(synth_dir, tmp_path):
    """--scan-type base-sdf with GT poses, as the JAX app's test: mesh, dist
    and weight dumps, no gradient files and no cloud."""
    results = str(tmp_path / "out_base")
    metrics = tscan.main([
        "--input", synth_dir, "--results", results, "--pose-file", "gt_poses.txt",
        "--scan-type", "base-sdf", "--data-type", "synth", "--voxel-size", "0.02",
        "--trunc", "5", "--last", "3", "--save-sdf", "--device", "cpu"])
    assert metrics["frames"] == 4
    assert metrics["num_blocks_active"] > 0
    mesh = load_ply(os.path.join(results, "gradient_sdf_mesh_final.ply"))
    assert len(mesh["vertex"]) > 50
    assert os.path.isfile(os.path.join(results, "gradient_sdf_sdf_d.txt"))
    assert not os.path.isfile(os.path.join(results, "gradient_sdf_sdf_n0.txt"))
    assert not os.path.isfile(os.path.join(results, "gradient_sdf_cloud_final.ply"))


def test_scan3d_base_sdf_tracks_like_the_jax_app(synth_dir, tmp_path):
    """Tracking mode, both apps on the one dataset: the trajectories agree to
    the noise floor of 320x240 tracking (5 mm / 5 mrad, as grad mode in
    tests/test_torch_scan3d.py) and stay within 2 cm of the ground truth."""
    from gradient_sdf_tpu.apps import scan3d as jscan

    argv = ["--input", synth_dir, "--pose-file", "none.txt", "--scan-type",
            "base-sdf", "--data-type", "synth", "--voxel-size", "0.02", "--trunc", "5"]
    jres, tres = str(tmp_path / "j"), str(tmp_path / "t")
    jm = jscan.run_scan(jscan.build_parser().parse_args(argv + ["--results", jres]))
    tm = tscan.main(argv + ["--results", tres, "--device", "cpu"])
    assert tm["frames"] == jm["frames"] == 5
    tj = tumio.read_trajectory(os.path.join(jres, "_poses.txt"))
    tt = tumio.read_trajectory(os.path.join(tres, "_poses.txt"))
    gt = tumio.read_trajectory(os.path.join(synth_dir, "gt_poses.txt"))
    for (_, Rt, t_t), (_, Rj, t_j) in zip(tt, tj):
        assert np.linalg.norm(t_t - t_j) < 5e-3
        assert np.abs(Rt - Rj).max() < 5e-3

    def rel(traj, i):
        R0, t0 = traj[0][1].astype(np.float64), traj[0][2].astype(np.float64)
        return R0.T @ (traj[i][2] - t0)

    for i in range(1, 5):
        assert np.linalg.norm(rel(tt, i) - rel(gt, i)) < 0.02
    assert all(e["gn_iters"] for e in tm["frame_log"][1:])
