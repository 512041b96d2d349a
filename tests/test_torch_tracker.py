"""Port tracker (gradient_sdf_tpu_torch/models/tracker.py, "grad" mode)
against the JAX package's tracker on the same map and the same frames.

The map is fused once by the JAX package (160x120 camera of
tests/test_tracker.py) and carried into the port with utils/interop, so
these tests isolate the tracker: both sides linearize against identical
voxels.

Tolerances, with their reasons:
  * one residual pass: rtol 1e-4 on (E, g, H) — float32 sums over ~10k
    residuals in another order (torch reductions and matmul vs XLA).
  * tracked pose: 1e-5 (rad and m) — the GN iterates are equal up to that
    summation order. Compared in cases that stop within <= 4 iterations (a
    looser convergence gate, or a lower iteration cap): at 160x120 the GN
    never reaches the 1e-3 gate (it oscillates at the discretization noise
    floor with ||xi|| ~ 4e-3), and from ~5 iterations on those
    oscillations amplify rounding differences chaotically. Full default
    runs are held to the noise floor instead (2 cm, 0.02 rad).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gradient_sdf_tpu.config import FusionConfig, GridConfig, TrackerConfig
torch.backends.cuda.matmul.allow_tf32 = False  # float32, as the JAX package
torch.backends.cudnn.allow_tf32 = False
from gradient_sdf_tpu.data import synth as jsynth
from gradient_sdf_tpu.models import tracker as jtr
from gradient_sdf_tpu.ops import fusion as jfu
from gradient_sdf_tpu.ops import normals as jnorm
from gradient_sdf_tpu.ops import voxel_grid as jvg
from gradient_sdf_tpu.utils import se3 as jse3
from gradient_sdf_tpu_torch.models import tracker as ttr
from gradient_sdf_tpu_torch.ops import normals as tnorm
from gradient_sdf_tpu_torch.utils import interop
from gradient_sdf_tpu_torch.utils import se3 as tse3

W, H = 160, 120
K = np.array([[132.0, 0, 79.5], [0, 132.0, 59.5], [0, 0, 1]], dtype=np.float32)
GCFG = GridConfig(voxel_size=0.02, num_blocks=4096)
FCFG = FusionConfig(trunc_voxels=5.0)
TCFG = TrackerConfig()
POSE_TOL = 1e-5
FLOOR = 0.02
XI = np.array([0.01, -0.015, 0.02, 0.01, -0.012, 0.008], np.float32)


@pytest.fixture(scope="module")
def setup():
    world = jsynth.SphereWorld(
        centers=jnp.asarray([[0.0, 0.0, 0.0], [0.3, 0.25, -0.1],
                             [-0.3, 0.1, 0.2]], jnp.float32),
        radii=jnp.asarray([0.25, 0.14, 0.12], jnp.float32),
    )
    cache = jnorm.build_cache(W, H, K, window=5)
    poses = jsynth.orbit_poses(n=24, radius=1.2)
    jgrid = jvg.create(GCFG)
    for R, t in poses[:8]:
        depth = jsynth.render_depth(world, jnp.asarray(R), jnp.asarray(t), K, W, H)
        jgrid = jfu.fuse_frame(jgrid, depth, cache, jnp.asarray(R),
                               jnp.asarray(t), GCFG, FCFG)
    tgrid = interop.grid_from_numpy({k: np.asarray(v) for k, v in
                                     jgrid._asdict().items()})
    depths = {i: np.array(jsynth.render_depth(world, jnp.asarray(poses[i][0]),
                                              jnp.asarray(poses[i][1]), K, W, H))
              for i in (4, 5, 8)}
    return world, poses, jgrid, tgrid, depths


def _perturbed(R, t):
    dR, dt = jse3.se3_exp(jnp.asarray(XI))
    R0, t0 = jse3.se3_mul(dR, dt, jnp.asarray(R), jnp.asarray(t))
    return np.array(R0), np.array(t0)


def _track_both(setup, idx, R0, t0, tcfg):
    _, _, jgrid, tgrid, depths = setup
    d = depths[idx]
    rj = jtr.track_frame(jgrid, jnp.asarray(d), jnp.asarray(K), jnp.asarray(R0),
                         jnp.asarray(t0), GCFG, FCFG, tcfg)
    rt = ttr.track_frame(tgrid, torch.from_numpy(d), K, torch.from_numpy(R0),
                         torch.from_numpy(t0), GCFG, FCFG, tcfg)
    return rj, rt


# (frame, start perturbed?, config, expect converged?)
CASES = {
    "perturbed": (4, True, TrackerConfig(conv_threshold=5e-3), True),
    "gt_start": (5, False, TrackerConfig(conv_threshold=5e-3), True),
    "stride2": (4, True, TrackerConfig(sampling=2, conv_threshold=1e-2), True),
    "stride3_cap": (4, True, TrackerConfig(sampling=3, num_iterations=3), False),
}


def _gt_error(res, R_gt, t_gt):
    err = tse3.se3_log(*tse3.se3_mul(*tse3.se3_inv(res.R, res.t),
                                     torch.from_numpy(R_gt), torch.from_numpy(t_gt)))
    return float(torch.linalg.norm(err))


@pytest.mark.parametrize("case", sorted(CASES))
def test_track_frame_matches_jax(setup, case):
    """Same GN iterates, same stop: converged-before-apply (the converging
    step is not applied) or the iteration cap."""
    idx, perturb, tcfg, converges = CASES[case]
    poses = setup[1]
    R0, t0 = _perturbed(*poses[idx]) if perturb else poses[idx]
    rj, rt = _track_both(setup, idx, R0, t0, tcfg)
    assert rt.converged == bool(rj.converged) == converges
    assert rt.num_iters == int(rj.num_iters) <= 4
    assert rt.num_valid == int(rj.num_valid) > 250
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=POSE_TOL)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=POSE_TOL)
    # the last iterates differ by ~1e-6: a residual point that close to a
    # voxel's rounding boundary can land in the neighbouring voxel
    np.testing.assert_allclose(rt.energy, float(rj.energy), rtol=1e-3)


def test_default_tracking_hits_the_cap_at_the_noise_floor(setup):
    """Reference settings (1e-3 gate, 25 iterations) at 160x120: both
    trackers run to the cap without converging and end at the same
    discretization noise floor near the GT pose."""
    poses = setup[1]
    R0, t0 = _perturbed(*poses[4])
    rj, rt = _track_both(setup, 4, R0, t0, TCFG)
    assert (rt.converged, rt.num_iters) == (bool(rj.converged), int(rj.num_iters)) \
        == (False, TCFG.num_iterations)
    assert _gt_error(rt, *poses[4]) < FLOOR
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=FLOOR)
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=FLOOR)


def test_nan_steps_are_skipped_like_jax(setup):
    """A map whose distances are NaN makes every GN step NaN: each step is
    skipped, iteration continues to the cap, the pose stays put."""
    _, poses, jgrid, _, depths = setup
    bad = {k: np.array(v) for k, v in jgrid._asdict().items()}
    bad["dist"][:] = np.nan
    jbad = type(jgrid)(**{k: jnp.asarray(v) for k, v in bad.items()})
    tbad = interop.grid_from_numpy(bad)
    R0, t0 = poses[4]
    d = depths[4]
    rj = jtr.track_frame(jbad, jnp.asarray(d), jnp.asarray(K), jnp.asarray(R0),
                         jnp.asarray(t0), GCFG, FCFG, TCFG)
    rt = ttr.track_frame(tbad, torch.from_numpy(d), K, torch.from_numpy(R0),
                         torch.from_numpy(t0), GCFG, FCFG, TCFG)
    assert (rt.converged, rt.num_iters) == (bool(rj.converged), int(rj.num_iters)) \
        == (False, TCFG.num_iterations)
    np.testing.assert_array_equal(rt.R.numpy(), R0)
    np.testing.assert_array_equal(rt.t.numpy(), t0)
    np.testing.assert_array_equal(np.asarray(rj.t), t0)


def test_residual_pass_matches_jax(setup):
    _, poses, jgrid, tgrid, depths = setup
    R0, t0 = _perturbed(*poses[4])
    d = depths[4]
    pj, zj = jtr.backproject_grid(jnp.asarray(d), jnp.asarray(K), 1)
    zvalid = (zj > FCFG.z_min) & (zj < FCFG.z_max)
    Ej, gj, Hj, nj = jtr._residual_pass(jgrid, pj, zvalid, jnp.asarray(R0),
                                        jnp.asarray(t0), GCFG, FCFG,
                                        packed=jtr._pack_fields(jgrid))
    pt, zt = ttr.backproject_grid(torch.from_numpy(d), K, 1)
    Et, gt, Ht, nt = ttr._residual_pass(
        tgrid, pt, (zt > FCFG.z_min) & (zt < FCFG.z_max), torch.from_numpy(R0),
        torch.from_numpy(t0), GCFG, FCFG, ttr._pack_fields(tgrid))
    assert int(nt) == int(nj) > 1000
    np.testing.assert_allclose(float(Et), float(Ej), rtol=1e-4)
    scale_g = float(np.abs(np.asarray(gj)).max())
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4,
                               atol=1e-5 * scale_g)
    scale_h = float(np.abs(np.asarray(Hj)).max())
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=1e-4,
                               atol=1e-6 * scale_h)


@pytest.mark.parametrize("sampling", [1, 2, 3])
def test_backproject_grid_matches_jax(setup, sampling):
    d = setup[4][4]
    pj, zj = jtr.backproject_grid(jnp.asarray(d), jnp.asarray(K), sampling)
    pt, zt = ttr.backproject_grid(torch.from_numpy(d), K, sampling)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))


def test_no_map_gives_no_residuals(setup):
    """An empty map: no valid residuals, xi ~ 0, immediately 'converged'
    with zero residual count — the JAX tracker's behaviour."""
    _, poses, _, _, depths = setup
    empty_cfg = GridConfig(num_blocks=64)
    rj = jtr.track_frame(jvg.create(empty_cfg), jnp.asarray(depths[4]),
                         jnp.asarray(K), jnp.asarray(poses[4][0]),
                         jnp.asarray(poses[4][1]), empty_cfg, FCFG, TCFG)
    from gradient_sdf_tpu_torch.ops import voxel_grid as tvg

    rt = ttr.track_frame(tvg.create(empty_cfg, "cpu"), torch.from_numpy(depths[4]), K,
                         torch.from_numpy(poses[4][0]),
                         torch.from_numpy(poses[4][1]), empty_cfg, FCFG, TCFG)
    assert rt.num_valid == int(rj.num_valid) == 0
    assert rt.converged == bool(rj.converged)
    assert rt.num_iters == int(rj.num_iters)


@pytest.mark.parametrize("alpha", [1.0, 0.5, 0.0])
def test_extrapolate_pose_matches_jax(setup, alpha):
    poses = setup[1]
    (R1, t1), (R2, t2) = poses[6], poses[5]
    want = jtr.extrapolate_pose(*(jnp.asarray(a) for a in (R1, t1, R2, t2)), alpha)
    got = ttr.extrapolate_pose(*(torch.from_numpy(a) for a in (R1, t1, R2, t2)),
                               alpha)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_adaptive_compact_cap_matches_jax(setup):
    d = setup[4][4]
    for depth in (d, np.zeros_like(d), np.full_like(d, 1.0)):
        assert (ttr.adaptive_compact_cap(torch.from_numpy(depth), FCFG)
                == jtr.adaptive_compact_cap(depth, FCFG))


def test_track_and_fuse_frame_matches_jax(setup, monkeypatch):
    """One full Scan3D frame (warm-started tracking, then fusion of the
    converged pose) on copies of the same map; a 5e-3 gate so that GN
    converges at this resolution (see the module docstring). The JAX
    fusion takes the port's normals, as in test_torch_fusion.py: the
    packages' normals differ by ~1e-3, enough to flip pixels that sit on
    fusion's view-angle gate."""
    from gradient_sdf_tpu.ops import fusion as jfu

    def port_normals(cache, depth):
        tc = tnorm.build_cache(W, H, K, window=cache.window, device="cpu")
        return jnp.asarray(tnorm.compute_normals(
            tc, torch.from_numpy(np.array(depth))).numpy())

    monkeypatch.setattr(jfu, "compute_normals", port_normals)
    _, poses, jgrid, _, depths = setup
    tgrid = interop.grid_from_numpy({k: np.asarray(v) for k, v in
                                     jgrid._asdict().items()})
    jcache = jnorm.build_cache(W, H, K, window=5)
    tcache = tnorm.build_cache(W, H, K, window=5, device="cpu")
    tcfg = TrackerConfig(conv_threshold=5e-3)
    (R0, t0), (Rp, tp) = poses[7], poses[6]
    d = depths[8]
    jg, rj = jtr.track_and_fuse_frame(
        jgrid, jnp.asarray(d), jnp.asarray(K), jnp.asarray(R0), jnp.asarray(t0),
        jcache, GCFG, FCFG, tcfg, R_prev2=jnp.asarray(Rp), t_prev2=jnp.asarray(tp),
        warm_alpha=0.5)
    tg, rt = ttr.track_and_fuse_frame(
        tgrid, torch.from_numpy(d), K, torch.from_numpy(R0), torch.from_numpy(t0),
        tcache, GCFG, FCFG, tcfg, R_prev2=torch.from_numpy(Rp),
        t_prev2=torch.from_numpy(tp), warm_alpha=0.5)
    assert rt.converged and bool(rj.converged)
    assert rt.num_iters == int(rj.num_iters)
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=POSE_TOL)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=POSE_TOL)
    assert int(tg.num_active) > int(setup[2].num_active)  # the frame claimed blocks
    np.testing.assert_array_equal(tg.directory.numpy(), np.asarray(jg.directory))
    # fused at poses ~1e-6 apart: each sample's projective sdf moves by
    # ~2e-6 m, its weight 1 - sdf/T by ~2e-5, summed over ~10 samples
    np.testing.assert_allclose(tg.weight.numpy(), np.asarray(jg.weight), atol=5e-4)
    np.testing.assert_allclose(tg.dist.numpy(), np.asarray(jg.dist), atol=5e-4)


@pytest.mark.parametrize("packed", [True, False])
def test_packed_row_gather_setting_matches_jax(setup, packed):
    """`TrackerConfig.packed_row_gather` on and off (the JAX tracker queries
    `query.tsdf_grad` when it is off, tests/test_tracker.py:196-236): the
    same iterates, stop and energy as the JAX tracker at the same setting,
    in the cases that stop within 4 iterations (module docstring)."""
    poses = setup[1]
    for case in ("perturbed", "gt_start"):
        idx, perturb, tcfg, converges = CASES[case]
        tcfg = dataclasses.replace(tcfg, packed_row_gather=packed)
        R0, t0 = _perturbed(*poses[idx]) if perturb else poses[idx]
        rj, rt = _track_both(setup, idx, R0, t0, tcfg)
        assert rt.converged == bool(rj.converged) == converges
        assert rt.num_iters == int(rj.num_iters) <= 4
        assert rt.num_valid == int(rj.num_valid) > 250
        np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=POSE_TOL)
        np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=POSE_TOL)
        np.testing.assert_allclose(rt.energy, float(rj.energy), rtol=1e-3)


def test_unpacked_residual_pass_equals_packed(setup):
    """Without packed rows the pass queries `query.tsdf_grad`: the same
    gathers and arithmetic, so (E, g, H, count) are bit-equal, as in the JAX
    package; and the flag decides which of the two `track_frame` runs."""
    _, poses, _, tgrid, depths = setup
    R0, t0 = (torch.from_numpy(a) for a in _perturbed(*poses[4]))
    pt, zt = ttr.backproject_grid(torch.from_numpy(depths[4]), K, 1)
    zv = (zt > FCFG.z_min) & (zt < FCFG.z_max)
    packed = ttr._residual_pass(tgrid, pt, zv, R0, t0, GCFG, FCFG,
                                ttr._pack_fields(tgrid))
    plain = ttr._residual_pass(tgrid, pt, zv, R0, t0, GCFG, FCFG, None)
    for a, b in zip(packed, plain):
        assert torch.equal(a, b)
    calls = []
    real = ttr._pack_fields

    def counting(grid):
        calls.append(1)
        return real(grid)

    ttr._pack_fields = counting
    try:
        for flag in (False, True):
            ttr.track_frame(tgrid, torch.from_numpy(depths[4]), K, R0, t0, GCFG,
                            FCFG, TrackerConfig(num_iterations=1,
                                                packed_row_gather=flag))
    finally:
        ttr._pack_fields = real
    assert len(calls) == 1
