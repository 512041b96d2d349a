"""The GN tracking kernels' plain versions (gradient_sdf_tpu_torch/ops/
kernels/gn_track.py) against the JAX package's tracker, on the map of
tests/test_torch_tracker.py (its `setup` fixture: 8 frames fused by the JAX
package at 160x120, carried into the port with utils/interop).

`gn_residual_reduce_reference` is held to the JAX `_residual_pass` (grad
mode with and without packed rows, trilinear mode, and a slot window that
keeps half of the blocks, against a JAX pass over a grid whose other blocks
are emptied); `gn_step_reference` to the body of the JAX loop
(tracker.py:213-222, written out below with the JAX functions) on crafted
systems; `gn_track_reference`, the plain version of the loop kernel, to the
JAX `track_frame` (perturbed start, no map, NaN steps; grad and trilinear)
and to the plain pass and step run by hand; `tracker.gn_loop`, the mesh's
loop, driven here by the plain versions, to the JAX tracker and to the
port's plain loop. The CUDA kernels themselves have no CPU mode: the
`gpu`-marked test holds them to these plain versions on a card.

Tolerances, with their reasons:
  * residual sums: count exact; E rtol 1e-4, g and H rtol 1e-4 plus atol
    1e-5 / 1e-6 of the largest entry (test_torch_tracker.py's bounds: float32
    sums over ~10k residuals in another order);
  * one GN step: 2e-6 on R and t (a well-conditioned 6x6 float32 LU in
    another order moves the step by a few ulps); the flags and the
    non-finite cases exactly;
  * tracked poses: 1e-5, test_torch_tracker.py's POSE_TOL; the energy of
    the last iteration rtol 1e-3 (test_torch_tracker.py's bound: a point
    within ~1e-6 of a voxel's rounding boundary may land in the
    neighbouring voxel).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gradient_sdf_tpu.models import tracker as jtr
from gradient_sdf_tpu.utils import se3 as jse3
from gradient_sdf_tpu_torch.config import TrackerConfig
from gradient_sdf_tpu_torch.models import tracker as ttr
from gradient_sdf_tpu_torch.ops.kernels import gn_track as gt
from gradient_sdf_tpu_torch.tools import track_bench

from gradient_sdf_tpu.config import GridConfig
from gradient_sdf_tpu.ops import voxel_grid as jvg
from gradient_sdf_tpu_torch.ops import voxel_grid as tvg
from gradient_sdf_tpu_torch.utils import interop

from test_torch_tracker import (CASES, FCFG, GCFG, K, POSE_TOL, TCFG,  # noqa: F401
                                _perturbed, setup)

STEP_TOL = track_bench.STEP_TOL
CONV_SQ = track_bench.CONV_SQ_CRAFTED


def _jax_pass(jgrid, d, R0, t0, mode, packed):
    pj, zj = jtr.backproject_grid(jnp.asarray(d), jnp.asarray(K), 1)
    zv = (zj > FCFG.z_min) & (zj < FCFG.z_max)
    return jtr._residual_pass(jgrid, pj, zv, jnp.asarray(R0), jnp.asarray(t0),
                              GCFG, FCFG, mode,
                              packed=jtr._pack_fields(jgrid) if packed else None)


def _points(d):
    return ttr.compact_points(torch.from_numpy(d), K, FCFG, TrackerConfig())


def _assert_sums_match(sums, want):
    E, g, H, n = gt.system_of_sums(sums)
    Ej, gj, Hj, nj = (np.asarray(a) for a in want)
    assert int(n) == int(nj) > 500
    np.testing.assert_allclose(float(E), float(Ej), rtol=1e-4)
    np.testing.assert_allclose(g.numpy(), gj, rtol=1e-4,
                               atol=1e-5 * np.abs(gj).max())
    np.testing.assert_allclose(H.numpy(), Hj, rtol=1e-4,
                               atol=1e-6 * np.abs(Hj).max())


@pytest.mark.parametrize("mode,packed", [("grad", True), ("grad", False),
                                         ("trilinear", False)])
def test_residual_reduce_matches_jax(setup, mode, packed):
    """The plain residual pass against the JAX `_residual_pass` (packed rows
    or `query.tsdf_grad`, or the trilinear query), and the wrapper on CPU
    tensors is the plain version, bit for bit, launching nothing."""
    _, poses, jgrid, tgrid, depths = setup
    R0, t0 = _perturbed(*poses[4])
    want = _jax_pass(jgrid, depths[4], R0, t0, mode, packed)
    pts = _points(depths[4])
    R, t = torch.from_numpy(R0), torch.from_numpy(t0)
    sums = gt.gn_residual_reduce_reference(pts, R, t, tgrid, GCFG, FCFG, mode=mode)
    _assert_sums_match(sums, want)
    gt.reset_launch_count()
    got = gt.gn_residual_reduce(pts, R, t, tgrid, GCFG, FCFG, mode=mode)
    assert torch.equal(got, sums) and got.shape == (gt.SUMS,)
    assert gt.launch_count == gt.step_launch_count == 0


def _emptied(jgrid, lo, hi):
    """The JAX grid with the fields of every block outside slots [lo, hi)
    zeroed: those blocks hold no observed voxel."""
    g = {k: np.array(v) for k, v in jgrid._asdict().items()}
    keep = np.zeros(g["dist"].shape[0], bool)
    keep[lo:hi] = True
    for k in ("dist", "weight", "grad_x", "grad_y", "grad_z"):
        g[k][~keep] = 0.0
    return type(jgrid)(**{k: jnp.asarray(v) for k, v in g.items()})


def _window(tgrid, lo, hi):
    """The port grid as a mesh rank holds it: the fields of slots [lo, hi)."""
    return tgrid._replace(**{k: getattr(tgrid, k)[lo:hi].contiguous() for k in
                             ("dist", "weight", "grad_x", "grad_y", "grad_z")})


def test_residual_reduce_slot_window_matches_jax(setup):
    """A window that keeps half of the allocated blocks (a mesh rank's
    shard) against the JAX pass over the grid whose other blocks are
    emptied; the two halves' sums add up to the whole pass, the count
    exactly (owner-computes)."""
    _, poses, jgrid, tgrid, depths = setup
    R0, t0 = _perturbed(*poses[4])
    pts = _points(depths[4])
    R, t = torch.from_numpy(R0), torch.from_numpy(t0)
    na, nb = int(tgrid.num_active), tgrid.num_blocks
    h = na // 2
    halves = []
    for lo, hi in ((h, nb), (0, h)):
        sums = gt.gn_residual_reduce(pts, R, t, _window(tgrid, lo, hi), GCFG,
                                     FCFG, mode="grad", slot_lo=lo)
        halves.append(sums)
    want = _jax_pass(_emptied(jgrid, h, nb), depths[4], R0, t0, "grad", False)
    _assert_sums_match(halves[0], want)
    whole = gt.gn_residual_reduce(pts, R, t, tgrid, GCFG, FCFG)
    assert float(halves[0][-1]) > 500 and float(halves[1][-1]) > 500
    assert float(halves[0][-1] + halves[1][-1]) == float(whole[-1])
    _assert_sums_match(halves[0] + halves[1],
                       _jax_pass(jgrid, depths[4], R0, t0, "grad", False))


def _jax_body(H, g, R, t, damping, conv_sq):
    """The JAX loop body after the residual pass (tracker.py:213-222)."""
    xi = damping * jnp.linalg.solve(H + 1e-12 * jnp.eye(6, dtype=H.dtype), g)
    small = jnp.sum(xi * xi) < conv_sq
    bad = jnp.any(jnp.isnan(xi))
    dR, dt = jse3.se3_exp(-xi)
    Rn, tn = jse3.se3_mul(dR, dt, R, t)
    apply = ~small & ~bad
    return jnp.where(apply, Rn, R), jnp.where(apply, tn, t), small, bad


def _sums(H, g):
    return track_bench.sums_of_system(H, g, "cpu")


def _crafted():
    """`tools/track_bench.crafted_systems` by name: a normal step, zero
    residuals, a rank-deficient H (a single plane), a NaN and an inf in g,
    and a step whose rotation is inside the theta^2 < 1e-8 Taylor branch."""
    return {name: (H, g) for name, H, g in track_bench.crafted_systems()}


@pytest.mark.parametrize("case", ["normal", "zero", "plane", "nan", "inf",
                                  "taylor"])
def test_gn_step_matches_jax_loop_body(setup, case):
    """One step from crafted sums: the flags equal, the pose within
    STEP_TOL of the JAX body's (the same pose, bit for bit, where the step
    is not applied); the wrapper on CPU tensors writes that pose and the
    status in place."""
    poses = setup[1]
    H, g = _crafted()[case]
    R0, t0 = (np.asarray(a, np.float32) for a in poses[4])
    sums = _sums(H, g)
    Rj, tj, sj, bj = _jax_body(jnp.asarray(H), jnp.asarray(g), jnp.asarray(R0),
                               jnp.asarray(t0), 1.0, CONV_SQ)
    R, t, small, bad = gt.gn_step_reference(
        sums, torch.from_numpy(R0), torch.from_numpy(t0), 1.0, CONV_SQ)
    assert (bool(small), bool(bad)) == (bool(sj), bool(bj))
    expect = {"normal": (False, False), "zero": (True, False),
              "plane": (False, False), "nan": (False, True),
              "inf": (False, True), "taylor": (False, False)}[case]
    assert (bool(small), bool(bad)) == expect
    if case == "taylor":
        _, g6, H6, _ = gt.system_of_sums(sums)
        xi = torch.linalg.solve(H6 + 1e-12 * torch.eye(6), g6)
        assert float((xi[3:] ** 2).sum()) < 1e-8
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), rtol=0, atol=STEP_TOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), rtol=0, atol=STEP_TOL)
    if any(expect):
        assert torch.equal(R, torch.from_numpy(R0))
        assert torch.equal(t, torch.from_numpy(t0))
    Rw, tw = torch.from_numpy(R0.copy()), torch.from_numpy(t0.copy())
    status = torch.full((4,), -1.0)
    gt.gn_step(sums, Rw, tw, status, damping=1.0, conv_sq=CONV_SQ)
    assert torch.equal(Rw, R) and torch.equal(tw, t)
    assert status.tolist() == [float(small), float(bad), 2.5, 1234.0]


def test_gn_update_is_the_plain_loops_step(setup):
    """`gauss_newton`'s step is `gn_update`: one plain iteration from the
    system of a residual pass equals `gn_step_reference` from its sums."""
    _, poses, _, tgrid, depths = setup
    R0, t0 = (torch.from_numpy(a) for a in _perturbed(*poses[4]))
    pts = _points(depths[4])
    sums = gt.gn_residual_reduce(pts, R0, t0, tgrid, GCFG, FCFG)
    _, g, H, _ = gt.system_of_sums(sums)
    a = gt.gn_update(H, g, R0, t0, 1.0, CONV_SQ)
    b = gt.gn_step_reference(sums, R0, t0, 1.0, CONV_SQ)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not bool(a[2]) and not torch.equal(a[0], R0)


@pytest.mark.parametrize("mode", ["grad", "trilinear"])
def test_gn_loop_matches_plain_loop(setup, mode):
    """The kernels' loop (`tracker.gn_loop` around the two wrappers, here
    their plain versions) against the port's plain loop on the CPU, which
    test_torch_tracker.py and test_torch_base_sdf.py hold to the JAX
    tracker: same stop, iterations, count, and poses within POSE_TOL."""
    _, poses, _, tgrid, depths = setup
    idx, perturb, tcfg, converges = CASES["perturbed"]
    R0, t0 = (torch.from_numpy(a) for a in _perturbed(*poses[idx]))
    pts = _points(depths[idx])
    gt.reset_launch_count()
    got = ttr.gn_loop(lambda R, t: gt.gn_residual_reduce(
        pts, R, t, tgrid, GCFG, FCFG, mode=mode), R0, t0, tcfg, "cpu")
    want = ttr.track_frame(tgrid, torch.from_numpy(depths[idx]), K, R0, t0, GCFG,
                           FCFG, tcfg, mode=mode)
    assert got.converged == want.converged
    assert got.num_iters == want.num_iters <= 4
    assert got.num_valid == want.num_valid > 250
    np.testing.assert_allclose(got.R.numpy(), want.R.numpy(), atol=POSE_TOL)
    np.testing.assert_allclose(got.t.numpy(), want.t.numpy(), atol=POSE_TOL)
    np.testing.assert_allclose(got.energy, want.energy, rtol=1e-3)
    assert gt.launch_count == gt.step_launch_count == 0
    # the loop leaves the caller's pose alone
    assert torch.equal(R0, torch.from_numpy(_perturbed(*poses[idx])[0]))


def test_gn_loop_matches_jax_tracker(setup):
    """The kernels' loop against the JAX tracker itself (grad mode,
    test_torch_tracker.py's 'perturbed' case)."""
    _, poses, jgrid, tgrid, depths = setup
    idx, _, tcfg, converges = CASES["perturbed"]
    R0, t0 = _perturbed(*poses[idx])
    rj = jtr.track_frame(jgrid, jnp.asarray(depths[idx]), jnp.asarray(K),
                         jnp.asarray(R0), jnp.asarray(t0), GCFG, FCFG, tcfg)
    pts = _points(depths[idx])
    got = ttr.gn_loop(lambda R, t: gt.gn_residual_reduce(
        pts, R, t, tgrid, GCFG, FCFG), torch.from_numpy(R0),
        torch.from_numpy(t0), tcfg, "cpu")
    assert got.converged == bool(rj.converged) == converges
    assert got.num_iters == int(rj.num_iters)
    assert got.num_valid == int(rj.num_valid)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(rj.R), atol=POSE_TOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(rj.t), atol=POSE_TOL)


def _loop_case(setup, case):
    """(JAX grid, port grid, depth, R0, t0, tracker config, grid config) of
    a `gn_track` case: 'perturbed' (test_torch_tracker.py's case), 'no_map'
    (an empty map: no residuals, a zero step) and 'nan_step' (every
    distance NaN: every step NaN and skipped, to the iteration cap)."""
    _, poses, jgrid, tgrid, depths = setup
    if case == "perturbed":
        idx, _, tcfg, _ = CASES["perturbed"]
        return (jgrid, tgrid, depths[idx], *_perturbed(*poses[idx]), tcfg,
                GCFG)
    R0, t0 = (np.asarray(a, np.float32) for a in poses[4])
    if case == "no_map":
        empty = GridConfig(num_blocks=64)
        return (jvg.create(empty), tvg.create(empty, "cpu"), depths[4], R0,
                t0, TCFG, empty)
    bad = {k: np.array(v) for k, v in jgrid._asdict().items()}
    bad["dist"][:] = np.nan
    return (type(jgrid)(**{k: jnp.asarray(v) for k, v in bad.items()}),
            interop.grid_from_numpy(bad), depths[4], R0, t0, TCFG, GCFG)


@pytest.mark.parametrize("mode", ["grad", "trilinear"])
@pytest.mark.parametrize("case", ["perturbed", "no_map", "nan_step"])
def test_gn_track_matches_jax_track_frame(setup, case, mode):
    """The loop kernel's plain version (`gn_track` on CPU tensors) against
    the JAX `track_frame`: converged, iterations, count, E and the pose; it
    updates R and t in place and launches nothing."""
    jgrid, tgrid, d, R0, t0, tcfg, gcfg = _loop_case(setup, case)
    rj = jtr.track_frame(jgrid, jnp.asarray(d), jnp.asarray(K), jnp.asarray(R0),
                         jnp.asarray(t0), gcfg, FCFG, tcfg, mode=mode)
    pts = _points(d)
    R, t = torch.from_numpy(R0.copy()), torch.from_numpy(t0.copy())
    gt.reset_launch_count()
    status = gt.gn_track(pts, R, t, tgrid, gcfg, FCFG, mode=mode,
                         num_iterations=tcfg.num_iterations,
                         damping=tcfg.damping,
                         conv_sq=tcfg.conv_threshold ** 2)
    small, bad, E, cnt, iters = status.tolist()
    assert status.shape == (gt.STATUS,) and status.dtype == torch.float32
    assert (small != 0.0) == bool(rj.converged)
    assert int(iters) == int(rj.num_iters)
    assert int(cnt) == int(rj.num_valid)
    np.testing.assert_allclose(E, float(rj.energy), rtol=1e-3)
    np.testing.assert_allclose(R.numpy(), np.asarray(rj.R), atol=POSE_TOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(rj.t), atol=POSE_TOL)
    expect = {"perturbed": (True, False, 4, 250),
              "no_map": (True, False, 1, 0),
              "nan_step": (False, True, TCFG.num_iterations, 250)}[case]
    assert (small != 0.0, bad != 0.0) == expect[:2]
    assert int(iters) <= expect[2]
    assert int(cnt) > expect[3] if expect[3] else int(cnt) == 0
    if case == "nan_step":
        assert int(iters) == TCFG.num_iterations and np.isnan(E)
        np.testing.assert_array_equal(R.numpy(), R0)
        np.testing.assert_array_equal(t.numpy(), t0)
    assert gt.loop_launch_count == gt.launch_count == gt.step_launch_count == 0


@pytest.mark.parametrize("mode", ["grad", "trilinear"])
def test_gn_track_status_is_the_plain_pass_and_step(setup, mode):
    """`gn_track_reference`'s pose and status [small, bad, E, count,
    iterations] are those of `gn_residual_reduce_reference` and
    `gn_step_reference` run by hand until a step is small, bit for bit; a
    cap of one iteration gives the first step."""
    _, tgrid, d, R0, t0, tcfg, gcfg = _loop_case(setup, "perturbed")
    pts = _points(d)
    conv_sq = tcfg.conv_threshold ** 2
    R, t = torch.from_numpy(R0), torch.from_numpy(t0)
    rows = []
    for _ in range(tcfg.num_iterations):
        sums = gt.gn_residual_reduce_reference(pts, R, t, tgrid, gcfg, FCFG,
                                               mode=mode)
        R, t, small, bad = gt.gn_step_reference(sums, R, t, tcfg.damping,
                                                conv_sq)
        rows.append((R, t, [float(small), float(bad), float(sums[0]),
                            float(sums[-1]), float(len(rows) + 1)]))
        if bool(small):
            break
    assert 2 <= len(rows) <= 4
    for cap, (Rw, tw, sw) in ((tcfg.num_iterations, rows[-1]), (1, rows[0])):
        Rg, tg, status = gt.gn_track_reference(
            pts, torch.from_numpy(R0), torch.from_numpy(t0), tgrid, gcfg, FCFG,
            mode=mode, num_iterations=cap, damping=tcfg.damping,
            conv_sq=conv_sq)
        assert status.tolist() == sw
        assert torch.equal(Rg, Rw) and torch.equal(tg, tw)


def test_wrappers_check_their_inputs(setup):
    tgrid = setup[3]
    pts = torch.zeros((10, 3))
    R, t = torch.eye(3), torch.zeros(3)
    with pytest.raises(ValueError, match="unknown tracking mode"):
        gt.gn_residual_reduce(pts, R, t, tgrid, GCFG, FCFG, mode="nearest")
    with pytest.raises(ValueError, match="pts"):
        gt.gn_residual_reduce(pts.double(), R, t, tgrid, GCFG, FCFG)
    with pytest.raises(ValueError, match="field"):
        gt.gn_residual_reduce(pts, R, t, tgrid, GCFG, FCFG, slot_lo=0, slot_hi=8)
    with pytest.raises(ValueError, match="status"):
        gt.gn_step(torch.zeros(gt.SUMS), R, t, torch.zeros(3), damping=1.0,
                   conv_sq=CONV_SQ)
    # no points: zero sums, and the 1e-12 I system gives a zero step
    sums = gt.gn_residual_reduce(torch.zeros((0, 3)), R, t, tgrid, GCFG, FCFG)
    assert torch.equal(sums, torch.zeros(gt.SUMS))
    status = torch.zeros(4)
    gt.gn_step(sums, R, t, status, damping=1.0, conv_sq=CONV_SQ)
    assert status.tolist() == [1.0, 0.0, 0.0, 0.0]


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "iterations",
                                 "mode"])
def test_gn_track_checks_its_inputs(setup, bad):
    """`gn_track` raises on points, pose or grid of another type, shape or
    device, on fewer than one iteration and on an unknown mode."""
    tgrid = setup[3]
    pts, R, t = torch.zeros((10, 3)), torch.eye(3), torch.zeros(3)
    kw = dict(mode="grad", num_iterations=3, damping=1.0, conv_sq=CONV_SQ)
    if bad == "dtype":
        pts, match = pts.double(), "pts"
    elif bad == "shape":
        R, match = torch.eye(4)[:3].contiguous(), "R"
    elif bad == "device":
        t, match = torch.zeros(3, device="meta"), "t"
    elif bad == "iterations":
        kw["num_iterations"], match = 0, "num_iterations"
    else:
        kw["mode"], match = "nearest", "unknown tracking mode"
    with pytest.raises(ValueError, match=match):
        gt.gn_track(pts, R, t, tgrid, GCFG, FCFG, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["grad", "trilinear"])
def test_cuda_gn_kernels_match_plain(setup, mode):
    """On a card: the one-pass launch's count equals the plain version's
    and its sums agree within float32 summation error; two runs give the
    same bits; the step kernel matches the plain step on the crafted
    systems; the loop kernel's first iteration is the one-pass launch's sums
    and the step kernel's pose, bit for bit, its full run the chain of its
    single-iteration runs (and a second full run) bit for bit, and the plain
    loop's iterations and pose within POSE_TOL; `track_frame` on a CUDA map
    is one launch of the loop kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    _, poses, _, tgrid, depths = setup
    cg = type(tgrid)(*(a.cuda() for a in tgrid))
    R0, t0 = (torch.from_numpy(a).cuda() for a in _perturbed(*poses[4]))
    pts = _points(depths[4]).cuda()
    gt.reset_launch_count()
    a = gt.gn_residual_reduce(pts, R0, t0, cg, GCFG, FCFG, mode=mode)
    b = gt.gn_residual_reduce(pts, R0, t0, cg, GCFG, FCFG, mode=mode)
    phi, J, valid = gt.gn_residual_terms(pts, R0, t0, cg, GCFG, FCFG, mode=mode)
    want = gt.sums_of_terms(phi, J, valid)
    scale = gt.sums_of_terms(phi.abs(), J.abs(), valid)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and float(a[-1]) == float(want[-1]) > 250
    assert bool(((a - want).abs() <= 2.0**-18 * scale).all())
    for name, (H, g) in _crafted().items():
        sums = _sums(H, g).cuda()
        R, t = R0.clone(), t0.clone()
        status = torch.zeros(4, device="cuda")
        gt.gn_step(sums, R, t, status, damping=1.0, conv_sq=CONV_SQ)
        Rp, tp, small, bad = gt.gn_step_reference(sums, R0, t0, 1.0, CONV_SQ)
        assert status[:2].tolist() == [float(small), float(bad)], name
        assert float((R - Rp).abs().max()) <= STEP_TOL, name
        assert float((t - tp).abs().max()) <= STEP_TOL, name
    tcfg = TrackerConfig(conv_threshold=5e-3)
    kw = dict(mode=mode, damping=tcfg.damping, conv_sq=tcfg.conv_threshold ** 2)
    R1, t1 = R0.clone(), t0.clone()
    one = gt.gn_track(pts, R1, t1, cg, GCFG, FCFG, num_iterations=1, **kw)
    Rs, ts = R0.clone(), t0.clone()
    status = torch.zeros(4, device="cuda")
    gt.gn_step(a, Rs, ts, status, damping=kw["damping"], conv_sq=kw["conv_sq"])
    assert one.tolist()[:4] == status.tolist() and one.tolist()[4] == 1.0
    assert torch.equal(R1, Rs) and torch.equal(t1, ts)
    R, t = R0.clone(), t0.clone()
    for k in range(tcfg.num_iterations):
        step = gt.gn_track(pts, R, t, cg, GCFG, FCFG, num_iterations=1, **kw)
        if step[0] != 0.0:
            break
    full = []
    for _ in range(2):
        Rf, tf = R0.clone(), t0.clone()
        full.append((gt.gn_track(pts, Rf, tf, cg, GCFG, FCFG,
                                 num_iterations=tcfg.num_iterations, **kw),
                     Rf, tf))
    for st, Rf, tf in full:
        assert st.tolist() == step.tolist()[:4] + [float(k + 1)]
        assert torch.equal(Rf, R) and torch.equal(tf, t)
    Rp, tp, sp = gt.gn_track_reference(pts, R0, t0, cg, GCFG, FCFG,
                                       num_iterations=tcfg.num_iterations, **kw)
    assert sp.tolist()[4] == full[0][0].tolist()[4] <= 4
    assert float((Rp - R).abs().max()) <= POSE_TOL
    assert float((tp - t).abs().max()) <= POSE_TOL
    # track_frame compacts the points on the card (its backprojection
    # rounds otherwise than the CPU's): the loop kernel on those points
    depth = torch.from_numpy(depths[4]).cuda()
    Rc, tc = R0.clone(), t0.clone()
    st = gt.gn_track(ttr.compact_points(depth, K, FCFG, tcfg), Rc, tc, cg, GCFG,
                     FCFG, num_iterations=tcfg.num_iterations, **kw).tolist()
    gt.reset_launch_count()
    res = ttr.track_frame(cg, depth, K, R0, t0, GCFG, FCFG, tcfg, mode=mode)
    assert gt.loop_launch_count == 1 <= res.num_iters
    assert gt.launch_count == gt.step_launch_count == 0
    assert torch.equal(res.R, Rc) and torch.equal(res.t, tc)
    assert [res.converged, res.num_iters, res.energy, res.num_valid] == [
        st[0] != 0.0, int(st[4]), st[2], int(st[3])]


def _jax_track(setup, d, R0, t0, tcfg):
    jgrid = setup[2]
    return jtr.track_frame(jgrid, jnp.asarray(d), jnp.asarray(K),
                           jnp.asarray(R0), jnp.asarray(t0), GCFG, FCFG, tcfg)


def test_track_frame_with_zero_iterations_matches_jax(setup):
    """`TrackerConfig.num_iterations = 0`: the JAX `track_frame`'s loop
    condition is false at once; the port returns the same, the start pose,
    not converged, 0 iterations, E 0 and count 0, and launches nothing."""
    _, poses, _, tgrid, depths = setup
    R0, t0 = _perturbed(*poses[4])
    tcfg = TrackerConfig(num_iterations=0)
    rj = _jax_track(setup, depths[4], R0, t0, tcfg)
    gt.reset_launch_count()
    res = ttr.track_frame(tgrid, torch.from_numpy(depths[4]), K,
                          torch.from_numpy(R0), torch.from_numpy(t0), GCFG,
                          FCFG, tcfg)
    assert (res.converged, res.num_iters, res.energy, res.num_valid) == (
        bool(rj.converged), int(rj.num_iters), float(rj.energy),
        int(rj.num_valid)) == (False, 0, 0.0, 0)
    np.testing.assert_array_equal(res.R.numpy(), np.asarray(rj.R))
    np.testing.assert_array_equal(res.t.numpy(), np.asarray(rj.t))
    np.testing.assert_array_equal(res.R.numpy(), R0)
    np.testing.assert_array_equal(res.t.numpy(), t0)
    assert gt.loop_launch_count == gt.launch_count == gt.step_launch_count == 0


@pytest.mark.gpu
def test_cuda_track_frame_with_zero_iterations_launches_nothing(setup):
    """On a CUDA map `num_iterations = 0` gives the JAX result without a
    launch of the loop kernel (which takes at least one iteration)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA map's path)")
    _, poses, _, tgrid, depths = setup
    cg = type(tgrid)(*(a.cuda() for a in tgrid))
    R0, t0 = _perturbed(*poses[4])
    tcfg = TrackerConfig(num_iterations=0)
    rj = _jax_track(setup, depths[4], R0, t0, tcfg)
    gt.reset_launch_count()
    res = ttr.track_frame(cg, torch.from_numpy(depths[4]).cuda(), K,
                          torch.from_numpy(R0).cuda(),
                          torch.from_numpy(t0).cuda(), GCFG, FCFG, tcfg)
    assert gt.loop_launch_count == gt.launch_count == gt.step_launch_count == 0
    assert (res.converged, res.num_iters, res.energy, res.num_valid) == (
        bool(rj.converged), int(rj.num_iters), float(rj.energy),
        int(rj.num_valid)) == (False, 0, 0.0, 0)
    np.testing.assert_array_equal(res.R.cpu().numpy(), R0)
    np.testing.assert_array_equal(res.t.cpu().numpy(), t0)
