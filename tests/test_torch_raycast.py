"""Port raycaster (gradient_sdf_tpu_torch/ops/raycast.py and the march of
ops/kernels/raycast_march.py) against the JAX package, and the JAX tests'
own gates on the port.

One grid: the 96x72 single-sphere fixture of tests/test_raycast.py, fused by
the JAX package and carried across with utils/interop, so both renderers
read the same arrays. On the CPU the port's march is the kernel's plain
version; the CUDA kernel is held against it by the `gpu`-marked test
(skipped without a card) and by `chip_smoke.py`.

Tolerances, with their reasons:
  * camera_rays, block_raster_windows: 1e-5 — the same float32 formulas.
  * hit masks, port vs JAX: may differ on at most 0.5% of the hits. The two
    marches probe the same voxels except where a probe lands within
    rounding of a voxel plane (XLA may fuse o + s*d into one multiply-add),
    and except that the JAX loop goes on probing a ray that stepped past
    its window for as long as other rays keep its loop running, while the
    port probes a ray only inside its window. Both touch silhouette rays
    only.
  * depth on common hits: median < 1e-5 m and 99.5% < 1e-4 m; the rest
    (rays that bracketed another voxel pair) under 1.5 voxels, counted in
    the assertion message.
  * normals on common hits with equal depth: 1e-4.
  * IFT gradient vs jax.grad of the same loss: 1e-3 relative.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gradient_sdf_tpu.config import FusionConfig, GridConfig
from gradient_sdf_tpu.data import synth as jsynth
from gradient_sdf_tpu.ops import fusion as jfu
from gradient_sdf_tpu.ops import normals as jnorm
from gradient_sdf_tpu.ops import raycast as jrc
from gradient_sdf_tpu.ops import voxel_grid as jvg
from gradient_sdf_tpu_torch.ops import raycast as trc
from gradient_sdf_tpu_torch.ops import voxel_grid as tvg
from gradient_sdf_tpu_torch.ops.kernels import raycast_march as rm
from gradient_sdf_tpu_torch.utils import interop

W, H = 96, 72
K = np.array([[79.0, 0, 47.5], [0, 79.0, 35.5], [0, 0, 1]], dtype=np.float32)
GCFG = GridConfig(voxel_size=0.02, num_blocks=4096)
FCFG = FusionConfig(trunc_voxels=5.0)
VS = GCFG.voxel_size
RANGE = dict(s_min=0.3, s_max=2.5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain march is ~20k operations on a few thousand rays per render:
    torch's thread pool gains nothing on them and, when several test
    processes share the cores, costs a barrier per operation."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def fused():
    """(world, poses, JAX grid, port grid): six frames fused by the JAX
    package, the port's grid built from the same arrays."""
    world = jsynth.SphereWorld(
        centers=jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32),
        radii=jnp.asarray([0.3], jnp.float32),
    )
    cache = jnorm.build_cache(W, H, K, window=5)
    poses = jsynth.orbit_poses(n=12, radius=1.2)
    jg = jvg.create(GCFG)
    for R, t in poses[:6]:
        depth = jsynth.render_depth(world, jnp.asarray(R), jnp.asarray(t), K, W, H)
        jg = jfu.fuse_frame(jg, depth, cache, jnp.asarray(R), jnp.asarray(t),
                            GCFG, FCFG)
    tg = interop.grid_from_numpy({k: np.asarray(v) for k, v in jg._asdict().items()})
    return world, poses, jg, tg


def _jrender(jg, R, t, **kw):
    if kw.get("depth_prior") is not None:
        kw["depth_prior"] = jnp.asarray(kw["depth_prior"])
    d, n, h = jrc.render_depth_normal(jg, jnp.asarray(K), jnp.asarray(R),
                                      jnp.asarray(t), W, H, GCFG, FCFG,
                                      **RANGE, **kw)
    return np.asarray(d), np.asarray(n), np.asarray(h)


def _trender(tg, R, t, **kw):
    if kw.get("depth_prior") is not None:
        kw["depth_prior"] = torch.as_tensor(np.asarray(kw["depth_prior"]))
    d, n, h = trc.render_depth_normal(tg, K, R, t, W, H, GCFG, FCFG, **RANGE, **kw)
    return d.numpy(), n.numpy(), h.numpy()


def _assert_same_render(got, want, what):
    (dt, nt, ht), (dj, nj, hj) = got, want
    n_hit = max(int(hj.sum()), 1)
    assert n_hit > 500, what
    flipped = int((ht ^ hj).sum())
    assert flipped <= 0.005 * n_hit, f"{what}: {flipped} of {n_hit} hits differ"
    both = ht & hj
    err = np.abs(dt[both] - dj[both])
    rest = int((err >= 1e-4).sum())
    assert np.median(err) < 1e-5, what
    assert np.quantile(err, 0.995) < 1e-4, f"{what}: {rest} rays beyond 1e-4 m"
    assert err.max() < 1.5 * VS, f"{what}: max {err.max()} m, {rest} beyond 1e-4 m"
    same = both & (np.abs(dt - dj) < 1e-4)
    np.testing.assert_allclose(nt[same], nj[same], atol=1e-4, err_msg=what)
    assert not dt[~ht].any() and not nt[~ht].any()


# ---------------------------------------------------------------------------
# port vs JAX
# ---------------------------------------------------------------------------


def test_camera_rays_match_jax(fused):
    _, poses, _, _ = fused
    R, t = poses[3]
    got = trc.camera_rays(K, R, t, W, H)
    want = jrc.camera_rays(jnp.asarray(K), jnp.asarray(R), jnp.asarray(t), W, H)
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("pose,tile", [(2, 16), (3, 4), (5, 4)])
def test_block_raster_windows_match_jax(fused, pose, tile):
    """At this image size the default 16-pixel tiles make every block wide
    (the global range); 4-pixel tiles with a span of up to 16 leave covered
    and empty tiles."""
    _, poses, jg, tg = fused
    R, t = poses[pose]
    kw = dict(tile=tile, max_span=4 if tile == 16 else 16)
    lo_t, hi_t = trc.block_raster_windows(tg, K, R, t, W, H, GCFG, **kw)
    lo_j, hi_j = jrc.block_raster_windows(jg, jnp.asarray(K), jnp.asarray(R),
                                          jnp.asarray(t), W, H, GCFG, **kw)
    for a, b in ((lo_t, lo_j), (hi_t, hi_j)):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        fin = np.isfinite(b)
        assert fin.any() and (tile == 16 or not fin.all())
        np.testing.assert_allclose(a[fin], b[fin], atol=1e-5)


def test_block_raster_windows_escapes_match_jax(fused):
    """A camera inside the band (blocks straddle its plane: the global
    range) and a cap below the active count (full-range windows, never a
    silent truncation)."""
    _, poses, jg, tg = fused
    R = poses[2][0]
    t = np.array([0.0, 0.0, 0.33], np.float32)
    lo_t, hi_t = trc.block_raster_windows(tg, K, R, t, W, H, GCFG)
    lo_j, hi_j = jrc.block_raster_windows(jg, jnp.asarray(K), jnp.asarray(R),
                                          jnp.asarray(t), W, H, GCFG)
    assert np.isfinite(lo_t.numpy()).all()
    np.testing.assert_allclose(lo_t.numpy(), np.asarray(lo_j), atol=1e-5)
    np.testing.assert_allclose(hi_t.numpy(), np.asarray(hi_j), atol=1e-5)
    assert int(tg.num_active) > 8
    lo, hi = trc.block_raster_windows(tg, K, *poses[2], W, H, GCFG, active_cap=8)
    assert bool((lo == 0).all()) and bool(torch.isinf(hi).all())
    lo_j, hi_j = jrc.block_raster_windows(
        jg, jnp.asarray(K), jnp.asarray(poses[2][0]), jnp.asarray(poses[2][1]),
        W, H, GCFG, active_cap=8)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(hi_j))


def test_neighborhood_minmax_matches_jax():
    rng = np.random.default_rng(21)
    img = rng.uniform(0.5, 2.0, (18, 24)).astype(np.float32)
    mask = rng.random((18, 24)) < 0.4
    mask[:4, :5] = False
    got = trc._neighborhood_minmax(torch.from_numpy(img), torch.from_numpy(mask))
    want = jrc._neighborhood_minmax(jnp.asarray(img), jnp.asarray(mask))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("refine", [True, False])
def test_raycast_matches_jax(fused, refine):
    _, poses, jg, tg = fused
    R, t = poses[4]
    oj, dj, _ = jrc.camera_rays(jnp.asarray(K), jnp.asarray(R), jnp.asarray(t), W, H)
    rj = jrc.raycast(jg, oj, dj, GCFG, FCFG, refine=refine, **RANGE)
    ot, dt, _ = trc.camera_rays(K, R, t, W, H)
    rt = trc.raycast(tg, ot, dt, GCFG, FCFG, refine=refine, **RANGE)
    shape = (H, W)
    got = (rt.depth.numpy().reshape(shape), rt.normal.numpy().reshape(shape + (3,)),
           rt.hit.numpy().reshape(shape))
    want = (np.asarray(rj.depth).reshape(shape),
            np.asarray(rj.normal).reshape(shape + (3,)),
            np.asarray(rj.hit).reshape(shape))
    _assert_same_render(got, want, f"raycast refine={refine}")
    same = (got[2] & want[2] & (np.abs(got[0] - want[0]) < 1e-4)).reshape(-1)
    np.testing.assert_allclose(rt.points.numpy()[same], np.asarray(rj.points)[same],
                               atol=1e-4)


MODES = {
    "stride4": dict(),
    "stride0": dict(prior_stride=0),
    "stride8": dict(prior_stride=8),
    "raster": dict(prior_mode="raster"),
    "march_all_miss": dict(prior_miss_skip=False),
    "few_steps": dict(prior_stride=0, max_steps=24, bisect_steps=0),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_render_depth_normal_matches_jax(fused, mode):
    _, poses, jg, tg = fused
    R, t = poses[3]
    _assert_same_render(_trender(tg, R, t, **MODES[mode]),
                        _jrender(jg, R, t, **MODES[mode]), mode)


PRIOR_MODES = {
    "march_holes": dict(),
    "skip_holes": dict(depth_prior_holes="skip"),
    "tight_margin": dict(depth_prior_holes="skip", prior_margin_voxels=4.0),
}


@pytest.mark.parametrize("mode", sorted(PRIOR_MODES))
def test_render_with_depth_prior_matches_jax(fused, mode):
    """The depth prior is the JAX package's unwindowed render, perturbed by
    up to 2 voxels (from a seed), handed to both."""
    _, poses, jg, tg = fused
    R, t = poses[3]
    d0, _, h0 = _jrender(jg, R, t, prior_stride=0)
    noise = np.random.default_rng(7).uniform(-2.0, 2.0, (H, W)).astype(np.float32)
    prior = np.where(h0, d0 + noise * VS, 0.0).astype(np.float32)
    kw = dict(depth_prior=prior, **PRIOR_MODES[mode])
    _assert_same_render(_trender(tg, R, t, **kw), _jrender(jg, R, t, **kw), mode)


def test_depth_gradient_matches_jax_grad(fused):
    """d(mean interior depth)/d(translation) through the IFT polish: the
    port's autograd against jax.grad of the same loss on the same grid."""
    import scipy.ndimage as ndi

    _, poses, jg, tg = fused
    R, t = poses[2]
    _, _, hit0 = _jrender(jg, R, t, prior_stride=0)
    sel = ndi.binary_erosion(hit0, iterations=4)
    n_sel = float(sel.sum())
    assert n_sel > 300

    def jloss(tj):
        d, _, _ = jrc.render_depth_normal(jg, jnp.asarray(K), jnp.asarray(R), tj,
                                          W, H, GCFG, FCFG, prior_stride=0, **RANGE)
        return jnp.sum(jnp.where(jnp.asarray(sel), d, 0.0)) / n_sel

    gj = np.asarray(jax.grad(jloss)(jnp.asarray(t)))
    tt = torch.tensor(t, requires_grad=True)
    d, _, _ = trc.render_depth_normal(tg, K, torch.from_numpy(R), tt, W, H, GCFG,
                                      FCFG, prior_stride=0, **RANGE)
    loss = torch.sum(torch.where(torch.from_numpy(sel), d, 0.0)) / n_sel
    loss.backward()
    gt = tt.grad.numpy()
    assert np.isfinite(gt).all()
    assert abs(float(loss) - float(jloss(jnp.asarray(t)))) < 1e-5
    np.testing.assert_allclose(gt, gj, rtol=1e-3, atol=1e-3 * np.abs(gj).max())


# ---------------------------------------------------------------------------
# the JAX tests' own gates (tests/test_raycast.py), on the port
# ---------------------------------------------------------------------------


def test_rendered_depth_matches_analytic(fused):
    world, poses, _, tg = fused
    R, t = poses[2]
    depth_gt = np.asarray(jsynth.render_depth(world, jnp.asarray(R), jnp.asarray(t),
                                              K, W, H))
    depth, normal, hit = _trender(tg, R, t)
    gt_hit = depth_gt > 0
    # most GT-hit pixels are hit by the raycaster (band edges may differ)
    overlap = hit & gt_hit
    assert overlap.sum() > 0.7 * gt_hit.sum()
    err = np.abs(depth[overlap] - depth_gt[overlap])
    assert np.median(err) < VS  # depth within one voxel
    # normals near the analytic outward normals at the hit points
    o, d, _ = trc.camera_rays(K, R, t, W, H)
    res = trc.raycast(tg, o, d, GCFG, FCFG, **RANGE)
    hitf = res.hit.numpy()
    p = res.points.numpy()[hitf]
    n_true = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-12)
    cos = np.sum(res.normal.numpy()[hitf] * n_true, axis=-1)
    assert np.median(cos) > 0.97


def test_raycast_misses_empty_space(fused):
    _, _, _, tg = fused
    res = trc.raycast(tg, torch.tensor([[5.0, 5.0, 5.0]]),
                      torch.tensor([[1.0, 0.0, 0.0]]), GCFG, FCFG, s_max=2.0)
    assert not bool(res.hit[0])
    assert float(res.depth[0]) == 0.0


def test_prior_pass_matches_full_march(fused):
    """The low-res prior pass only narrows march windows; the image must
    match the unwindowed march (tiny edge tolerance)."""
    _, poses, _, tg = fused
    R, t = poses[3]
    d0, _, h0 = _trender(tg, R, t, prior_stride=0)
    d1, _, h1 = _trender(tg, R, t, prior_stride=8)
    both = h0 & h1
    assert (h0 ^ h1).sum() <= 0.02 * max(both.sum(), 1)
    err = np.abs(d1[both] - d0[both])
    assert np.quantile(err, 0.995) < 1.5 * VS
    assert err.max() < 10 * VS


def test_depth_gradient_matches_finite_differences(fused):
    """IFT depth differentiability: d(mean interior depth)/d(translation)
    agrees with central finite differences at a voxel-scale step, in
    direction (cos) and magnitude ratio (the per-pixel depth is only
    piecewise smooth)."""
    import scipy.ndimage as ndi

    _, poses, _, tg = fused
    R, t = poses[2]
    _, _, hit0 = _trender(tg, R, t, prior_stride=0)
    sel = torch.from_numpy(ndi.binary_erosion(hit0, iterations=4))
    n_sel = float(sel.sum())
    assert n_sel > 300

    def mean_depth(tt):
        d, _, _ = trc.render_depth_normal(tg, K, torch.from_numpy(R), tt, W, H,
                                          GCFG, FCFG, prior_stride=0, **RANGE)
        return torch.sum(torch.where(sel, d, 0.0)) / n_sel

    tt = torch.tensor(t, requires_grad=True)
    mean_depth(tt).backward()
    g = tt.grad.numpy()
    assert np.all(np.isfinite(g))
    eps = 3e-3
    fd = np.zeros(3)
    for a in range(3):
        step = np.zeros(3, np.float32)
        step[a] = eps
        with torch.no_grad():
            fd[a] = (float(mean_depth(torch.tensor(t + step)))
                     - float(mean_depth(torch.tensor(t - step)))) / (2 * eps)
    cos = np.dot(g, fd) / (np.linalg.norm(g) * np.linalg.norm(fd))
    ratio = np.linalg.norm(g) / np.linalg.norm(fd)
    assert cos > 0.97, f"gradient direction off: cos={cos:.3f}"
    assert 0.7 < ratio < 1.4, f"gradient magnitude off: ratio={ratio:.3f}"


def test_depth_prior_render_matches_full(fused):
    _, poses, _, tg = fused
    R, t = poses[3]
    d0, _, h0 = _trender(tg, R, t, prior_stride=0)
    d1, _, h1 = _trender(tg, R, t, depth_prior=d0)
    both = h0 & h1
    assert both.sum() > 0.95 * h0.sum()
    err = np.abs(d1[both] - d0[both])
    assert np.quantile(err, 0.995) < 1.5 * VS


def test_prior_miss_skip_only_drops_subcell_geometry(fused):
    _, poses, _, tg = fused
    R, t = poses[2]
    _, _, h_march = _trender(tg, R, t, prior_stride=4, prior_miss_skip=False)
    _, _, h_skip = _trender(tg, R, t, prior_stride=4, prior_miss_skip=True)
    assert not np.any(h_skip & ~h_march)          # no new hits
    lost = (h_march & ~h_skip).sum()
    assert lost <= 0.02 * max(h_march.sum(), 1)   # only silhouette tails


def test_depth_prior_hole_skip(fused):
    _, poses, _, tg = fused
    R, t = poses[3]
    d0, _, h0 = _trender(tg, R, t, prior_stride=0)
    d1, _, h1 = _trender(tg, R, t, depth_prior=d0, depth_prior_holes="skip")
    assert not np.any(h1 & ~h0)       # holes stay misses
    both = h0 & h1
    assert both.sum() > 0.95 * h0.sum()
    err = np.abs(d1[both] - d0[both])
    assert np.quantile(err, 0.995) < 1.5 * VS


def test_depth_prior_tight_margin(fused):
    _, poses, _, tg = fused
    R, t = poses[3]
    d0, _, h0 = _trender(tg, R, t, prior_stride=0)
    noise = np.random.default_rng(7).uniform(-2.0, 2.0, (H, W)).astype(np.float32)
    d_prior = np.where(h0, d0 + noise * VS, 0.0).astype(np.float32)
    d1, _, h1 = _trender(tg, R, t, depth_prior=d_prior, depth_prior_holes="skip",
                         prior_margin_voxels=4.0)
    assert not np.any(h1 & ~h0)
    both = h0 & h1
    assert both.sum() > 0.93 * h0.sum()
    err = np.abs(d1[both] - d0[both])
    assert np.quantile(err, 0.99) < 1.5 * VS


def test_raster_prior_matches_full_march(fused):
    _, poses, _, tg = fused
    R, t = poses[3]
    d0, _, h0 = _trender(tg, R, t, prior_stride=0)
    d1, _, h1 = _trender(tg, R, t, prior_mode="raster")
    assert not (h0 & ~h1).any()       # exact culling: no hit may be lost
    assert (h1 & ~h0).sum() <= 0.005 * max(h0.sum(), 1)
    both = h0 & h1
    err = np.abs(d1[both] - d0[both])
    assert np.quantile(err, 0.995) < 1.5 * VS
    assert err.max() < 10 * VS
    # window soundness directly: every hit depth lies inside its window
    s_lo, s_hi = trc.block_raster_windows(tg, K, R, t, W, H, GCFG)
    ray_s = d0.reshape(-1) / trc.camera_rays(K, R, t, W, H)[2].numpy()
    hit_flat = h0.reshape(-1)
    sv = ray_s[hit_flat]
    assert (sv >= s_lo.numpy()[hit_flat] - 1e-4).all()
    assert (sv <= s_hi.numpy()[hit_flat] + 1e-4).all()


@pytest.mark.parametrize("divs", [(), (64,), (2,), (4096,), (16, 256)])
def test_straggler_schedule_keywords_change_nothing(fused, divs):
    """`compact_divisors` and `burst_steps` pick buffer sizes in the JAX
    package and nothing here: every setting gives the bits of the default."""
    _, poses, _, tg = fused
    o, d, _ = trc.camera_rays(K, *poses[4], W, H)
    base = trc.raycast(tg, o, d, GCFG, FCFG, **RANGE)
    res = trc.raycast(tg, o, d, GCFG, FCFG, compact_divisors=divs,
                      burst_steps=5, **RANGE)
    assert torch.equal(res.hit, base.hit) and torch.equal(res.depth, base.depth)
    assert int(base.hit.sum()) > 500


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------


def test_occlusion_zcap_raises(fused):
    _, poses, _, tg = fused
    R, t = poses[2]
    with pytest.raises(ValueError, match="occlusion_zcap"):
        trc.block_raster_windows(tg, K, R, t, W, H, GCFG, occlusion_zcap=True)
    with pytest.raises(ValueError, match="occlusion_zcap"):
        trc.render_depth_normal(tg, K, R, t, W, H, GCFG, FCFG,
                                prior_occlusion_zcap=True)


def _march_args(tg, poses, pose=4):
    o, d, _ = trc.camera_rays(K, *poses[pose], W, H)
    return (o.contiguous(), d.contiguous(), tg.directory, tg.coarse_occ, tg.dist,
            tg.weight)


def test_march_probes_a_ray_only_inside_its_window(fused):
    """Empty windows (s0 > s_end) are never probed; the step budget bounds
    every ray's probes; a found ray pays its bisection probes on top."""
    _, poses, _, tg = fused
    o, d, *grid = _march_args(tg, poses)
    n = o.shape[0]
    s0 = torch.full((n,), 0.3)
    s_end = torch.full((n,), 2.5)
    s0[::2], s_end[::2] = 2.5, 0.3 - 1.0
    res = rm.raycast_march(o, d, s0, s_end, *grid, GCFG, FCFG, max_steps=40,
                           bisect_steps=2, stats=True)
    probes, sectors = res.stats[:, 0], res.stats[:, 1]
    assert not res.found[::2].any() and not probes[::2].any()
    assert not res.s_star[::2].any() and not res.s_mid[::2].any()
    assert int(res.found.sum()) > 200
    assert int(probes[~res.found].max()) <= 40
    assert int(probes[res.found].max()) <= 42 and int(probes[res.found].min()) >= 3
    # one to three 32-byte sectors per probe: directory, then coarse_occ or
    # dist + weight
    assert bool((sectors <= 3 * probes).all())
    assert bool((sectors[probes > 0] >= probes[probes > 0]).all())
    # the distinct sectors among them: one mark each, far fewer than gathers
    offs = rm.sector_offsets(GCFG, grid[2].shape[0])
    assert res.touched.shape == (offs[-1],) and res.touched.dtype == torch.uint8
    per_array = [int(res.touched[a:b].sum()) for a, b in zip(offs, offs[1:])]
    assert all(c > 0 for c in per_array) and per_array[2] == per_array[3]
    assert sum(per_array) < int(sectors.sum()) // 4
    full = rm.raycast_march(o, d, torch.full((n,), 0.3), s_end.fill_(2.5), *grid,
                            GCFG, FCFG, max_steps=40, bisect_steps=2)
    assert full.stats is None and full.touched is None
    assert torch.equal(full.found[1::2], res.found[1::2])
    assert torch.equal(full.s_star[1::2], res.s_star[1::2])


def test_march_rejects_what_the_kernel_does_not_take(fused):
    _, poses, _, tg = fused
    o, d, *grid = _march_args(tg, poses)
    s = torch.full((o.shape[0],), 0.3)
    with pytest.raises(ValueError, match="dirs"):
        rm.raycast_march(o, d.double(), s, s, *grid, GCFG, FCFG)
    with pytest.raises(ValueError, match="origins"):
        rm.raycast_march(o.T.contiguous().T, d, s, s, *grid, GCFG, FCFG)
    with pytest.raises(ValueError, match="s_end"):
        rm.raycast_march(o, d, s, s[:-1], *grid, GCFG, FCFG)
    with pytest.raises(ValueError, match="directory"):
        rm.raycast_march(o, d, s, s, grid[0][:-1], *grid[1:], GCFG, FCFG)
    # the kernel's int32 keys and voxel indices: a directory of 1291^3 cells
    # or 2^22 blocks of 512 voxels is refused before any array is read;
    # MAX_DIR_DIM's 512^3 passes that check (and meets the shape check)
    for dim, match in ((1291, "int32"), (tvg.MAX_DIR_DIM, "directory")):
        big = GridConfig(voxel_size=VS, num_blocks=GCFG.num_blocks, dir_dim=dim)
        with pytest.raises(ValueError, match=match):
            rm.raycast_march(o, d, s, s, *grid, big, FCFG)
    many = torch.zeros(1, GCFG.voxels_per_block).expand(2**22, -1)
    with pytest.raises(ValueError, match="int32"):
        rm.raycast_march(o, d, s, s, *grid[:2], many, many, GCFG, FCFG)
    # tiles need the rays to be a whole image
    with pytest.raises(ValueError, match="width"):
        rm.raycast_march(o, d, s, s, *grid, GCFG, FCFG, width=W + 1)


def test_render_on_a_map_and_on_the_base_sdf_map(fused):
    """`render_depth_normal` on a `GradSdfMap.grid` and on a `PixelSdfMap`
    that fused the same frames (no stored gradient: same hits, zero
    normals; the depth is the secant's, which the gradient map's
    straight-through form s + s_ift - s_ift rounds by an ulp or two)."""
    from gradient_sdf_tpu_torch import config as tcfg_mod
    from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap
    from gradient_sdf_tpu_torch.models.pixel_sdf import PixelSdfMap

    world, poses, _, _ = fused
    cfg = tcfg_mod.PipelineConfig(grid=GCFG, fusion=tcfg_mod.FusionConfig(
        trunc_voxels=5.0, normal_window=5))
    gm, pm = GradSdfMap(cfg, device="cpu"), PixelSdfMap(cfg, device="cpu")
    for R, t in poses[:3]:
        depth = np.array(jsynth.render_depth(world, jnp.asarray(R), jnp.asarray(t),
                                               K, W, H))
        gm.update(depth, K, (R, t))
        pm.update(depth, K, (R, t))
    R, t = poses[1]
    dg, ng, hg = trc.render_depth_normal(gm.grid, K, R, t, W, H, gm.cfg.grid,
                                         gm.cfg.fusion, **RANGE)
    dp, npx, hp = trc.render_depth_normal(pm.grid, K, R, t, W, H, pm.cfg.grid,
                                          pm.cfg.fusion, **RANGE)
    assert int(hg.sum()) > 500
    assert torch.equal(hg, hp)
    np.testing.assert_allclose(dg.numpy(), dp.numpy(), atol=1e-6)
    assert float(ng[hg].norm(dim=-1).median()) > 0.99 and not npx.any()


@pytest.mark.gpu
def test_cuda_march_kernel_matches_reference_bit_for_bit(fused):
    """Both instances of the kernel (counting and plain), with the rays in
    their order and in pixel tiles, unwindowed and in raster windows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    _, poses, _, tg = fused
    args = [a.cuda() for a in _march_args(tg, poses)]
    n = args[0].shape[0]
    lo, hi = trc.block_raster_windows(tg, K, *poses[4], W, H, GCFG)
    windows = {"unwindowed": (torch.full((n,), 0.3), torch.full((n,), 2.5)),
               "raster": (lo.clamp(min=0.3), hi.clamp(max=2.5))}
    rm.reset_launch_count()
    for name, (s0, s_end) in windows.items():
        s0, s_end = s0.cuda().contiguous(), s_end.cuda().contiguous()
        call = (*args[:2], s0, s_end, *args[2:], GCFG, FCFG)
        want = rm.raycast_march_reference(*call, stats=True)
        for width in (None, W):
            got = rm.raycast_march(*call, stats=True, width=width)
            fast = rm.raycast_march(*call, width=width)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert torch.equal(a, b), (name, width)
            for a, b in zip(fast[:3], want[:3]):
                assert torch.equal(a, b), (name, width)
            assert fast.stats is None and int(got.found.sum()) > 500
    assert rm.launch_count == 8


@pytest.mark.gpu
@pytest.mark.parametrize("b", [4, 6, 16])
def test_cuda_march_at_other_block_shapes_matches_reference(fused, b):
    """The shift-and-mask instances for 4 and 16 and the runtime-divisor
    instance (6) on a grid the port fuses on the CPU, both orders."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from gradient_sdf_tpu_torch.ops import fusion, normals

    world, poses, _, _ = fused
    gcfg = GridConfig(voxel_size=VS, block_shape=b, num_blocks=4096 * 512 // b**3,
                      dir_dim=256)
    cache = normals.build_cache(W, H, K, FCFG.normal_window, "cpu")
    g = tvg.create(gcfg, "cpu")
    for R, t in poses[:4]:
        depth = torch.from_numpy(np.array(jsynth.render_depth(
            world, jnp.asarray(R), jnp.asarray(t), K, W, H)))
        g = fusion.fuse_frame(g, depth, cache, torch.as_tensor(R), torch.as_tensor(t),
                              gcfg, FCFG)
    o, d, _ = trc.camera_rays(K, *poses[3], W, H)
    n = o.shape[0]
    call = [a.cuda().contiguous() for a in (o, d, torch.full((n,), 0.3),
                                            torch.full((n,), 2.5), g.directory,
                                            g.coarse_occ, g.dist, g.weight)]
    want = rm.raycast_march_reference(*call, gcfg, FCFG, stats=True)
    for width in (None, W):
        got = rm.raycast_march(*call, gcfg, FCFG, stats=True, width=width)
        torch.cuda.synchronize()
        for a, c in zip(got, want):
            assert torch.equal(a, c), width
    assert int(want.found.sum()) > 500


@pytest.mark.gpu
def test_cuda_render_goes_through_the_kernel(fused):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    _, poses, _, tg = fused
    R, t = poses[3]
    cg = tvg.VoxelGrid(*(a.cuda() for a in tg))
    rm.reset_launch_count()
    d, n, h = trc.render_depth_normal(cg, K, R, t, W, H, GCFG, FCFG, **RANGE)
    assert rm.launch_count == 2    # the prior pass and the full-res pass
    dc, nc, hc = trc.render_depth_normal(tg, K, R, t, W, H, GCFG, FCFG, **RANGE)
    assert torch.equal(h.cpu(), hc)
    np.testing.assert_allclose(d.cpu().numpy(), dc.numpy(), atol=1e-6)
