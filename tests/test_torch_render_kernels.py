"""The renderer's window and finish passes (ops/kernels/render_windows.py,
prior_windows.py, ray_finish.py): their plain versions against the JAX
package on the CPU, and the CUDA kernels (csrc/render_windows.cu,
prior_windows.cu, ray_finish.cu) against the plain versions on a card.

The grid is the 96x72 single-sphere fixture of tests/test_torch_raycast.py
(six frames fused by the JAX package, carried across with utils/interop);
the prior windows' inputs are made from a numpy seed. Tolerances, with
their reasons:
  * windows, tiles, depth, points and normals against the JAX package:
    1e-5, the gates of test_torch_raycast.py (the same float32 formulas;
    XLA may fuse a multiply-add where PyTorch rounds twice);
  * hit masks: exact (the same march on this fixture's rays: its hits agree
    with the JAX render's ray for ray without a prior);
  * the finish's backward against the plain autograd (`RayFinish` over
    `finish_values`, the kernel's arithmetic in PyTorch): 1e-5 of each
    gradient's largest entry (the same terms, summed in another order),
    where the plain autograd is finite (`_assert_same_grads`).
On a card (`gpu` marker; skipped here), with the kernel built from this
checkout: tiles and windows bit for bit; the finish's depth, points and
camera-z depth within 2e-7 relative (an ulp: the plain version sums G . d
and |G|^2 in an order PyTorch picks; points relative to the largest depth,
as a point o + s d near the origin is a difference of larger numbers) and
normals within 1e-6, hit masks
exact; its backward within 1e-5 of the plain autograd's largest entry; a
render in every mode with no `nonzero` and no host sync.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradient_sdf_tpu.ops import query as jquery
from gradient_sdf_tpu.ops import raycast as jrc
from gradient_sdf_tpu_torch.ops import raycast as trc
from gradient_sdf_tpu_torch.ops import voxel_grid as tvg
from gradient_sdf_tpu_torch.ops.kernels import prior_windows as pw
from gradient_sdf_tpu_torch.ops.kernels import ray_finish as rf
from gradient_sdf_tpu_torch.ops.kernels import raycast_march as rm
from gradient_sdf_tpu_torch.ops.kernels import render_windows as rw
from test_torch_raycast import (FCFG, GCFG, RANGE, VS, H, K, W, _jrender,  # noqa: F401
                                fused, one_torch_thread)

S_MIN, S_MAX = RANGE["s_min"], RANGE["s_max"]
TOL = 1e-5
MARGIN = FCFG.trunc_voxels * VS + 2.0 * VS


def _finite_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=what)
    np.testing.assert_array_equal(got[~np.isfinite(want)], want[~np.isfinite(want)],
                                  err_msg=what)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=TOL, err_msg=what)


# ---------------------------------------------------------------------------
# plain versions vs the JAX package (CPU)
# ---------------------------------------------------------------------------

# (pose, tile, max_span, stride, offset, clamped, active_cap, camera in the band)
RASTER_CASES = {
    "full, covered and empty tiles": (3, 4, 16, 1, 0, False, 4096, False),
    "full, clamped": (5, 4, 16, 1, 0, True, 4096, False),
    "strided coarse pixels, clamped": (5, 4, 16, 4, 2, True, 4096, False),
    "strided, 16-pixel tiles (all wide)": (2, 16, 4, 4, 2, True, 4096, False),
    "active_cap escape, strided": (2, 4, 16, 4, 2, True, 8, False),
    "camera inside the band": (2, 16, 4, 1, 0, False, 4096, True),
    "partial tiles at both edges, stride 3 offset 1": (4, 7, 16, 3, 1, False, 4096,
                                                       False),
    "blocks straddle patch edges, camera in the band": (2, 4, 16, 1, 0, False,
                                                        4096, True),
}


@pytest.mark.parametrize("case", sorted(RASTER_CASES))
def test_raster_windows_match_jax(fused, case):
    """`render_windows` (the plain version on the CPU) against the JAX
    package's `block_raster_windows`, taken at the same pixels and clamped
    as its `raycast` clamps, 1e-5; the tile grid against the windows it
    expands to."""
    pose, tile, span, stride, off, clamped, cap, inside = RASTER_CASES[case]
    _, poses, jg, tg = fused
    R, t = poses[pose]
    if inside:
        t = np.array([0.0, 0.0, 0.33], np.float32)
    kw = dict(tile=tile, max_span=span, active_cap=cap)
    clamps = dict(s_min=S_MIN, s_max=S_MAX) if clamped else {}
    lo, hi = rw.render_windows(tg, K, R, t, W, H, GCFG, stride=stride, offset=off,
                               **kw, **clamps)
    # the finished tile grid: one window a tile, unclamped
    tiles, _ = rw.render_windows(tg, K, R, t, W, H, GCFG, stride=tile, offset=0, **kw)
    lo_j, hi_j = jrc.block_raster_windows(jg, jnp.asarray(K), jnp.asarray(R),
                                          jnp.asarray(t), W, H, GCFG, **kw)
    lo_j = np.asarray(lo_j).reshape(H, W)[off::stride, off::stride].reshape(-1)
    hi_j = np.asarray(hi_j).reshape(H, W)[off::stride, off::stride].reshape(-1)
    if clamped:
        lo_j, hi_j = np.maximum(lo_j, S_MIN), np.minimum(hi_j, S_MAX)
    _finite_close(lo.numpy(), lo_j, f"{case}: s_lo")
    _finite_close(hi.numpy(), hi_j, f"{case}: s_hi")
    if cap < int(tg.num_active):
        assert bool((tiles == 0).all())
    elif inside:
        assert bool(torch.isfinite(tiles).all())   # the global range everywhere
    elif not clamped:
        assert 0 < int(torch.isinf(lo).sum()) < lo.numel()
    # the windows are the tiles', pixel by pixel
    wt = -(-W // tile)
    ys, xs = np.meshgrid(np.arange(off, H, stride), np.arange(off, W, stride),
                         indexing="ij")
    k = torch.as_tensor(((ys // tile) * wt + xs // tile).reshape(-1))
    want_lo = tiles[k] if not clamped else tiles[k].clamp(min=S_MIN)
    assert torch.equal(lo, want_lo)


def _jax_prior_windows(ok, mn, mx, skip):
    """JAX :857-877 (the window arithmetic) and `raycast`'s clamps :290-296."""
    if skip:
        lo = jnp.where(ok, jnp.maximum(mn - MARGIN, S_MIN), S_MAX)
        hi = jnp.where(ok, jnp.minimum(mx + MARGIN, S_MAX), S_MIN - 1.0)
    else:
        lo = jnp.where(ok, jnp.maximum(mn - MARGIN, S_MIN), S_MIN)
        hi = jnp.where(ok, jnp.minimum(mx + MARGIN, S_MAX), S_MAX)
    return np.asarray(jnp.maximum(lo, S_MIN)), np.asarray(jnp.minimum(hi, S_MAX))


# coarse images (hc, wc, stride): one inside the kernel's 32 x 8 cell
# rectangle, a width past it at a stride whose rows of four pixels span two
# cells (and a pixel row that is no multiple of 4), and a stride of 8
STRIDE_SHAPES = [(9, 12, 4), (7, 33, 2), (5, 37, 8)]
# (skip, shape), the first shape's cases under their names before the
# other shapes came
STRIDE_CASES = [pytest.param(skip, shape, id=str(skip) if shape == STRIDE_SHAPES[0]
                             else f"{skip}-{'x'.join(map(str, shape))}")
                for shape in STRIDE_SHAPES for skip in (True, False)]


def _coarse_image(hc, wc):
    """A seeded coarse image: hits in 0.5-2 m, a few missing, an all-miss
    corner."""
    rng = np.random.default_rng(18)
    img = rng.uniform(0.5, 2.0, (hc, wc)).astype(np.float32)
    mask = rng.random((hc, wc)) < 0.6
    mask[:3, :4] = False
    return img, mask


@pytest.mark.parametrize("skip,shape", STRIDE_CASES)
def test_stride_windows_match_jax(skip, shape):
    """The stride prior's windows from a seeded coarse image against
    `_neighborhood_minmax` and the window arithmetic of the JAX package,
    repeated over stride x stride pixels; 1e-5."""
    hc, wc, stride = shape
    img, mask = _coarse_image(hc, wc)
    lo, hi = pw.stride_windows(torch.from_numpy(img).reshape(-1),
                               torch.from_numpy(mask).reshape(-1), hc, wc, stride,
                               MARGIN, S_MIN, S_MAX, skip)
    mn, mx, anyhit = jrc._neighborhood_minmax(jnp.asarray(img), jnp.asarray(mask))
    lo_j, hi_j = _jax_prior_windows(anyhit, mn, mx, skip)
    for got, want in ((lo, lo_j), (hi, hi_j)):
        want = np.repeat(np.repeat(want, stride, 0), stride, 1).reshape(-1)
        _finite_close(got.numpy(), want, f"skip={skip}")
    assert bool((lo > hi).any()) == skip


@pytest.mark.parametrize("skip,n", [
    pytest.param(skip, n, id=str(skip) if n == 500 else f"{skip}-{n}")
    for n in (500, 77) for skip in (True, False)])
def test_depth_prior_windows_match_jax(skip, n):
    """A depth prior's windows (seeded camera-z depths with holes, the
    rays' inv_hnorm; 77 rays: a tail past the kernel's rows of four) against
    the JAX package's arithmetic (:803-824); 1e-5."""
    rng = np.random.default_rng(19)
    prior = rng.uniform(0.4, 2.6, n).astype(np.float32)
    prior[rng.random(n) < 0.2] = 0.0
    inv_hnorm = rng.uniform(0.7, 1.0, n).astype(np.float32)
    lo, hi = pw.depth_prior_windows(torch.from_numpy(prior),
                                    torch.from_numpy(inv_hnorm), MARGIN, S_MIN,
                                    S_MAX, skip)
    sp = jnp.asarray(prior) / jnp.asarray(inv_hnorm)
    lo_j, hi_j = _jax_prior_windows(jnp.asarray(prior) > 0, sp, sp, skip)
    _finite_close(lo.numpy(), lo_j, "s_lo")
    _finite_close(hi.numpy(), hi_j, "s_hi")


def _march(tg, pose_R, pose_t):
    o, d, ih = trc.camera_rays(K, pose_R, pose_t, W, H, device=tg.device)
    o = o.contiguous()
    n = o.shape[0]
    f32 = dict(dtype=torch.float32, device=tg.device)
    res = rm.raycast_march(o, d, torch.full((n,), S_MIN, **f32),
                           torch.full((n,), S_MAX, **f32),
                           tg.directory, tg.coarse_occ, tg.dist, tg.weight, GCFG,
                           FCFG)
    return res, o, d, ih


def test_finish_matches_jax(fused):
    """The finish (the plain version on the CPU) on the port's march against
    the JAX package's polish of the same secant points (:479-501, its
    `query.tsdf_grad`) and against its render without prior: hits exact,
    depth, camera-z depth, points and normals 1e-5."""
    _, poses, jg, tg = fused
    R, t = poses[4]
    res, o, d, ih = _march(tg, R, t)
    fin = rf.ray_finish(res.found, res.s_star, o, d, ih, tg, GCFG, FCFG)
    hit = res.found.numpy()
    assert int(hit.sum()) > 500
    # the JAX polish of the same rays
    m = jnp.asarray(res.s_star.numpy())
    oj, dj = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    p = oj + m[:, None] * dj
    phi, g, w = jquery.tsdf_grad(jg, p, GCFG, FCFG)
    denom = jnp.sum(g * dj, axis=-1)
    safe = (w > 0.0) & (denom > 0.0)
    s_ift = m - phi / jnp.maximum(denom, 0.25 * FCFG.grad_scale)
    s_hit = np.asarray(jnp.where(safe, m + s_ift - s_ift, m))
    normal = np.asarray(-g / jnp.maximum(jnp.linalg.norm(g, axis=-1, keepdims=True),
                                         1e-12))
    np.testing.assert_allclose(fin.depth.numpy()[hit], s_hit[hit], atol=TOL)
    np.testing.assert_allclose(fin.normal.numpy()[hit], normal[hit], atol=TOL)
    np.testing.assert_allclose(fin.points.numpy()[hit],
                               np.asarray(oj + s_hit[:, None] * dj)[hit], atol=TOL)
    assert not fin.depth.numpy()[~hit].any() and not fin.normal.numpy()[~hit].any()
    # against the JAX render without prior
    dj_img, nj_img, hj_img = _jrender(jg, R, t, prior_stride=0)
    np.testing.assert_array_equal(hit.reshape(H, W), hj_img)
    np.testing.assert_allclose(fin.zdepth.numpy().reshape(H, W), dj_img, atol=TOL)
    np.testing.assert_allclose(fin.normal.numpy().reshape(H, W, 3), nj_img, atol=TOL)


def _grads(fn, leaves, weights):
    """d(sum of the outputs weighted by `weights`) / d(leaves)."""
    for a in leaves:
        a.grad = None
    outs = fn()
    loss = sum(torch.sum(o * w) for o, w in zip(outs, weights))
    loss.backward()
    return [a.grad.clone() for a in leaves]


def _finish_leaves(tg, R, t):
    """The finish's differentiable inputs as leaves (a pose translation
    expanded into the origins, the directions, inv_hnorm, the four fields)
    and the march's found and s_star."""
    res, o, d, ih = _march(tg, R, t)
    tt = torch.tensor(t, dtype=torch.float32, device=o.device, requires_grad=True)
    d = d.detach().clone().requires_grad_(True)
    ih = ih.detach().clone().requires_grad_(True)
    fields = [getattr(tg, k).detach().clone().requires_grad_(True)
              for k in ("dist", "grad_x", "grad_y", "grad_z")]
    return res, tt, d, ih, fields


def _finish_both(tg, res, tt, d, ih, fields, impl):
    """(plain autograd outputs, RayFinish outputs) as callables."""
    grid = tg._replace(dist=fields[0], grad_x=fields[1], grad_y=fields[2],
                       grad_z=fields[3])
    n = d.shape[0]

    def plain():
        f = rf.ray_finish_reference(res.found, res.s_star, tt.expand(n, 3), d, ih,
                                    grid, GCFG, FCFG)
        return f.depth, f.points, f.normal, f.zdepth

    def kernel():
        depth, pts, normal, zdepth = rf.RayFinish.apply(
            impl, res.found, res.s_star, tt.expand(n, 3).contiguous(), d, ih,
            *fields, grid, GCFG, FCFG, True)
        return depth, pts, normal, zdepth

    return plain, kernel


def _assert_same_grads(got, want, names):
    """The gradients within TOL of each one's largest entry. The plain
    autograd gives NaN to the field entries that a hit on an unobserved
    voxel (zero stored gradient) gathers: sqrt's derivative at 0 (0/0)
    times the clamp's zero mask. `RayFinish` gives those rays no gradient;
    it must be finite everywhere and agree wherever the plain one is."""
    for g, w, name in zip(got, want, names):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        assert np.isfinite(g).all(), name
        fin = np.isfinite(w)
        assert fin.mean() > 0.99, name
        scale = float(np.abs(w[fin]).max())
        assert scale > 0, name
        np.testing.assert_allclose(g[fin], w[fin], atol=TOL * scale, rtol=0,
                                   err_msg=name)


NAMES = ["t", "dirs", "inv_hnorm", "dist", "grad_x", "grad_y", "grad_z"]


def test_finish_backward_matches_plain_autograd(fused):
    """`RayFinish` over `finish_values` (the kernel's arithmetic and saved
    state, in PyTorch) against the plain version's autograd, for random
    weights on depth, points, normals and camera-z depth: the gradients of
    the pose translation, directions, inv_hnorm and the four fields within
    1e-5 of each one's largest entry, the values within 2e-7 relative."""
    _, poses, _, tg = fused
    res, tt, d, ih, fields = _finish_leaves(tg, *poses[4])
    plain, kernel = _finish_both(tg, res, tt, d, ih, fields, rf.finish_values)
    rng = np.random.default_rng(5)
    n = d.shape[0]
    weights = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((n,), (n, 3), (n, 3), (n,))]
    leaves = [tt, d, ih] + fields
    want = _grads(plain, leaves, weights)
    got = _grads(kernel, leaves, weights)
    _assert_same_grads(got, want, NAMES)
    with torch.no_grad():
        for a, b in zip(kernel(), plain()):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-7, atol=0)


def test_wrappers_take_the_plain_version_on_the_cpu_and_raise_elsewhere(fused):
    """On CPU tensors each wrapper is its plain version; a device with no
    kernel raises, and so do shapes the kernels do not take."""
    _, poses, _, tg = fused
    R, t = poses[3]
    a = rw.render_windows(tg, K, R, t, W, H, GCFG, stride=4, offset=2)
    b = rw.render_windows_reference(tg, K, R, t, W, H, GCFG, stride=4, offset=2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    meta = tvg.VoxelGrid(*(x.to("meta") for x in tg))
    with pytest.raises(RuntimeError, match="no kernel"):
        rw.render_windows(meta, K, R, t, W, H, GCFG)
    with pytest.raises(ValueError, match="stride"):
        rw.render_windows(tg, K, R, t, W, H, GCFG, stride=4, offset=4)
    s = torch.ones(12)
    with pytest.raises(RuntimeError, match="no kernel"):
        pw.stride_windows(s.to("meta"), (s > 0).to("meta"), 3, 4, 2, MARGIN,
                          S_MIN, S_MAX, True)
    with pytest.raises(ValueError, match="found"):
        pw.stride_windows(s, s, 3, 4, 2, MARGIN, S_MIN, S_MAX, True)
    with pytest.raises(ValueError, match="inv_hnorm"):
        pw.depth_prior_windows(s, s[:-1], MARGIN, S_MIN, S_MAX, True)
    res, o, d, ih = _march(tg, R, t)
    with pytest.raises(ValueError, match="dirs"):
        rf.ray_finish(res.found, res.s_star, o, d.double(), ih, tg, GCFG, FCFG)
    with pytest.raises(RuntimeError, match="no kernel"):
        rf.ray_finish(res.found.to("meta"), res.s_star.to("meta"), o.to("meta"),
                      d.to("meta"), None, meta, GCFG, FCFG)


@pytest.mark.parametrize("source", ["render_windows.cu", "prior_windows.cu"])
def test_bench_switches_match_the_kernel_source(source):
    """`tools/raycast_bench.py --windows` takes each window kernel apart by
    one-switch builds of a copy of its source: the source is one of the
    designs its table knows, and every switch's anchor is in it exactly
    once."""
    import os

    from gradient_sdf_tpu_torch.ops.kernels import _build
    from gradient_sdf_tpu_torch.tools import raycast_bench

    with open(os.path.join(_build.CSRC, source)) as f:
        text = f.read()
    table = {"render_windows.cu": raycast_bench.RENDER_WINDOWS_SWITCHES,
             "prior_windows.cu": raycast_bench.PRIOR_WINDOWS_SWITCHES}[source]
    designs = [d for d, (mark, _) in table.items() if mark in text]
    assert len(designs) == 1
    for name, edits in table[designs[0]][1].items():
        for old, _ in edits:
            assert text.count(old) == 1, name


# ---------------------------------------------------------------------------
# the kernels against the plain versions (a card)
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(RASTER_CASES))
def test_cuda_render_windows_match_plain_bit_for_bit(fused, case):
    _card()
    pose, tile, span, stride, off, clamped, cap, inside = RASTER_CASES[case]
    _, poses, _, tg = fused
    cg = tvg.VoxelGrid(*(a.cuda() for a in tg))
    R, t = poses[pose]
    if inside:
        t = np.array([0.0, 0.0, 0.33], np.float32)
    kw = dict(tile=tile, max_span=span, active_cap=cap)
    clamps = dict(s_min=S_MIN, s_max=S_MAX) if clamped else {}
    rw.reset_launch_count()
    for form in (dict(stride=stride, offset=off, **clamps), dict(stride=tile)):
        got = rw.render_windows(cg, K, R, t, W, H, GCFG, **kw, **form)
        want = rw.render_windows_reference(cg, K, R, t, W, H, GCFG, **kw, **form)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), (case, form)
    assert rw.launch_count == 2


@pytest.mark.gpu
@pytest.mark.parametrize("width,height,span", [(1920, 1080, 4), (1920, 1080, 64),
                                               (3840, 2160, 160)])
def test_cuda_render_windows_at_large_images_match_plain_bit_for_bit(
        fused, width, height, span):
    """Images past VGA with the fixture's camera scaled to them: 1920x1080
    (8160 tiles) and 3840x2160 (32400; the kernel's patches grow with the
    image, 16 x 8 and 32 x 16 tiles); the render's own span of 4 (nearly
    every block wide) and spans that rasterize every block into its tiles
    (64 tiles at 1920, 160 at 3840: the same 64 of the fixture's pixels),
    leaving tiles no block covers. Windows and tile grid bit for bit; a call
    is one CUDA launch at every size."""
    _card()
    from torch.profiler import ProfilerActivity, profile

    _, poses, _, tg = fused
    cg = tvg.VoxelGrid(*(a.cuda() for a in tg))
    R, t = poses[3]
    k = np.array(K, np.float64)
    k[0, 0] *= width / W
    k[1, 1] *= width / W
    k[0, 2], k[1, 2] = 0.5 * (width - 1), 0.5 * (height - 1)
    rw.render_windows(cg, k, R, t, width, height, GCFG, max_span=span)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rw.render_windows(cg, k, R, t, width, height, GCFG, max_span=span)
        torch.cuda.synchronize()
    assert sum(e.count for e in prof.key_averages()
               if e.key.startswith("cudaLaunchKernel")) == 1
    for form in (dict(), dict(stride=16), dict(stride=4, offset=2, s_min=S_MIN,
                                               s_max=S_MAX)):
        got = rw.render_windows(cg, k, R, t, width, height, GCFG, max_span=span,
                                **form)
        want = rw.render_windows_reference(cg, k, R, t, width, height, GCFG,
                                           max_span=span, **form)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), form
    if span > 4:
        assert 0 < int(torch.isfinite(want[0]).sum()) < want[0].numel()


@pytest.mark.gpu
@pytest.mark.parametrize("skip,shape", STRIDE_CASES)
def test_cuda_prior_windows_match_plain_bit_for_bit(fused, skip, shape):
    """Both modes bit for bit: the stride prior on the seeded coarse image
    of `shape` and on the fixture's render; the depth prior on that render,
    on all but its last 3 rays (a tail past the rows of four) and from its
    second ray on (pointers off 16 bytes: the scalar loads)."""
    _card()
    _, poses, _, tg = fused
    cg = tvg.VoxelGrid(*(a.cuda() for a in tg))
    R, t = poses[3]
    depth, _, hit = trc.render_depth_normal(cg, K, R, t, W, H, GCFG, FCFG, **RANGE)
    o, d, ih = trc.camera_rays(K, R, t, W, H, device="cuda")
    img = depth[2::4, 2::4] / ih.reshape(H, W)[2::4, 2::4]
    args = (img.reshape(-1).contiguous(), hit[2::4, 2::4].reshape(-1).contiguous(),
            H // 4, W // 4, 4, MARGIN, S_MIN, S_MAX, skip)
    hc, wc, stride = shape
    img_s, mask_s = (torch.from_numpy(a).reshape(-1).cuda() for a in _coarse_image(hc, wc))
    seeded = (img_s, mask_s, hc, wc, stride, MARGIN, S_MIN, S_MAX, skip)
    dp = depth.reshape(-1)
    pw.reset_launch_count()
    calls = [(pw.stride_windows, pw.stride_windows_reference, a) for a in (args, seeded)]
    calls += [(pw.depth_prior_windows, pw.depth_prior_windows_reference,
               (p, i, 4 * VS, S_MIN, S_MAX, skip))
              for p, i in ((dp, ih), (dp[:-3], ih[:-3]), (dp[1:], ih[1:]))]
    for kern, ref, a in calls:
        got, want = kern(*a), ref(*a)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), a[2:]
    assert pw.launch_count == len(calls)


@pytest.mark.gpu
def test_cuda_finish_matches_plain_forward_and_backward(fused):
    _card()
    _, poses, _, tg = fused
    cg = tvg.VoxelGrid(*(a.cuda() for a in tg))
    res, tt, d, ih, fields = _finish_leaves(cg, *poses[4])
    plain, kernel = _finish_both(cg, res, tt, d, ih, fields, rf._launch)
    rf.reset_launch_count()
    with torch.no_grad():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
    hit = res.found
    for a, b, name in zip(got, want, ("depth", "points", "normal", "zdepth")):
        # depth-like outputs: an ulp of each entry; points: an ulp of the
        # largest depth (o + s d near the origin is a difference of larger
        # numbers, which an ulp of s moves by an ulp of s)
        if name == "normal":
            assert float((a - b).abs().max()) <= 1e-6, name
        elif name == "points":
            assert float((a - b).abs().max()) <= 2e-7 * float(want[0].abs().max()), name
        else:
            assert bool(((a - b).abs() <= 2e-7 * b.abs()).all()), name
    assert torch.equal(got[0] != 0, want[0] != 0) and int(hit.sum()) > 500
    rng = np.random.default_rng(5)
    n = d.shape[0]
    weights = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda()
               for s in ((n,), (n, 3), (n, 3), (n,))]
    leaves = [tt, d, ih] + fields
    _assert_same_grads(_grads(kernel, leaves, weights),
                       _grads(plain, leaves, weights), NAMES)
    assert rf.launch_count == 2


@pytest.mark.gpu
def test_cuda_finish_values_follow_the_kernel(fused):
    """`finish_values`, which the CPU test of the backward runs in the
    kernel's place, against the kernel's launch on the same rays: the voxel
    index and the safe flag exactly, every output and saved column within
    2e-7 of its largest entry (an ulp)."""
    _card()
    _, poses, _, tg = fused
    cg = tvg.VoxelGrid(*(a.cuda() for a in tg))
    res, o, d, ih = _march(cg, *poses[4])
    args = (res.found, res.s_star, o, d, ih, cg, GCFG, FCFG)
    got, (lin, safe, aux) = rf._launch(*args, points=True, state=True)
    want, (lin_w, safe_w, aux_w) = rf.finish_values(*args, points=True, state=True)
    torch.cuda.synchronize()
    assert torch.equal(lin, lin_w) and torch.equal(safe, safe_w)
    assert int((lin >= 0).sum()) > 500
    for a, b in list(zip(got, want)) + [(aux[:, j], aux_w[:, j]) for j in range(8)]:
        assert float((a - b).abs().max()) <= 2e-7 * float(b.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["stride4", "no_prior", "raster", "incremental"])
def test_cuda_render_launches_the_kernels_without_a_host_sync(fused, mode):
    """A render with the camera on the card, under PyTorch's sync debug
    mode "error" (which raises at any host sync): it goes through the
    kernels of its mode and equals the render with the plain passes."""
    _card()
    _, poses, _, tg = fused
    cg = tvg.VoxelGrid(*(a.cuda() for a in tg))
    R, t = poses[3]
    cam = [torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (K, R, t)]
    kw = {"stride4": {}, "no_prior": dict(prior_stride=0),
          "raster": dict(prior_mode="raster")}.get(mode)
    if kw is None:
        prior = trc.render_depth_normal(cg, *cam, W, H, GCFG, FCFG, **RANGE)[0]
        kw = dict(depth_prior=prior, depth_prior_holes="skip", prior_margin_voxels=4.0)
    mods = (rm, rw, pw, rf)
    for mod in mods:
        mod.reset_launch_count()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        d, n, h = trc.render_depth_normal(cg, *cam, W, H, GCFG, FCFG, **RANGE, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = {"stride4": (2, 1, 1, 1), "no_prior": (1, 0, 0, 1),
            "raster": (1, 1, 0, 1), "incremental": (1, 0, 1, 1)}[mode]
    assert tuple(mod.launch_count for mod in mods) == want
    dc, nc, hc = trc.render_depth_normal(tg, K, R, t, W, H, GCFG, FCFG, **RANGE, **kw)
    assert torch.equal(h.cpu(), hc)


@pytest.mark.gpu
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(fused):
    """On CUDA tensors a wrapper launches its kernel or raises: block
    coordinates of a wrong dtype, inputs on two devices, a wrong dtype."""
    _card()
    _, poses, _, tg = fused
    cg = tvg.VoxelGrid(*(a.cuda() for a in tg))
    R, t = poses[3]
    with pytest.raises(ValueError, match="block_coords"):
        rw.render_windows(cg._replace(block_coords=cg.block_coords.long()), K, R, t,
                          W, H, GCFG)
    s = torch.ones(12, device="cuda")
    with pytest.raises(ValueError, match="one device"):
        pw.stride_windows(s, (s > 0).cpu(), 3, 4, 2, MARGIN, S_MIN, S_MAX, True)
    res, o, d, ih = _march(cg, R, t)
    with pytest.raises(ValueError, match="inv_hnorm"):
        rf.ray_finish(res.found, res.s_star, o, d, ih.cpu(), cg, GCFG, FCFG)
    with pytest.raises(ValueError, match="s_star"):
        rf.ray_finish(res.found, res.s_star.double(), o, d, ih, cg, GCFG, FCFG)
