"""Port PhotoBA (`gradient_sdf_tpu_torch/models/photo_ba.py`) and what it
stands on against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through both packages; the
port runs on `device="cpu"`. Tolerances, with their reasons:
  * `bilinear_sample_grad`, 1e-6: the same float32 lerp of values in [0, 1].
  * `modified_laplacian`, rtol 1e-5: a float32 mean over the image, summed
    in another order.
  * `energy`, rtol 1e-4: sum|A|^2 - |sum A|^2/N cancels in float32, and the
    port sums the frames in the reduction's order, not strictly one by one.
  * `solve_dist`, atol 1e-6 + rtol 1e-4 on `dist`: one b/H step of the same
    float32 sums.
  * pose systems: `H` and `b` to 1e-4 of their largest entry (sums over
    3V residual rows, through each package's float32 matrix product; they
    agree to ~4e-7). Poses after one step to 1e-5 plus what the system's
    conditioning makes of that: a relative change eps of H and b moves the
    step by up to cond(H) * eps * |delta|, taken with eps = 1e-6. The
    textured-plane fixture has cond(H) ~ 7e3 (decoupled) and ~1e5 (coupled:
    moving all cameras together barely changes a zero-mean residual), the
    random fixture ~1e2.
  * the whole `optimize()` loop: each energy to rtol 1e-3 — rounding
    differences feed back through 2 x iterations solver steps.
"""

import ast
import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gradient_sdf_tpu.config import FusionConfig, GridConfig, PhotoBAConfig
from gradient_sdf_tpu.data import synth as jsynth
from gradient_sdf_tpu.models import loss as jloss
from gradient_sdf_tpu.models import photo_ba as jba
from gradient_sdf_tpu.models import sharpness as jsharp
from gradient_sdf_tpu.ops import filters as jfilters
from gradient_sdf_tpu.ops import fusion as jfu
from gradient_sdf_tpu.ops import marching_cubes as jmc
from gradient_sdf_tpu.ops import normals as jnorm
from gradient_sdf_tpu.ops import voxel_grid as jvg
from gradient_sdf_tpu_torch import config as tcfg_mod
from gradient_sdf_tpu_torch.models import loss as tloss
from gradient_sdf_tpu_torch.models import photo_ba as tba
from gradient_sdf_tpu_torch.models import sharpness as tsharp
from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap
from gradient_sdf_tpu_torch.ops import filters as tfilters
from gradient_sdf_tpu_torch.ops import marching_cubes as tmc
from gradient_sdf_tpu_torch.ops import voxel_grid as tvg
from gradient_sdf_tpu_torch.utils import interop
from gradient_sdf_tpu_torch.utils import se3 as tse3

torch.backends.cuda.matmul.allow_tf32 = False  # float32, as the JAX package
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

W, H = 64, 48
K = np.array([[60.0, 0, 31.5], [0, 60.0, 23.5], [0, 0, 1]], dtype=np.float32)
GCFG = GridConfig(voxel_size=0.02, num_blocks=512)
PCFG = PhotoBAConfig(max_iterations=10)


# ---------------------------------------------------------------------------
# image sampler, sharpness, loss
# ---------------------------------------------------------------------------


def _sample_coords(rng, n, w, h, kind):
    if kind == "interior":
        return rng.uniform(0, w - 1, n), rng.uniform(0, h - 1, n)
    if kind == "out_of_bounds":
        return rng.uniform(-5, w + 5, n), rng.uniform(-5, h + 5, n)
    # the last row and column, their half-open ends, and the exact corners
    u = np.concatenate([rng.uniform(w - 1, w, n), [0, w - 1, w, w - 1e-4, -0.0]])
    v = np.concatenate([rng.uniform(h - 1, h, n), [0, h - 1, h - 1e-4, h, 0.0]])
    return u, v


@pytest.mark.parametrize("kind", ["interior", "out_of_bounds", "last_row_col"])
def test_bilinear_sample_grad_matches_jax(kind):
    rng = np.random.RandomState(3)
    img = rng.rand(H, W, 3).astype(np.float32)
    u, v = (a.astype(np.float32) for a in _sample_coords(rng, 500, W, H, kind))
    want = jfilters.bilinear_sample_grad(jnp.asarray(img), jnp.asarray(u),
                                         jnp.asarray(v))
    got = tfilters.bilinear_sample_grad(torch.from_numpy(img),
                                        torch.from_numpy(u), torch.from_numpy(v))
    for g, w_ in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-6)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert got[3].numpy().any()
    if kind != "interior":
        assert not got[3].numpy().all()


def test_bilinear_sample_grad_image_stack_equals_per_image():
    """A stack [F, H, W, C] with coordinates [F, ...] samples image f in
    row f: bit-equal to F single-image calls."""
    rng = np.random.RandomState(4)
    imgs = torch.from_numpy(rng.rand(3, H, W, 3).astype(np.float32))
    u = torch.from_numpy(rng.uniform(-3, W + 3, (3, 40, 8)).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-3, H + 3, (3, 40, 8)).astype(np.float32))
    got = tfilters.bilinear_sample_grad(imgs, u, v)
    for f in range(3):
        want = tfilters.bilinear_sample_grad(imgs[f], u[f], v[f])
        for g, w_ in zip(got, want):
            assert torch.equal(g[f], w_)


@pytest.mark.parametrize("shape", [(48, 64, 3), (48, 64), (37, 53, 3)])
def test_modified_laplacian_matches_jax(shape):
    img = np.random.RandomState(5).rand(*shape).astype(np.float32)
    want = float(jsharp.modified_laplacian(jnp.asarray(img)))
    got = float(tsharp.modified_laplacian(img))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for thr in (want * 0.5, want * 2.0):
        assert tsharp.sharp_detector(img, thr) == jsharp.sharp_detector(img, thr)


@pytest.mark.parametrize("name", ["L2", "CAUCHY", "HUBER", "TUKEY", "TRUNC_L2"])
def test_loss_weight_matches_jax(name):
    r = np.random.RandomState(6).randn(400).astype(np.float32) * 2.0
    r[:3] = [0.0, 0.7, -0.7]  # |r| / scale == 1 exactly
    want = jloss.weight(jnp.asarray(r), jloss.LossFunction[name], 0.7)
    got = tloss.weight(torch.from_numpy(r), tloss.LossFunction[name], 0.7)
    assert tloss.LossFunction[name].value == jloss.LossFunction[name].value
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# voxel grid and coloured marching cubes
# ---------------------------------------------------------------------------


def test_ensure_blocks_slot_ids_match_jax():
    rng = np.random.RandomState(7)
    vox = rng.randint(-60, 60, (3000, 3)).astype(np.int32)
    valid = rng.rand(3000) < 0.8
    jg = jvg.ensure_blocks(jvg.create(GCFG), jnp.asarray(vox),
                           jnp.asarray(valid), GCFG)
    tg = tvg.ensure_blocks(tvg.create(GCFG, "cpu"), torch.from_numpy(vox),
                           torch.from_numpy(valid), GCFG)
    assert int(tg.num_active) == int(jg.num_active) > 100
    assert bool(tg.overflow) == bool(jg.overflow)
    np.testing.assert_array_equal(tg.directory.numpy(), np.asarray(jg.directory))
    np.testing.assert_array_equal(tg.block_coords.numpy(),
                                  np.asarray(jg.block_coords))
    jl, jp = jvg.lookup_voxels(jg, jnp.asarray(vox), GCFG)
    tl, tp = tvg.lookup_voxels(tg, torch.from_numpy(vox), GCFG)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def _fused_jax_grid(with_vis=False, n=4, kf_words=1):
    """A small spheres scene fused by the JAX package (96x72, 4 views)."""
    w, h = 96, 72
    k = np.array([[78.75, 0, 47.5], [0, 78.75, 35.5], [0, 0, 1]], np.float32)
    gcfg = GridConfig(voxel_size=0.02, num_blocks=1024)
    fcfg = FusionConfig(trunc_voxels=5.0)
    world = jsynth.random_spheres(seed=2)
    cache = jnorm.build_cache(w, h, k, window=5)
    jg = jvg.create(gcfg)
    vis = jnp.zeros((gcfg.num_blocks, gcfg.voxels_per_block, kf_words),
                    jnp.uint32) if with_vis else None
    poses = jsynth.orbit_poses(n=n, radius=2.0, arc=np.deg2rad(20.0))
    # keyframe slots spread over the words, bit 31 included
    slots = [0, 31, 32 * kf_words - 1, 5][:n] if with_vis else []
    for i, (R, t) in enumerate(poses):
        d = jsynth.render_depth(world, jnp.asarray(R), jnp.asarray(t), k, w, h)
        if with_vis:
            jg, vis = jfu.fuse_frame(jg, d, cache, jnp.asarray(R), jnp.asarray(t),
                                     gcfg, fcfg, vis=vis, kf_slot=slots[i])
        else:
            jg = jfu.fuse_frame(jg, d, cache, jnp.asarray(R), jnp.asarray(t),
                                gcfg, fcfg)
    return jg, vis, gcfg, poses, slots, k, (w, h)


def _to_port_grid(jg):
    return interop.grid_from_numpy({k: np.asarray(v)
                                    for k, v in jg._asdict().items()})


def _sorted_rows(*arrays):
    """Rows of the column-stacked arrays in lexicographic order."""
    a = np.concatenate([np.asarray(x, np.float64).reshape(len(arrays[0]), -1)
                        for x in arrays], axis=1)
    return a[np.lexsort(a.T[::-1])]


def test_colored_extract_mesh_with_origin_matches_jax():
    jg, _, gcfg, *_ = _fused_jax_grid()
    rng = np.random.RandomState(8)
    color = rng.rand(gcfg.num_blocks, gcfg.voxels_per_block, 3).astype(np.float32)
    origin = gcfg.voxel_size / 4.0
    jv, jf, jc = jmc.extract_mesh(jg, gcfg, chunk=64, color_field=jnp.asarray(color),
                                  origin=origin)
    tv, tf, tc = tmc.extract_mesh(_to_port_grid(jg), gcfg, chunk=64,
                                  color_field=torch.from_numpy(color),
                                  origin=origin)
    assert len(tv) == len(jv) > 100 and len(tf) == len(jf) > 100
    assert tc.shape == (len(tv), 3)
    # the dedups number the vertices differently: pair each vertex with the
    # nearest one of the other mesh (positions to 1e-6 m, one to one), then
    # compare the pair's colours to 1e-5
    from scipy.spatial import cKDTree

    dist, match = cKDTree(jv).query(tv)
    assert dist.max() <= 1e-6
    assert len(np.unique(match)) == len(jv)
    np.testing.assert_allclose(tc, jc[match], atol=1e-5)
    assert tc.std() > 0.1  # the random colours, not a constant
    assert cKDTree(jv[jf].mean(axis=1)).query(tv[tf].mean(axis=1))[0].max() <= 1e-6
    # the shift itself: origin moves every vertex by the same amount
    tv0, _ = tmc.extract_mesh(_to_port_grid(jg), gcfg, chunk=64)
    np.testing.assert_allclose(_sorted_rows(tv0) + origin, _sorted_rows(tv),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# BA problems
# ---------------------------------------------------------------------------


def _plane_arrays(F=3, V=200, seed=0, pose_noise=0.0):
    """Voxels on a textured plane z=1 (world), F cameras looking at it: the
    fixture of the JAX package's PhotoBA tests, as numpy arrays."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.RandomState(seed)
    xs = rng.uniform(-0.3, 0.3, V)
    ys = rng.uniform(-0.2, 0.2, V)
    vox = np.round(np.stack([xs, ys, np.full(V, 1.0)], -1) / GCFG.voxel_size)
    vox = np.unique(vox.astype(np.int32), axis=0)
    V = len(vox)
    tex = rng.rand(6, 8, 3).astype(np.float32)
    big = np.kron(tex, np.ones((H // 6, W // 8, 1))).astype(np.float32)
    img0 = gaussian_filter(big, sigma=(3, 3, 0))

    Rs, ts, images = [], [], []
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    for i in range(F):
        t = np.array([0.02 * i, -0.01 * i, 0.0], np.float32)
        R = np.eye(3, dtype=np.float32)
        if pose_noise > 0 and i > 0:
            xi = rng.randn(6).astype(np.float32) * pose_noise
            dR, dt = tse3.se3_exp(torch.from_numpy(xi))
            R = R @ dR.numpy()
            t = t + dt.numpy()
        Rs.append(R)
        ts.append(t)
        # pixel (u,v) sees the plane point t + z*(x0,y0,1) with p_z = 1
        zplane = 1.0 - t[2]
        px = t[0] + zplane * (u - cx) / fx
        py = t[1] + zplane * (v - cy) / fy
        tu = (px + 0.4) / 0.8 * (W - 1)
        tv = (py + 0.3) / 0.6 * (H - 1)
        images.append(img0[np.clip(tv.astype(int), 0, H - 1),
                           np.clip(tu.astype(int), 0, W - 1)])
    problem = dict(
        vox=vox, grad=np.tile([0.0, 0.0, 5.0], (V, 1)).astype(np.float32),
        weight=np.full(V, 10.0, np.float32), vmask=np.ones(V, bool),
        vis=np.ones((V, F), bool), images=np.stack(images).astype(np.float32),
        K=K)
    state = dict(dist=np.zeros(V, np.float32), R=np.stack(Rs).astype(np.float32),
                 t=np.stack(ts).astype(np.float32))
    return problem, state


def _random_arrays(F=4, V=700, seed=11):
    """An unstructured problem: random voxels, gradients, visibility,
    padding rows and images; some projections fall outside the image or
    behind the camera, some frames see nothing of a voxel."""
    rng = np.random.RandomState(seed)
    vox = np.concatenate([rng.randint(-12, 12, (V, 2)),
                          rng.randint(30, 70, (V, 1))], 1).astype(np.int32)
    vox[:20, 2] = -5  # behind the cameras
    vmask = np.arange(V) < V - 50
    vis = rng.rand(V, F) < 0.6
    vis[100:120] = False
    problem = dict(
        vox=vox, grad=rng.randn(V, 3).astype(np.float32),
        weight=rng.uniform(1, 20, V).astype(np.float32), vmask=vmask, vis=vis,
        images=rng.rand(F, H, W, 3).astype(np.float32), K=K)
    dist = rng.uniform(-0.03, 0.03, V).astype(np.float32)  # some beyond 1 voxel
    R = np.stack([tse3.so3_exp(torch.from_numpy(
        rng.randn(3).astype(np.float32) * 0.02)).numpy() for _ in range(F)])
    state = dict(dist=dist, R=R.astype(np.float32),
                 t=rng.uniform(-0.05, 0.05, (F, 3)).astype(np.float32))
    return problem, state


def _both(arrays):
    problem, state = arrays
    jp = jba.BAProblem(**{k: jnp.asarray(v) for k, v in problem.items()})
    js = jba.BAState(**{k: jnp.asarray(v) for k, v in state.items()})
    return (jp, js), (interop.problem_from_numpy(problem),
                      interop.state_from_numpy(state))


FIXTURES = {
    "plane": lambda: _plane_arrays(F=3, seed=2, pose_noise=0.004),
    "random": _random_arrays,
}
LOSSES = ["cauchy", "trunc_l2"]


def _pcfg(loss, **kw):
    # lambda 0.6 lets the TRUNC_L2 gate (max_ch A^2 <= lambda^2) pass some
    # samples of images in [0, 1] and reject others
    return dataclasses.replace(PCFG, loss=loss, lambda_=0.6, **kw)


def test_interop_problem_state_roundtrip():
    problem, state = _random_arrays()
    (jp, js), (tp, ts) = _both((problem, state))
    for name, rec, src in (("problem", interop.problem_to_numpy(tp), problem),
                           ("state", interop.state_to_numpy(ts), state)):
        for k, v in src.items():
            assert rec[k].dtype == np.asarray(v).dtype, (name, k)
            np.testing.assert_array_equal(rec[k], v)
    assert tp.vis.dtype == torch.bool and tp.vox.dtype == torch.int32
    back = jba.BAProblem(**{k: jnp.asarray(v)
                            for k, v in interop.problem_to_numpy(tp).items()})
    np.testing.assert_array_equal(np.asarray(back.vis), np.asarray(jp.vis))


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_energy_matches_jax(fixture):
    (jp, js), (tp, ts) = _both(FIXTURES[fixture]())
    want = float(jba.energy(jp, js, GCFG))
    got = float(tba.energy(tp, ts, GCFG))
    assert want > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_energy_zero_for_identical_frames():
    """Identical images and poses: every residual is 0, and the clamp keeps
    the float32 cancellation from going negative."""
    problem, state = _plane_arrays(F=2, V=64, seed=1)
    problem["images"][1] = problem["images"][0]
    state["R"][1], state["t"][1] = state["R"][0], state["t"][0]
    (jp, js), (tp, ts) = _both((problem, state))
    got = float(tba.energy(tp, ts, GCFG))
    assert 0.0 <= got < 1e-5
    assert float(jba.energy(jp, js, GCFG)) < 1e-5


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_solve_dist_matches_jax(fixture, loss):
    problem, state = FIXTURES[fixture]()
    state["dist"] = state["dist"] + np.float32(0.004)
    (jp, js), (tp, ts) = _both((problem, state))
    pcfg = _pcfg(loss)
    want = np.asarray(jba.solve_dist(jp, js, GCFG, pcfg).dist)
    got = tba.solve_dist(tp, ts, GCFG, pcfg).dist.numpy()
    assert np.abs(want - state["dist"]).max() > 1e-4  # the step is real
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-4)
    # padding rows and voxels no frame sees do not move
    still = ~problem["vmask"] | ~problem["vis"].any(axis=1)
    np.testing.assert_array_equal(got[still], state["dist"][still])


def test_solve_dist_trunc_gate_changes_the_step():
    (jp, js), (tp, ts) = _both(_random_arrays())
    a = tba.solve_dist(tp, ts, GCFG, _pcfg("cauchy")).dist
    b = tba.solve_dist(tp, ts, GCFG, _pcfg("trunc_l2")).dist
    assert float((a - b).abs().max()) > 1e-6


def _step_atol(H, delta):
    """1e-5 plus the conditioning allowance of the module docstring."""
    H = np.asarray(H, np.float64)
    cond = max(np.linalg.cond(h) for h in H.reshape((-1,) + H.shape[-2:]))
    return 1e-5 + cond * 1e-6 * float(np.abs(np.asarray(delta)).max())


def _jax_pose_system(jp, js, pcfg):
    """(H [F,6,6], b [F,6]) of the JAX package's decoupled pose step,
    assembled from its own per-frame pass."""
    frame_AJ, n, inv_n, mean_A, xs = jba._pose_terms(jp, js, GCFG, pcfg)
    Hs, bs = [], []
    for i in range(jp.images.shape[0]):
        A, Jc, valid = frame_AJ(js.R[i], js.t[i], jp.images[i], jp.vis[:, i])
        w = (valid & (n > 0)).astype(jnp.float32)
        bs.append(jnp.einsum("v,vc,vce->e", w, A - mean_A, Jc, precision="highest"))
        Hs.append(jnp.einsum("v,vce,vcf->ef", w * (1.0 - inv_n), Jc, Jc,
                             precision="highest"))
    return np.asarray(jnp.stack(Hs)), np.asarray(jnp.stack(bs))


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_solve_pose_matches_jax(fixture, loss):
    (jp, js), (tp, ts) = _both(FIXTURES[fixture]())
    pcfg = _pcfg(loss)
    # the 6x6 systems
    Hj, bj = _jax_pose_system(jp, js, pcfg)
    A, Jc, valid, n, inv_n, mean_A = tba._pose_terms(tp, ts, GCFG, pcfg)
    w = (valid & (n > 0)).to(torch.float32)
    bt, Ht = tba._weighted_systems(w, w * (1.0 - inv_n), A - mean_A, Jc)
    assert np.abs(Hj).max() > 0 and np.abs(bj).max() > 0
    np.testing.assert_allclose(Ht.numpy(), Hj, atol=1e-4 * np.abs(Hj).max())
    np.testing.assert_allclose(bt.numpy(), bj, atol=1e-4 * np.abs(bj).max())
    # the step
    want = jba.solve_pose(jp, js, GCFG, pcfg)
    got = tba.solve_pose(tp, ts, GCFG, pcfg)
    assert np.abs(np.asarray(want.t) - np.asarray(js.t)).max() > 1e-5
    atol = _step_atol(Hj, np.linalg.solve(Hj.astype(np.float64),
                                          bj.astype(np.float64)[..., None]))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=atol)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=atol)
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_pose_full_system_matches_jax(fixture):
    (jp, js), (tp, ts) = _both(FIXTURES[fixture]())
    Hj, bj = (np.asarray(a) for a in jba._pose_full_system(jp, js, GCFG, PCFG))
    Ht, bt = tba._pose_full_system(tp, ts, GCFG, PCFG)
    F = tp.images.shape[0]
    assert Ht.shape == (6 * F, 6 * F) and bt.shape == (6 * F,)
    np.testing.assert_allclose(Ht.numpy(), Hj, atol=1e-4 * np.abs(Hj).max())
    np.testing.assert_allclose(bt.numpy(), bj, atol=1e-4 * np.abs(bj).max())
    # the off-diagonal (cross-frame) blocks are populated and symmetric
    assert np.abs(Hj[:6, 6:12]).max() > 0
    np.testing.assert_allclose(Ht.numpy(), Ht.numpy().T,
                               atol=1e-5 * np.abs(Hj).max())


@pytest.mark.parametrize("chunk", [64, 100, 8192])
def test_pose_full_system_chunk_invariant(chunk):
    _, (tp, ts) = _both(_plane_arrays(pose_noise=2e-3))
    V = tp.vox.shape[0]
    H_all, b_all = tba._pose_full_system(tp, ts, GCFG, PCFG, chunk=V)
    Hc, bc = tba._pose_full_system(tp, ts, GCFG, PCFG, chunk=chunk)
    np.testing.assert_allclose(Hc.numpy(), H_all.numpy(),
                               atol=1e-5 * float(H_all.abs().max()))
    np.testing.assert_allclose(bc.numpy(), b_all.numpy(),
                               atol=1e-5 * float(b_all.abs().max()))


def test_solve_pose_full_matches_jax():
    (jp, js), (tp, ts) = _both(_plane_arrays(F=3, seed=5, pose_noise=0.004))
    want = jba.solve_pose_full(jp, js, GCFG, PCFG)
    got = tba.solve_pose_full(tp, ts, GCFG, PCFG)
    assert np.abs(np.asarray(want.t) - np.asarray(js.t)).max() > 1e-5
    Hj, bj = (np.asarray(a, np.float64)
              for a in jba._pose_full_system(jp, js, GCFG, PCFG))
    Hj = Hj + 1e-9 * np.eye(len(Hj))
    atol = _step_atol(Hj, np.linalg.solve(Hj, bj))
    assert atol < 2e-2
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=atol)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=atol)
    # what the ill-conditioned directions do not touch: the energy reached
    e0 = float(tba.energy(tp, ts, GCFG))
    e1 = float(tba.energy(tp, got, GCFG))
    assert e1 < e0
    np.testing.assert_allclose(e1, float(jba.energy(jp, want, GCFG)), rtol=1e-3)


def test_apply_pose_delta_matches_jax_and_skips_nan():
    rng = np.random.RandomState(9)
    (jp, js), (tp, ts) = _both(_random_arrays())
    delta = (rng.randn(4, 6) * 0.01).astype(np.float32)
    delta[2, 4] = np.nan
    want = jba._apply_pose_delta(js, jnp.asarray(delta))
    got = tba._apply_pose_delta(ts, torch.from_numpy(delta))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-6)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-7)
    # the NaN frame keeps its pose; right-multiplicative update elsewhere
    np.testing.assert_allclose(got.R[2].numpy(), np.asarray(js.R[2]), atol=1e-7)
    np.testing.assert_array_equal(got.t[2].numpy(), np.asarray(js.t[2]))
    Rd = tse3.so3_exp(torch.from_numpy(-delta[0, 3:]))
    np.testing.assert_allclose(got.R[0].numpy(), (ts.R[0] @ Rd).numpy(), atol=1e-7)


def test_singular_pose_system_does_not_raise():
    """A frame no voxel is visible in has H = 0: the solve returns, and the
    frame's pose stays (delta = 0 / 1e-12)."""
    problem, state = _random_arrays()
    problem["vis"][:, 1] = False
    (jp, js), (tp, ts) = _both((problem, state))
    want = jba.solve_pose(jp, js, GCFG, PCFG)
    got = tba.solve_pose(tp, ts, GCFG, PCFG)
    np.testing.assert_array_equal(got.R[1].numpy(), state["R"][1])
    np.testing.assert_array_equal(got.t[1].numpy(), state["t"][1])
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-5)


def test_channel_mix_reverses_gradient_channels():
    (jp, js), (tp, ts) = _both(_plane_arrays(F=3, seed=6, pose_noise=0.003))
    x = tba._surface_points(tp, ts.dist, GCFG.voxel_size)
    args = (tp, x, ts.R[1], ts.t[1], tp.images[1], tp.vis[:, 1])
    A0, dI0, p0, v0 = tba._per_frame_terms(*args, channel_mix=False)
    A1, dI1, p1, v1 = tba._per_frame_terms(*args, channel_mix=True)
    assert torch.equal(A0, A1) and torch.equal(v0, v1) and torch.equal(p0, p1)
    assert torch.equal(dI1, dI0.flip(-2))
    # one frame's terms against the JAX package's, and against the same
    # frame inside the all-frames call
    jx = jba._surface_points(jp, js.dist, GCFG.voxel_size)
    jA, jdI, jpc, jv = jba._per_frame_terms(jp, jx, js.R[1], js.t[1], jp.images[1],
                                            jp.vis[:, 1], channel_mix=True)
    np.testing.assert_allclose(A1.numpy(), np.asarray(jA), atol=1e-6)
    np.testing.assert_allclose(dI1.numpy(), np.asarray(jdI),
                               atol=1e-5 * float(np.abs(jdI).max()))
    np.testing.assert_array_equal(v1.numpy(), np.asarray(jv))
    Aall, dIall, pall, vall = tba._per_frame_terms(
        tp, x, ts.R, ts.t, tp.images, tp.vis.T, channel_mix=True)
    np.testing.assert_allclose(dIall[1].numpy(), dI1.numpy(), atol=1e-6)
    assert torch.equal(vall[1], v1)
    # the mixed pose step differs on coloured data and agrees with JAX's
    mix = dataclasses.replace(PCFG, channel_mix_parity=True)
    s0 = tba.solve_pose(tp, ts, GCFG, PCFG)
    s1 = tba.solve_pose(tp, ts, GCFG, mix)
    assert float((s0.t - s1.t).abs().max()) > 1e-7
    np.testing.assert_allclose(s1.t.numpy(),
                               np.asarray(jba.solve_pose(jp, js, GCFG, mix).t),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# from a fused grid: build_problem, write_back_dist
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fused():
    jg, jvis, gcfg, poses, slots, k, (w, h) = _fused_jax_grid(with_vis=True,
                                                             kf_words=2)
    images = np.random.RandomState(12).rand(len(poses), h, w, 3).astype(np.float32)
    return dict(jg=jg, jvis=jvis, gcfg=gcfg, poses=poses, slots=slots, K=k,
                images=images)


def test_vis_words_cross_the_packages(fused):
    words = np.asarray(fused["jvis"])
    tvis = interop.vis_from_numpy(words)
    assert tvis.dtype == torch.int32 and words.dtype == np.uint32
    assert (tvis < 0).any()  # slot 31: the sign bit of an int32 word
    np.testing.assert_array_equal(interop.vis_to_numpy(tvis), words)


def test_build_problem_matches_jax(fused):
    f = fused
    jp, js = jba.build_problem(f["jg"], f["jvis"], f["slots"], f["images"],
                               f["poses"], f["K"], f["gcfg"])
    tp, ts = tba.build_problem(
        _to_port_grid(f["jg"]), interop.vis_from_numpy(np.asarray(f["jvis"])),
        f["slots"], f["images"], f["poses"], f["K"], f["gcfg"])
    assert int(np.asarray(jp.vmask).sum()) > 1000
    assert tp.vox.shape[0] % 1024 == 0
    for name in jba.BAProblem._fields:
        got, want = getattr(tp, name).numpy(), np.asarray(getattr(jp, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in jba.BAState._fields:
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), err_msg=name)
    # every keyframe slot, bit 31 and the second word included, sees voxels
    assert tp.vis.numpy().any(axis=0).all()


def test_write_back_dist_matches_jax(fused):
    f = fused
    jp, js = jba.build_problem(f["jg"], f["jvis"], f["slots"], f["images"],
                               f["poses"], f["K"], f["gcfg"])
    tg = _to_port_grid(f["jg"])
    tp, ts = tba.build_problem(
        tg, interop.vis_from_numpy(np.asarray(f["jvis"])), f["slots"],
        f["images"], f["poses"], f["K"], f["gcfg"])
    new = np.random.RandomState(13).uniform(-0.01, 0.01, tp.vox.shape[0])
    new = new.astype(np.float32)
    # one voxel that left the grid, beside the padding rows
    vox = np.asarray(jp.vox).copy()
    vox[5] = [4000, 4000, 4000]
    jp = jp._replace(vox=jnp.asarray(vox))
    tp = tp._replace(vox=torch.from_numpy(vox))
    before = tg.dist.clone()
    jg2 = jba.write_back_dist(f["jg"], jp, js._replace(dist=jnp.asarray(new)),
                              f["gcfg"])
    tg2 = tba.write_back_dist(tg, tp, ts._replace(dist=torch.from_numpy(new)),
                              f["gcfg"])
    np.testing.assert_array_equal(tg2.dist.numpy(), np.asarray(jg2.dist))
    assert int((tg2.dist != before).sum()) > 1000
    assert tg2.dist is tg.dist  # in place


# ---------------------------------------------------------------------------
# the whole loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("coupled", [False, True])
def test_optimize_matches_jax(coupled, tmp_path):
    (jp, js), (tp, ts) = _both(_plane_arrays(F=3, seed=2, pose_noise=0.004))
    stamps = ["001", "002", "003"]
    jopt = jba.PhotometricOptimizer(jp, js, GCFG, PCFG, verbose=False,
                                    coupled_poses=coupled)
    topt = tba.PhotometricOptimizer(tp, ts, GCFG, PCFG, verbose=False,
                                    coupled_poses=coupled,
                                    save_path=str(tmp_path), key_stamps=stamps)
    assert topt.optimize() == jopt.optimize()
    assert len(topt.energies) == len(jopt.energies) >= 3
    np.testing.assert_allclose(topt.energies, jopt.energies, rtol=1e-3)
    assert topt.energies[-1] < 0.9 * topt.energies[0]
    np.testing.assert_allclose(topt.state.t.numpy(), np.asarray(jopt.state.t),
                               atol=1e-4)
    np.testing.assert_allclose(topt.state.dist.numpy(),
                               np.asarray(jopt.state.dist), atol=1e-4)
    # pose snapshots: before BA and at the exit
    from gradient_sdf_tpu_torch.utils import tumio

    before = tumio.read_trajectory(
        str(tmp_path / "selected_frame_poses_before_optimization.txt"))
    after = tumio.read_trajectory(str(tmp_path / "coarse_BA_poses_optimized.txt"))
    assert [e[0] for e in before] == stamps == [e[0] for e in after]
    np.testing.assert_allclose(np.stack([e[2] for e in before]), ts.t.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(np.stack([e[2] for e in after]),
                               topt.state.t.numpy(), atol=1e-6)
    assert tba.PhotometricOptimizer(tp, ts, GCFG, PCFG).save_poses("x") is False


# ---------------------------------------------------------------------------
# the port's ground rules
# ---------------------------------------------------------------------------


def test_grad_sdf_map_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    cfg = tcfg_mod.PipelineConfig(grid=tcfg_mod.GridConfig(num_blocks=8, dir_dim=8))
    with pytest.raises(RuntimeError) as err:
        GradSdfMap(cfg)
    assert "--device cpu" in str(err.value) and 'device="cpu"' in str(err.value)
    assert GradSdfMap(cfg, device="cpu").device.type == "cpu"
    with pytest.raises(TypeError):
        tvg.create(cfg.grid)  # no silent default device


def _port_sources():
    pkg = os.path.join(ROOT, "gradient_sdf_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(pkg):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_port_imports_neither_jax_nor_the_jax_package():
    banned = ("jax", "jaxlib", "flax", "gradient_sdf_tpu")
    files = _port_sources()
    assert len(files) > 30
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in banned, (path, node.lineno, m)
