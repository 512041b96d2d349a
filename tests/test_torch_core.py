"""Port core (se3, voxel_grid, normals, filters, interop) against the JAX
package on the same numpy inputs.

Tolerances, with their reasons:
  * se3: atol 2e-6 — float32 closed forms evaluated in another order
    (matmul vs einsum) differ by a few ulps of O(1) values.
  * voxel_grid: exact — integer arithmetic, same claim order.
  * normals: atol 2e-3 on unit normals — the box sums differ (prefix sums
    in float64 here, banded float32 matmuls there) by ~1e-6 relative, and
    the per-pixel 3x3 inverse of FALS amplifies that ~1000x near the
    image border; the non-finite pattern must be identical.
"""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gradient_sdf_tpu.config import GridConfig
torch.backends.cuda.matmul.allow_tf32 = False  # float32, as the JAX package
torch.backends.cudnn.allow_tf32 = False
from gradient_sdf_tpu.ops import filters as jfilt
from gradient_sdf_tpu.ops import normals as jnorm
from gradient_sdf_tpu.ops import voxel_grid as jvg
from gradient_sdf_tpu.utils import checkpoint as jckpt
from gradient_sdf_tpu.utils import se3 as jse3
from gradient_sdf_tpu_torch.ops import filters as tfilt
from gradient_sdf_tpu_torch.ops import normals as tnorm
from gradient_sdf_tpu_torch.ops import voxel_grid as tvg
from gradient_sdf_tpu_torch.utils import interop
from gradient_sdf_tpu_torch.utils import se3 as tse3

SE3_ATOL = 2e-6
CFG = GridConfig(voxel_size=0.05, num_blocks=64, dir_dim=16)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.array(x)


def _twists(seed=0, n=64):
    """Random twists incl. theta ~ 0 and theta ~ pi rotations."""
    rng = np.random.default_rng(seed)
    xi = rng.standard_normal((n, 6)).astype(np.float32)
    xi[:8, 3:] *= 1e-6                       # near-identity rotations
    axis = rng.standard_normal((8, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    xi[8:16, 3:] = (axis * (np.pi - 1e-3)).astype(np.float32)  # near pi
    return xi


# ---------------------------------------------------------------------------
# se3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["hat", "so3_exp", "se3_exp"])
def test_se3_exp_family_matches_jax(fn):
    xi = _twists()
    arg = xi[:, 3:] if fn in ("hat", "so3_exp") else xi
    got = getattr(tse3, fn)(torch.from_numpy(arg))
    want = getattr(jse3, fn)(jnp.asarray(arg))
    if fn == "se3_exp":
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), _np(w), atol=SE3_ATOL)
    else:
        np.testing.assert_allclose(_np(got), _np(want), atol=SE3_ATOL)


@pytest.mark.parametrize("fn", ["so3_log", "se3_log", "vee"])
def test_se3_log_family_matches_jax(fn):
    xi = _twists(1)
    R, t = (_np(a) for a in jse3.se3_exp(jnp.asarray(xi)))
    if fn == "so3_log":
        got, want = tse3.so3_log(torch.from_numpy(R)), jse3.so3_log(jnp.asarray(R))
        # near pi the log has precision ~sqrt(eps) in both packages
        atol = 2e-3
    elif fn == "se3_log":
        got = tse3.se3_log(torch.from_numpy(R[16:]), torch.from_numpy(t[16:]))
        want = jse3.se3_log(jnp.asarray(R[16:]), jnp.asarray(t[16:]))
        atol = 1e-4  # generic angles: arccos of a float32 trace
    else:
        got, want = tse3.vee(torch.from_numpy(R)), jse3.vee(jnp.asarray(R))
        atol = 0.0
    np.testing.assert_allclose(_np(got), _np(want), atol=atol)


def test_se3_compose_apply_and_quaternions_match_jax():
    xi = _twists(2, 24)[8:]  # near-pi and generic rotations
    Ra, ta = (_np(a) for a in jse3.se3_exp(jnp.asarray(xi)))
    Rb, tb = (_np(a) for a in jse3.se3_exp(jnp.asarray(xi[::-1].copy())))
    T = torch.from_numpy
    for got, want in [
        (tse3.se3_mul(T(Ra), T(ta), T(Rb), T(tb)),
         jse3.se3_mul(jnp.asarray(Ra), jnp.asarray(ta), jnp.asarray(Rb),
                      jnp.asarray(tb))),
        (tse3.se3_inv(T(Ra), T(ta)), jse3.se3_inv(jnp.asarray(Ra), jnp.asarray(ta))),
    ]:
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), _np(w), atol=SE3_ATOL)
    pts = np.random.default_rng(3).standard_normal((16, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tse3.se3_apply(T(Ra)[:, None], T(ta)[:, None], T(pts))),
        _np(jse3.se3_apply(jnp.asarray(Ra)[:, None], jnp.asarray(ta)[:, None],
                           jnp.asarray(pts))), atol=1e-5)
    for i in range(len(Ra)):  # every Shepperd branch is hit by some rotation
        q_t = _np(tse3.rotmat_to_quat(T(Ra[i])))
        q_j = _np(jse3.rotmat_to_quat(jnp.asarray(Ra[i])))
        np.testing.assert_allclose(q_t, q_j, atol=SE3_ATOL)
        np.testing.assert_allclose(_np(tse3.quat_to_rotmat(T(q_t))),
                                   _np(jse3.quat_to_rotmat(jnp.asarray(q_j))),
                                   atol=SE3_ATOL)


# ---------------------------------------------------------------------------
# voxel grid
# ---------------------------------------------------------------------------


def test_key_and_voxel_addressing_match_jax():
    rng = np.random.default_rng(4)
    bc = rng.integers(-10, 10, size=(200, 3)).astype(np.int32)  # some out of range
    np.testing.assert_array_equal(_np(tvg.pack_key(torch.from_numpy(bc), CFG)),
                                  _np(jvg.pack_key(jnp.asarray(bc), CFG)))
    keys = rng.integers(0, CFG.dir_dim**3, 100).astype(np.int32)
    np.testing.assert_array_equal(_np(tvg.unpack_key(torch.from_numpy(keys), CFG)),
                                  _np(jvg.unpack_key(jnp.asarray(keys), CFG)))
    vox = rng.integers(-40, 40, size=(300, 3)).astype(np.int32)  # negatives
    for g, w in zip(tvg.voxel_to_block(torch.from_numpy(vox), CFG),
                    jvg.voxel_to_block(jnp.asarray(vox), CFG)):
        np.testing.assert_array_equal(_np(g), _np(w))
    np.testing.assert_array_equal(
        _np(tvg.block_local_to_voxel(torch.from_numpy(bc[:4]), CFG)),
        _np(jvg.block_local_to_voxel(jnp.asarray(bc[:4]), CFG)))
    # half-way points round to even, as jnp.round does
    pts = (np.array([[0.5, 1.5, 2.5], [-0.5, -1.5, -2.5]], np.float32)
           * CFG.voxel_size)
    np.testing.assert_array_equal(
        _np(tvg.point_to_voxel(torch.from_numpy(pts), CFG.voxel_size)),
        _np(jvg.point_to_voxel(jnp.asarray(pts), CFG.voxel_size)))


def _insert_both(keys, want, cfg, jgrid=None):
    jgrid = jvg.create(cfg) if jgrid is None else jgrid
    tgrid = interop.grid_from_numpy({k: np.asarray(v) for k, v in
                                     jgrid._asdict().items()})
    jg = jvg.insert_new(jgrid, jnp.asarray(keys), jnp.asarray(want), cfg)
    tg = tvg.insert_new(tgrid, torch.from_numpy(keys), torch.from_numpy(want), cfg)
    return jg, tg


def _assert_grids_equal(jg, tg):
    a = interop.grid_to_numpy(tg)
    for k, v in jg._asdict().items():
        np.testing.assert_array_equal(a[k], np.asarray(v), err_msg=k)


def test_insert_new_slot_ids_match_jax_with_duplicates_and_overflow():
    rng = np.random.default_rng(5)
    d3 = CFG.dir_dim**3
    keys = rng.integers(-1, d3, size=400).astype(np.int32)
    keys[::3] = keys[0]                       # many duplicate claims
    want = (keys >= 0) & (rng.random(400) < 0.8)
    # num_blocks=64 < distinct wanted keys: overflow drops the late claims
    jg, tg = _insert_both(keys, want, CFG)
    assert bool(jg.overflow) and int(jg.num_active) == CFG.num_blocks
    _assert_grids_equal(jg, tg)
    # a second batch on top of the first: slots continue in candidate order
    big = dataclasses.replace(CFG, num_blocks=4096)
    jg1, _ = _insert_both(keys[:100], want[:100], big)
    keys2 = rng.integers(0, d3, size=300).astype(np.int32)
    jg2, tg2 = _insert_both(keys2, np.ones(300, bool), big, jgrid=jg1)
    _assert_grids_equal(jg2, tg2)
    # lookups agree, and insert_keys skips what exists
    got = tvg.lookup_keys(tg2, torch.from_numpy(keys2), big)
    np.testing.assert_array_equal(
        _np(got), _np(jvg.lookup_keys(jg2, jnp.asarray(keys2), big)))
    again = tvg.insert_keys(tg2, torch.from_numpy(keys2), big)
    assert int(again.num_active) == int(jg2.num_active)


def test_lookup_voxels_after_insert_keys_match_jax():
    rng = np.random.default_rng(6)
    cfg = dataclasses.replace(CFG, num_blocks=512)
    vox = rng.integers(-30, 30, size=(250, 3)).astype(np.int32)
    # the blocks of ~70% of the voxels (others padded with EMPTY_KEY)
    keys = np.asarray(jvg.pack_key(jvg.voxel_to_block(jnp.asarray(vox), cfg)[0], cfg))
    keys = np.where(rng.random(250) < 0.7, keys, -1).astype(np.int32)
    jg = jvg.insert_keys(jvg.create(cfg), jnp.asarray(keys), cfg)
    tg = tvg.insert_keys(tvg.create(cfg, "cpu"), torch.from_numpy(keys), cfg)
    _assert_grids_equal(jg, tg)
    for g, w in zip(tvg.lookup_voxels(tg, torch.from_numpy(vox), cfg),
                    jvg.lookup_voxels(jg, jnp.asarray(vox), cfg)):
        np.testing.assert_array_equal(_np(g), _np(w))


def test_grow_and_grow_directory_match_jax():
    rng = np.random.default_rng(7)
    cfg = dataclasses.replace(CFG, num_blocks=128)
    keys = rng.integers(0, cfg.dir_dim**3, 100).astype(np.int32)
    jg, tg = _insert_both(keys, np.ones(100, bool), cfg)
    fill = rng.standard_normal(tuple(jg.dist.shape)).astype(np.float32)
    jg = jg._replace(dist=jnp.asarray(fill))
    tg = tg._replace(dist=torch.from_numpy(fill.copy()))
    jb, jcfg = jvg.grow(jg, cfg)
    tb, tcfg = tvg.grow(tg, cfg)
    assert jcfg == tcfg
    _assert_grids_equal(jb, tb)
    jd, jdcfg = jvg.grow_directory(jb, jcfg)
    td, tdcfg = tvg.grow_directory(tb, tcfg)
    assert jdcfg == tdcfg
    _assert_grids_equal(jd, td)
    # the oob policy: a counted loss grows the directory, else nothing
    td = td._replace(oob_samples=torch.tensor(5, dtype=torch.int32))
    tg3, cfg3, grew = tvg.handle_oob_growth(td, tdcfg)
    assert grew and cfg3.dir_dim == 2 * tdcfg.dir_dim
    assert int(tg3.oob_samples) == 0
    assert tvg.handle_oob_growth(tg3, cfg3)[2] is False


# ---------------------------------------------------------------------------
# normals + filters
# ---------------------------------------------------------------------------

W, H = 64, 48
K = np.array([[52.5, 0, 31.5], [0, 52.5, 23.5], [0, 0, 1]], dtype=np.float32)


def _depth(seed=8):
    """A tilted, bumpy surface with holes (zero depth) and a far edge."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    d = 1.2 + 0.01 * xx + 0.004 * yy + 0.02 * np.sin(xx / 5.0)
    d += 0.002 * rng.standard_normal((H, W))
    d[rng.random((H, W)) < 0.05] = 0.0
    d[:, -6:] = 0.0  # an empty band: windows there have no depth at all
    return d.astype(np.float32)


def test_normal_cache_matches_jax():
    jc = jnorm.build_cache(W, H, K, window=5)
    tc = tnorm.build_cache(W, H, K, window=5, device="cpu")
    for name in ("x0", "y0", "n_sq_inv", "x0_n_sq_inv", "y0_n_sq_inv", "Q"):
        np.testing.assert_array_equal(_np(getattr(tc, name)),
                                      _np(getattr(jc, name)), err_msg=name)


def test_box_filter_matches_numpy_reflect101():
    img = np.random.default_rng(9).standard_normal((H, W)).astype(np.float32)
    want = tnorm._np_box_filter(img.astype(np.float64), 7)
    got = tnorm.box_filter(torch.from_numpy(img), 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("window", [5, 11])
def test_compute_normals_matches_jax(window):
    depth = _depth()
    jc = jnorm.build_cache(W, H, K, window=window)
    tc = tnorm.build_cache(W, H, K, window=window, device="cpu")
    want = np.asarray(jnorm.compute_normals(jc, jnp.asarray(depth)))
    got = tnorm.compute_normals(tc, torch.from_numpy(depth)).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert (~fin).any() and fin.any()  # both IEEE outcomes are exercised
    np.testing.assert_allclose(got[fin], want[fin], atol=2e-3)


def test_median_blur_matches_jax():
    depth = _depth(10)
    want = np.asarray(jfilt.median_blur(jnp.asarray(depth), 5))
    got = tfilt.median_blur(torch.from_numpy(depth), 5).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# interop
# ---------------------------------------------------------------------------


def test_interop_round_trip_and_jax_checkpoint(tmp_path):
    rng = np.random.default_rng(11)
    cfg = dataclasses.replace(CFG, num_blocks=256)
    keys = rng.integers(0, cfg.dir_dim**3, 120).astype(np.int32)
    jg = jvg.insert_keys(jvg.create(cfg), jnp.asarray(keys), cfg)
    shape = tuple(jg.dist.shape)
    jg = jg._replace(dist=jnp.asarray(rng.standard_normal(shape), jnp.float32),
                     weight=jnp.asarray(rng.random(shape), jnp.float32),
                     oob_samples=jnp.int32(3))
    path = os.path.join(tmp_path, "state.npz")
    jckpt.save_state(path, jg, counter=4, grid_cfg=cfg)
    tg = interop.grid_from_numpy(np.load(path))
    assert tg.dist.dtype == torch.float32 and tg.directory.dtype == torch.int32
    assert tg.overflow.dtype == torch.bool and tg.num_blocks == cfg.num_blocks
    _assert_grids_equal(jg, tg)
    # and back: the JAX package computes the same lookups on the round trip
    back = jvg.VoxelGrid(**{k: jnp.asarray(v) for k, v in
                            interop.grid_to_numpy(tg).items()})
    vox = rng.integers(-20, 20, size=(64, 3)).astype(np.int32)
    for g, w in zip(jvg.lookup_voxels(back, jnp.asarray(vox), cfg),
                    tvg.lookup_voxels(tg, torch.from_numpy(vox), cfg)):
        np.testing.assert_array_equal(np.asarray(g), _np(w))
