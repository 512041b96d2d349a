"""The march kernel's index arithmetic, ray mapping and index limits
(gradient_sdf_tpu_torch/ops/kernels/raycast_march.py and
csrc/raycast_march.cu), and the renderer at other block shapes against the
JAX package.

The kernel computes a probe's block coordinate with an arithmetic right
shift and its offset in the block with a mask for every block shape that
has an instance of its own (`POW2_BLOCK_SHAPES`), and with runtime floor
division for every other shape; the plain version uses floor division
throughout, which the shift and the mask must equal exactly.

Tolerances, with their reasons: index arithmetic and ray order are
integers, compared exactly. The renders at block shapes 4 and 6 use the
gates of tests/test_torch_raycast.py (`_assert_same_render` there: hit masks
on at most 0.5% of the hits, depth median < 1e-5 m and 99.5% < 1e-4 m, the
rest under 1.5 voxels): the two marches probe the same voxels except within
rounding of a voxel plane.
"""

import os
import re

import numpy as np
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
FCFG = FusionConfig(trunc_voxels=5.0)
RANGE = dict(s_min=0.3, s_max=2.5)
SOURCE = os.path.join(os.path.dirname(rm.__file__), "..", "..", "csrc",
                      "raycast_march.cu")


def test_pow2_instances_are_the_sources():
    """`POW2_BLOCK_SHAPES` names exactly the shapes `pick` gives an instance
    of their own, each with its log2 and the coarse factor 4."""
    with open(SOURCE) as f:
        src = f.read()
    cases = re.findall(r"case (\d+): return march_rays<(\d+), (\d+), kStats>", src)
    assert sorted(int(b) for b, _, _ in cases) == list(rm.POW2_BLOCK_SHAPES)
    for b, log_b, log_f in cases:
        assert 1 << int(log_b) == int(b) and 1 << int(log_f) == tvg.COARSE_FACTOR


@pytest.mark.parametrize("b", rm.POW2_BLOCK_SHAPES)
def test_block_index_equals_floor_division(b):
    """For every block shape with an instance of its own (the coarse factor
    4 among them), the kernel's int32 `v >> log2(b)` and `v & (b - 1)` against
    torch.div(..., rounding_mode="floor") and v - b floor(v / b) on negative
    and positive voxel indices, the multiples of b and their neighbours
    included."""
    rng = np.random.default_rng(b)
    edges = np.arange(-40 * b, 40 * b + 1)
    wide = rng.integers(-2**30, 2**30, 20000)
    v = torch.as_tensor(np.concatenate([edges, wide]).astype(np.int32))
    q = torch.div(v, b, rounding_mode="floor")
    assert torch.equal(v >> (b.bit_length() - 1), q)
    assert torch.equal(v & (b - 1), v - q * b)


def test_tile_geometry_is_the_sources():
    """`WARP_TILE`, `TILES_X` and `THREADS`, which `ray_order` (and the
    bench's count of lanes in use) lays out, are the kernel's kWarpW x
    kWarpH, kTilesX and kThreads."""
    with open(SOURCE) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    assert rm.WARP_TILE == (const("kWarpW"), const("kWarpH"))
    assert rm.TILES_X == const("kTilesX") and rm.THREADS == const("kThreads")


@pytest.mark.parametrize("width,height", [(640, 480), (160, 120), (96, 72),
                                          (13, 7), (33, 9), (1, 5)])
def test_ray_order_tiles_every_pixel_once(width, height):
    """Each pixel goes to exactly one thread; the lanes of a warp hold an
    8 x 4 tile (cut at the image's edge); width None keeps the order."""
    n = width * height
    order = rm.ray_order(n, width)
    assert order.numel() % rm.THREADS == 0
    taken = order[order >= 0]
    assert torch.equal(taken.sort().values, torch.arange(n))
    tw, th = rm.WARP_TILE
    for warp in order.reshape(-1, 32):
        rays = warp[warp >= 0]
        if rays.numel():
            x, y = rays % width, rays // width
            assert int(x.max() - x.min()) < tw and int(y.max() - y.min()) < th
    flat = rm.ray_order(n, None)
    assert torch.equal(flat[:n], torch.arange(n)) and bool((flat[n:] == -1).all())
    assert flat.numel() % 32 == 0


@pytest.fixture(scope="module")
def sphere_scene():
    world = jsynth.SphereWorld(
        centers=jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32),
        radii=jnp.asarray([0.3], jnp.float32))
    return world, jnorm.build_cache(W, H, K, window=5), jsynth.orbit_poses(n=12, radius=1.2)


@pytest.mark.parametrize("b", [4, 6])
def test_render_at_other_block_shapes_matches_jax(sphere_scene, b):
    """Block shape 4 (shift and mask) and 6 (runtime divisors) through the
    whole renderer: the JAX package fuses the frames, both packages render
    the same grid without a prior and with the stride prior."""
    world, cache, poses = sphere_scene
    gcfg = GridConfig(voxel_size=0.02, block_shape=b,
                      num_blocks=4096 * 512 // b**3, dir_dim=256)
    jg = jvg.create(gcfg)
    for R, t in poses[:4]:
        depth = jsynth.render_depth(world, jnp.asarray(R), jnp.asarray(t), K, W, H)
        jg = jfu.fuse_frame(jg, depth, cache, jnp.asarray(R), jnp.asarray(t),
                            gcfg, FCFG)
    tg = interop.grid_from_numpy({k: np.asarray(v) for k, v in jg._asdict().items()})
    R, t = poses[3]
    for kw in (dict(prior_stride=0), dict()):
        dj, _, hj = (np.asarray(a) for a in jrc.render_depth_normal(
            jg, jnp.asarray(K), jnp.asarray(R), jnp.asarray(t), W, H, gcfg, FCFG,
            **RANGE, **kw))
        dt, _, ht = (a.numpy() for a in trc.render_depth_normal(
            tg, K, R, t, W, H, gcfg, FCFG, **RANGE, **kw))
        n_hit = int(hj.sum())
        assert n_hit > 500
        assert int((ht ^ hj).sum()) <= 0.005 * n_hit, kw
        err = np.abs(dt - dj)[ht & hj]
        assert np.median(err) < 1e-5 and np.quantile(err, 0.995) < 1e-4, kw
        assert err.max() < 1.5 * gcfg.voxel_size, kw


def test_render_passes_march_as_images(sphere_scene, monkeypatch):
    """`render_depth_normal` hands the march each pass's image width (the
    kernel's tiles); `raycast` on arbitrary rays keeps the flat order."""
    world, cache, poses = sphere_scene
    gcfg = GridConfig(voxel_size=0.02, num_blocks=1024)
    grid = tvg.create(gcfg, "cpu")
    widths = []
    real = trc.raycast_march

    def spy(*args, width=None, **kw):
        widths.append(width)
        return real(*args, width=width, **kw)

    monkeypatch.setattr(trc, "raycast_march", spy)
    R, t = poses[3]
    trc.render_depth_normal(grid, K, R, t, W, H, gcfg, FCFG, **RANGE)
    assert widths == [W // 4, W]
    o, d, _ = trc.camera_rays(K, R, t, W, H)
    trc.raycast(grid, o, d, gcfg, FCFG, **RANGE)
    assert widths[-1] is None
