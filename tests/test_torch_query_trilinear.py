"""Port trilinear queries (`tsdf_trilinear`, `weights_trilinear` of
gradient_sdf_tpu_torch/ops/query.py) against the JAX package.

The three trilinear tests of tests/test_query.py on the port, then both
packages on one grid (built with the JAX package, carried across with
utils/interop) at random points from a seed.

Tolerances: phi and grad 1e-6 absolute (grad relative to its 1/vs scale:
the same eight products summed in the reduction's order), validity equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gradient_sdf_tpu.config import FusionConfig, GridConfig
from gradient_sdf_tpu.ops import query as jq
from gradient_sdf_tpu.ops import voxel_grid as jvg
from gradient_sdf_tpu_torch.ops import query as tq
from gradient_sdf_tpu_torch.utils import interop

GCFG = GridConfig(voxel_size=0.05, num_blocks=256)
FCFG = FusionConfig(trunc_voxels=5.0)
VS = GCFG.voxel_size


def _grids_with(vox, dist, weight):
    """(JAX grid, port grid) holding the given voxels' dist and weight."""
    grid = jvg.create(GCFG)
    vox = np.asarray(vox, np.int32)
    grid = jvg.ensure_blocks(grid, jnp.asarray(vox), jnp.ones(len(vox), bool), GCFG)
    lin, present = jvg.lookup_voxels(grid, jnp.asarray(vox), GCFG)
    assert np.all(np.asarray(present))
    lin = np.asarray(lin)
    d = np.array(jvg.flat_field(grid.dist))
    w = np.array(jvg.flat_field(grid.weight))
    d[lin] = dist
    w[lin] = weight
    grid = grid._replace(dist=jnp.asarray(d).reshape(grid.dist.shape),
                         weight=jnp.asarray(w).reshape(grid.weight.shape))
    return grid, interop.grid_from_numpy(
        {k: np.asarray(v) for k, v in grid._asdict().items()})


CORNERS = [[i, j, k] for i in range(2) for j in range(2) for k in range(2)]


def test_trilinear_interpolation_matches_oracle():
    """8-corner cell with a linear field: interpolation must be exact."""
    # linear field f(x,y,z) = 2x + 3y - z (in voxel units)
    dist = np.array([2 * c[0] + 3 * c[1] - c[2] for c in CORNERS], np.float32) * VS
    _, grid = _grids_with(CORNERS, dist, np.ones(8))
    p = torch.tensor([0.3, 0.6, 0.2]) * VS
    phi, grad, valid = tq.tsdf_trilinear(grid, p, GCFG, FCFG)
    assert bool(valid)
    assert abs(float(phi) - (2 * 0.3 + 3 * 0.6 - 0.2) * VS) < 1e-6
    np.testing.assert_allclose(grad.numpy(), [2.0, 3.0, -1.0], atol=1e-4)


def test_trilinear_partial_and_missing():
    _, grid = _grids_with([[0, 0, 0]], [0.01], [1.0])
    T = FCFG.trunc_voxels * VS
    # some of the 8 corners observed -> 0, invalid
    phi, g, valid = tq.tsdf_trilinear(grid, torch.tensor([[0.02, 0.02, 0.02]]),
                                      GCFG, FCFG)
    assert not bool(valid[0])
    assert float(phi[0]) == 0.0 and not g.any()
    # far away: no corner -> -T (extrapolation), invalid
    phi2, g2, valid2 = tq.tsdf_trilinear(grid, torch.tensor([[5.0, 5.0, 5.0]]),
                                         GCFG, FCFG)
    assert not bool(valid2[0]) and not g2.any()
    np.testing.assert_allclose(float(phi2[0]), -T, atol=1e-6)


def test_weights_trilinear_requires_all_corners():
    _, grid = _grids_with(CORNERS, np.zeros(8), np.arange(1.0, 9.0))
    p = torch.tensor([[0.5, 0.5, 0.5]]) * VS
    assert float(tq.weights_trilinear(grid, p, GCFG)[0]) == 1.0  # min corner weight
    _, grid2 = _grids_with(CORNERS[:7], np.zeros(7), np.ones(7))
    assert float(tq.weights_trilinear(grid2, p, GCFG)[0]) == 0.0


def test_corner_order_is_x_major():
    """A field that is 1 at corner (1, 0, 0) only: the value at a point is
    that corner's weight fx (1 - fy) (1 - fz)."""
    dist = np.array([1.0 if c == [1, 0, 0] else 0.0 for c in CORNERS], np.float32)
    _, grid = _grids_with(CORNERS, dist, np.ones(8))
    phi, grad, valid = tq.tsdf_trilinear(
        grid, torch.tensor([0.7, 0.2, 0.4]) * VS, GCFG, FCFG)
    assert bool(valid)
    np.testing.assert_allclose(float(phi), 0.7 * 0.8 * 0.6, atol=1e-6)
    np.testing.assert_allclose(grad.numpy() * VS,
                               [0.8 * 0.6, -0.7 * 0.6, -0.7 * 0.8], atol=1e-5)


@pytest.fixture(scope="module")
def random_grids():
    """A 12^3 voxel cube straddling block borders and the origin, ~85% of
    its voxels observed (weight > 0), smooth dist plus noise."""
    rng = np.random.default_rng(31)
    r = np.arange(-5, 7)
    vox = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    dist = (0.03 * vox[:, 0] - 0.02 * vox[:, 1] + 0.01 * vox[:, 2]
            + 0.01 * rng.standard_normal(len(vox))).astype(np.float32)
    weight = np.where(rng.random(len(vox)) < 0.85,
                      rng.uniform(0.5, 9.0, len(vox)), 0.0).astype(np.float32)
    return _grids_with(vox, dist, weight)


def test_trilinear_matches_jax_on_random_points(random_grids):
    jg, tg = random_grids
    rng = np.random.default_rng(32)
    pts = np.concatenate([
        rng.uniform(-6.5, 7.5, (4000, 3)) * VS,        # in and around the cube
        rng.uniform(-3.0, 3.0, (500, 3)),              # mostly far outside
        rng.integers(-5, 7, (500, 3)) * VS,            # exactly on voxel centres
    ]).astype(np.float32)
    jphi, jgrad, jvalid = jq.tsdf_trilinear(jg, jnp.asarray(pts), GCFG, FCFG)
    tphi, tgrad, tvalid = tq.tsdf_trilinear(tg, torch.from_numpy(pts), GCFG, FCFG)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    n_valid = int(tvalid.sum())
    assert 300 < n_valid < len(pts) - 300
    np.testing.assert_allclose(tphi.numpy(), np.asarray(jphi), atol=1e-6)
    np.testing.assert_allclose(tgrad.numpy() * VS, np.asarray(jgrad) * VS, atol=1e-6)
    # all three outcomes occur: interpolated, extrapolated (-T), partial (0)
    T = FCFG.trunc_voxels * VS
    assert (np.abs(tphi.numpy()[~tvalid.numpy()] + T) < 1e-6).sum() > 100
    assert (tphi.numpy()[~tvalid.numpy()] == 0.0).sum() > 100
    np.testing.assert_allclose(
        tq.weights_trilinear(tg, torch.from_numpy(pts), GCFG).numpy(),
        np.asarray(jq.weights_trilinear(jg, jnp.asarray(pts), GCFG)), atol=1e-6)


def test_trilinear_keeps_leading_dimensions(random_grids):
    jg, tg = random_grids
    pts = np.random.default_rng(33).uniform(-0.2, 0.3, (5, 7, 3)).astype(np.float32)
    tphi, tgrad, tvalid = tq.tsdf_trilinear(tg, torch.from_numpy(pts), GCFG, FCFG)
    assert tphi.shape == (5, 7) and tgrad.shape == (5, 7, 3) and tvalid.shape == (5, 7)
    jphi, jgrad, _ = jq.tsdf_trilinear(jg, jnp.asarray(pts), GCFG, FCFG)
    np.testing.assert_allclose(tphi.numpy(), np.asarray(jphi), atol=1e-6)
    np.testing.assert_allclose(tgrad.numpy() * VS, np.asarray(jgrad) * VS, atol=1e-6)
    assert tq.weights_trilinear(tg, torch.from_numpy(pts), GCFG).shape == (5, 7)
