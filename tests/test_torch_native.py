"""The port's host runtime against the JAX package's native library
(`gradient_sdf_tpu/native`): the first-occurrence vertex dedup
(`ops/marching_cubes.dedup_vertices`, C in `native/dedup.c`) id for id, and
the port's numpy PLY writers byte for byte against the JAX native writers.

The dedup is also held to its plain Python twin, which needs no JAX
library; the comparisons with the JAX library skip where it cannot be
built. Every comparison is exact: the same keys, the same ids, the same
bytes.
"""

import numpy as np
import pytest

from gradient_sdf_tpu import native as jnative
from gradient_sdf_tpu_torch.ops import marching_cubes as tmc
from gradient_sdf_tpu_torch.utils import ply as tply

QUANTUM = 0.02 * 1e-4   # extract_mesh's: voxel size x 1e-4


def _verts(case):
    rng = np.random.default_rng({"random": 0, "ties": 1, "negative": 2,
                                 "ties_quantum": 3}[case])
    if case == "random":
        # a soup: each vertex repeated, shuffled, as neighbouring cubes emit it
        v = (rng.random((3000, 3)) * 2 - 1).astype(np.float32)
        v = np.concatenate([v, v[rng.integers(0, len(v), 6000)]])
        return v[rng.permutation(len(v))], QUANTUM
    if case == "ties":
        # coordinates exactly half a quantum off the lattice, either sign:
        # round half away from zero (llround), not numpy's half to even
        k = rng.integers(-40, 40, (2000, 3))
        v = np.concatenate([(k + 0.5) * 0.25, k * 0.25, (k - 0.5) * 0.25])
        return v[rng.permutation(len(v))].astype(np.float32), 0.25
    if case == "negative":
        v = -(rng.random((2000, 3)) * 0.01).astype(np.float32)
        return np.concatenate([v, v[::-1], v + np.float32(1e-7)]), QUANTUM
    # near-ties at the real quantum, whose inverse is not exact in double
    k = rng.integers(-10**5, 10**5, (3000, 3))
    return np.concatenate([((k + 0.5) * QUANTUM).astype(np.float32),
                           (k * QUANTUM).astype(np.float32)]), QUANTUM


CASES = ["random", "ties", "negative", "ties_quantum"]


@pytest.mark.parametrize("case", CASES)
def test_dedup_matches_plain_twin(case):
    v, q = _verts(case)
    u, index_map, first = tmc.dedup_vertices(v, q)
    pu, pmap, pfirst = tmc.dedup_vertices_reference(v, q)
    np.testing.assert_array_equal(index_map, pmap)
    np.testing.assert_array_equal(first, pfirst)
    np.testing.assert_array_equal(u, pu)
    assert u.dtype == np.float32 and index_map.dtype == np.int32
    # ids in order of first occurrence, and each unique vertex is its first
    assert np.array_equal(np.unique(index_map, return_index=True)[1], first)
    np.testing.assert_array_equal(u, v[first])
    assert 0 < len(u) < len(v)


@pytest.mark.parametrize("case", CASES)
def test_dedup_matches_jax_native(case):
    if not jnative.available():
        pytest.skip("the JAX package's native library cannot be built here")
    v, q = _verts(case)
    u, index_map, _ = tmc.dedup_vertices(v, q)
    ju, jmap = jnative.dedup_vertices(v, q)
    np.testing.assert_array_equal(index_map, jmap)
    np.testing.assert_array_equal(u, ju)


def test_dedup_empty_and_single():
    u, index_map, first = tmc.dedup_vertices(np.zeros((0, 3), np.float32), QUANTUM)
    assert u.shape == (0, 3) and index_map.shape == (0,) and first.shape == (0,)
    v = np.array([[0.1, -0.2, 0.3]], np.float32)
    u, index_map, first = tmc.dedup_vertices(v, QUANTUM)
    np.testing.assert_array_equal(u, v)
    assert index_map.tolist() == [0] and first.tolist() == [0]


def _cloud(n=257, seed=4):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    col = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    return pts, nrm, col


@pytest.mark.parametrize("normals", [False, True])
@pytest.mark.parametrize("colors", [False, True])
def test_ply_points_bytes_equal_jax_native(tmp_path, normals, colors):
    if not jnative.available():
        pytest.skip("the JAX package's native library cannot be built here")
    pts, nrm, col = _cloud()
    a, b = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    assert tply.save_point_cloud_ply(a, pts, nrm if normals else None,
                                     col if colors else None)
    assert jnative.write_ply_points(b, pts, nrm if normals else None,
                                    col if colors else None)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("colors", [False, True])
def test_ply_mesh_bytes_equal_jax_native(tmp_path, colors):
    if not jnative.available():
        pytest.skip("the JAX package's native library cannot be built here")
    pts, _, col = _cloud(n=300, seed=6)
    faces = np.random.default_rng(7).integers(0, 300, (411, 3)).astype(np.int32)
    a, b = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    assert tply.save_mesh_ply(a, pts, faces, col if colors else None)
    assert jnative.write_ply_mesh(b, pts, faces, col if colors else None)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
