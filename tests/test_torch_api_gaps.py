"""Five small public functions of the port against the JAX package's, on
the CPU: `ops/voxel_grid.voxel_to_point` and `lookup_coarse`,
`utils/se3.identity`, `utils/tumio.ate_rmse` and
`utils/logging_util.MetricsRecorder`.

The same numpy inputs, made from a seed, go through both packages. Integer
and boolean results are compared exactly; `voxel_to_point` bit for bit (one
float32 product); `ate_rmse` to rtol 1e-12 (both run the same float64
numpy code on the same float32 inputs).
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradient_sdf_tpu.config import GridConfig
from gradient_sdf_tpu.ops import voxel_grid as jvg
from gradient_sdf_tpu.utils import logging_util as jlog
from gradient_sdf_tpu.utils import se3 as jse3
from gradient_sdf_tpu.utils import tumio as jtum
from gradient_sdf_tpu_torch import config as tcfg_mod
from gradient_sdf_tpu_torch.ops import voxel_grid as tvg
from gradient_sdf_tpu_torch.utils import logging_util as tlog
from gradient_sdf_tpu_torch.utils import se3 as tse3
from gradient_sdf_tpu_torch.utils import tumio as ttum

# a directory of 16^3 blocks of 8^3 voxels: 4^3 coarse cells of 32 voxels,
# the volume spans voxels [-64, 64) on each axis
CFG = GridConfig(voxel_size=0.02, dir_dim=16, num_blocks=64)
TCFG = tcfg_mod.GridConfig(**dataclasses.asdict(CFG))
CELL = CFG.block_shape * jvg.COARSE_FACTOR


def _grids():
    """Blocks around the origin and at negative coordinates, allocated in
    both packages from the same voxels."""
    vox = np.array([[0, 0, 0], [-1, -1, -1], [-33, 5, 40], [31, -32, -64],
                    [63, 63, 63], [-64, 0, 17]], np.int32)
    jg = jvg.ensure_blocks(jvg.create(CFG), jnp.asarray(vox),
                           jnp.ones(len(vox), bool), CFG)
    tg = tvg.ensure_blocks(tvg.create(TCFG, "cpu"), torch.from_numpy(vox),
                           torch.ones(len(vox), dtype=torch.bool), TCFG)
    return jg, tg


def _points(kind, rng):
    vs = CFG.voxel_size
    if kind == "random":   # inside and outside the volume, both signs
        return rng.uniform(-1.6, 1.6, (400, 3))
    if kind == "negative":  # negative voxel indices, which must floor
        return rng.randint(-70, 0, (400, 3)) * vs
    if kind == "outside":   # beyond +-64 voxels on one axis
        p = rng.uniform(-1.2, 1.2, (300, 3))
        p[:100, 0] = rng.uniform(1.29, 3.0, 100)
        p[100:200, 1] = rng.uniform(-3.0, -1.29, 100)
        p[200:, 2] = 64 * vs
        return p
    # block and coarse-cell planes: voxel indices on both sides of each
    # multiple of the coarse cell, and of a block edge
    planes = np.arange(-2, 3) * CELL
    idx = np.concatenate([planes, planes - 1, planes + 1, planes + 8,
                          planes - 8])
    g = np.stack(np.meshgrid(idx, idx, idx, indexing="ij"), -1)
    return g.reshape(-1, 3) * vs


@pytest.mark.parametrize("kind", ["random", "negative", "outside", "plane"])
def test_lookup_coarse_matches_jax(kind):
    jg, tg = _grids()
    np.testing.assert_array_equal(tg.coarse_occ.numpy(), np.asarray(jg.coarse_occ))
    pts = _points(kind, np.random.RandomState(31)).astype(np.float32)
    want = np.asarray(jvg.lookup_coarse(jg, jnp.asarray(pts), CFG))
    got = tvg.lookup_coarse(tg, torch.from_numpy(pts), TCFG)
    assert got.dtype == torch.bool and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "outside":
        assert not want.any()
    elif kind != "random":
        assert want.any() and not want.all()


def test_lookup_coarse_keeps_leading_axes():
    jg, tg = _grids()
    pts = np.random.RandomState(32).uniform(-1.0, 1.0, (5, 7, 3)).astype(np.float32)
    want = np.asarray(jvg.lookup_coarse(jg, jnp.asarray(pts), CFG))
    got = tvg.lookup_coarse(tg, torch.from_numpy(pts), TCFG)
    assert got.shape == (5, 7)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.int32, np.int16, np.int8])
def test_voxel_to_point_matches_jax(dtype):
    vox = np.random.RandomState(33).randint(-100, 100, (50, 3)).astype(dtype)
    want = np.asarray(jvg.voxel_to_point(jnp.asarray(vox), 0.013))
    got = tvg.voxel_to_point(torch.from_numpy(vox), 0.013)
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_identity_matches_jax(dtype):
    jR, jt = jse3.identity(getattr(jnp, dtype))
    tR, tt = tse3.identity(getattr(torch, dtype))
    for g, w in ((tR, jR), (tt, jt)):
        assert str(g.dtype) == f"torch.{w.dtype}" and g.shape == w.shape
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))
    R, t = tse3.identity(device="cpu")
    assert R.dtype == torch.float32 and R.device.type == "cpu"
    assert torch.equal(R, torch.eye(3)) and torch.equal(t, torch.zeros(3))


def _trajectories(n, rng):
    """An estimate that is the truth moved rigidly, plus noise, with one
    stamp of each list that the other lacks."""
    gt_t = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    Rw = np.asarray(jse3.so3_exp(jnp.asarray(rng.randn(3).astype(np.float32))))
    est_t = (gt_t @ Rw.T + np.float32([0.3, -0.1, 0.2])
             + rng.randn(n, 3).astype(np.float32) * 0.01).astype(np.float32)
    eye = np.eye(3, dtype=np.float32)
    gt = [(f"{i:.4f}", eye, gt_t[i]) for i in range(n)] + [("99.0", eye, gt_t[0])]
    est = [(f"{i:.4f}", eye, est_t[i]) for i in range(n)] + [("98.0", eye, est_t[0])]
    return est, gt


@pytest.mark.parametrize("align", [True, False])
def test_ate_rmse_matches_jax(align):
    est, gt = _trajectories(12, np.random.RandomState(34))
    want = jtum.ate_rmse(est, gt, align=align)
    got = ttum.ate_rmse(est, gt, align=align)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # alignment removes the rigid motion and leaves the noise
    assert (got < 0.05) if align else (got > 0.1)


def test_ate_rmse_raises_below_three_matches():
    est, gt = _trajectories(2, np.random.RandomState(35))
    for fn in (jtum.ate_rmse, ttum.ate_rmse):
        with pytest.raises(ValueError, match="not enough matched"):
            fn(est, gt)
    est3, gt3 = _trajectories(3, np.random.RandomState(35))
    assert ttum.ate_rmse(est3, gt3) == pytest.approx(jtum.ate_rmse(est3, gt3),
                                                      rel=1e-12)


def test_metrics_recorder_dumps_like_jax(tmp_path):
    dumps = []
    for mod in (jlog, tlog):
        rec = mod.MetricsRecorder()
        assert rec.frames == [] and rec.run == {}
        rec.log_frame(frame=0, track_ms=1.5, fused=True)
        rec.set(dataset="synth", frames=2)
        rec.log_frame(frame=1, track_ms=None, wall_time=12.5)
        rec.set(frames=3, ate=0.004)
        assert isinstance(rec.frames[0]["wall_time"], float)
        path = tmp_path / f"{mod.__name__.split('.')[0]}.json"
        rec.dump(str(path))
        dumps.append((path.read_text(), json.loads(path.read_text())))
    (jtext, jd), (ttext, td) = dumps
    assert td["frames"][1]["wall_time"] == 12.5
    for d in (jd, td):
        d["frames"][0].pop("wall_time")
    assert td == jd
    assert list(td) == ["run", "frames"] and ttext.startswith('{\n  "run"')
