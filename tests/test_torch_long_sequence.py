"""The port's tracker and fusion on the noisy long sequence of
`tests/test_long_sequence.py`: a 60-frame third of an orbit at 160x120 with
disparity-domain Kinect noise and 16-bit quantization, tracked frame to
model, fusing only converged frames, gated on ATE RMSE.

The depth frames are the JAX test's, to the bit: rendered and noised by the
JAX package from `PRNGKey(7)` with the same key splits (the port draws its
noise from numpy, so only the JAX package can make these frames). The port
is held to the JAX test's bounds: ATE RMSE < 0.03 m (about 1.5 voxels) and
at most half the frames unconverged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradient_sdf_tpu.data import synth as jsynth
from gradient_sdf_tpu_torch.config import FusionConfig, GridConfig, TrackerConfig
from gradient_sdf_tpu_torch.models import tracker
from gradient_sdf_tpu_torch.ops import fusion, normals
from gradient_sdf_tpu_torch.ops import voxel_grid as vg
from gradient_sdf_tpu_torch.utils import ate

W, H = 160, 120
K = np.array([[132.0, 0, 79.5], [0, 132.0, 59.5], [0, 0, 1]], dtype=np.float32)
GCFG = GridConfig(voxel_size=0.02, num_blocks=8192)
FCFG = FusionConfig(trunc_voxels=5.0)
# the JAX test's stride and its 5e-3 gate (the 1e-3 gate is calibrated for
# dense 640x480 input; at 160x120 the GN noise floor sits near 4e-3)
TCFG = TrackerConfig(sampling=2, conv_threshold=5e-3)
N_FRAMES = 60


@pytest.fixture
def one_torch_thread():
    """A frame is a few hundred small operations on ~10k pixels: torch's
    thread pool gains nothing on them and, when several test processes
    share the cores, costs a barrier per operation."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_noisy_frames():
    """(depth frames, GT poses) of tests/test_long_sequence.py."""
    world = jsynth.SphereWorld(
        centers=jnp.asarray([[0.0, 0.0, 0.0], [0.3, 0.25, -0.1],
                             [-0.3, 0.1, 0.2], [0.1, -0.3, 0.15]], jnp.float32),
        radii=jnp.asarray([0.25, 0.14, 0.12, 0.16], jnp.float32),
    )
    poses = jsynth.orbit_poses(n=N_FRAMES, radius=1.3, arc=2.0 * np.pi / 3.0)
    render = jax.jit(lambda R, t: jsynth.render_depth(world, R, t, K, W, H))
    key = jax.random.PRNGKey(7)
    depths = []
    for R, t in poses:
        key, sub = jax.random.split(key)
        d = jsynth.add_kinect_noise(render(jnp.asarray(R), jnp.asarray(t)), sub)
        depths.append(np.asarray(jsynth.quantize_depth(d)))
    return depths, poses


def test_noisy_long_sequence_ate(one_torch_thread):
    depths, poses = _jax_noisy_frames()
    cache = normals.build_cache(W, H, K, window=5, device="cpu")
    grid = vg.create(GCFG, "cpu")
    acc = fusion.new_accumulator(grid)
    R_cur, t_cur = (torch.from_numpy(a) for a in poses[0])
    est, gt = [], []
    n_unconverged = 0
    for i, (depth, (R_gt, t_gt)) in enumerate(zip(depths, poses)):
        d = torch.from_numpy(depth)
        if i == 0:
            grid = fusion.fuse_frame(grid, d, cache, R_cur, t_cur, GCFG, FCFG,
                                     acc=acc)
        else:
            res = tracker.track_frame(grid, d, K, R_cur, t_cur, GCFG, FCFG, TCFG)
            R_cur, t_cur = res.R, res.t
            if res.converged:
                grid = fusion.fuse_frame(grid, d, cache, R_cur, t_cur, GCFG,
                                         FCFG, acc=acc)
            else:
                n_unconverged += 1
        est.append((0.1 * i, t_cur.numpy().copy()))
        gt.append((0.1 * i, t_gt))

    assert not bool(grid.overflow)
    assert n_unconverged <= N_FRAMES // 2
    res = ate.evaluate_ate(est, gt)
    assert res is not None and res.num_pairs == N_FRAMES
    assert res.rmse < 0.03, f"ATE regression: {res.rmse:.4f} m"
