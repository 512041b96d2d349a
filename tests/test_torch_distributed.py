"""The port's multi-host entry point (`parallel/distributed.py`) in 4 OS
processes, started the way torchrun starts them (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK, LOCAL_RANK, LOCAL_WORLD_SIZE) as two "hosts" of 2 ranks,
gloo on the CPU. `global_mesh()` puts the hosts on the block axis, so the
grid's storage is sharded across them. The ranks (tests/torch_mesh_worker.py
run as a script, torch only) fuse two frames, render and track, as
tests/distributed_worker.py does for the JAX package; this test holds the
results to the JAX package's fusion and to the port's single-device render
and tracker on the same map.

Tolerances: fusion as in test_torch_parallel.py (JAX fusion with the
port's normals); the render bit-equal to the port's unsharded render of
the gathered map; tracking against the port's single-device tracker on the
same map: the same iteration count and poses to 5e-4 (tests/
distributed_worker.py's gate: the residual sums are split over ranks).
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gradient_sdf_tpu.config import FusionConfig, GridConfig, TrackerConfig
from gradient_sdf_tpu.data import synth
from gradient_sdf_tpu.ops import fusion, normals
from gradient_sdf_tpu.ops import voxel_grid as vg
from gradient_sdf_tpu_torch.models import tracker as ttracker
from gradient_sdf_tpu_torch.ops import normals as tnorm
from gradient_sdf_tpu_torch.ops import raycast as trc
from gradient_sdf_tpu_torch.utils import interop

W, H = 64, 48
K = np.array([[52.5, 0, 31.5], [0, 52.5, 23.5], [0, 0, 1]], np.float32)
GCFG = GridConfig(voxel_size=0.02, num_blocks=2048)
FCFG = FusionConfig(trunc_voxels=5.0)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def frames():
    world = synth.SphereWorld(
        centers=jnp.asarray([[0.0, 0.0, 0.0], [0.3, 0.2, -0.1]], jnp.float32),
        radii=jnp.asarray([0.25, 0.15], jnp.float32),
    )
    out = []
    for R, t in synth.orbit_poses(n=4, radius=1.5)[:2]:
        d = synth.render_depth(world, jnp.asarray(R), jnp.asarray(t), K, W, H)
        out.append((np.array(d), np.asarray(R), np.asarray(t)))
    return out


@pytest.fixture(scope="module")
def ranks(frames, tmp_path_factory):
    """Start the 4 ranks, wait (bounded), and read their results."""
    import dataclasses

    out = str(tmp_path_factory.mktemp("dist"))
    with open(os.path.join(out, "inputs.pkl"), "wb") as f:
        pickle.dump({"K": K, "W": W, "H": H, "frames": frames,
                     "gcfg": dataclasses.asdict(GCFG),
                     "fcfg": dataclasses.asdict(FCFG)}, f)
    here = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(here, "torch_mesh_worker.py")
    port = _free_port()
    procs = []
    for rank in range(4):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="4", RANK=str(rank), LOCAL_RANK=str(rank % 2),
                   LOCAL_WORLD_SIZE="2", OMP_NUM_THREADS="1",
                   PYTHONPATH=os.path.dirname(here))
        procs.append(subprocess.Popen(
            [sys.executable, worker, out], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, env=env, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"
    results = []
    for rank in range(4):
        with open(os.path.join(out, f"rank{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def test_global_mesh_puts_hosts_on_the_block_axis(ranks):
    for rank, r in enumerate(ranks):
        assert r["shape"] == (2, 2)
        # host = rank // 2 is the block index, the local rank the ray index
        assert r["position"] == (rank % 2, rank // 2)
        assert r["rows"] == [GCFG.num_blocks // 2] * 2


def test_fusion_across_hosts_matches_jax(ranks, frames, monkeypatch):
    tc = tnorm.build_cache(W, H, K, window=5, device="cpu")

    def port_normals(cache, depth):
        def host(d):
            return tnorm.compute_normals(tc, torch.from_numpy(np.array(d))).numpy()

        return jax.pure_callback(
            host, jax.ShapeDtypeStruct(tuple(depth.shape) + (3,), jnp.float32),
            depth)

    monkeypatch.setattr(fusion, "compute_normals", port_normals)
    cache = normals.build_cache(W, H, K, window=5)
    ref = vg.create(GCFG)
    for d, R, t in frames:
        ref = fusion.fuse_frame(ref, jnp.asarray(d), cache, jnp.asarray(R),
                                jnp.asarray(t), GCFG, FCFG)
    want = {k: np.asarray(v) for k, v in ref._asdict().items()}
    for r in ranks:
        got = r["grid"]
        for k in ("directory", "num_active", "block_coords"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got["weight"], want["weight"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["dist"], want["dist"], rtol=1e-4,
                                   atol=1e-6)


def test_render_across_hosts_equals_the_unsharded_render(ranks, frames):
    _, R, t = frames[1]
    grid = interop.grid_from_numpy(ranks[0]["grid"])
    d, n, h = trc.render_depth_normal(grid, K, R, t, W, H, GCFG, FCFG,
                                      s_max=2.5, prior_stride=0, max_steps=48)
    assert int(h.sum()) > 100
    for r in ranks:
        for a, b in zip(r["render"], (d.numpy(), n.numpy(), h.numpy())):
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_tracking_across_hosts_matches_the_local_tracker(ranks, frames):
    (_, R0, t0), (d1, _, _) = frames
    grid = interop.grid_from_numpy(ranks[0]["grid"])
    res = ttracker.track_frame(grid, torch.from_numpy(d1), K,
                               torch.from_numpy(R0), torch.from_numpy(t0),
                               GCFG, FCFG, TrackerConfig(num_iterations=5))
    for r in ranks:
        R, t, iters = r["track"]
        assert iters == res.num_iters
        assert np.abs(R - res.R.numpy()).max() < 5e-4
        assert np.abs(t - res.t.numpy()).max() < 5e-4
