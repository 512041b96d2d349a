"""Rank workers for the port's multi-device tests.

This module imports torch and the port only: a rank started with the spawn
method imports the module of its target to unpickle it, and the test files
(and `tests/conftest.py`) import JAX. Inputs come from the tests as numpy
arrays; results go back as numpy arrays (rank 0's return value), and the
tests hold them to the JAX package's.

Run as a script it is one rank of a torchrun-style group
(`tests/test_torch_distributed.py`): `python torch_mesh_worker.py OUT_DIR`
with MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK and
LOCAL_WORLD_SIZE set, inputs in OUT_DIR/inputs.pkl.
"""

import contextlib
import os
import pickle
import sys

import numpy as np
import torch


# (GN iterations, start pose, step gate) of frame 1's track-and-fuse: from
# its own pose under a loose gate the first step converges and the frame is
# fused (64x48 sits above the 1e-3 gate's noise floor); from frame 0's pose
# one iteration does not converge, and the frame is not fused
TRACK_AND_FUSE = ((5, 1, 1.0), (1, 0, 1e-3))


def _quiet():
    """The ranks' prints go nowhere (the tests read return values)."""
    return contextlib.redirect_stdout(open(os.devnull, "w"))


def _cfgs(inputs):
    from gradient_sdf_tpu_torch.config import (FusionConfig, GridConfig,
                                               TrackerConfig)

    return (GridConfig(**inputs["gcfg"]), FusionConfig(**inputs["fcfg"]),
            TrackerConfig)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _host_grid(grid):
    from gradient_sdf_tpu_torch.utils import interop

    return interop.grid_to_numpy(grid)


def _fuse_sharded(mesh, frames, cache, gcfg, fcfg, **kw):
    """Frames fused from an empty grid into a sharded one; the whole grid
    after each frame's shard rows are recorded."""
    from gradient_sdf_tpu_torch.ops import voxel_grid as vg
    from gradient_sdf_tpu_torch.parallel import sharding

    grid = sharding.shard_grid(mesh, vg.create(gcfg, "cpu"))
    rows = []
    for depth, R, t in frames:
        grid = sharding.sharded_fuse_frame(mesh, grid, _t(depth), cache, _t(R),
                                           _t(t), gcfg, fcfg, **kw)
        rows.append(grid.dist.shape[0])
    return grid, rows


def parallel_cases(inputs):
    """Every case of tests/test_torch_parallel.py on this rank (4 ranks on
    the CPU); returns a dict of numpy results."""
    torch.set_num_threads(1)
    with _quiet():
        return _parallel_cases(inputs)


def _parallel_cases(inputs):
    from gradient_sdf_tpu_torch import config as cfg_mod
    from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap
    from gradient_sdf_tpu_torch.ops import normals
    from gradient_sdf_tpu_torch.parallel import mesh as mesh_mod
    from gradient_sdf_tpu_torch.parallel import sharding
    from gradient_sdf_tpu_torch.utils import interop

    gcfg, fcfg, TrackerConfig = _cfgs(inputs)
    K, W, H = inputs["K"], inputs["W"], inputs["H"]
    frames = inputs["frames"]
    cache = normals.build_cache(W, H, K, window=5, device="cpu")
    meshes = {bp: mesh_mod.make_mesh(4, bp, "cpu") for bp in (1, 2, 4)}
    out = {}

    # layouts: every rank's (ray, block) position
    for bp, mesh in meshes.items():
        me = torch.tensor([[mesh.rank, mesh.ray_index, mesh.block_index]])
        out[f"layout{bp}"] = mesh_mod.all_gather_rows(me, mesh, mesh_mod.WORLD,
                                                      n=4).numpy()

    # collectives: uneven gathers keep every bit (-0.0 too), scatter rows
    mesh = meshes[2]
    x = torch.tensor([-0.0, 1.5, float("inf"), -2.25, 3.0, -0.0, 7.0])
    mine = mesh_mod.shard_rows(7, mesh)
    before = (mesh_mod.calls, mesh_mod.nbytes)
    out["gathered"] = mesh_mod.all_gather_rows(x[mine].clone(), mesh,
                                               mesh_mod.WORLD, n=7).numpy()
    out["gather_count"] = (mesh_mod.calls - before[0],
                           mesh_mod.nbytes - before[1])
    rows = torch.arange(8, dtype=torch.float32).reshape(4, 2) * (mesh.rank + 1)
    kept = mesh_mod.psum_scatter_rows(rows, mesh, mesh_mod.BLOCK_AXIS,
                                      sum_axes=mesh_mod.WORLD)
    out["scatter_rows"] = mesh_mod.all_gather_rows(
        kept.contiguous(), mesh, mesh_mod.WORLD).numpy()

    # fusion, three layouts (one frame from an empty grid)
    for bp, mesh in meshes.items():
        grid, _ = _fuse_sharded(mesh, frames[:1], cache, gcfg, fcfg)
        out[f"fusion{bp}"] = _host_grid(sharding.gather_grid(mesh, grid))

    # tracking on the JAX map of three frames, ray axis 2, block axis 2
    mesh = meshes[2]
    grid3 = interop.grid_from_numpy(inputs["grid3"])
    tcfg = TrackerConfig(num_iterations=5)
    d1, R1, t1 = frames[1]
    res = sharding.sharded_track_frame(mesh, sharding.shard_grid(mesh, grid3),
                                       _t(d1), K, _t(R1), _t(t1), gcfg, fcfg,
                                       tcfg)
    out["track"] = (res.R.numpy(), res.t.numpy(), res.num_iters,
                    res.converged)

    # one track-and-fuse frame on the JAX map of three frames (the cases of
    # TRACK_AND_FUSE: converged and fused, or not converged and not fused)
    for iters, start, conv in TRACK_AND_FUSE:
        _, R, t = frames[start]
        shard = sharding.shard_grid(mesh, grid3)
        shard, res = sharding.sharded_track_and_fuse_frame(
            mesh, shard, _t(d1), K, _t(R), _t(t), cache, gcfg, fcfg,
            TrackerConfig(num_iterations=iters, conv_threshold=conv))
        out[f"track_and_fuse{iters}"] = (
            res.R.numpy(), res.t.numpy(), res.converged,
            _host_grid(sharding.gather_grid(mesh, shard)))

    # one BA alternation, voxel axis over the 4 ranks
    from gradient_sdf_tpu_torch.config import PhotoBAConfig, GridConfig

    problem = interop.problem_from_numpy(inputs["ba_problem"], "cpu")
    state = interop.state_from_numpy(inputs["ba_state"], "cpu")
    p_l, s_l = sharding.shard_ba(mesh, problem, state)
    s_l, e_pose, e_dist = sharding.sharded_ba_step(
        mesh, p_l, s_l, GridConfig(**inputs["ba_gcfg"]),
        PhotoBAConfig(**inputs["ba_pcfg"]))
    out["ba"] = (interop.state_to_numpy(sharding.gather_ba_state(mesh, s_l)),
                 float(e_pose), float(e_dist))

    # resident shards: nb/4 rows through three frames, then tracking
    # against the sharded volume
    mesh = meshes[4]
    grid, rows = _fuse_sharded(mesh, frames, cache, gcfg, fcfg)
    tcfg4 = TrackerConfig(num_iterations=4)
    res = sharding.sharded_track_frame(mesh, grid, _t(d1), K, _t(R1), _t(t1),
                                       gcfg, fcfg, tcfg4)
    out["resident"] = (rows, _host_grid(sharding.gather_grid(mesh, grid)),
                       res.R.numpy(), res.t.numpy())

    # renders, three layouts, of the JAX map of three frames at pose 1
    for bp, mesh in meshes.items():
        d, n, h = sharding.sharded_render_depth_normal(
            mesh, sharding.shard_grid(mesh, grid3), K, R1, t1, W, H, gcfg,
            fcfg, s_max=2.5)
        out[f"render{bp}"] = (d.numpy(), n.numpy(), h.numpy())

    # the active-prefix render of the map of two frames at pose 0, and a
    # cap below num_active
    mesh = meshes[2]
    grid2 = sharding.shard_grid(mesh, interop.grid_from_numpy(inputs["grid2"]))
    d0, R0, t0 = frames[0]
    before = (mesh_mod.calls, mesh_mod.nbytes)
    d, n, h = sharding.sharded_render_depth_normal(
        mesh, grid2, K, R0, t0, W, H, gcfg, fcfg, s_max=2.5, active_cap=128)
    out["active_cap"] = (d.numpy(), n.numpy(), h.numpy(),
                         mesh_mod.calls - before[0],
                         mesh_mod.nbytes - before[1])
    na = int(grid2.num_active)
    try:
        sharding.sharded_render_depth_normal(
            mesh, grid2, K, R0, t0, W, H, gcfg, fcfg, s_max=2.5,
            active_cap=na - 1)
        out["cap_below"] = None
    except ValueError as e:
        out["cap_below"] = str(e)

    # compact fusion at two caps (1 forces the full path), bytes per frame
    for cap in (256, 1):
        before = (mesh_mod.calls, mesh_mod.nbytes)
        grid, _ = _fuse_sharded(mesh, frames, cache, gcfg, fcfg,
                                touched_cap=cap)
        moved = (mesh_mod.calls - before[0], mesh_mod.nbytes - before[1])
        out[f"touched{cap}"] = (_host_grid(sharding.gather_grid(mesh, grid)),
                                *moved)

    # the collective of one frame at touched_cap=128
    before = (mesh_mod.calls, mesh_mod.nbytes)
    _fuse_sharded(mesh, frames[:1], cache, gcfg, fcfg, touched_cap=128)
    out["cap128"] = (mesh_mod.calls - before[0], mesh_mod.nbytes - before[1])

    # replicated-state check: passes, then catches one rank's difference
    sharding.check_replicated(mesh, grid2, R0, t0, flags=(True, 3))
    bad = grid2._replace(directory=grid2.directory.clone())
    if mesh.rank == 1:
        bad.directory[0] = 7
    try:
        sharding.check_replicated(mesh, bad, R0, t0)
        out["divergence"] = None
    except RuntimeError as e:
        out["divergence"] = str(e)

    # capacity and world-range growth of a map on the mesh
    cfg = cfg_mod.PipelineConfig(grid=GridConfig(**inputs["growth_gcfg"]))
    m = GradSdfMap(cfg, device="cpu")
    m.attach_mesh(mesh)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    for _ in range(3):
        m.update(inputs["growth_depth"], K, (eye, zero))
    out["growth"] = (m.growth_events, m.cfg.grid.num_blocks,
                     m.cfg.grid.dir_dim, m.grid.dist.shape[0],
                     m.acc, _host_grid(m.full_grid()))
    return out if mesh.rank == 0 else None


def fail_on_rank_1():
    """A rank that raises (the group must fail, not hang)."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    dist.barrier()


def photoba_rank(argv):
    """One rank of `photoba --sharded-ba` inside a launched group."""
    torch.set_num_threads(1)
    from gradient_sdf_tpu_torch.apps import photoba

    with _quiet():
        return photoba.main(argv)


def distributed_cases(inputs):
    """Fusion, render and tracking on the global mesh of a torchrun-style
    group (`parallel.distributed`): block axis over the "hosts"."""
    from gradient_sdf_tpu_torch.ops import normals
    from gradient_sdf_tpu_torch.parallel import distributed, sharding

    gcfg, fcfg, TrackerConfig = _cfgs(inputs)
    K, W, H = inputs["K"], inputs["W"], inputs["H"]
    frames = inputs["frames"]
    mesh = distributed.global_mesh(device="cpu")
    cache = normals.build_cache(W, H, K, window=5, device="cpu")
    grid, rows = _fuse_sharded(mesh, frames[:2], cache, gcfg, fcfg)
    full = sharding.gather_grid(mesh, grid)
    d1, R1, t1 = frames[1]
    render = sharding.sharded_render_depth_normal(
        mesh, grid, K, R1, t1, W, H, gcfg, fcfg, s_max=2.5, max_steps=48)
    d0, R0, t0 = frames[0]
    res = sharding.sharded_track_frame(
        mesh, grid, _t(d1), K, _t(R0), _t(t0), gcfg, fcfg,
        TrackerConfig(num_iterations=5))
    return {"shape": mesh.shape, "position": (mesh.ray_index, mesh.block_index),
            "rows": rows, "grid": _host_grid(full),
            "render": tuple(a.numpy() for a in render),
            "track": (res.R.numpy(), res.t.numpy(), res.num_iters)}


def main(out_dir):
    from gradient_sdf_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    assert distributed.init(device="cpu", timeout_s=240)
    try:
        with _quiet():
            out = distributed_cases(inputs)
    finally:
        torch.distributed.destroy_process_group()
    rank = int(os.environ["RANK"])
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
