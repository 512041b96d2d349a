"""Port checkpoint / resume (gradient_sdf_tpu_torch/utils/checkpoint.py and
`scan3d --checkpoint-every / --resume`) against the JAX package's format.

A file written by either package loads in the other, array for array (the
visibility words are uint32 in the file, int32 with the same bits in the
port's memory). The app's resume equivalence runs on the CPU, where fusion's
accumulator is the scatter's plain version (`index_add_`, one fixed order):
an interrupted-and-resumed run repeats the uninterrupted run's float
operations, so its poses are held to 1e-6 and its map to bit equality. On
the card float atomics reorder fusion's sums from run to run, and the same
comparison is held to a tolerance by `chip_smoke.py`.
"""

import dataclasses
import math
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gradient_sdf_tpu.config import GridConfig
from gradient_sdf_tpu.ops import voxel_grid as jvg
from gradient_sdf_tpu.utils import checkpoint as jckpt
from gradient_sdf_tpu_torch import config as tcfg_mod
from gradient_sdf_tpu_torch.apps import make_synth as tmake
from gradient_sdf_tpu_torch.apps import scan3d as tscan
from gradient_sdf_tpu_torch.models.grad_sdf import GradSdfMap
from gradient_sdf_tpu_torch.ops import voxel_grid as tvg
from gradient_sdf_tpu_torch.utils import checkpoint as tckpt
from gradient_sdf_tpu_torch.utils import interop, tumio

POSES = [("001", np.eye(3, dtype=np.float32), np.zeros(3, np.float32)),
         ("002", np.eye(3, dtype=np.float32), np.ones(3, np.float32))]


def _port_grid(gcfg, seed=0):
    """A grid with two blocks and seeded field values."""
    rng = np.random.default_rng(seed)
    grid = tvg.create(gcfg, "cpu")
    coords = torch.tensor([[1, 2, 3], [-4, 0, 5]], dtype=torch.int32)
    grid = tvg.insert_keys(grid, tvg.pack_key(coords, gcfg), gcfg)
    for name in ("dist", "weight", "grad_x", "grad_y", "grad_z"):
        getattr(grid, name)[:2] = torch.from_numpy(
            rng.standard_normal((2, gcfg.voxels_per_block)).astype(np.float32))
    return grid


def _vis(gcfg, seed=1):
    words = np.random.default_rng(seed).integers(
        0, 2**32, (gcfg.num_blocks, gcfg.voxels_per_block, 2), dtype=np.uint32)
    return words


def _same_cfg(a, b):
    """Equal geometry; each package has its own GridConfig class."""
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def test_format_version_matches_jax():
    assert tckpt.FORMAT_VERSION == jckpt.FORMAT_VERSION == 2


def test_state_roundtrip(tmp_path):
    gcfg = GridConfig(num_blocks=128)
    grid = _port_grid(gcfg)
    vis = interop.vis_from_numpy(_vis(gcfg))
    path = str(tmp_path / "state.npz")
    tckpt.save_state(path, grid, vis=vis, counter=2, poses=POSES, grid_cfg=gcfg,
                     extra={"note": np.arange(3)})
    assert not os.path.exists(path + ".tmp.npz")     # written, then renamed
    state = tckpt.load_state(path, device="cpu")
    assert int(state["grid"].num_active) == 2
    for k, v in grid._asdict().items():
        got = getattr(state["grid"], k)
        assert got.dtype == v.dtype and torch.equal(got, v), k
    assert state["vis"].dtype == torch.int32 and torch.equal(state["vis"], vis)
    assert state["counter"] == 2 and _same_cfg(state["grid_cfg"], gcfg)
    assert [p[0] for p in state["poses"]] == ["001", "002"]
    np.testing.assert_array_equal(state["poses"][1][2], np.ones(3))
    np.testing.assert_array_equal(np.load(path)["extra_note"], np.arange(3))
    # poses given as tensors are saved alike
    tckpt.save_state(path, grid, poses=[(s, torch.from_numpy(R), torch.from_numpy(t))
                                        for s, R, t in POSES])
    again = tckpt.load_state(path, device="cpu")
    np.testing.assert_array_equal(again["poses"][1][2], np.ones(3))
    assert again["vis"] is None and again["counter"] == 0


def test_file_written_by_the_port_loads_in_the_jax_package(tmp_path):
    gcfg = GridConfig(voxel_size=0.02, num_blocks=64, dir_dim=16)
    grid = _port_grid(gcfg, seed=3)
    words = _vis(gcfg)
    path = str(tmp_path / "port.npz")
    tckpt.save_state(path, grid, vis=interop.vis_from_numpy(words), counter=5,
                     poses=POSES, grid_cfg=gcfg)
    state = jckpt.load_state(path)
    want = interop.grid_to_numpy(grid)
    for k, v in state["grid"]._asdict().items():
        a = np.asarray(v)
        assert a.dtype == want[k].dtype, k
        np.testing.assert_array_equal(a, want[k], err_msg=k)
    assert np.asarray(state["vis"]).dtype == np.uint32
    np.testing.assert_array_equal(np.asarray(state["vis"]), words)
    assert state["counter"] == 5 and state["grid_cfg"] == gcfg
    assert state["poses"][1][0] == "002"
    np.testing.assert_array_equal(state["poses"][1][2], np.ones(3))
    # the restored JAX grid answers lookups
    lin, present = jvg.lookup_voxels(
        state["grid"], jvg.block_local_to_voxel(jnp.asarray([[1, 2, 3]], jnp.int32),
                                                gcfg), gcfg)
    assert np.all(np.asarray(present))


def test_file_written_by_the_jax_package_loads_in_the_port(tmp_path):
    gcfg = GridConfig(voxel_size=0.02, num_blocks=64, dir_dim=16)
    rng = np.random.default_rng(4)
    jgrid = jvg.create(gcfg)
    coords = jnp.asarray([[1, 2, 3], [-4, 0, 5]], jnp.int32)
    jgrid = jvg.insert_keys(jgrid, jvg.pack_key(coords, gcfg), gcfg)
    jgrid = jgrid._replace(**{
        k: jnp.asarray(rng.standard_normal(jgrid.dist.shape).astype(np.float32))
        for k in ("dist", "weight", "grad_x", "grad_y", "grad_z")})
    words = _vis(gcfg)
    path = str(tmp_path / "jax.npz")
    jckpt.save_state(path, jgrid, vis=jnp.asarray(words), counter=7, poses=POSES,
                     grid_cfg=gcfg)
    state = tckpt.load_state(path, device="cpu")
    got = interop.grid_to_numpy(state["grid"])
    for k, v in jgrid._asdict().items():
        assert got[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(interop.vis_to_numpy(state["vis"]), words)
    assert state["counter"] == 7 and _same_cfg(state["grid_cfg"], gcfg)
    assert state["poses"][0][0] == "001"
    # both loaders read the same file alike, and the port's copy is its own
    # (it updates grids in place)
    jstate = jckpt.load_state(path)
    np.testing.assert_array_equal(got["dist"], np.asarray(jstate["grid"].dist))
    state["grid"].dist.zero_()
    assert np.asarray(jckpt.load_state(path)["grid"].dist).any()


def test_grown_grid_config_roundtrip(tmp_path):
    """A checkpoint taken after directory growth restores the grown
    GridConfig (a stale dir_dim would mis-linearize every key on resume);
    a legacy file (no geometry) recovers it from the array shapes."""
    gcfg = GridConfig(voxel_size=0.02, num_blocks=128, dir_dim=16)
    grid = tvg.create(gcfg, "cpu")
    coords = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    grid = tvg.insert_keys(grid, tvg.pack_key(coords, gcfg), gcfg)
    grid, gcfg = tvg.grow_directory(grid, gcfg)  # dir_dim 16 -> 32
    path = str(tmp_path / "state.npz")
    tckpt.save_state(path, grid, counter=1, grid_cfg=gcfg)
    state = tckpt.load_state(path, device="cpu")
    gc = state["grid_cfg"]
    assert (gc.dir_dim, gc.num_blocks) == (32, 128)
    assert abs(gc.voxel_size - 0.02) < 1e-9
    lin, present = tvg.lookup_voxels(
        state["grid"], tvg.block_local_to_voxel(coords, gc), gc)
    assert bool(present.all())
    tckpt.save_state(path, grid, counter=1)
    for loader in (lambda p: tckpt.load_state(p, device="cpu"), jckpt.load_state):
        gc2 = loader(path)["grid_cfg"]
        assert (gc2.dir_dim, gc2.num_blocks, gc2.block_shape) == (32, 128, 8)
        assert math.isnan(gc2.voxel_size)


def test_map_restore_rebuilds_what_is_sized_to_the_grid(tmp_path):
    """A map created at the command line's geometry takes over a grown
    checkpoint: config, accumulator and the next fusion follow the restored
    geometry (a stale accumulator would be written through the wrong size)."""
    from gradient_sdf_tpu_torch.data import synth

    K = synth.KINECT_K.copy()
    K[:2] *= 0.1
    world = synth.SphereWorld(torch.tensor([[0.0, 0.0, 1.0]]), torch.tensor([0.3]))
    R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    depth = synth.render_depth(world, R, t, K, 64, 48).numpy()
    cfg = tcfg_mod.PipelineConfig()
    small = dataclasses.replace(cfg, grid=dataclasses.replace(
        cfg.grid, voxel_size=0.02, num_blocks=16, dir_dim=8),
        fusion=dataclasses.replace(cfg.fusion, normal_window=5))
    a = GradSdfMap(small, with_vis=True, device="cpu")
    for _ in range(3):
        a.update(depth, K, (R, t), kf_slot=1)
    assert {e["kind"] for e in a.growth_events} == {"capacity", "world_range"}
    assert a.cfg.grid != small.grid
    path = str(tmp_path / "grown.npz")
    tckpt.save_state(path, a.grid, vis=a.vis, counter=a.counter, grid_cfg=a.cfg.grid)

    b = GradSdfMap(small, with_vis=True, device="cpu")
    state = tckpt.load_state(path, device="cpu")
    b.restore(state["grid"], state["grid_cfg"], vis=state["vis"],
              counter=state["counter"])
    assert b.cfg.grid == a.cfg.grid and b.counter == 3
    assert b.acc.shape == a.acc.shape and not b.acc.any()
    assert torch.equal(b.vis, a.vis)
    a.update(depth, K, (R, t), kf_slot=2)
    b.update(depth, K, (R, t), kf_slot=2)
    for k, v in a.grid._asdict().items():
        assert torch.equal(getattr(b.grid, k), v), k
    assert torch.equal(b.vis, a.vis) and not b.acc.any()
    # a grid that does not fit the stated geometry is refused
    c = GradSdfMap(small, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        c.restore(state["grid"])


# ---------------------------------------------------------------------------
# the app
# ---------------------------------------------------------------------------

APP = ["--data-type", "synth", "--voxel-size", "0.02", "--trunc", "5",
       "--device", "cpu"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("data"))
    tmake.generate(out, frames=5, seed=2, width=160, height=120, noise=False,
                   arc_deg=2.0, device="cpu")
    return out


def _same_trajectory(out_a, out_b, n):
    ta = tumio.read_trajectory(os.path.join(out_a, "_poses.txt"))
    tb = tumio.read_trajectory(os.path.join(out_b, "_poses.txt"))
    assert len(ta) == len(tb) == n
    for (sa, Ra, taa), (sb, Rb, tbb) in zip(ta, tb):
        assert sa == sb
        np.testing.assert_allclose(Ra, Rb, atol=1e-6)
        np.testing.assert_allclose(taa, tbb, atol=1e-6)


def _same_dump(out_a, out_b):
    for suffix in ("_grid_info.txt", "_sdf_d.txt", "_sdf_weight.txt", "_sdf_n0.txt"):
        with open(os.path.join(out_a, "gradient_sdf" + suffix)) as fa, \
                open(os.path.join(out_b, "gradient_sdf" + suffix)) as fb:
            assert fa.read() == fb.read(), suffix


@pytest.mark.parametrize("scan_type", ["grad-sdf", "base-sdf"])
def test_scan3d_checkpoint_resume_equivalence_gt_poses(data, tmp_path, scan_type):
    """4 frames straight vs 2 frames + checkpoint + resume 2: same
    trajectory, same map."""
    base = ["--input", data, "--pose-file", "gt_poses.txt", "--last", "3",
            "--scan-type", scan_type, "--save-sdf"] + APP
    out_a, out_b = str(tmp_path / "a"), str(tmp_path / "b")
    m_a = tscan.main(base + ["--results", out_a])
    tscan.main(["--input", data, "--pose-file", "gt_poses.txt", "--last", "1",
                "--scan-type", scan_type, "--checkpoint-every", "1",
                "--results", out_b] + APP)
    saved = np.load(os.path.join(out_b, "checkpoint.npz"))
    assert int(saved["counter"]) == 2 and len(saved["pose_stamps"]) == 2
    m_b = tscan.main(base + ["--results", out_b, "--resume",
                             os.path.join(out_b, "checkpoint.npz")])
    assert m_a["frames"] == 4 and m_b["frames"] == 2   # only the remaining frames
    assert m_b["num_blocks_active"] == m_a["num_blocks_active"]
    _same_trajectory(out_a, out_b, 4)
    if scan_type == "grad-sdf":
        _same_dump(out_a, out_b)


def test_scan3d_checkpoint_resume_equivalence_tracking(data, tmp_path):
    """Tracking mode: the resumed run starts GN from the checkpoint's last
    pose, keeps the straight run's frame bookkeeping (a rejected frame is
    recorded but not fused), and ends on the same trajectory and map."""
    base = ["--input", data, "--pose-file", "none.txt", "--save-sdf"] + APP
    out_a, out_b = str(tmp_path / "a"), str(tmp_path / "b")
    m_a = tscan.main(base + ["--results", out_a])
    tscan.main(base + ["--results", out_b, "--last", "2", "--checkpoint-every", "1"])
    m_b = tscan.main(base + ["--results", out_b, "--resume",
                             os.path.join(out_b, "checkpoint.npz")])
    assert m_a["frames"] == 5 and m_b["frames"] == 2
    assert m_b["invalid_frames"] == [i for i in m_a["invalid_frames"] if i >= 3]
    _same_trajectory(out_a, out_b, 5)
    _same_dump(out_a, out_b)


def test_scan3d_checkpoint_cadence(data, tmp_path, monkeypatch):
    """--checkpoint-every K saves when the fused-frame counter is a multiple
    of K after a frame (the synchronous cadence of the JAX app)."""
    saved = []
    real = tckpt.save_state
    monkeypatch.setattr(tckpt, "save_state",
                        lambda path, grid, **kw: (saved.append(kw["counter"]),
                                                  real(path, grid, **kw))[1])
    m = tscan.main(["--input", data, "--pose-file", "gt_poses.txt",
                    "--results", str(tmp_path), "--checkpoint-every", "2"] + APP)
    assert m["frames"] == 5 and saved == [2, 4]
    state = tckpt.load_state(os.path.join(tmp_path, "checkpoint.npz"), device="cpu")
    assert state["counter"] == 4 and len(state["poses"]) == 4
    assert state["grid_cfg"].voxel_size == 0.02


def test_scan3d_resumes_a_checkpoint_of_the_jax_app(data, tmp_path):
    """The JAX app writes the checkpoint, the port resumes from it: the run
    ends within fusion's cross-package tolerance of the port's own straight
    run (the packages' normals differ by ~1e-3, tests/test_torch_scan3d.py)."""
    from gradient_sdf_tpu.apps import scan3d as jscan

    argv = ["--input", data, "--pose-file", "gt_poses.txt", "--data-type", "synth",
            "--voxel-size", "0.02", "--trunc", "5"]
    out_j, out_t = str(tmp_path / "j"), str(tmp_path / "t")
    jscan.run_scan(jscan.build_parser().parse_args(
        argv + ["--results", out_j, "--last", "1", "--checkpoint-every", "1"]))
    m = tscan.main(argv + ["--results", out_t, "--device", "cpu", "--resume",
                           os.path.join(out_j, "checkpoint.npz")])
    assert m["frames"] == 3
    straight = tscan.main(argv + ["--results", str(tmp_path / "s"), "--device", "cpu"])
    assert abs(m["num_blocks_active"] - straight["num_blocks_active"]) <= 2
    _same_trajectory(out_t, str(tmp_path / "s"), 5)


def test_scan3d_profile_writes_a_chrome_trace(data, tmp_path):
    prof = str(tmp_path / "prof")
    tscan.main(["--input", data, "--pose-file", "gt_poses.txt", "--last", "3",
                "--results", str(tmp_path / "out"), "--profile", prof] + APP)
    traces = os.listdir(prof)
    assert traces == ["frame_2.trace.json"]     # the third processed frame
    import json

    with open(os.path.join(prof, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("index_add" in e.get("name", "") for e in events)
