"""The port's multi-device apps on 4 gloo ranks on the CPU, against the JAX
apps with the same flags (tests/test_app_sharded.py's protocol) and against
the port's own single-device runs.

`scan3d --devices 4` starts its 4 ranks itself (`parallel.mesh.launch`);
`photoba --sharded-ba` runs inside a 4-rank group that the test launches
(`tests/torch_mesh_worker.py`: a spawned rank must not import JAX).

Bounds, with their reasons:
  * Scan3D mesh vs the JAX mesh app and vs the port's single-device app:
    test_app_sharded.py's bounds. Poses to 3e-3 (the sharded and unsharded
    residual passes sum in other orders and GN turns that into pose noise
    at its 1e-3 stopping rule), voxel sets >= 99% shared, dist median
    < 2e-4 and p99 < 3e-3 on the shared voxels. Block counts: equal to the
    port's single-device run; within 2 of the JAX app's, test_torch_scan3d's
    bound (the packages' FALS normals differ by ~1e-3 and flip pixels on
    fusion's 60-degree gate).
  * Mesh checkpoint + resume vs the uninterrupted mesh run: 1e-5, the JAX
    test's bound (on the CPU the runs repeat bit for bit).
  * PhotoBA --sharded-ba vs the JAX app's: test_torch_photoba_app.py's
    bounds for the GT-pose textured protocol.
"""

import os

import numpy as np
import pytest

from gradient_sdf_tpu.apps import photoba as jphotoba
from gradient_sdf_tpu.apps import scan3d as jscan
from gradient_sdf_tpu_torch.apps import make_synth as tmake
from gradient_sdf_tpu_torch.apps import scan3d as tscan
from gradient_sdf_tpu_torch.parallel import mesh as tmesh
from gradient_sdf_tpu_torch.utils import tumio
from gradient_sdf_tpu_torch.utils.ply import load_ply

import torch_mesh_worker

APP_ARGS = ["--data-type", "synth", "--voxel-size", "0.02", "--trunc", "5"]


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_rank():
    """Ranks on one thread each: a rank's float sums then repeat bit for bit
    from run to run (a multi-threaded BLAS may split a product differently
    when the host is loaded), which the resume test's 1e-5 needs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


@pytest.fixture(scope="module")
def qvga_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("synthqvga"))
    tmake.generate(out, frames=5, seed=2, width=320, height=240, noise=False,
                   arc_deg=4.0, device="cpu")
    return out


def _argv(data_dir, results, extra, last=4):
    return (["--input", data_dir, "--results", results, "--pose-file",
             "nonexistent.txt", "--last", str(last)] + APP_ARGS + extra)


def _port(data_dir, results, extra, last=4):
    """The port's app on the CPU; mesh runs hold the ranks' replicated state
    equal after every frame."""
    return tscan.main(_argv(data_dir, results, extra, last) + ["--device", "cpu"],
                      check_replicated=True)


def _load_dump(path):
    return {int(l.split()[0]): float(l.split()[1]) for l in open(path)}


def _assert_close_runs(res_a, res_b):
    ta = tumio.read_trajectory(os.path.join(res_a, "_poses.txt"))
    tb = tumio.read_trajectory(os.path.join(res_b, "_poses.txt"))
    assert len(ta) == len(tb) == 5
    for (sa, Ra, ta_), (sb, Rb, tb_) in zip(ta, tb):
        assert sa == sb
        assert np.abs(np.asarray(Ra) - np.asarray(Rb)).max() < 3e-3
        assert np.abs(np.asarray(ta_) - np.asarray(tb_)).max() < 3e-3
    da = _load_dump(os.path.join(res_a, "gradient_sdf_sdf_d.txt"))
    db = _load_dump(os.path.join(res_b, "gradient_sdf_sdf_d.txt"))
    common = sorted(set(da) & set(db))
    assert len(common) > 0.99 * max(len(da), len(db))
    diffs = np.abs(np.array([da[k] - db[k] for k in common]))
    assert np.median(diffs) < 2e-4
    assert np.quantile(diffs, 0.99) < 3e-3


def test_scan3d_devices_matches_jax_app(qvga_dir, tmp_path):
    res_m, res_1, res_j = (str(tmp_path / n) for n in ("mesh4", "single", "jax"))
    flags = ["--save-sdf", "--devices", "4", "--merged-step"]
    m = _port(qvga_dir, res_m, flags)
    s = _port(qvga_dir, res_1, ["--save-sdf"])
    j = jscan.run_scan(jscan.build_parser().parse_args(
        _argv(qvga_dir, res_j, flags)))
    assert m["mesh"]["devices"] == 4 and m["mesh"]["backend"] == "gloo"
    assert (m["mesh"]["rays"], m["mesh"]["blocks"]) == (2, 2)
    # the CPU runs the kernels' plain versions, which count no launch
    assert m["mesh"]["kernel_launches"] == {
        "merge_clear": 0, "raycast_march": 0, "scatter_add": 0,
        "gn_track_loop": 0, "gn_residual_reduce": 0, "gn_step": 0,
        "fuse_claim": 0, "fuse_integrate": 0}
    # per frame: the touched-block vector and the compact sums, plus one
    # all_reduce per GN iteration of a tracked frame
    for e in m["frame_log"]:
        assert e["collective_calls"] == (e["gn_iters"] or 0) + 2 * (
            e["fuse_ms"] is not None)
    for other in (s, j):
        assert m["frames"] == other["frames"] == 5
        assert m["invalid_frames"] == other["invalid_frames"]
    assert m["num_blocks_active"] == s["num_blocks_active"]
    assert abs(m["num_blocks_active"] - j["num_blocks_active"]) <= 2
    _assert_close_runs(res_m, res_1)
    _assert_close_runs(res_m, res_j)
    for name in ("gradient_sdf_mesh_final.ply", "gradient_sdf_cloud_final.ply"):
        assert len(load_ply(os.path.join(res_m, name))["vertex"]) > 100


def test_scan3d_devices_checkpoint_resume(qvga_dir, tmp_path):
    """Interrupt + resume on the mesh equals the uninterrupted mesh run: the
    checkpoint gathers the sharded volume and rank 0 writes it; on resume
    every rank loads it and the map is sharded again."""
    res_full, res_ck = str(tmp_path / "full"), str(tmp_path / "ck")
    base = ["--devices", "4", "--merged-step"]
    m_full = _port(qvga_dir, res_full, base)
    _port(qvga_dir, res_ck, base + ["--checkpoint-every", "1"], last=2)
    m_res = _port(qvga_dir, res_ck,
                  base + ["--resume", os.path.join(res_ck, "checkpoint.npz")])
    assert m_res["num_blocks_active"] == m_full["num_blocks_active"]
    ta = tumio.read_trajectory(os.path.join(res_full, "_poses.txt"))
    tb = tumio.read_trajectory(os.path.join(res_ck, "_poses.txt"))
    assert len(ta) == len(tb) == 5
    for (sa, Ra, ta_), (sb, Rb, tb_) in zip(ta, tb):
        assert sa == sb
        np.testing.assert_allclose(np.asarray(Ra), np.asarray(Rb), atol=1e-5)
        np.testing.assert_allclose(np.asarray(ta_), np.asarray(tb_), atol=1e-5)


def test_photoba_sharded_ba_matches_jax_app(tmp_path):
    """test_torch_photoba_app.py's GT-pose protocol (8 textured frames, BA
    started from perturbed poses) with --sharded-ba: the port's BA over 4
    ranks against the JAX app's over the suite's 8 virtual devices."""
    synth_dir = str(tmp_path / "textured")
    tmake.generate(synth_dir, frames=8, seed=2, width=320, height=240,
                   noise=False, arc_deg=10.0 * 8 / 14, gray_texture=True,
                   device="cpu")
    gt = tumio.read_trajectory(os.path.join(synth_dir, "gt_poses.txt"))
    rng = np.random.RandomState(3)
    init = [(ts, R, t + (rng.randn(3) * 0.003).astype(np.float32))
            for ts, R, t in gt]
    tumio.write_trajectory(os.path.join(synth_dir, "ba_init.txt"), init)
    common = ["--input", synth_dir, "--key-frame", "4", "--pose-file",
              "gt_poses.txt", "--ba-init-pose-file", "ba_init.txt",
              "--sharded-ba"] + APP_ARGS
    jres, tres = str(tmp_path / "j"), str(tmp_path / "t")
    jm = jphotoba.run_photoba(jphotoba.build_parser().parse_args(
        common + ["--results", jres]))
    tm = tmesh.launch(torch_mesh_worker.photoba_rank, 4,
                      common + ["--results", tres, "--device", "cpu"],
                      device="cpu", timeout_s=240, join_timeout_s=600)

    assert tm["mesh"] == {"devices": 4, "backend": "gloo", "ranks_per_card": 0}
    assert tm["keyframes"] == jm["keyframes"] == 4
    assert tm["invalid_frames"] == jm["invalid_frames"] == []
    assert tm["ba_converged"] == jm["ba_converged"]
    assert len(tm["ba_energies"]) == len(jm["ba_energies"]) >= 3
    np.testing.assert_allclose(tm["ba_energies"], jm["ba_energies"], rtol=0.05)
    assert tm["ba_energies"][-1] < 0.9 * tm["ba_energies"][0]
    a = tumio.read_trajectory(os.path.join(tres, "coarse_BA_poses_optimized.txt"))
    b = tumio.read_trajectory(os.path.join(jres, "coarse_BA_poses_optimized.txt"))
    assert [e[0] for e in a] == [e[0] for e in b]
    np.testing.assert_allclose(np.stack([e[2] for e in a]),
                               np.stack([e[2] for e in b]), atol=1e-3)
    truth = {ts: t for ts, _, t in gt}
    start = {ts: t for ts, _, t in init}
    err0 = np.mean([np.linalg.norm(start[e[0]] - truth[e[0]]) for e in a])
    err1 = np.mean([np.linalg.norm(e[2] - truth[e[0]]) for e in a])
    assert err1 < err0
    for name in ("coarse_BA_mesh_after_upsample.ply",
                 "coarse_BA_cloud_after_upsample.ply", "mesh_lr.ply"):
        na = len(load_ply(os.path.join(tres, name))["vertex"])
        nb = len(load_ply(os.path.join(jres, name))["vertex"])
        assert na > 100 and abs(na - nb) <= 0.02 * nb, (name, na, nb)
