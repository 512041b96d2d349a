"""Port PhotoBA app (`gradient_sdf_tpu_torch/apps/photoba.py`) end to end on
the CPU, and against the JAX app.

One dataset (the port's make_synth, 320x240, 14 frames over a 10 degree
arc, seed 2, no noise — the JAX app test's protocol) is read by both
packages. 320x240 is the smallest size at which GN tracking meets the
1e-3 convergence gate on this scene, and even there a frame or two is
rejected, not always the same one in both packages. So the app-vs-app
comparison runs with ground-truth poses (fusion-only phase 1), where both
fuse the same frames into the same keyframe slots, and on textured spheres
(the protocol's flat colours leave BA nothing to do); what is left between
them is the FALS normals' ~1e-3 difference, which flips a few pixels on
fusion's 60-degree gate (see test_torch_scan3d.py), hence tolerances on
the energies and the outputs' sizes and not equality.
"""

import json
import os

import numpy as np
import pytest

from gradient_sdf_tpu.apps import photoba as jphotoba
from gradient_sdf_tpu_torch.apps import make_synth as tmake
from gradient_sdf_tpu_torch.apps import photoba as tphotoba
from gradient_sdf_tpu_torch.utils import tumio
from gradient_sdf_tpu_torch.utils.ply import load_ply

ARTIFACTS = ["_poses.txt", "mesh_lr.ply", "cloud_lr.ply",
             "selected_frame_poses_before_optimization.txt",
             "coarse_BA_poses_optimized.txt",
             "coarse_BA_mesh_after_upsample.ply",
             "coarse_BA_cloud_after_upsample.ply"]
APP_ARGS = ["--data-type", "synth", "--voxel-size", "0.02", "--trunc", "5"]


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("photoba_data"))
    tmake.generate(out, frames=14, seed=2, width=320, height=240,
                   noise=False, arc_deg=10.0, device="cpu")
    return out


# ---------------------------------------------------------------------------
# keyframe sampling
# ---------------------------------------------------------------------------


def test_sample_keyframes_six_to_three():
    assert tphotoba.sample_keyframes(list(range(6)), 3) == [0, 3, 5]


@pytest.mark.parametrize("max_num", range(2, 11))
def test_sample_keyframes_matches_jax(max_num):
    for n in range(1, 41):
        items = list(range(100, 100 + n))
        got = tphotoba.sample_keyframes(items, max_num)
        assert got == jphotoba.sample_keyframes(items, max_num), n
        assert len(got) <= max(max_num, n if n < max_num else 0)
        assert got[-1] == items[-1]


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices and
                     tuple(a.choices))
            for a in parser._actions if a.dest != "help"}


def test_parser_has_every_jax_flag_plus_device():
    want, got = _options(jphotoba.build_parser()), _options(tphotoba.build_parser())
    assert set(got) - set(want) == {"device"}
    for dest, spec in want.items():
        assert got[dest] == spec, dest
    assert got["device"][1] == "cuda"


@pytest.mark.parametrize("argv", [[], ["--sharded-ba"]])
def test_sharded_ba_flag_parses_like_jax(argv):
    """--sharded-ba is a switch in both apps, off by default."""
    base = ["--input", "x"]
    got = tphotoba.build_parser().parse_args(base + argv).sharded_ba
    assert got == jphotoba.build_parser().parse_args(base + argv).sharded_ba
    assert got == bool(argv)


def test_default_device_is_the_card_and_fails_without_one(synth_dir, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tphotoba.main(["--input", synth_dir, "--results", str(tmp_path / "o")]
                      + APP_ARGS)


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


def test_photoba_end_to_end_cpu(synth_dir, tmp_path):
    results = str(tmp_path / "out")
    mpath = os.path.join(str(tmp_path), "m.json")
    metrics = tphotoba.main(
        ["--input", synth_dir, "--results", results, "--key-frame", "5",
         "--device", "cpu", "--metrics-json", mpath] + APP_ARGS)

    assert metrics["keyframes"] >= 2
    assert len(metrics["invalid_frames"]) <= 2  # occasional GN non-convergence at this scale
    es = metrics["ba_energies"]
    assert len(es) >= 3
    assert all(np.isfinite(e) for e in es)
    assert es[-1] <= es[0] * 1.05
    assert metrics["device"] == "cpu"
    with open(mpath) as f:
        on_disk = json.load(f)
    assert set(on_disk) == {"keyframes", "invalid_frames", "suppressed_keyframes",
                            "ba_converged", "ba_energies", "timers", "device",
                            "load_ms", "loop_fps"}
    assert {"Integrate depth data into Sdf", "Point optimization",
            "Photometric BA", "Color upsampling", "Load data"} <= set(on_disk["timers"])
    # phase 1's wait for each frame, and its loop rate with that wait
    assert len(on_disk["load_ms"]) == 14
    assert all(np.isfinite(x) and x >= 0 for x in on_disk["load_ms"])
    assert np.isfinite(on_disk["loop_fps"]) and on_disk["loop_fps"] > 0

    for f in ARTIFACTS:
        assert os.path.isfile(os.path.join(results, f)), f
    assert len(tumio.read_trajectory(os.path.join(results, "_poses.txt"))) == 14
    for name in ("selected_frame_poses_before_optimization.txt",
                 "coarse_BA_poses_optimized.txt"):
        assert len(tumio.read_trajectory(os.path.join(results, name))) == \
            metrics["keyframes"]

    # HR colored outputs parse and carry color
    mesh = load_ply(os.path.join(results, "coarse_BA_mesh_after_upsample.ply"))
    assert len(mesh["vertex"]) > 100
    assert "red" in mesh["vertex"].dtype.names
    cloud = load_ply(os.path.join(results, "coarse_BA_cloud_after_upsample.ply"))
    assert len(cloud["vertex"]) > 50
    # albedo should be non-trivial (synthetic spheres are colored)
    assert cloud["vertex"]["red"].astype(float).max() > 20


def test_photoba_slot_cap_and_lazy_images(synth_dir, tmp_path, capsys):
    """With --keyframe-gap 0 every converged frame is keyframe-eligible, so a
    small --max-recorded-keyframes exercises the visibility slot cap
    (suppression counted + warned, run completes); images are decoded only
    for the <= --key-frame SAMPLED keyframes."""
    results = str(tmp_path / "out_cap")
    metrics = tphotoba.main(
        ["--input", synth_dir, "--results", results, "--key-frame", "4",
         "--keyframe-gap", "0", "--max-recorded-keyframes", "8",
         "--device", "cpu"] + APP_ARGS)
    out = capsys.readouterr().out
    assert metrics["suppressed_keyframes"] >= 2
    assert "keyframe slot cap" in out
    assert metrics["keyframes"] == 4
    assert all(np.isfinite(e) for e in metrics["ba_energies"])
    for f in ["coarse_BA_poses_optimized.txt", "coarse_BA_mesh_after_upsample.ply"]:
        assert os.path.isfile(os.path.join(results, f)), f


def test_photoba_gt_poses_matches_jax_app(tmp_path):
    """Fusion-only phase 1 from `gt_poses.txt`, BA started from perturbed
    poses (`--ba-init-pose-file`, the BA-recovery fixture), 8 frames, in
    both apps. The spheres carry make_synth's grey world-anchored texture:
    with their flat colours every residual is zero and BA has nothing to do."""
    synth_dir = str(tmp_path / "textured")
    tmake.generate(synth_dir, frames=8, seed=2, width=320, height=240,
                   noise=False, arc_deg=10.0 * 8 / 14, gray_texture=True,
                   device="cpu")
    gt = tumio.read_trajectory(os.path.join(synth_dir, "gt_poses.txt"))
    rng = np.random.RandomState(3)
    init = [(ts, R, t + (rng.randn(3) * 0.003).astype(np.float32))
            for ts, R, t in gt]
    tumio.write_trajectory(os.path.join(synth_dir, "ba_init.txt"), init)
    common = ["--input", synth_dir, "--key-frame", "4",
              "--pose-file", "gt_poses.txt", "--ba-init-pose-file",
              "ba_init.txt"] + APP_ARGS
    jres, tres = str(tmp_path / "j"), str(tmp_path / "t")
    jm = jphotoba.run_photoba(jphotoba.build_parser().parse_args(
        common + ["--results", jres]))
    tm = tphotoba.main(common + ["--results", tres, "--device", "cpu"])

    assert tm["keyframes"] == jm["keyframes"] == 4
    assert tm["invalid_frames"] == jm["invalid_frames"] == []
    assert tm["ba_converged"] == jm["ba_converged"]
    assert len(tm["ba_energies"]) == len(jm["ba_energies"]) >= 3
    # the perturbed start costs energy, and BA wins it back, alike in both
    np.testing.assert_allclose(tm["ba_energies"], jm["ba_energies"], rtol=0.05)
    assert tm["ba_energies"][-1] < 0.9 * tm["ba_energies"][0]

    for name in ("_poses.txt", "selected_frame_poses_before_optimization.txt"):
        a = tumio.read_trajectory(os.path.join(tres, name))
        b = tumio.read_trajectory(os.path.join(jres, name))
        assert [e[0] for e in a] == [e[0] for e in b]
        np.testing.assert_allclose(np.stack([e[2] for e in a]),
                                   np.stack([e[2] for e in b]), atol=1e-6)
    a = tumio.read_trajectory(os.path.join(tres, "coarse_BA_poses_optimized.txt"))
    b = tumio.read_trajectory(os.path.join(jres, "coarse_BA_poses_optimized.txt"))
    np.testing.assert_allclose(np.stack([e[2] for e in a]),
                               np.stack([e[2] for e in b]), atol=1e-3)
    # optimized poses moved back towards the ground truth
    stamps = [e[0] for e in a]
    truth = {ts: t for ts, _, t in gt}
    start = {ts: t for ts, _, t in init}
    err0 = np.mean([np.linalg.norm(start[s] - truth[s]) for s in stamps])
    err1 = np.mean([np.linalg.norm(e[2] - truth[e[0]]) for e in a])
    assert err1 < err0

    for name in ("coarse_BA_mesh_after_upsample.ply",
                 "coarse_BA_cloud_after_upsample.ply", "mesh_lr.ply"):
        na = len(load_ply(os.path.join(tres, name))["vertex"])
        nb = len(load_ply(os.path.join(jres, name))["vertex"])
        assert na > 100 and abs(na - nb) <= 0.02 * nb, (name, na, nb)


def _textured(out, frames=8):
    tmake.generate(out, frames=frames, seed=2, width=320, height=240,
                   noise=False, arc_deg=10.0 * frames / 14, gray_texture=True,
                   device="cpu")
    return tumio.read_trajectory(os.path.join(out, "gt_poses.txt"))


def _lay_out(src, dst, layout, gt):
    """The synth dataset at `src` as a Printed3D folder (`depth_%06d.png`,
    `color_%06d.png` from 0) or a Redwood one (`depth/*.png`, `rgb/*.jpg`,
    here JPEGs written by PIL, in colour or greyscale), with its trajectory
    stamped as that loader stamps frames. Returns the stamps."""
    import shutil

    from PIL import Image

    os.makedirs(dst)
    shutil.copy(os.path.join(src, "intrinsics.txt"), dst)
    stamps = []
    for i in range(len(gt)):
        name = f"{i + 1:03d}.png"
        depth, rgb = (os.path.join(src, d, name) for d in ("depth", "rgb"))
        if layout == "printed":
            stamps.append(f"{i:06d}")
            shutil.copy(depth, os.path.join(dst, f"depth_{i:06d}.png"))
            shutil.copy(rgb, os.path.join(dst, f"color_{i:06d}.png"))
        else:
            stamps.append(f"{i:05d}")
            os.makedirs(os.path.join(dst, "depth"), exist_ok=True)
            os.makedirs(os.path.join(dst, "rgb"), exist_ok=True)
            shutil.copy(depth, os.path.join(dst, "depth", f"{i:05d}.png"))
            im = Image.open(rgb)
            if layout == "redwood-grey":
                im = im.convert("L")
            im.save(os.path.join(dst, "rgb", f"{i:05d}.jpg"), quality=95)
    tumio.write_trajectory(os.path.join(dst, "gt.txt"),
                           [(s, R, t) for s, (_, R, t) in zip(stamps, gt)])
    rng = np.random.RandomState(3)
    tumio.write_trajectory(
        os.path.join(dst, "ba_init.txt"),
        [(s, R, t + (rng.randn(3) * 0.003).astype(np.float32))
         for s, (_, R, t) in zip(stamps, gt)])
    return stamps


@pytest.mark.parametrize("layout,data_type", [("printed", "printed"),
                                              ("redwood", "redwood"),
                                              ("redwood-grey", "rw")])
def test_photoba_on_printed3d_and_redwood_folders_matches_jax_app(
        tmp_path, layout, data_type):
    """PhotoBA through the Printed3D and Redwood loaders (the Redwood colour
    frames are JPEGs: the JAX app decodes them with PIL, the port with its
    own decoder), from ground-truth poses with BA started from perturbed
    ones, in both apps: the same keyframes, the same phase-1 poses, BA
    energies and poses as close as in the synth-layout test above. These
    presets keep the sharpness threshold that the synth preset lowers, so
    `--keyframe-gap 0` makes every frame eligible, as there."""
    src = str(tmp_path / "synth")
    gt = _textured(src)
    data = str(tmp_path / layout)
    stamps = _lay_out(src, data, layout, gt)
    common = ["--input", data, "--key-frame", "4", "--keyframe-gap", "0",
              "--pose-file", "gt.txt",
              "--ba-init-pose-file", "ba_init.txt", "--data-type", data_type,
              "--voxel-size", "0.02", "--trunc", "5"]
    jres, tres = str(tmp_path / "j"), str(tmp_path / "t")
    jm = jphotoba.run_photoba(jphotoba.build_parser().parse_args(
        common + ["--results", jres]))
    tm = tphotoba.main(common + ["--results", tres, "--device", "cpu"])

    assert tm["keyframes"] == jm["keyframes"] == 4
    assert tm["invalid_frames"] == jm["invalid_frames"] == []
    assert len(tm["ba_energies"]) == len(jm["ba_energies"]) >= 3
    np.testing.assert_allclose(tm["ba_energies"], jm["ba_energies"], rtol=0.05)
    assert tm["ba_energies"][-1] < 0.9 * tm["ba_energies"][0]
    for name in ("_poses.txt", "selected_frame_poses_before_optimization.txt",
                 "coarse_BA_poses_optimized.txt"):
        a = tumio.read_trajectory(os.path.join(tres, name))
        b = tumio.read_trajectory(os.path.join(jres, name))
        assert [e[0] for e in a] == [e[0] for e in b]
        assert set(e[0] for e in a) <= set(stamps)
        atol = 1e-3 if name.startswith("coarse") else 1e-6
        np.testing.assert_allclose(np.stack([e[2] for e in a]),
                                   np.stack([e[2] for e in b]), atol=atol)
