"""Port marching cubes, data layer and the Scan3D app against the JAX
package.

Both apps run on ONE dataset (the port's make_synth, 320x240, 4 frames,
seed 2, no noise; PNGs through the port's stdlib codec, which the JAX
loader reads too), on the CPU.

Tolerances, with their reasons:
  * marching cubes on a shared grid: vertices to 1e-6 m — the same float32
    interpolation; faces equal, both numbering vertices by first
    occurrence.
  * app vs app: the packages' FALS normals differ by ~1e-3 (see
    test_torch_core.py), which flips the few pixels whose view angle sits
    on fusion's 60-degree gate, and moves tracked poses within the GN
    noise floor. So voxel sets are compared by coordinate (>= 99% shared),
    fields on the shared voxels that no flipped pixel touched, meshes by
    nearest-vertex distance, and poses to 5 mm / 5 mrad.
"""

import os
import struct
import zlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gradient_sdf_tpu import native as jnative
from gradient_sdf_tpu.apps import scan3d as jscan
torch.backends.cuda.matmul.allow_tf32 = False  # float32, as the JAX package
torch.backends.cudnn.allow_tf32 = False
from gradient_sdf_tpu.config import FusionConfig, GridConfig
from gradient_sdf_tpu.data import synth as jsynth
from gradient_sdf_tpu.ops import fusion as jfu
from gradient_sdf_tpu.ops import marching_cubes as jmc
from gradient_sdf_tpu.ops import normals as jnorm
from gradient_sdf_tpu.ops import voxel_grid as jvg
from gradient_sdf_tpu.utils.ply import load_ply
from gradient_sdf_tpu_torch.apps import make_synth as tmake
from gradient_sdf_tpu_torch.apps import scan3d as tscan
from gradient_sdf_tpu_torch.data import loaders as tloaders
from gradient_sdf_tpu_torch.data import png as tpng
from gradient_sdf_tpu_torch.ops import marching_cubes as tmc
from gradient_sdf_tpu_torch.utils import interop, tumio

APP_ARGS = ["--data-type", "synth", "--voxel-size", "0.02", "--trunc", "5"]


# ---------------------------------------------------------------------------
# marching cubes
# ---------------------------------------------------------------------------


def test_mc_tables_match_jax():
    for got, want in zip(tmc.build_tables(), jmc.build_tables()):
        np.testing.assert_array_equal(got, want)


def _assert_same_points(a, b, tol):
    """Equal-size point sets, each point within `tol` of the other set."""
    from scipy.spatial import cKDTree

    assert len(a) == len(b)
    assert cKDTree(b).query(a)[0].max() <= tol
    assert cKDTree(a).query(b)[0].max() <= tol


def test_extract_mesh_on_interop_grid_matches_jax():
    W, H = 96, 72
    K = np.array([[78.75, 0, 47.5], [0, 78.75, 35.5], [0, 0, 1]], np.float32)
    gcfg = GridConfig(voxel_size=0.02, num_blocks=1024)
    fcfg = FusionConfig(trunc_voxels=5.0)
    world = jsynth.random_spheres(seed=2)
    cache = jnorm.build_cache(W, H, K, window=5)
    jg = jvg.create(gcfg)
    for R, t in jsynth.orbit_poses(n=4, radius=2.0, arc=np.deg2rad(20.0)):
        d = jsynth.render_depth(world, jnp.asarray(R), jnp.asarray(t), K, W, H)
        jg = jfu.fuse_frame(jg, d, cache, jnp.asarray(R), jnp.asarray(t), gcfg, fcfg)
    tg = interop.grid_from_numpy({k: np.asarray(v) for k, v in jg._asdict().items()})
    jv, jf = jmc.extract_mesh(jg, gcfg, chunk=64)
    tv, tf = tmc.extract_mesh(tg, gcfg, chunk=64)
    assert len(tf) > 100
    if jnative.available():
        # both number vertices in order of first occurrence: the same
        # arrays, in the same order
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)
        # colours follow the first occurrence in both packages
        rng = np.random.default_rng(5)
        cf = rng.random((gcfg.num_blocks, gcfg.block_shape ** 3, 3)).astype(np.float32)
        jv_c, jf_c, jc = jmc.extract_mesh(jg, gcfg, chunk=64,
                                          color_field=jnp.asarray(cf))
        tv_c, tf_c, tc = tmc.extract_mesh(tg, gcfg, chunk=64,
                                          color_field=torch.as_tensor(cf))
        np.testing.assert_array_equal(tf_c, jf_c)
        np.testing.assert_allclose(tv_c, jv_c, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-6)
    else:
        # the JAX package's np.unique fallback numbers vertices by sorted
        # key: compare vertices and triangle centroids as point sets
        _assert_same_points(tv, jv, 1e-6)
        _assert_same_points(tv[tf].mean(axis=1), jv[jf].mean(axis=1), 1e-6)
    # without dedup: the same triangle soup
    tv_raw, tf_raw = tmc.extract_mesh(tg, gcfg, chunk=64, dedup=False)
    jv_raw, _ = jmc.extract_mesh(jg, gcfg, chunk=64, dedup=False)
    assert len(tv_raw) == 3 * len(tf_raw)
    _assert_same_points(tv_raw, jv_raw, 1e-6)


# ---------------------------------------------------------------------------
# PNG codec + loaders
# ---------------------------------------------------------------------------


def _encode_png(img, depth, ctype, filters):
    """Reference encoder applying the given per-row filter types (0-4)."""
    h = img.shape[0]
    raw = (img.astype(">u2") if depth == 16 else img).reshape(h, -1).view(np.uint8)
    bpp = {0: 1, 2: 3}[ctype] * depth // 8
    rows = []
    prev = np.zeros(raw.shape[1], np.int64)
    for y in range(h):
        cur = raw[y].astype(np.int64)
        ft = filters[y % len(filters)]
        a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = a
        elif ft == 2:
            pred = prev
        elif ft == 3:
            pred = (a + prev) // 2
        else:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        rows.append(bytes([ft]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", img.shape[1], h, depth, ctype, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["gray16", "rgb8", "gray8"])
def test_png_codec_decodes_all_filter_types(tmp_path, kind):
    rng = np.random.default_rng(13)
    if kind == "gray16":
        img, depth, ctype = rng.integers(0, 65536, (23, 17)).astype(np.uint16), 16, 0
    elif kind == "rgb8":
        img, depth, ctype = rng.integers(0, 256, (23, 17, 3)).astype(np.uint8), 8, 2
    else:
        img, depth, ctype = rng.integers(0, 256, (23, 17)).astype(np.uint8), 8, 0
    path = os.path.join(tmp_path, "f.png")
    with open(path, "wb") as f:
        f.write(_encode_png(img, depth, ctype, filters=[0, 1, 2, 3, 4, 4, 3]))
    np.testing.assert_array_equal(tpng.read_png(path), img)
    # the writer's output reads back, and is a PNG other decoders take
    out = os.path.join(tmp_path, "w.png")
    tpng.write_png(out, img)
    np.testing.assert_array_equal(tpng.read_png(out), img)
    from gradient_sdf_tpu.data import loaders as jloaders

    np.testing.assert_array_equal(jloaders._imread(out), img)


def test_png_codec_rejects_interlaced_and_non_png(tmp_path):
    """Adam7 images are read (tests/test_torch_png.py); what is rejected is
    non-interlaced image data under the Adam7 flag (its seven passes need
    other sizes) and an interlace method the format does not define."""
    bad = os.path.join(tmp_path, "bad.png")
    with open(bad, "wb") as f:
        f.write(b"not a png")
    with pytest.raises(ValueError):
        tpng.read_png(bad)
    img = np.zeros((4, 4), np.uint8)
    blob = bytearray(_encode_png(img, 8, 0, [0]))
    for method, message in ((1, "wrong size"), (2, "unsupported")):
        blob[28] = method  # IHDR interlace byte: 1 is Adam7
        with open(bad, "wb") as f:
            f.write(bytes(blob))
        with pytest.raises(ValueError, match=message):
            tpng.read_png(bad)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("synth"))
    tmake.main(["--out", out, "--frames", "4", "--seed", "2", "--width", "320",
                "--height", "240", "--arc-deg", "4", "--no-noise",
                "--device", "cpu"])
    return out


def test_make_synth_layout_and_loader_match_jax(dataset):
    for sub in ("depth", "rgb", "albedo"):
        assert sorted(os.listdir(os.path.join(dataset, sub))) == [
            f"{i:03d}.png" for i in range(1, 5)]
    for name in ("intrinsics.txt", "gt_poses.txt", "spheres.txt"):
        assert os.path.isfile(os.path.join(dataset, name))
    # the world is the JAX package's for the same seed
    world = jsynth.random_spheres(seed=2)
    spheres = np.loadtxt(os.path.join(dataset, "spheres.txt"))
    np.testing.assert_allclose(spheres[:, :3], np.asarray(world.centers), atol=1e-6)
    from gradient_sdf_tpu.data import loaders as jloaders

    tl = tloaders.make_loader("synth", dataset)
    jl = jloaders.make_loader("synth", dataset)
    np.testing.assert_array_equal(tl.load_intrinsics(), jl.load_intrinsics())
    frames_t, frames_j = list(tl.frames()), list(jl.frames())
    assert [f.timestamp for f in frames_t] == [f.timestamp for f in frames_j]
    for ft, fj in zip(frames_t, frames_j):
        np.testing.assert_array_equal(ft.depth, fj.depth)
        np.testing.assert_array_equal(ft.color, fj.color)
    # the port's renderer matches the JAX renderer (float32 rounding), and
    # frame 0 on disk is its render rounded to the PNG's millimetres
    from gradient_sdf_tpu_torch.data import synth as tsynth

    K = tl.load_intrinsics()
    R, t = tsynth.orbit_poses(n=4, radius=2.0, arc=np.deg2rad(4.0))[0]
    jd = np.asarray(jsynth.render_depth(world, jnp.asarray(R), jnp.asarray(t),
                                        K, 320, 240))
    td = tsynth.render_depth(tsynth.random_spheres(seed=2, device="cpu"), R, t, K, 320, 240)
    np.testing.assert_allclose(td.numpy(), jd, atol=1e-6)
    mm = np.round(td.numpy() * 1000.0).astype(np.uint16)
    np.testing.assert_array_equal(frames_t[0].depth, mm.astype(np.float32) * 1e-3)


def test_sphere_sdf_noise_and_quantization_match_jax(monkeypatch):
    import jax

    from gradient_sdf_tpu_torch.data import synth as tsynth

    jw, tw = jsynth.random_spheres(seed=3), tsynth.random_spheres(seed=3, device="cpu")
    pts = np.random.default_rng(14).uniform(-0.8, 0.8, (500, 3)).astype(np.float32)
    for got, want in zip(tsynth.sphere_sdf(tw, torch.from_numpy(pts)),
                         jsynth.sphere_sdf(jw, jnp.asarray(pts))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    R, t = tsynth.orbit_poses(n=4, radius=2.0)[1]
    K = tsynth.KINECT_K.copy()
    K[:2] *= 0.25
    depth = tsynth.render_depth(tw, R, t, K, 160, 120)
    assert (depth > 0).any() and (depth == 0).any()
    # the same normal draws on both sides: the JAX package's jax.random
    # draw is replaced by the numpy generator's
    noise = np.random.default_rng(15).standard_normal(tuple(depth.shape))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype: jnp.asarray(noise, dtype))
    got = tsynth.add_kinect_noise(depth, np.random.default_rng(15))
    want = jsynth.add_kinect_noise(jnp.asarray(depth.numpy()), jax.random.PRNGKey(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(
        tsynth.quantize_depth(got).numpy(),
        np.asarray(jsynth.quantize_depth(jnp.asarray(got.numpy()))))


# ---------------------------------------------------------------------------
# the two apps on one dataset
# ---------------------------------------------------------------------------


def _sdf_dump(prefix):
    """--save-sdf dump -> {voxel coord: (dist, weight, n0, n1, n2)}."""
    with open(prefix + "_grid_info.txt") as f:
        info = {l.split(":")[0]: l.split(":")[1].split() for l in f}
    dim = np.array(info["voxel dim"], np.int64)
    vmin = np.array(info["voxel min"], np.int64)
    cols = []
    for suffix in ("_sdf_d.txt", "_sdf_weight.txt", "_sdf_n0.txt",
                   "_sdf_n1.txt", "_sdf_n2.txt"):
        a = np.loadtxt(prefix + suffix, ndmin=2)
        lin, vals = a[:, 0].astype(np.int64), a[:, 1]
        cols.append(vals)
    x = lin % dim[0] + vmin[0]
    y = (lin // dim[0]) % dim[1] + vmin[1]
    z = lin // (dim[0] * dim[1]) + vmin[2]
    return {k: v for k, v in zip(zip(x.tolist(), y.tolist(), z.tolist()),
                                 np.stack(cols, axis=1))}


@pytest.fixture(scope="module")
def apps(dataset, tmp_path_factory):
    """Both apps, GT-pose mode and tracking mode, on the one dataset."""
    out = {}
    for mode, pose_file in (("gt", "gt_poses.txt"), ("track", "none.txt")):
        for pkg, main, extra in (("jax", jscan.main, []),
                                 ("torch", tscan.main, ["--device", "cpu"])):
            res = str(tmp_path_factory.mktemp(f"{pkg}_{mode}"))
            metrics = os.path.join(res, "m.json")
            argv = (["--input", dataset, "--results", res, "--pose-file",
                     pose_file, "--save-sdf", "--metrics-json", metrics]
                    + APP_ARGS + extra)
            if pkg == "torch" and mode == "gt":
                argv += ["--merged-step", "--sync-growth-checks"]  # no-ops
            main(argv)
            import json

            with open(metrics) as f:
                out[pkg, mode] = (res, json.load(f))
    return out


def test_scan3d_apps_agree_on_map_and_mesh(apps):
    """GT-pose mode: both apps fuse the same frames at the same poses.
    (In tracking mode the 320x240 GN sits at the 1e-3 gate's noise floor,
    so which frame is rejected as non-converged can differ between the
    packages; their trajectories are compared below instead.)"""
    (jres, jm), (tres, tm) = apps["jax", "gt"], apps["torch", "gt"]
    assert tm["frames"] == jm["frames"] == 4
    assert tm["invalid_frames"] == jm["invalid_frames"] == []
    assert tm["overflow"] is False and tm["num_blocks_active"] > 0
    assert abs(tm["num_blocks_active"] - jm["num_blocks_active"]) <= 2
    a = _sdf_dump(os.path.join(tres, "gradient_sdf"))
    b = _sdf_dump(os.path.join(jres, "gradient_sdf"))
    shared = set(a) & set(b)
    assert len(shared) >= 0.99 * max(len(a), len(b))
    va = np.stack([a[k] for k in sorted(shared)])
    vb = np.stack([b[k] for k in sorted(shared)])
    # voxels fed only by pixels both packages fused have equal weights
    same_w = np.abs(va[:, 1] - vb[:, 1]) < 1e-4
    assert same_w.mean() >= 0.98
    np.testing.assert_allclose(va[same_w, 0], vb[same_w, 0], atol=1e-4)
    # meshes: same size, and the vertices on top of each other
    from scipy.spatial import cKDTree

    ma = load_ply(os.path.join(tres, "gradient_sdf_mesh_final.ply"))
    mb = load_ply(os.path.join(jres, "gradient_sdf_mesh_final.ply"))
    pa = np.stack([ma["vertex"][c] for c in "xyz"], -1)
    pb = np.stack([mb["vertex"][c] for c in "xyz"], -1)
    assert abs(len(ma["face"]) - len(mb["face"])) <= 0.03 * len(mb["face"])
    d_ab, _ = cKDTree(pb).query(pa)
    assert np.median(d_ab) < 1e-5
    assert np.percentile(d_ab, 99) < 0.01  # 1 voxel = 2 cm
    cloud = load_ply(os.path.join(tres, "gradient_sdf_cloud_final.ply"))
    assert len(cloud["vertex"]) > 100


def test_scan3d_load_ms_and_loop_fps(apps):
    """The port app times the wait for each frame ("Load data", the JAX
    app's label) and the loop rate with it; the loader decoded ahead."""
    for mode in ("gt", "track"):
        _, m = apps["torch", mode]
        loads = [e["load_ms"] for e in m["frame_log"]]
        assert len(loads) == m["frames"] == 4
        assert all(np.isfinite(x) and x >= 0 for x in loads)
        assert m["timers"]["Load data"]["count"] == 4
        # frames 1-3 over the wall time from asking for frame 1: at most the
        # rate of the frames' own work, which leaves the load out
        work_s = sum(e["frame_ms"] for e in m["frame_log"][1:]) / 1e3
        assert np.isfinite(m["loop_fps"]) and 0 < m["loop_fps"] <= 3 / work_s
        assert m["reader"]["n_threads"] == 2 and m["reader"]["window"] == 16
        assert 1 <= m["reader"]["peak_resident"] <= 16 + 2


def test_scan3d_frame_log_carries_the_program_spans(apps):
    """With --metrics-json each frame's entry holds the program's spans
    (utils/trace) in ms, its host reads and its launches (none on the
    CPU, where the wrappers run their plain versions)."""
    for mode in ("gt", "track"):
        _, m = apps["torch", mode]
        for e in m["frame_log"]:
            tracked = e["gn_iters"] is not None
            fused = e["fuse_ms"] is not None
            for key, on in (("track_launch_ms", tracked),
                            ("track_read_ms", tracked),
                            ("fuse_launch_ms", fused),
                            ("fuse_read_ms", fused)):
                assert (e[key] is not None) == on, (mode, e)
                assert e[key] is None or 0 < e[key] < e["frame_ms"]
            if tracked:
                assert (e["track_launch_ms"] + e["track_read_ms"]
                        <= e["track_ms"])
            if fused:
                assert e["fuse_launch_ms"] + e["fuse_read_ms"] <= e["fuse_ms"]
            # the plain GN loop's flag a pass and its E and count, the
            # growth flags, the pose's two tensors
            assert e["host_reads"] == ((e["gn_iters"] or 0) + 2 * tracked
                                       + fused + 2)
            assert e["launches"] == 0
            # no graph on the CPU
            assert e["graph_captures"] == e["graph_replays"] == 0


def test_scan3d_apps_agree_on_trajectory(apps, dataset):
    (jres, jm), (tres, tm) = apps["jax", "track"], apps["torch", "track"]
    tj = tumio.read_trajectory(os.path.join(jres, "_poses.txt"))
    tt = tumio.read_trajectory(os.path.join(tres, "_poses.txt"))
    gt = tumio.read_trajectory(os.path.join(dataset, "gt_poses.txt"))
    assert [e[0] for e in tt] == [e[0] for e in tj] == [e[0] for e in gt]
    for (_, Rt, t_t), (_, Rj, t_j) in zip(tt, tj):
        assert np.linalg.norm(t_t - t_j) < 5e-3
        assert np.abs(Rt - Rj).max() < 5e-3

    def rel(traj, i):
        R0, t0 = traj[0][1].astype(np.float64), traj[0][2].astype(np.float64)
        return R0.T @ (traj[i][2] - t0)

    for i in range(1, 4):
        assert np.linalg.norm(rel(tt, i) - rel(gt, i)) < 0.02
    assert "ate_rmse" not in tm  # no groundtruth.txt in a synth dataset
    # frame 0 anchors both at identity, then every frame is tracked
    assert all(e["gn_iters"] for e in tm["frame_log"][1:])


@pytest.mark.parametrize("data_type", ["printed", "rw"])
def test_scan3d_reads_printed3d_and_redwood_layouts(apps, dataset, tmp_path,
                                                    data_type):
    """The dataset laid out as a Printed3D folder (its PNGs renamed) or a
    Redwood one (its depth PNGs, the colour as JPEGs written by PIL): the
    port's Scan3D tracks it through that loader to the poses of the synth
    layout (the same depth frames), stamped as that loader stamps frames."""
    import shutil

    from PIL import Image

    root = str(tmp_path / data_type)
    os.makedirs(root)
    shutil.copy(os.path.join(dataset, "intrinsics.txt"), root)
    stamps = []
    for i in range(4):
        depth, rgb = (os.path.join(dataset, sub, f"{i + 1:03d}.png")
                      for sub in ("depth", "rgb"))
        if data_type == "printed":
            stamps.append(f"{i:06d}")
            shutil.copy(depth, os.path.join(root, f"depth_{i:06d}.png"))
            shutil.copy(rgb, os.path.join(root, f"color_{i:06d}.png"))
        else:
            stamps.append(f"{i:05d}")
            for sub in ("depth", "rgb"):
                os.makedirs(os.path.join(root, sub), exist_ok=True)
            shutil.copy(depth, os.path.join(root, "depth", f"{i:05d}.png"))
            with Image.open(rgb) as im:
                im.save(os.path.join(root, "rgb", f"{i:05d}.jpg"))
    res = str(tmp_path / "out")
    m = tscan.main(["--input", root, "--results", res, "--pose-file",
                    "none.txt", "--data-type", data_type, "--voxel-size",
                    "0.02", "--trunc", "5", "--device", "cpu"])
    assert m["frames"] == 4
    got = tumio.read_trajectory(os.path.join(res, "_poses.txt"))
    want = tumio.read_trajectory(
        os.path.join(apps["torch", "track"][0], "_poses.txt"))
    assert [e[0] for e in got] == stamps
    for (_, Ra, ta), (_, Rb, tb) in zip(got, want):
        np.testing.assert_allclose(Ra, Rb, atol=1e-6)
        np.testing.assert_allclose(ta, tb, atol=1e-6)


def test_scan3d_device_cuda_raises_without_cuda(dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tscan.main(["--input", dataset, "--results", str(tmp_path),
                    "--pose-file", "gt_poses.txt"] + APP_ARGS)


@pytest.mark.parametrize("flags, message", [
    (["--devices", "2", "--scan-type", "base-sdf"],
     "--devices requires --scan-type grad-sdf"),
    (["--devices", "4", "--block-parallel", "3"],
     "--block-parallel 3 does not divide --devices 4")])
def test_scan3d_mesh_flags_are_checked(dataset, tmp_path, flags, message):
    """The JAX app's rules for --devices (grad-sdf only; --block-parallel
    divides --devices), checked before any rank starts."""
    with pytest.raises(SystemExit, match=message):
        tscan.main(["--input", dataset, "--results", str(tmp_path),
                    "--device", "cpu"] + APP_ARGS + flags)
    assert not os.path.exists(os.path.join(str(tmp_path), "_poses.txt"))


def test_scan3d_parser_accepts_every_reference_flag():
    """Every option of the JAX app's parser parses in the port's."""
    jopts = {o for a in jscan.build_parser()._actions for o in a.option_strings}
    topts = {o for a in tscan.build_parser()._actions for o in a.option_strings}
    assert jopts <= topts
    assert topts - jopts == {"--device"}
