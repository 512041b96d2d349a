"""The port's box world (`gradient_sdf_tpu_torch/data/synth.py`:
`BoxWorld`, `default_boxes`, `box_sdf`, `render_depth_boxes`; and
`apps/make_synth.render_color_boxes`, `--world box`): the six tests of
`tests/test_box_world.py` on the port, then each function against the JAX
package's on the same inputs.

Tolerances, with their reasons:
  * `default_boxes`: equal (the same numpy draw, cast to float32 alike).
  * `box_sdf`: sdf 1e-6 m, gradients 1e-6 — float32 in both; points are
    drawn away from the creases, where the argmin over boxes or axes is a
    tie that the two packages may break by a last bit.
  * renders: a pixel's ray is R @ [cu, cv, 1], summed in another order than
    XLA's einsum, so a ray that grazes a box edge can hit in one package and
    miss in the other: hit masks may differ on at most 0.1% of the pixels
    (silhouettes), depth agrees to 1e-5 relative where both hit, and the
    colour where both hit except on at most 0.1% (the crease pixels whose
    nearest box flips with the last bit of the depth).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gradient_sdf_tpu.apps import make_synth as jmake
from gradient_sdf_tpu.data import synth as jsynth
from gradient_sdf_tpu_torch.apps import make_synth as tmake
from gradient_sdf_tpu_torch.data import synth
from gradient_sdf_tpu_torch.utils import se3

W, H = 160, 120
K = synth.KINECT_K.copy() * np.array([[0.25], [0.25], [1.0]])
FLIPS = 1e-3


def _poses(n=4):
    return synth.orbit_poses(n=n, radius=1.8, height_range=(0.35, 0.6),
                             target=np.array([0.0, 0.0, -0.25]),
                             arc=np.deg2rad(4.0))


def _surface_points(world, R, t, d):
    v, u = np.meshgrid(np.arange(d.shape[0]), np.arange(d.shape[1]),
                       indexing="ij")
    m = d > 0
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    pc = np.stack([(u - cx) / fx * d, (v - cy) / fy * d, d], -1)[m]
    return se3.se3_apply(torch.from_numpy(R), torch.from_numpy(t),
                         torch.from_numpy(pc.astype(np.float32)))


# --- the six tests of tests/test_box_world.py, on the port -----------------


def test_box_render_matches_analytic_sdf():
    """Backprojected depth pixels lie on the analytic zero set, the
    gradients are unit, and stepping inward goes inside."""
    world = synth.default_boxes(seed=2, device="cpu")
    R, t = _poses()[0]
    d = synth.render_depth_boxes(world, R, t, K, W, H).numpy()
    assert 0.15 < (d > 0).mean() < 0.9
    pw = _surface_points(world, R, t, d)
    sdf, grad = synth.box_sdf(world, pw)
    assert float(sdf.abs().max()) < 1e-5
    np.testing.assert_allclose(torch.linalg.norm(grad, dim=-1).numpy(), 1.0,
                               atol=1e-5)
    s2, _ = synth.box_sdf(world, pw - 0.04 * grad)
    assert float(s2.max()) < 0.0


def test_box_render_has_occlusion_edges():
    world = synth.default_boxes(seed=2, device="cpu")
    R, t = _poses()[0]
    d = synth.render_depth_boxes(world, R, t, K, W, H).numpy()
    both = (d[:, 1:] > 0) & (d[:, :-1] > 0)
    jumps = np.abs(np.diff(d, axis=1))[both]
    assert (jumps > 0.1).sum() > 20


def test_box_world_separation():
    world = synth.default_boxes(seed=0, n=3, device="cpu")
    c, h = world.centers.numpy(), world.half_extents.numpy()
    floor_top = c[0, 2] + h[0, 2]
    np.testing.assert_allclose(c[1:, 2] - h[1:, 2], floor_top, atol=1e-6)
    for i in range(1, 4):
        for j in range(i + 1, 4):
            assert np.max(np.abs(c[i, :2] - c[j, :2]) - (h[i, :2] + h[j, :2])) > 0.05


def test_box_scan3d_gt_fusion_and_analysis(tmp_path):
    """make_synth --world box, Scan3D from ground-truth poses with
    --save-sdf, and the analysis against the exact box normals, all in the
    port on the CPU; the same median bound as the JAX test at this size."""
    from gradient_sdf_tpu_torch.analysis import gradient_analysis as ga
    from gradient_sdf_tpu_torch.apps import scan3d
    from gradient_sdf_tpu_torch.utils.ply import load_ply

    data = str(tmp_path / "boxdata")
    tmake.main(["--out", data, "--frames", "4", "--seed", "2", "--width",
                "160", "--height", "120", "--no-noise", "--arc-deg", "4",
                "--world", "box", "--device", "cpu"])
    assert os.path.isfile(os.path.join(data, "boxes.txt"))
    out = str(tmp_path / "boxout")
    m = scan3d.main(["--input", data, "--results", out, "--pose-file",
                     "gt_poses.txt", "--data-type", "synth", "--voxel-size",
                     "0.02", "--trunc", "5", "--save-sdf", "--device", "cpu"])
    assert m["frames"] == 4 and m["num_blocks_active"] > 20
    mesh = load_ply(os.path.join(out, "gradient_sdf_mesh_final.ply"))
    assert len(mesh["vertex"]) > 100
    dump = ga.load_sdf_dump(os.path.join(out, "gradient_sdf"), "cpu")
    boxes = np.loadtxt(os.path.join(data, "boxes.txt"))
    res = ga.analyze_boxes(dump, boxes[:, :3], boxes[:, 3:], num_bins=5)
    near = [b for b in res["stored"] if b.get("count")][0]
    assert near["count"] > 500
    assert near["median"] < 15.0


def test_cosine_correction_halves_grazing_bias():
    """FusionConfig.cosine_correction cuts the residual bias on the grazing
    floor plane by more than 25% (tests/test_box_world.py's measurement)."""
    from gradient_sdf_tpu_torch.config import preset
    from gradient_sdf_tpu_torch.ops import fusion, normals, query
    from gradient_sdf_tpu_torch.ops import voxel_grid as vg

    cfg = preset("synth")
    gcfg = dataclasses.replace(cfg.grid, voxel_size=0.02)
    world = synth.default_boxes(seed=2, device="cpu")
    K2 = synth.KINECT_K.copy()
    K2[:2] *= 0.5
    W2, H2 = 320, 240
    R0, t0 = synth.orbit_poses(n=2, radius=1.8, height_range=(0.35, 0.6),
                               target=np.array([0.0, 0.0, -0.25]),
                               arc=np.deg2rad(4.0))[0]
    cache = normals.build_cache(W2, H2, K2, window=5, device="cpu")
    d0 = synth.render_depth_boxes(world, R0, t0, K2, W2, H2)
    d = d0.numpy()
    m = d > 0
    v, u = np.meshgrid(np.arange(H2), np.arange(W2), indexing="ij")
    fx, fy, cx, cy = K2[0, 0], K2[1, 1], K2[0, 2], K2[1, 2]
    pc = np.stack([(u - cx) / fx * d, (v - cy) / fy * d, d], -1)[m]
    Rt, tt = torch.from_numpy(R0), torch.from_numpy(t0)
    pw = se3.se3_apply(Rt, tt, torch.from_numpy(pc.astype(np.float32)))
    _, g_t = synth.box_sdf(world, pw)
    floor = g_t[:, 2].numpy() > 0.9
    means = {}
    for cc in (False, True):
        fcfg = dataclasses.replace(cfg.fusion, trunc_voxels=5.0,
                                   cosine_correction=cc)
        grid = fusion.fuse_frame(vg.create(gcfg, "cpu"), d0, cache, Rt, tt,
                                 gcfg, fcfg)
        phi, _, w = query.tsdf_grad(grid, pw, gcfg, fcfg)
        sel = floor & (w.numpy() > 0)
        means[cc] = abs(float(phi.numpy()[sel].mean()))
    assert means[True] < 0.75 * means[False], means


def test_gradient_analysis_fd_sign_convention(tmp_path):
    """Stored and central-FD medians are small angles near the surface on
    a perfect sphere fusion, not ~180 degrees (the sign convention)."""
    from gradient_sdf_tpu_torch.analysis import gradient_analysis as ga
    from gradient_sdf_tpu_torch.apps import scan3d

    data = str(tmp_path / "sphdata")
    tmake.generate(data, frames=4, seed=1, width=160, height=120,
                   noise=False, arc_deg=4.0, device="cpu")
    out = str(tmp_path / "sphout")
    scan3d.main(["--input", data, "--results", out, "--pose-file",
                 "gt_poses.txt", "--data-type", "synth", "--voxel-size",
                 "0.02", "--trunc", "5", "--save-sdf", "--device", "cpu"])
    dump = ga.load_sdf_dump(os.path.join(out, "gradient_sdf"), "cpu")
    sph = np.loadtxt(os.path.join(data, "spheres.txt"))
    res = ga.analyze(dump, sph[:, :3], sph[:, 3], num_bins=5)
    for meth in ("stored", "central"):
        near = [b for b in res[meth] if b.get("count")][0]
        assert near["median"] < 30.0, (meth, near)


# --- against the JAX package -------------------------------------------------


@pytest.mark.parametrize("seed", [0, 2, 7])
def test_default_boxes_equal_jax(seed):
    tw, jw = synth.default_boxes(seed=seed, device="cpu"), jsynth.default_boxes(seed=seed)
    np.testing.assert_array_equal(tw.centers.numpy(), np.asarray(jw.centers))
    np.testing.assert_array_equal(tw.half_extents.numpy(),
                                  np.asarray(jw.half_extents))


def test_box_sdf_matches_jax():
    """At points around the boxes, inside and outside, away from creases
    (where two boxes' or two axes' terms are within 1e-4 of each other)."""
    world = synth.default_boxes(seed=2, device="cpu")
    jw = jsynth.default_boxes(seed=2)
    rng = np.random.default_rng(0)
    pts = rng.uniform([-0.9, -0.9, -0.6], [0.9, 0.9, 0.1], (20000, 3))
    pts = pts.astype(np.float32)
    c, h = world.centers.numpy(), world.half_extents.numpy()
    q = np.abs(pts[:, None] - c) - h
    out = np.linalg.norm(np.maximum(q, 0), axis=-1)
    sdf_b = out + np.minimum(q.max(-1), 0)
    two = np.sort(sdf_b, axis=-1)[:, :2]
    qs = np.sort(q[np.arange(len(pts)), sdf_b.argmin(-1)], axis=-1)
    keep = (two[:, 1] - two[:, 0] > 1e-4) & (qs[:, 2] - qs[:, 1] > 1e-4)
    assert keep.mean() > 0.9
    ts, tg = synth.box_sdf(world, torch.from_numpy(pts[keep]))
    js, jg = jsynth.box_sdf(jw, jnp.asarray(pts[keep]))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
    assert (ts.numpy() < 0).any() and (ts.numpy() > 0).any()


@pytest.mark.parametrize("pose", [0, 3])
def test_render_depth_and_color_boxes_match_jax(pose):
    world = synth.default_boxes(seed=2, device="cpu")
    jw = jsynth.default_boxes(seed=2)
    R, t = _poses()[pose]
    td = synth.render_depth_boxes(world, R, t, K, W, H).numpy()
    jd = np.asarray(jsynth.render_depth_boxes(jw, jnp.asarray(R),
                                              jnp.asarray(t), K, W, H))
    th, jh = td > 0, jd > 0
    assert (th ^ jh).sum() <= FLIPS * th.size
    both = th & jh
    np.testing.assert_allclose(td[both], jd[both], rtol=1e-5)
    for gray in (False, True):
        tc = tmake.render_color_boxes(world, R, t, K, W, H, gray).numpy()
        jc = np.asarray(jmake.render_color_boxes(jw, jnp.asarray(R),
                                                 jnp.asarray(t), K, W, H, gray))
        assert tc.shape == jc.shape == (H, W, 3)
        bad = ~np.isclose(tc, jc, atol=1e-4).all(-1) & both
        assert bad.sum() <= FLIPS * th.size, bad.sum()
        assert not tc[~th].any()


def test_make_synth_box_dataset_matches_jax(tmp_path):
    """`make_synth --world box` in both packages (no noise): the same
    boxes.txt, poses and intrinsics; depth PNGs equal but for the
    silhouette pixels (see the module docstring)."""
    from PIL import Image

    from gradient_sdf_tpu_torch.data.png import read_png

    a, b = str(tmp_path / "t"), str(tmp_path / "j")
    tmake.main(["--out", a, "--frames", "3", "--seed", "2", "--width", "160",
                "--height", "120", "--no-noise", "--arc-deg", "4", "--world",
                "box", "--device", "cpu"])
    jmake.generate(b, frames=3, seed=2, width=160, height=120, noise=False,
                   arc_deg=4.0, world_kind="box")
    for name in ("boxes.txt", "gt_poses.txt", "intrinsics.txt"):
        with open(os.path.join(a, name)) as f, open(os.path.join(b, name)) as g:
            assert f.read() == g.read(), name
    for i in range(1, 4):
        td = read_png(os.path.join(a, "depth", f"{i:03d}.png"))
        jd = np.asarray(Image.open(os.path.join(b, "depth", f"{i:03d}.png")))
        assert (td != jd).mean() <= FLIPS, (td != jd).sum()
