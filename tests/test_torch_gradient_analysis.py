"""The port's gradient analysis (`gradient_sdf_tpu_torch/analysis/
gradient_analysis.py`, `apps/analyze.py`) against the JAX package's on the
same `--save-sdf` dumps.

Both work in float64 on the same dense fields, so counts are equal and the
statistics agree to rtol 1e-9 (summation order of the means, and the last
bit of arccos, are all that differ). The box world's analytic field differs
on purpose: the port takes the signed argmin over boxes, as
`data/synth.box_sdf` does, the JAX module the argmin of |sdf|; the box
comparisons hand the JAX module's `_analyze_field` the signed field.
"""

import json
import os

import numpy as np
import pytest
import torch

from gradient_sdf_tpu.analysis import gradient_analysis as jga
from gradient_sdf_tpu.apps import analyze as janalyze
from gradient_sdf_tpu.data import synth as jsynth
from gradient_sdf_tpu_torch.analysis import gradient_analysis as tga
from gradient_sdf_tpu_torch.apps import analyze as tanalyze
from gradient_sdf_tpu_torch.apps import make_synth as tmake
from gradient_sdf_tpu_torch.apps import scan3d as tscan

RTOL = 1e-9


def _dump(tmp_path_factory, world):
    data = str(tmp_path_factory.mktemp(f"{world}_data"))
    tmake.main(["--out", data, "--frames", "4", "--seed", "2", "--width", "160",
                "--height", "120", "--no-noise", "--arc-deg", "4", "--world",
                world, "--device", "cpu"])
    out = str(tmp_path_factory.mktemp(f"{world}_out"))
    tscan.main(["--input", data, "--results", out, "--pose-file",
                "gt_poses.txt", "--data-type", "synth", "--voxel-size", "0.02",
                "--trunc", "5", "--save-sdf", "--device", "cpu"])
    return data, os.path.join(out, "gradient_sdf")


@pytest.fixture(scope="module")
def spheres(tmp_path_factory):
    return _dump(tmp_path_factory, "spheres")


@pytest.fixture(scope="module")
def boxes(tmp_path_factory):
    return _dump(tmp_path_factory, "box")


def _same_stats(got, want):
    assert list(got) == list(want)
    for method in want:
        assert len(got[method]) == len(want[method])
        for a, b in zip(got[method], want[method]):
            assert tuple(a["bin"]) == tuple(b["bin"])
            assert a["count"] == b["count"], (method, a, b)
            for k in ("mean", "median", "rmse", "p95"):
                if b["count"]:
                    np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=1e-12)


def _signed_box_field(pts, centers, halfs):
    """The JAX module's `box_true_field` with the signed argmin, in numpy
    float64: the field the port computes."""
    d = pts[..., None, :] - centers
    q = np.abs(d) - halfs
    out = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    sdf_b = out + np.minimum(q.max(axis=-1), 0.0)
    b = np.argmin(sdf_b, axis=-1)
    sdf = np.take_along_axis(sdf_b, b[..., None], axis=-1)[..., 0]
    dn = np.take_along_axis(d, b[..., None, None], axis=-2)[..., 0, :]
    qn = np.take_along_axis(q, b[..., None, None], axis=-2)[..., 0, :]
    outn = np.take_along_axis(out, b[..., None], axis=-1)[..., 0]
    g_out = np.sign(dn) * np.maximum(qn, 0.0) / np.maximum(outn[..., None], 1e-12)
    g_in = np.sign(dn) * np.eye(3)[qn.argmax(axis=-1)]
    return sdf, -np.where((outn > 0.0)[..., None], g_out, g_in)


def test_load_sdf_dump_matches_jax(spheres):
    _, prefix = spheres
    t, j = tga.load_sdf_dump(prefix, "cpu"), jga.load_sdf_dump(prefix)
    assert t["voxel_size"] == j["voxel_size"]
    np.testing.assert_array_equal(t["dim"], j["dim"])
    np.testing.assert_array_equal(t["vmin"], j["vmin"])
    for k in ("d", "w", "n0", "n1", "n2"):
        assert t[k].dtype == torch.float64
        np.testing.assert_array_equal(t[k].numpy(), j[k])
    assert (j["w"] > 0).sum() > 1000
    np.testing.assert_array_equal(tga.grid_points(t).numpy(), jga.grid_points(j))


def test_finite_differences_match_jax(spheres):
    _, prefix = spheres
    t, j = tga.load_sdf_dump(prefix, "cpu"), jga.load_sdf_dump(prefix)
    tg, tv = tga._finite_diff(t["d"], t["w"], t["voxel_size"])
    jg, jv = jga._finite_diff(j["d"], j["w"], j["voxel_size"])
    for mode in ("central", "forward", "backward"):
        np.testing.assert_array_equal(tv[mode].numpy(), jv[mode])
        np.testing.assert_allclose(tg[mode].numpy(), jg[mode], rtol=1e-15)


def test_analyze_spheres_matches_jax(spheres):
    data, prefix = spheres
    sph = np.loadtxt(os.path.join(data, "spheres.txt"))
    got = tga.analyze(tga.load_sdf_dump(prefix, "cpu"), sph[:, :3], sph[:, 3])
    want = jga.analyze(jga.load_sdf_dump(prefix), sph[:, :3], sph[:, 3])
    _same_stats(got, want)
    assert got["stored"][0]["count"] > 100


@pytest.mark.parametrize("num_bins", [5, 10])
def test_analyze_field_on_boxes_matches_jax(boxes, num_bins):
    """The same box field (signed argmin) into both `_analyze_field`s, and
    the port's `analyze_boxes`, which computes that field itself."""
    data, prefix = boxes
    bx = np.loadtxt(os.path.join(data, "boxes.txt"))
    jd = jga.load_sdf_dump(prefix)
    sdf, n = _signed_box_field(jga.grid_points(jd), bx[:, :3], bx[:, 3:])
    want = jga._analyze_field(jd, sdf, n, num_bins, 10.0)
    td = tga.load_sdf_dump(prefix, "cpu")
    _same_stats(tga._analyze_field(td, torch.from_numpy(sdf), torch.from_numpy(n),
                                   num_bins, 10.0), want)
    _same_stats(tga.analyze_boxes(td, bx[:, :3], bx[:, 3:], num_bins=num_bins),
                want)


def test_box_true_field_is_box_sdf_signed():
    """The port's field equals `data/synth.box_sdf` of the JAX package (the
    signed argmin), normals inward; the JAX `box_true_field` does not where
    a point inside one box lies nearer another box's surface."""
    world = jsynth.default_boxes(seed=2)
    c, h = np.asarray(world.centers), np.asarray(world.half_extents)
    rng = np.random.default_rng(1)
    # around the floor's top under the boxes (inside the slab and just above)
    pts = rng.uniform([-0.5, -0.5, -0.45], [0.5, 0.5, -0.35], (20000, 3))
    pts = pts.astype(np.float32).astype(np.float64)
    sdf, n = tga.box_true_field(torch.from_numpy(pts), c, h)
    js, jg = jsynth.box_sdf(world, pts.astype(np.float32))
    np.testing.assert_allclose(sdf.numpy(), np.asarray(js), atol=2e-6)
    agree = np.abs(n.numpy() + np.asarray(jg)).max(-1) < 1e-5
    assert agree.mean() > 0.999
    jsdf, _ = jga.box_true_field(pts, c, h)
    assert (np.abs(jsdf - np.asarray(js)) > 1e-4).sum() > 0   # the JAX fault


@pytest.mark.parametrize("n", [1, 2, 3, 4, 10, 1001, 4096])
def test_median_and_percentile_follow_numpy(n):
    """Even counts take the mean of the two middle values (torch.median
    takes the lower); percentiles interpolate linearly, as numpy does."""
    x = np.random.default_rng(n).standard_normal(n) * 7.0
    s = torch.sort(torch.from_numpy(x)).values
    assert tga.median_sorted(s) == np.median(x)
    for q in (0, 5, 50, 95, 99.9, 100):
        np.testing.assert_allclose(tga.percentile_sorted(s, q),
                                   np.percentile(x, q), rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("world", ["spheres", "box"])
def test_analyze_cli_json_matches_jax(spheres, boxes, tmp_path, capsys, world):
    """`analyze --json` in both packages on the same dump: the same
    structure, numbers and printed lines. The box run is held to the JAX
    module's `_analyze_field` on the signed field (the JAX CLI's own box
    numbers differ: its unsigned argmin gives other normals on this dump)."""
    data, prefix = spheres if world == "spheres" else boxes
    flag = (["--spheres", os.path.join(data, "spheres.txt")] if world == "spheres"
            else ["--boxes", os.path.join(data, "boxes.txt")])
    tj, jj = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    tanalyze.main(["--sdf-prefix", prefix, "--json", tj, "--device", "cpu"] + flag)
    tout = capsys.readouterr().out
    janalyze.main(["--sdf-prefix", prefix, "--json", jj] + flag)
    jout = capsys.readouterr().out
    with open(tj) as f, open(jj) as g:
        got, want = json.load(f), json.load(g)
    if world == "box":
        bx = np.loadtxt(os.path.join(data, "boxes.txt"))
        jd = jga.load_sdf_dump(prefix)
        sdf, n = _signed_box_field(jga.grid_points(jd), bx[:, :3], bx[:, 3:])
        want = json.loads(json.dumps(jga._analyze_field(jd, sdf, n, 10, 10.0)))
    _same_stats(got, want)
    assert tout.splitlines()[0] == jout.splitlines()[0] == "== stored"
    assert len(tout.splitlines()) == len(jout.splitlines())


def test_analyze_defaults_to_the_card(spheres):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    data, prefix = spheres
    with pytest.raises(RuntimeError, match="--device cpu"):
        tanalyze.main(["--sdf-prefix", prefix, "--spheres",
                       os.path.join(data, "spheres.txt")])
