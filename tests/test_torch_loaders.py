"""The port's dataset loaders (`gradient_sdf_tpu_torch/data/loaders.py`)
against the JAX package's on the same folders, written with PIL as
`tests/test_loaders.py` writes them: the tests of that file, and every
frame equal to the JAX loader's, colour and depth, bit for bit (the port's
PNG and JPEG decoders return PIL's samples)."""

import os

import numpy as np
import pytest
from PIL import Image

from gradient_sdf_tpu.data import loaders as jld
from gradient_sdf_tpu_torch.data import loaders as tld


def _write_depth(path, shape=(12, 16), value=1234, rng=None):
    arr = np.full(shape, value, np.uint16)
    if rng is not None:
        arr = rng.integers(0, 65535, shape).astype(np.uint16)
    Image.fromarray(arr).save(path)


def _write_rgb(path, shape=(12, 16), value=100, rng=None, **kw):
    arr = np.full(shape + (3,), value, np.uint8)
    if rng is not None:
        y, x = np.mgrid[0:shape[0], 0:shape[1]]
        arr = ((x * 5 + y * 3)[..., None] + np.arange(3) * 60
               + rng.integers(0, 30, shape + (3,))).astype(np.uint8)
    Image.fromarray(arr).save(path, **kw)


def _same_frames(data_type, path, first=0, last=None):
    """Both packages' frames over the same range: equal, and returned."""
    tframes = list(tld.make_loader(data_type, path).frames(first, last))
    jframes = list(jld.make_loader(data_type, path).frames(first, last))
    assert len(tframes) == len(jframes)
    for a, b in zip(tframes, jframes):
        assert (a.index, a.timestamp) == (b.index, b.timestamp)
        assert a.color.dtype == b.color.dtype == np.float32
        np.testing.assert_array_equal(a.color, b.color)
        np.testing.assert_array_equal(a.depth, b.depth)
    return tframes


def test_tum_loader(tmp_path):
    d = tmp_path / "tum"
    (d / "depth").mkdir(parents=True)
    (d / "rgb").mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        _write_depth(str(d / "depth" / f"{i}.png"), rng=rng)
        _write_rgb(str(d / "rgb" / f"{i}.png"), rng=rng)
    with open(d / "associated.txt", "w") as f:
        f.write("# comment line\n")
        for i in range(3):
            f.write(f"10.{i} rgb/{i}.png 10.{i}5 depth/{i}.png\n")
    np.savetxt(d / "intrinsics.txt", np.eye(3))

    ld = tld.make_loader("tum", str(d))
    assert len(ld) == 3
    frames = _same_frames("tum", str(d))
    assert len(frames) == 3
    assert frames[0].color.shape == (12, 16, 3)
    assert frames[0].timestamp == "10.0"
    np.testing.assert_array_equal(ld.load_intrinsics(),
                                  jld.make_loader("tum", str(d)).load_intrinsics())
    np.testing.assert_array_equal(ld.load_color_at(1), frames[1].color)
    # TUM depth unit is 1/5000
    _write_depth(str(d / "depth" / "0.png"))
    np.testing.assert_allclose(next(ld.frames()).depth, 1234 / 5000.0, rtol=1e-6)


@pytest.mark.parametrize("sampling", [0, 2])
def test_redwood_loader(tmp_path, sampling):
    """Redwood's colour frames are JPEGs (4:4:4 and 4:2:0 here): the JAX
    loader decodes them with PIL, the port with its own decoder."""
    d = tmp_path / "rw"
    (d / "depth").mkdir(parents=True)
    (d / "rgb").mkdir()
    rng = np.random.default_rng(1)
    for i in range(2):
        _write_depth(str(d / "depth" / f"00{i}.png"))
        _write_rgb(str(d / "rgb" / f"00{i}.jpg"), shape=(30, 41), rng=rng,
                   quality=85, subsampling=sampling)
        _write_depth(str(d / "depth" / f"00{i}.png"), shape=(30, 41))
    frames = _same_frames("rw", str(d))
    assert len(frames) == 2
    # Redwood unit 1/1000, timestamp = the file's stem
    np.testing.assert_allclose(frames[0].depth, 1.234, rtol=1e-3)
    assert frames[0].timestamp == "000"
    ld = tld.make_loader("redwood", str(d))
    assert len(ld) == 2
    np.testing.assert_array_equal(ld.load_color_at(1), frames[1].color)
    assert ld.load_color_at(2) is None


def test_printed3d_loader(tmp_path):
    d = tmp_path / "p3d"
    d.mkdir()
    rng = np.random.default_rng(2)
    for i in range(2):
        _write_depth(str(d / f"depth_{i:06d}.png"))
        _write_rgb(str(d / f"color_{i:06d}.png"), rng=rng)
    frames = _same_frames("printed", str(d))
    assert len(frames) == 2
    np.testing.assert_allclose(frames[1].depth, 1.234, rtol=1e-3)
    assert [f.timestamp for f in frames] == ["000000", "000001"]
    ld = tld.make_loader("printed3d", str(d))
    np.testing.assert_array_equal(ld.load_color_at(0), frames[0].color)
    assert ld.load_color_at(5) is None


def test_synth_loader_keyframe_albedo(tmp_path):
    d = tmp_path / "sy"
    for sub in ("depth", "rgb", "albedo"):
        (d / sub).mkdir(parents=True)
    _write_depth(str(d / "depth" / "001.png"))
    _write_rgb(str(d / "rgb" / "001.png"), value=50)
    _write_rgb(str(d / "albedo" / "001.png"), value=200)
    ld = tld.make_loader("synth", str(d))
    frames = _same_frames("synth", str(d))
    assert len(frames) == 1
    kf = ld.load_keyframe(0)
    want = jld.make_loader("synth", str(d)).load_keyframe(0)
    assert kf is not None
    # keyframe colour comes from albedo/ (SynthLoader.h:86-107)
    np.testing.assert_allclose(kf.color, 200 / 255.0, rtol=1e-6)
    np.testing.assert_allclose(frames[0].color, 50 / 255.0, rtol=1e-6)
    np.testing.assert_array_equal(kf.color, want.color)
    np.testing.assert_array_equal(kf.depth, want.depth)
    assert (kf.timestamp, kf.index) == (want.timestamp, want.index) == ("001", 0)
    assert ld.load_keyframe(1) is None
    assert tld.make_loader("printed", str(d)).load_keyframe(0) is None


def _make_synth_dir(d, n=6, w=20, h=14):
    (d / "depth").mkdir(parents=True)
    (d / "rgb").mkdir()
    rng = np.random.RandomState(7)
    for i in range(n):
        depth = rng.randint(0, 65535, size=(h, w)).astype(np.uint16)
        rgb = rng.randint(0, 255, size=(h, w, 3)).astype(np.uint8)
        Image.fromarray(depth).save(str(d / "depth" / f"{i + 1:03d}.png"))
        Image.fromarray(rgb).save(str(d / "rgb" / f"{i + 1:03d}.png"))


def test_frames_range_respects_first_last(tmp_path):
    d = tmp_path / "synth"
    _make_synth_dir(d, n=6)
    frames = _same_frames("synth", str(d), 2, 5)
    assert [f.index for f in frames] == [2, 3, 4]
    assert [f.index for f in _same_frames("synth", str(d))] == list(range(6))


def test_unknown_data_type_and_image_type_raise(tmp_path):
    with pytest.raises(ValueError, match="unknown data type"):
        tld.make_loader("kitti", str(tmp_path))
    path = str(tmp_path / "a.bmp")
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(path)
    with pytest.raises(ValueError, match="no decoder"):
        tld.load_color_png(path)
