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


# ---------------------------------------------------------------------------
# decode-ahead: `frames()` through `_PrefetchReader`, the counterpart of the
# JAX loader's native prefetcher (tests/test_loaders.py:102-147)
# ---------------------------------------------------------------------------

JPEG_DIR = os.path.join(os.path.dirname(__file__), "data", "jpeg")
JPEGS = ["golden_420.jpg", "golden_444.jpg", "golden_grey.jpg"]


def _folder(tmp_path, data_type, n=5):
    """A folder of `n` frames in `data_type`'s layout: random 16-bit depth
    PNGs, random RGB PNGs (Redwood: the committed JPEG fixtures)."""
    import shutil

    rng = np.random.default_rng(11)
    d = tmp_path / data_type
    d.mkdir()
    if data_type != "printed":
        (d / "depth").mkdir()
        (d / "rgb").mkdir()
    names = {
        "tum": lambda i: (f"rgb/{i}.png", f"depth/{i}.png"),
        "synth": lambda i: (f"rgb/{i + 1:03d}.png", f"depth/{i + 1:03d}.png"),
        "printed": lambda i: (f"color_{i:06d}.png", f"depth_{i:06d}.png"),
        "rw": lambda i: (f"rgb/{i:05d}.jpg", f"depth/{i:05d}.png"),
    }[data_type]
    for i in range(n):
        cp, dp = names(i)
        _write_depth(str(d / dp), shape=(14, 20), rng=rng)
        if data_type == "rw":
            shutil.copy(os.path.join(JPEG_DIR, JPEGS[i % 3]), d / cp)
        else:
            _write_rgb(str(d / cp), shape=(14, 20), rng=rng)
    if data_type == "tum":
        with open(d / "associated.txt", "w") as f:
            for i in range(n):
                cp, dp = names(i)
                f.write(f"{i}.0 {cp} {i}.01 {dp}\n")
    return str(d), names


@pytest.mark.parametrize("window", [1, 16])
@pytest.mark.parametrize("n_threads", [0, 1, 2])
@pytest.mark.parametrize("data_type", ["tum", "synth", "printed", "rw"])
def test_frames_decode_ahead_equal_jax(tmp_path, data_type, n_threads, window):
    """Every frame, in order, byte-equal to the JAX loader's frames() (its
    native prefetcher for PNG, PIL for JPEG) and to the synchronous decode
    of the same files."""
    path, names = _folder(tmp_path, data_type)
    ld = tld.make_loader(data_type, path)
    got = list(ld.frames(n_threads=n_threads, window=window))
    want = list(jld.make_loader(data_type, path).frames())
    assert [f.index for f in got] == [f.index for f in want] == list(range(5))
    for a, b in zip(got, want):
        assert a.timestamp == b.timestamp
        assert a.color.dtype == a.depth.dtype == np.float32
        np.testing.assert_array_equal(a.color, b.color)
        np.testing.assert_array_equal(a.depth, b.depth)
        cp, dp = names(a.index)
        np.testing.assert_array_equal(a.color, tld.load_color_png(os.path.join(path, cp)))
        np.testing.assert_array_equal(
            a.depth, tld.load_depth_png(os.path.join(path, dp), ld.unit))
    assert ld.reader.n_threads == n_threads and ld.reader.window == window


def _depth_paths(tmp_path, n):
    path, names = _folder(tmp_path, "synth", n)
    return [os.path.join(path, names(i)[1]) for i in range(n)]


def test_reader_window_one_serves_every_image_and_out_of_order(tmp_path):
    """A window of 1 still serves every image (taking one unblocks the
    stalled workers), and a request past the window slides it forward."""
    paths = _depth_paths(tmp_path, 5)
    want = [tld._imread(p) for p in paths]
    reader = tld._PrefetchReader(paths, n_threads=2, window=1)
    try:
        for i in range(5):
            np.testing.assert_array_equal(reader.get(i), want[i])
    finally:
        reader.close()
    reader = tld._PrefetchReader(paths, n_threads=2, window=1)
    try:
        np.testing.assert_array_equal(reader.get(4), want[4])
        np.testing.assert_array_equal(reader.get(0), want[0])
        with pytest.raises(IndexError):
            reader.get(5)
        with pytest.raises(IndexError, match="taken already"):
            reader.get(4)
    finally:
        reader.close()


@pytest.mark.parametrize("n_threads", [0, 2])
def test_corrupt_png_raises_at_its_frame(tmp_path, n_threads):
    """A corrupt depth PNG at frame 3 of 6: frames 0-2 come out, then the
    error, with the file's path, on the loop's thread; no frame is skipped
    and nothing is decoded again."""
    path, names = _folder(tmp_path, "synth", 6)
    bad = os.path.join(path, names(3)[1])
    with open(bad, "r+b") as f:
        f.seek(48)    # 8 signature + 25 IHDR + 8 IDAT length and tag + 7
        f.write(b"\xff" * 16)    # inside the IDAT stream
    seen = []
    with pytest.raises(RuntimeError, match=bad):
        for frame in tld.make_loader("synth", path).frames(n_threads=n_threads):
            seen.append(frame.index)
    assert seen == [0, 1, 2]


def _decode_threads():
    import threading

    return [t for t in threading.enumerate() if t.name.startswith("gsdf-decode")]


@pytest.mark.parametrize("how", ["break", "raise", "last", "end"])
def test_frames_leaves_no_thread(tmp_path, how):
    """Breaking out of frames(), raising inside the loop, stopping at a
    `last` and running to the end all leave no reader thread behind."""
    import threading

    path, _ = _folder(tmp_path, "synth", 8)
    before = threading.active_count()
    ld = tld.make_loader("synth", path)
    if how == "break":
        for frame in ld.frames():
            if frame.index == 1:
                break
    elif how == "raise":
        with pytest.raises(KeyError):
            for frame in ld.frames():
                if frame.index == 2:
                    raise KeyError("stop")
    elif how == "last":
        assert [f.index for f in ld.frames(0, 3)] == [0, 1, 2]
    else:
        assert len(list(ld.frames())) == 8
    assert not _decode_threads()
    assert threading.active_count() == before


@pytest.mark.parametrize("window", [1, 4, 16])
def test_reader_peak_resident_bounded(tmp_path, window):
    """The decoded images waiting for the loop, with those in progress,
    never exceed the window plus the thread count, however slow the loop."""
    import time

    path, _ = _folder(tmp_path, "synth", 12)
    ld = tld.make_loader("synth", path)
    for _ in ld.frames(window=window):
        time.sleep(0.005)     # a slow consumer: the workers run ahead
    assert 1 <= ld.reader.peak_resident <= window + ld.reader.n_threads


def test_reader_stress_more_threads_than_cores(tmp_path):
    """More decoding threads than cores, a 1 us switch interval and a window
    of 3: every image is decoded exactly once, comes back in order, at most
    3 are resident, and every worker is joined, within a time bound."""
    import collections
    import sys
    import threading

    n, window = 24, 3
    paths = _depth_paths(tmp_path, n)
    want = [tld._imread(p) for p in paths]
    calls, lock = collections.Counter(), threading.Lock()

    def counting(k):
        def convert(a):
            with lock:
                calls[k] += 1
            return a
        return convert

    out = {}

    def body():
        reader = tld._PrefetchReader(paths, n_threads=(os.cpu_count() or 4) + 4,
                                     window=window,
                                     convert=[counting(k) for k in range(n)])
        try:
            out["got"] = [reader.get(k) for k in range(n)]
        finally:
            reader.close()
        out["reader"] = reader

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=body, daemon=True)
        t.start()
        t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive(), "the reader did not finish within 120 s"
    reader = out["reader"]
    for got, w in zip(out["got"], want):
        np.testing.assert_array_equal(got, w)
    assert len(out["got"]) == n and dict(calls) == {k: 1 for k in range(n)}
    assert 1 <= reader.peak_resident <= window
    assert not any(w.is_alive() for w in reader._threads)
