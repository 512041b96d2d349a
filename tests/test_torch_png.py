"""The port's PNG codec (`gradient_sdf_tpu_torch/data/png.py` and its native
row unfilter `native/png_unfilter.c`) against its plain numpy unfilter, PIL
and the JAX package's loaders.

Every comparison is exact: PNG is lossless, so a decoder either returns
the stored samples or is wrong. PIL keeps 8 bits of a 16-bit RGB, RGBA or
grey+alpha sample (the most significant byte); those comparisons take the
port's samples >> 8.
"""

import os
import struct
import zlib

import numpy as np
import pytest

from gradient_sdf_tpu_torch.data import loaders as tld
from gradient_sdf_tpu_torch.data import png

# colour type -> samples per pixel
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _image(rng, h, w, ch, depth=8):
    """A smooth gradient plus noise, so every filter type wins some rows
    when an encoder chooses per row."""
    y, x = np.mgrid[0:h, 0:w]
    top = (1 << depth) - 1
    base = np.stack([(x * 7 + y * 3 + 40 * k) % (top + 1) for k in range(ch)], -1)
    img = (base + rng.integers(0, 8, (h, w, ch))) % (top + 1)
    return img.astype(np.uint16 if depth == 16 else np.uint8)


def _encode(path, samples, ctype, depth, rng, interlace=False, plte=None):
    """A PNG written here, sample by sample, with a random filter per row:
    colour types and bit depths `write_png` does not write, and Adam7."""
    h, w = samples.shape[:2]
    ch = CHANNELS[ctype]
    bits = ch * depth
    bpp = max(1, bits // 8)

    def rows(sub):
        sh, sw = sub.shape[:2]
        if depth == 16:
            raw = sub.astype(">u2").reshape(sh, -1).view(np.uint8)
        elif depth == 8:
            raw = sub.reshape(sh, -1).astype(np.uint8)
        else:
            per = 8 // depth
            vals = sub.reshape(sh, sw).astype(np.uint8)
            pad = (-sw) % per
            vals = np.concatenate([vals, np.zeros((sh, pad), np.uint8)], 1)
            vals = vals.reshape(sh, -1, per)
            shifts = np.arange(per - 1, -1, -1) * depth
            raw = (vals << shifts).sum(-1).astype(np.uint8)
        return png.filter_rows(raw, bpp, rng.integers(0, 5, sh)).tobytes()

    if interlace:
        data = b"".join(rows(samples[y0::dy, x0::dx])
                        for x0, y0, dx, dy in png.ADAM7
                        if x0 < w and y0 < h)
    else:
        data = rows(samples)
    chunks = [png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                              0, 0, int(interlace)))]
    if plte is not None:
        chunks.append(png._chunk(b"PLTE", plte.astype(np.uint8).tobytes()))
    chunks += [png._chunk(b"IDAT", zlib.compress(data)), png._chunk(b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(png._SIGNATURE + b"".join(chunks))


def _pil(path, convert=None):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert(convert) if convert else im)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_native_unfilter_matches_plain_version(bpp):
    """Random bytes under random per-row filters 0-4: the C unfilter and
    the plain numpy one undo them to the same rows, and to the rows that
    were filtered."""
    rng = np.random.default_rng(bpp)
    raw = rng.integers(0, 256, (37, bpp * 29), dtype=np.uint8)
    data = png.filter_rows(raw, bpp, rng.integers(0, 5, raw.shape[0])).tobytes()
    got = png.unfilter(data, raw.shape[0], raw.shape[1], bpp)
    np.testing.assert_array_equal(got, png._unfilter(data, *raw.shape, bpp))
    np.testing.assert_array_equal(got, raw)


@pytest.mark.parametrize("what", ["rgb8", "grey16", "grey8"])
def test_write_png_per_row_filters_read_by_pil_and_port(tmp_path, what):
    """`write_png` with every row on its own filter: PIL and `read_png`
    read back the image; the file holds the filters asked for."""
    rng = np.random.default_rng(3)
    img = {"rgb8": lambda: _image(rng, 41, 53, 3),
           "grey16": lambda: _image(rng, 41, 53, 1, 16)[..., 0],
           "grey8": lambda: _image(rng, 41, 53, 1)[..., 0]}[what]()
    filters = np.arange(41) % 5
    path = str(tmp_path / "f.png")
    png.write_png(path, img, filters=filters)
    np.testing.assert_array_equal(png.read_png(path), img)
    np.testing.assert_array_equal(_pil(path), img)
    with open(path, "rb") as f:
        blob = f.read()
    start = blob.index(b"IDAT") + 4
    n = struct.unpack(">I", blob[start - 8:start - 4])[0]
    data = zlib.decompress(blob[start:start + n])
    stride = img[0].nbytes
    np.testing.assert_array_equal(
        np.frombuffer(data, np.uint8)[::stride + 1], filters)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "LA", "I;16"])
def test_pil_written_images_read_as_pil_reads_them(tmp_path, mode):
    """PIL chooses a filter per row (adaptive filtering), so these images
    send rows down all five filters."""
    from PIL import Image

    rng = np.random.default_rng(5)
    ch = {"L": 1, "RGB": 3, "RGBA": 4, "LA": 2, "I;16": 1}[mode]
    img = _image(rng, 47, 61, ch, 16 if mode == "I;16" else 8)
    img = img[..., 0] if ch == 1 else img
    path = str(tmp_path / "p.png")
    Image.fromarray(img).save(path)
    got = png.read_png(path)
    np.testing.assert_array_equal(got, _pil(path))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("colours", [2, 4, 16, 256])
def test_palette_images_expand_through_plte(tmp_path, colours):
    """PIL writes a palette of 2, 4 or 16 colours at 1, 2 or 4 bits per
    index. The port expands indices to RGB, as PIL's convert("RGB") does
    (the JAX loader's `np.asarray` of a palette image gives the indices)."""
    from PIL import Image

    rng = np.random.default_rng(colours)
    idx = rng.integers(0, colours, (29, 43)).astype(np.uint8)
    im = Image.fromarray(idx, "P")
    im.putpalette(rng.integers(0, 256, 3 * colours).astype(np.uint8).tolist())
    path = str(tmp_path / "p.png")
    im.save(path)
    with open(path, "rb") as f:
        depth = f.read()[24]
    assert depth == {2: 1, 4: 2, 16: 4, 256: 8}[colours]
    np.testing.assert_array_equal(png.read_png(path), _pil(path, "RGB"))


@pytest.mark.parametrize("ctype", [2, 4, 6])
def test_sixteen_bit_colour_types(tmp_path, ctype):
    """16-bit RGB, grey+alpha and RGBA (PIL writes none of them): the port
    returns the stored 16-bit samples; PIL reads their high bytes (and opens
    grey+alpha as RGBA, grey on three channels)."""
    rng = np.random.default_rng(ctype)
    img = _image(rng, 23, 31, CHANNELS[ctype], 16)
    path = str(tmp_path / "s.png")
    _encode(path, img, ctype, 16, rng)
    got = png.read_png(path)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal((got >> 8).astype(np.uint8),
                                  _pil(path, "LA" if ctype == 4 else None))


ADAM7_CASES = [(0, 8), (0, 16), (2, 8), (2, 16), (3, 4), (3, 8), (4, 8),
               (6, 8), (6, 16)]


@pytest.mark.parametrize("ctype,depth", ADAM7_CASES)
def test_adam7_interlaced_images(tmp_path, ctype, depth):
    """Adam7 images, down to sizes where some of the seven passes are empty,
    each pass under random row filters: equal to PIL and to the samples."""
    rng = np.random.default_rng(ctype * 100 + depth)
    for h, w in ((1, 1), (3, 5), (9, 13), (40, 33)):
        ch = CHANNELS[ctype]
        if ctype == 3:
            img = rng.integers(0, 1 << depth, (h, w, 1)).astype(np.uint8)
            plte = rng.integers(0, 256, (1 << depth, 3))
        else:
            img = _image(rng, h, w, ch, depth)
            plte = None
        path = str(tmp_path / f"a{h}.png")
        _encode(path, img, ctype, depth, rng, interlace=True, plte=plte)
        got = png.read_png(path)
        if ctype == 3:
            want = plte.astype(np.uint8)[img[..., 0]]
            np.testing.assert_array_equal(_pil(path, "RGB"), want)
        else:
            want = img[..., 0] if ch == 1 else img
            pil = _pil(path)
            cmp = (got >> 8).astype(np.uint8) if depth == 16 and ch > 1 else got
            np.testing.assert_array_equal(cmp, pil)
        np.testing.assert_array_equal(got, want)


def test_bad_filter_type_and_bad_size_raise(tmp_path):
    raw = np.zeros((4, 10), np.uint8)
    data = bytearray(png.filter_rows(raw, 1, [0, 1, 2, 3]).tobytes())
    data[2 * 11] = 5
    with pytest.raises(ValueError, match="filter type 5"):
        png.unfilter(bytes(data), 4, 10, 1)
    with pytest.raises(ValueError, match="wrong size"):
        png.unfilter(bytes(data[:-1]), 4, 10, 1)
    path = str(tmp_path / "x.png")
    _encode(path, np.zeros((4, 4, 1), np.uint8), 0, 8,
            np.random.default_rng(0))
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:   # grey at 4 bits: outside what the port reads
        f.write(blob[:24] + bytes([4]) + blob[25:])
    with pytest.raises(ValueError, match="unsupported PNG"):
        png.read_png(path)


def test_header_claiming_a_huge_image_raises_without_allocating_it(tmp_path):
    """An IHDR claiming 60000 x 60000 RGBA at 16 bits (~29 GB of samples)
    over a tiny stream: `read_png` sizes zlib's buffer by what the stream
    can inflate to, and raises on the short data."""
    path = str(tmp_path / "huge.png")
    _encode(path, np.zeros((4, 4, 1), np.uint8), 0, 8, np.random.default_rng(0))
    with open(path, "rb") as f:
        blob = f.read()
    ihdr = struct.pack(">IIBBBBB", 60000, 60000, 16, 6, 0, 0, 0)
    chunk = (struct.pack(">I", 13) + b"IHDR" + ihdr
             + struct.pack(">I", zlib.crc32(b"IHDR" + ihdr) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(blob[:8] + chunk + blob[33:])
    with pytest.raises(ValueError, match="wrong size"):
        png.read_png(path)


@pytest.mark.parametrize("what", ["depth", "rgb"])
def test_vga_pair_equals_the_jax_loader(tmp_path, what):
    """A 640x480 depth and RGB pair as PIL writes them: the port's loader
    functions return what the JAX package's return, to the bit."""
    from PIL import Image
    from gradient_sdf_tpu.data import loaders as jld

    rng = np.random.default_rng(11)
    path = str(tmp_path / f"{what}.png")
    if what == "depth":
        img = _image(rng, 480, 640, 1, 16)[..., 0]
        Image.fromarray(img).save(path)
        np.testing.assert_array_equal(tld.load_depth_png(path, 1 / 5000.0),
                                      jld.load_depth_png(path, 1 / 5000.0))
    else:
        Image.fromarray(_image(rng, 480, 640, 3)).save(path)
        np.testing.assert_array_equal(tld.load_color_png(path),
                                      jld.load_color_png(path))


@pytest.mark.parametrize("mode", ["RGBA", "LA"])
def test_loader_drops_alpha(tmp_path, mode):
    """RGBA loses its alpha, as in the JAX loader. Grey+alpha gives its grey
    on all three channels (the JAX loader passes its 2 channels on)."""
    from PIL import Image
    from gradient_sdf_tpu.data import loaders as jld

    rng = np.random.default_rng(13)
    img = _image(rng, 20, 30, len(mode))
    path = str(tmp_path / "a.png")
    Image.fromarray(img).save(path)
    got = tld.load_color_png(path)
    assert got.shape == (20, 30, 3)
    if mode == "RGBA":
        np.testing.assert_array_equal(got, jld.load_color_png(path))
    else:
        np.testing.assert_array_equal(
            got, np.repeat(img[..., :1], 3, -1).astype(np.float32) / 255.0)
        assert jld.load_color_png(path).shape[-1] == 2


@pytest.mark.gpu
def test_native_unfilter_builds_and_matches_on_the_card_machine(tmp_path):
    """On the machine with the card (no PIL there): the unfilter builds with
    its host compiler and undoes VGA rows of all five filters, 8-bit RGB and
    16-bit grey, to the plain version's rows."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA machine's build")
    rng = np.random.default_rng(0)
    for img in (_image(rng, 480, 640, 3), _image(rng, 480, 640, 1, 16)[..., 0]):
        path = str(tmp_path / "v.png")
        png.write_png(path, img, filters=np.arange(480) % 5)
        np.testing.assert_array_equal(png.read_png(path), img)
        raw = np.ascontiguousarray(img.astype(">u2") if img.dtype == np.uint16
                                   else img).reshape(480, -1).view(np.uint8)
        bpp = 3 if img.ndim == 3 else 2
        data = png.filter_rows(raw, bpp, np.arange(480) % 5).tobytes()
        np.testing.assert_array_equal(png.unfilter(data, 480, raw.shape[1], bpp),
                                      png._unfilter(data, 480, raw.shape[1], bpp))
