"""The port's baseline JPEG decoder (`gradient_sdf_tpu_torch/data/jpeg.py`
over `native/jpeg_decode.c`) against PIL, which decodes with libjpeg's
default settings (islow IDCT, fancy upsampling).

The decoder follows libjpeg's integer arithmetic, so the samples are held
EQUAL to PIL's; a failure reports how many differ and by how much. The
images are smooth fields with noise at sizes that are not multiples of the
MCU (641x479 and small ones down to 1x1, where libjpeg's fancy upsampling
falls back to replication), at qualities 50, 75 and 95.
"""

import os

import numpy as np
import pytest

from gradient_sdf_tpu_torch.data import jpeg

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "jpeg")
SIZES = [(479, 641), (17, 3), (33, 5), (2, 2), (1, 1), (24, 32)]


def _image(rng, h, w):
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 17.0 + k) * np.cos(y / 23.0 - k)
                     for k in range(3)], -1)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)


def _save_and_compare(tmp_path, img, **kw):
    from PIL import Image

    path = str(tmp_path / "t.jpg")
    Image.fromarray(img).save(path, **kw)
    with Image.open(path) as im:
        want = np.asarray(im)
    got = jpeg.read_jpeg(path)
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert not diff.any(), (f"{int((diff > 0).sum())} of {diff.size} samples "
                            f"differ from PIL's, by up to {int(diff.max())}")


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "grey"])
def test_decoder_equals_pil(tmp_path, quality, sampling):
    rng = np.random.default_rng(quality)
    for h, w in SIZES:
        img = _image(rng, h, w)
        if sampling == "grey":
            _save_and_compare(tmp_path, img[..., 0], quality=quality)
        else:
            sub = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}[sampling]
            _save_and_compare(tmp_path, img, quality=quality, subsampling=sub)


@pytest.mark.parametrize("sampling", [0, 1, 2])
@pytest.mark.parametrize("restart", [dict(restart_marker_blocks=3),
                                     dict(restart_marker_rows=1)])
def test_restart_intervals(tmp_path, sampling, restart):
    """A restart marker every 3 MCUs, or every MCU row: DC predictors reset
    and the bit stream realigns at each."""
    img = _image(np.random.default_rng(sampling), 479, 641)
    _save_and_compare(tmp_path, img, quality=80, subsampling=sampling, **restart)
    with open(str(tmp_path / "t.jpg"), "rb") as f:
        blob = f.read()
    assert b"\xff\xdd" in blob and b"\xff\xd0" in blob


def test_unsupported_files_raise(tmp_path):
    """Progressive (written by PIL) and, patched into a baseline file's
    frame header, 12-bit samples and arithmetic coding raise ValueError;
    so do a CMYK file and a file that is no JPEG."""
    from PIL import Image

    img = _image(np.random.default_rng(0), 48, 64)
    path = str(tmp_path / "p.jpg")
    Image.fromarray(img).save(path, progressive=True)
    with pytest.raises(ValueError, match="progressive"):
        jpeg.read_jpeg(path)
    Image.fromarray(img).save(path, quality=80)
    with open(path, "rb") as f:
        blob = f.read()
    sof = blob.index(b"\xff\xc0")
    with pytest.raises(ValueError, match="8-bit"):
        jpeg.decode_jpeg(blob[:sof + 4] + bytes([12]) + blob[sof + 5:])
    with pytest.raises(ValueError, match="arithmetic"):
        jpeg.decode_jpeg(blob[:sof + 1] + b"\xc9" + blob[sof + 2:])
    # a second frame header, here of another size: the output was sized by
    # the first
    end = sof + 2 + int.from_bytes(blob[sof + 2:sof + 4], "big")
    bigger = blob[sof:sof + 5] + (96).to_bytes(2, "big") + blob[sof + 7:end]
    with pytest.raises(ValueError, match="more than one frame header"):
        jpeg.decode_jpeg(blob[:end] + bigger + blob[end:])
    Image.fromarray(img).convert("CMYK").save(path)
    with pytest.raises(ValueError, match="3-component"):
        jpeg.read_jpeg(path)
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x89PNG\r\n\x1a\n")


def test_committed_fixtures_still_decode_as_stored():
    """The fixtures the smoke holds the decoder to on the card's machine
    (which has no PIL): PIL here still decodes each to its stored array,
    and so does the port."""
    from PIL import Image

    with np.load(os.path.join(FIXTURES, "pil_decodes.npz")) as z:
        stored = {k: z[k] for k in z.files}
    assert sorted(stored) == ["golden_420.jpg", "golden_444.jpg", "golden_grey.jpg"]
    for name, want in stored.items():
        path = os.path.join(FIXTURES, name)
        with Image.open(path) as im:
            np.testing.assert_array_equal(np.asarray(im), want)
        np.testing.assert_array_equal(jpeg.read_jpeg(path), want)


@pytest.mark.gpu
def test_decoder_builds_and_matches_fixtures_on_the_card_machine():
    """On the machine with the card: the decoder builds with its host
    compiler and decodes the committed fixtures to PIL's stored arrays."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA machine's build")
    with np.load(os.path.join(FIXTURES, "pil_decodes.npz")) as z:
        for name in z.files:
            np.testing.assert_array_equal(
                jpeg.read_jpeg(os.path.join(FIXTURES, name)), z[name])
