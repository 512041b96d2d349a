"""A small PNG codec on the standard library (zlib + struct), numpy and a
native row unfilter.

Reads greyscale (colour type 0) and RGB (2) at 8 and 16 bits, palette
images (3) at 1, 2, 4 and 8 bits, expanded through `PLTE` to RGB, grey+alpha
(4) and RGBA (6) at 8 and 16 bits, non-interlaced or Adam7-interlaced, with
any of the five row filters (0 none, 1 sub, 2 up, 3 average, 4 Paeth). That
covers what the JAX package's loaders read through its native decoder or
PIL. Rows are unfiltered by `native/png_unfilter.c`, built at first use with
the host C compiler; `_unfilter` below is its plain numpy version, which the
tests hold it to. Writes greyscale or RGB at 8 bits and greyscale at 16
bits, with a filter per row (default 0). 16-bit samples are big-endian in
the file, as the format requires.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from ..native import _build

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples per pixel, allowed bit depths)
_TYPES = {0: (1, (8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
          4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7 passes: (x start, y start, x step, y step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def filter_rows(raw: np.ndarray, bpp: int, filters) -> np.ndarray:
    """Encode uint8 rows [h, stride] with filter type `filters[y]` on row y
    -> the [h, 1 + stride] bytes of the image data stream. Every filter is
    elementwise on the unfiltered bytes, so all rows encode at once."""
    h, stride = raw.shape
    ftype = np.asarray(filters, np.uint8).reshape(h)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG filter types are 0-4, got {int(ftype.max())}")
    x = raw.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = np.select([ftype[:, None] == k for k in (1, 2, 3, 4)],
                     [a, b, (a + b) >> 1, paeth], 0)
    out = ((x - pred) & 0xFF).astype(np.uint8)
    return np.concatenate([ftype[:, None], out], axis=1)


def write_png(path: str, img: np.ndarray, filters=None):
    """Write uint8 [H, W] / [H, W, 3] or uint16 [H, W] as a PNG. `filters`:
    one filter type (0-4) per row; default 0 on every row."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 2:
        ctype, depth = 0, 8
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        ctype, depth = 2, 8
    elif img.dtype == np.uint16 and img.ndim == 2:
        ctype, depth = 0, 16
    else:
        raise ValueError(f"unsupported image {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = img.astype(">u2") if depth == 16 else img
    raw = np.ascontiguousarray(rows).reshape(h, -1).view(np.uint8)
    bpp = (1 if img.ndim == 2 else 3) * depth // 8
    data = filter_rows(raw, bpp, np.zeros(h, np.uint8) if filters is None
                       else filters)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(data.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters -> uint8 [h, stride]. The plain version of
    `unfilter`: numpy for filters 0-2, an interpreted loop for 3 and 4."""
    raw = np.frombuffer(data, np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = raw[y, 0]
        line = raw[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:    # sub: running sum per byte lane, mod 256
            cur = np.cumsum(line.reshape(-1, bpp).astype(np.uint32),
                            axis=0).astype(np.uint8).reshape(-1)
        elif ftype == 2:    # up
            cur = line + prev
        elif ftype in (3, 4):  # average / Paeth: sequential along the row
            cur = _unfilter_seq(line.tolist(), prev.tolist(), bpp, ftype)
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def _unfilter_seq(line, prev, bpp, ftype) -> np.ndarray:
    cur = [0] * len(line)
    for i, x in enumerate(line):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if ftype == 3:
            cur[i] = (x + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (x + pred) & 0xFF
    return np.asarray(cur, np.uint8)


def _native():
    lib = _build.load("png_unfilter")
    fn = lib.gsdf_png_unfilter
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64]
        fn.restype = ctypes.c_int64
    return fn


def unfilter(data, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters -> uint8 [h, stride], in native code (the
    same function as `_unfilter`)."""
    raw = np.frombuffer(data, np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    out = np.empty((h, stride), np.uint8)
    bad = _native()(raw.ctypes.data, out.ctypes.data, h, stride, bpp)
    if bad:
        raise ValueError(f"unknown PNG filter type {raw[(bad - 1) * (stride + 1)]}")
    return out


def _samples(rows: np.ndarray, w: int, depth: int, ch: int) -> np.ndarray:
    """Unfiltered rows [h, stride] -> samples [h, w, ch] (uint8, or uint16 at
    16 bits; sub-byte samples unpacked, most significant bits first)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.reshape(h, -1, 2).view(">u2")[..., 0].astype(
            np.uint16).reshape(h, w, ch)
    if depth == 8:
        return rows.reshape(h, w, ch)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    vals = (bits * weights).sum(axis=-1, dtype=np.uint8)
    return vals[:, :w * ch].reshape(h, w, ch)


def read_png(path: str) -> np.ndarray:
    """PNG -> numpy array, uint8 or uint16 (16-bit images): [H, W] grey,
    [H, W, 2] grey+alpha, [H, W, 3] RGB and palette images (expanded through
    the palette), [H, W, 4] RGBA."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos = len(_SIGNATURE)
    idat = []
    hdr = plte = None
    view = memoryview(blob)   # chunks without copies
    while pos < len(blob):
        (n,) = struct.unpack(">I", view[pos:pos + 4])
        tag = blob[pos + 4:pos + 8]
        data = view[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"PLTE":
            plte = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = hdr
    if (ctype not in _TYPES or depth not in _TYPES[ctype][1] or comp or filt
            or interlace not in (0, 1)):
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{ctype}, interlace {interlace})")
    if ctype == 3 and plte is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    ch = _TYPES[ctype][0]
    bits = ch * depth          # per pixel
    bpp = max(1, bits // 8)    # the filters' byte distance
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    size = sum(-(-(h - y0) // dy) * (1 + -(-(-(-(w - x0) // dx) * bits) // 8))
               for x0, y0, dx, dy in passes if w > x0 and h > y0)
    # one output buffer of the expected size: zlib inflates in one call, so
    # a decoding thread gives up and retakes the GIL once, not once a block.
    # A header is outside input: the buffer is capped at what the stream can
    # inflate to (deflate expands at most ~1032x).
    stream = idat[0] if len(idat) == 1 else b"".join(idat)
    data = zlib.decompress(stream, bufsize=max(1, min(size, 1032 * len(stream))))
    if not interlace:
        img = _samples(unfilter(data, h, -(-w * bits // 8), bpp), w, depth, ch)
    else:
        img = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue    # an empty pass has no rows, not even filter bytes
            stride = -(-pw * bits // 8)
            size = ph * (stride + 1)
            rows = unfilter(data[pos:pos + size], ph, stride, bpp)
            img[y0::dy, x0::dx] = _samples(rows, pw, depth, ch)
            pos += size
        if pos != len(data):
            raise ValueError(f"{path}: PNG image data has the wrong size")
    if ctype == 3:
        if int(img.max(initial=0)) >= len(plte):
            raise ValueError(f"{path}: palette index beyond the PLTE chunk")
        return plte[img[..., 0]]
    return img[..., 0] if ch == 1 else img
