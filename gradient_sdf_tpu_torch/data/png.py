"""A small PNG codec on the standard library (zlib + struct) and numpy.

Reads non-interlaced 8- and 16-bit greyscale and RGB images with any of
the five row filters (0 none, 1 sub, 2 up, 3 average, 4 Paeth), which
covers the depth and colour PNGs of TUM RGB-D and of the synthetic
datasets. Writes greyscale or RGB at 8 bits and
greyscale at 16 bits, with filter 0 on every row. 16-bit samples are
big-endian in the file, as the format requires.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}  # colour type -> samples per pixel


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray):
    """Write uint8 [H, W] / [H, W, 3] or uint16 [H, W] as a PNG."""
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
    raw = rows.reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), raw], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters -> uint8 [h, stride]."""
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


def read_png(path: str) -> np.ndarray:
    """PNG -> numpy array: uint8 or uint16, [H, W] for greyscale, [H, W, 3]
    for RGB."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos = len(_SIGNATURE)
    idat = []
    hdr = None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        tag = blob[pos + 4:pos + 8]
        data = blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{ctype}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    pix = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        pix = pix.reshape(h, w * ch, 2).view(">u2")[..., 0].astype(np.uint16)
    arr = pix.reshape(h, w, ch)
    return arr[..., 0] if ch == 1 else arr
