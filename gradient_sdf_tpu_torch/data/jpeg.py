"""Baseline JPEG decoding for the Redwood loader's `rgb/*.jpg` frames.

The decoder is `native/jpeg_decode.c`, built at first use with the host C
compiler and bound here with ctypes. It reads sequential Huffman-coded
8-bit JPEGs with 1 or 3 components, chroma sampled 4:4:4, 4:2:2 or 4:2:0,
with restart intervals, at any size, and returns the samples PIL (libjpeg
with its default settings) returns for them: it follows libjpeg's integer
inverse DCT, its fancy chroma upsampling and its YCbCr -> RGB tables.
Progressive, lossless, arithmetic-coded and 12-bit files raise ValueError.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..native import _build

_ERRLEN = 256


def _lib():
    lib = _build.load("jpeg_decode")
    if not lib.gsdf_jpeg_decode.argtypes:
        vp, i64, ip = ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int)
        lib.gsdf_jpeg_info.argtypes = [vp, i64, ip, ip, ip, ctypes.c_char_p,
                                       ctypes.c_int]
        lib.gsdf_jpeg_info.restype = ctypes.c_int
        lib.gsdf_jpeg_decode.argtypes = [vp, i64, vp, i64, ctypes.c_char_p,
                                         ctypes.c_int]
        lib.gsdf_jpeg_decode.restype = ctypes.c_int
    return lib


def decode_jpeg(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG file contents -> uint8 [H, W] (greyscale) or [H, W, 3] (RGB)."""
    lib = _lib()
    buf = np.frombuffer(blob, np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    w, h, nc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.gsdf_jpeg_info(buf.ctypes.data, buf.size, ctypes.byref(w),
                            ctypes.byref(h), ctypes.byref(nc), err, _ERRLEN)
    if rc == 0:
        shape = (h.value, w.value) if nc.value == 1 else (h.value, w.value, 3)
        out = np.empty(shape, np.uint8)
        rc = lib.gsdf_jpeg_decode(buf.ctypes.data, buf.size, out.ctypes.data,
                                  out.nbytes, err, _ERRLEN)
    if rc != 0:
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    return out


def read_jpeg(path: str) -> np.ndarray:
    """JPEG file -> uint8 [H, W] (greyscale) or [H, W, 3] (RGB)."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)
