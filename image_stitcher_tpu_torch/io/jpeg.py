"""JPEG through the hand-written C codec: ``.jpg`` tiles read
(baseline, extended and progressive Huffman frames) and JPEG OME-TIFF
tiles written.

The C library (``csrc/jpeg.c``, built at first use with the system C
compiler by :func:`image_stitcher_tpu_torch.native.load`) is what the
readers and the TIFF writer call: ctypes releases the interpreter lock
around each call, so the tile loader's threads and the TIFF writer's
encode pool work in parallel. Its plain version, the specification of
both (scope, arithmetic, markers), is :mod:`.jpeg_plain`; the tests and
``chip_smoke.py`` hold the two equal, byte for byte. Nothing here falls
back to the plain version: a codec that cannot be built raises, and so
does a stream that does not decode (:class:`DecodeError`) or lies
outside the scope (:class:`NotImplementedError` naming ROADMAP item 19
(remainder)).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from .jpeg_plain import not_ported
from .tile_decode import DecodeError

_LIB: Optional[ctypes.CDLL] = None

_NOT_PORTED = {-10: "progressive, with coefficients left unrefined "
                    "(libjpeg-turbo's block smoothing),",
               -11: "arithmetic-coded", -12: "lossless", -13: "hierarchical",
               -14: "other than 8-bit", -15: "2-component"}


def lib() -> ctypes.CDLL:
    """The C codec, built and bound on first use (raises when no C
    compiler can build it)."""
    global _LIB
    if _LIB is None:
        from ..native import load
        so = load('jpeg')
        i64, vp, ci = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
        so.jpeg_info.argtypes = [vp, i64, vp]
        so.jpeg_info.restype = i64
        so.jpeg_decode.argtypes = [vp, i64, vp, i64]
        so.jpeg_decode.restype = i64
        so.jpeg_encode.argtypes = [vp, i64, i64, ci, ci, ci, ci, ci, vp, i64]
        so.jpeg_encode.restype = i64
        _LIB = so
    return _LIB


def _check(rc: int, what: str) -> int:
    if rc >= 0:
        return rc
    if rc in _NOT_PORTED:
        raise not_ported(_NOT_PORTED[rc])
    if rc == -4:
        raise MemoryError(f"JPEG {what}: out of memory")
    if rc == -19:
        raise ValueError(f"JPEG {what}: a coefficient outside baseline's "
                         "range")
    raise DecodeError(f"JPEG {what}: "
                      + {-1: "bad arguments", -5: "output too small"}.get(
                          rc, "corrupt stream"))


def info(data) -> Tuple[int, int, int]:
    """(height, width, channels) of a JPEG stream's decoded pixels, from
    its frame header: 1 for grey, 3 for colour (RGB, YCbCr, CMYK and
    YCCK streams all decode to RGB)."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(3, np.int64)
    _check(lib().jpeg_info(src.ctypes.data, src.size, out.ctypes.data),
           "header")
    return int(out[0]), int(out[1]), int(out[2])


def decode(data) -> np.ndarray:
    """Pixels of a JPEG stream: (H, W) grey or (H, W, 3) RGB uint8, what
    ``cv2.imread(IMREAD_UNCHANGED)`` gives (BGR flipped to RGB)."""
    src = np.frombuffer(data, np.uint8)
    h, w, nc = info(src)
    out = np.empty((h, w, nc) if nc > 1 else (h, w), np.uint8)
    _check(lib().jpeg_decode(src.ctypes.data, src.size, out.ctypes.data,
                             out.size), "decode")
    return out


def encode(pixels: np.ndarray, quality: int = 85,
           sampling: Tuple[int, int] = (2, 2), restart: int = 0) -> bytes:
    """A JPEG stream of (H, W) grey or (H, W, 3) RGB uint8 ``pixels``:
    the bytes ``cv2.imencode('.jpg')`` writes with that quality, luma
    sampling for RGB ((2, 2): 4:2:0) and restart interval."""
    if pixels.dtype != np.uint8 or pixels.ndim not in (2, 3) or (
            pixels.ndim == 3 and pixels.shape[2] != 3):
        raise ValueError("JPEG encode takes (H, W) or (H, W, 3) uint8")
    src = np.ascontiguousarray(pixels)
    h, w = src.shape[:2]
    nc = 1 if src.ndim == 2 else 3
    cap = 8 * src.size + 4096
    dst = np.empty(cap, np.uint8)
    n = _check(lib().jpeg_encode(src.ctypes.data, h, w, nc, int(quality),
                                 int(sampling[0]), int(sampling[1]),
                                 int(restart), dst.ctypes.data, cap),
               "encode")
    return dst[:n].tobytes()
