"""JPEG through the hand-written C codec: ``.jpg`` tiles read
(baseline, extended and progressive frames, Huffman or arithmetic-coded,
and lossless frames of 2..8 bits), JPEG-in-TIFF segments decoded, and
JPEG OME-TIFF tiles written.

The C library (``csrc/jpeg.c``, built at first use with the system C
compiler by :func:`image_stitcher_tpu_torch.native.load`) is what the
readers and the TIFF writer call: ctypes releases the interpreter lock
around each call, so the tile loader's threads and the TIFF writer's
encode pool work in parallel. Its plain version, the specification of
both (scope, arithmetic, markers), is :mod:`.jpeg_plain`; the tests and
``chip_smoke.py`` hold the two equal, byte for byte. Nothing here falls
back to the plain version: a codec that cannot be built raises, and so
does a stream that does not decode, OpenCV's libjpeg-turbo included
(:class:`DecodeError`; for the streams neither OpenCV nor Pillow gives
pixels for, it says so).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from .jpeg_plain import no_pixels
from .tile_decode import DecodeError

_LIB: Optional[ctypes.CDLL] = None

_NO_PIXELS = {-11: "hierarchical", -12: "lossless arithmetic-coded",
              -13: "DCT frames of other than 8-bit or lossless over 8-bit",
              -14: "2-component", -15: "lossless YCbCr"}
#: decode modes: cv2.imread's colour space (by the markers), or as a
#: TIFF's Photometric sets it: the components as they are (4 kept), or
#: 3 converted from YCbCr
MODES = {'cv2': 0, 'raw': 1, 'ycc': 2}


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
        so.jpeg_decode.argtypes = [vp, i64, vp, i64, ci]
        so.jpeg_decode.restype = i64
        so.jpeg_encode.argtypes = [vp, i64, i64, ci, ci, ci, ci, ci, vp, i64]
        so.jpeg_encode.restype = i64
        _LIB = so
    return _LIB


def _check(rc: int, what: str) -> int:
    if rc >= 0:
        return rc
    if rc in _NO_PIXELS:
        raise no_pixels(_NO_PIXELS[rc])
    if rc == -4:
        raise MemoryError(f"JPEG {what}: out of memory")
    if rc == -19:
        raise ValueError(f"JPEG {what}: a coefficient outside baseline's "
                         "range")
    raise DecodeError(f"JPEG {what}: "
                      + {-1: "bad arguments", -5: "output too small"}.get(
                          rc, "corrupt stream"))


def info(data, mode: str = 'cv2') -> Tuple[int, int, int]:
    """(height, width, channels) of a JPEG stream's decoded pixels, from
    its frame header: 1 for grey, 3 for colour (RGB, YCbCr, CMYK and
    YCCK streams all decode to RGB), 4 for 4 components in mode 'raw'."""
    src = np.frombuffer(data, np.uint8)
    out = np.zeros(4, np.int64)
    _check(lib().jpeg_info(src.ctypes.data, src.size, out.ctypes.data),
           "header")
    nc = int(out[3]) if mode == 'raw' else int(out[2])
    return int(out[0]), int(out[1]), nc


def decode(data, mode: str = 'cv2') -> np.ndarray:
    """Pixels of a JPEG stream: (H, W) grey or (H, W, 3) RGB uint8, what
    ``cv2.imread(IMREAD_UNCHANGED)`` gives (BGR flipped to RGB), or with
    the colour handling ``mode`` names (:data:`MODES`)."""
    src = np.frombuffer(data, np.uint8)
    h, w, nc = info(src, mode)
    out = np.empty((h, w, nc) if nc > 1 else (h, w), np.uint8)
    _check(lib().jpeg_decode(src.ctypes.data, src.size, out.ctypes.data,
                             out.size, MODES[mode]), "decode")
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
