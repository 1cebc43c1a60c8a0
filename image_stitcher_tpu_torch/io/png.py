"""8-bit grayscale PNG writer from the standard library (zlib, struct).

The JAX package writes its registration debug images with
``cv2.imwrite``; the port's host has no OpenCV, so it writes the same
pixels with this minimal encoder: one IHDR (bit depth 8, color type 0,
no interlace), the rows each behind filter byte 0 in one zlib IDAT
chunk, and IEND. Any PNG decoder reads back the array it was given.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b'\x89PNG\r\n\x1a\n'


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_gray8(img: np.ndarray) -> bytes:
    """The PNG file bytes of a (h, w) uint8 image."""
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"encode_gray8 takes a (h, w) uint8 image, got "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape
    if h == 0 or w == 0:
        raise ValueError(f"a PNG has at least one pixel, got {img.shape}")
    rows = np.zeros((h, w + 1), np.uint8)   # column 0: filter type None
    rows[:, 1:] = img
    header = struct.pack('>IIBBBBB', w, h, 8, 0, 0, 0, 0)
    return (_SIGNATURE + _chunk(b'IHDR', header)
            + _chunk(b'IDAT', zlib.compress(rows.tobytes()))
            + _chunk(b'IEND', b''))


def write_gray8(path: str, img: np.ndarray) -> None:
    """Write a (h, w) uint8 image as an 8-bit grayscale PNG."""
    data = encode_gray8(img)
    with open(path, 'wb') as f:
        f.write(data)
