"""PNG files from the standard library (zlib, struct) and the port's C
row unfilter: an 8-bit grayscale writer and a decoder.

The JAX package writes its registration debug images with
``cv2.imwrite`` and reads PNG tiles with ``cv2.imread``; the port's host
has no OpenCV. :func:`encode_gray8` writes one IHDR (bit depth 8, color
type 0, no interlace), the rows each behind filter byte 0 in one zlib
IDAT chunk, and IEND; any PNG decoder reads back the array it was given.

:func:`decode_png` reads what ``cv2.imread(path, IMREAD_UNCHANGED)``
reads, with the channels in RGB(A) order instead of OpenCV's BGR(A):
- bit depths 1, 2, 4, 8 and 16 (16-bit samples big-endian in the file,
  native in the result); gray under 8 bits scaled to 8 bits as libpng's
  ``png_set_expand_gray_1_2_4_to_8`` does (x 255, 85, 17);
- color types 0 (gray, (H, W)), 2 (RGB, (H, W, 3)), 3 (palette, (H, W, 3)
  uint8; indices past the palette read black), 4 (gray + alpha, (H, W, 4)
  with the gray in R, G and B, as OpenCV gives it) and 6 (RGBA);
- every filter type, undone in C (``io/tile_decode.py``), and Adam7
  interlacing;
- every chunk's CRC is checked: a bad one in a critical chunk raises, a
  bad ancillary chunk is skipped (libpng's defaults); the IDAT chunks are
  concatenated and inflated with zlib. tRNS is not applied: OpenCV's
  extra alpha plane is one the readers drop.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import tile_decode
from .tile_decode import DecodeError

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


_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
#: Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(data):
    """(kind, body) of each chunk up to IEND, CRCs checked."""
    mv = memoryview(data)
    if bytes(mv[:8]) != _SIGNATURE:
        raise DecodeError("not a PNG file")
    pos = 8
    while True:
        if pos + 12 > len(mv):
            raise DecodeError("PNG file ends before its IEND chunk")
        length = struct.unpack_from('>I', mv, pos)[0]
        kind = bytes(mv[pos + 4:pos + 8])
        end = pos + 12 + length
        if end > len(mv):
            raise DecodeError(f"PNG chunk {kind!r} runs past the file's end")
        body = mv[pos + 8:end - 4]
        crc = struct.unpack_from('>I', mv, end - 4)[0]
        if zlib.crc32(body, zlib.crc32(kind)) & 0xFFFFFFFF != crc:
            if kind[:1].isupper():
                raise DecodeError(f"PNG chunk {kind!r}: CRC mismatch")
        else:
            yield kind, body
        if kind == b'IEND':
            return
        pos = end


def _unpack(rows: np.ndarray, width: int, depth: int,
            channels: int) -> np.ndarray:
    """Unfiltered rows -> (h, width, channels) samples."""
    h = rows.shape[0]
    if depth == 8:
        return rows.reshape(h, width, channels)
    if depth == 16:
        return (rows.view('>u2').astype(np.uint16)
                .reshape(h, width, channels))
    per = 8 // depth          # samples a byte, one channel
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, rows.shape[1] * per)[:, :width, None]


def decode_png(data) -> np.ndarray:
    """Decode a PNG file (bytes-like) as ``cv2.imread(...,
    IMREAD_UNCHANGED)`` does, channels in RGB(A) order."""
    header = palette = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b'IHDR':
            if len(body) != 13:
                raise DecodeError("PNG IHDR of the wrong length")
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'PLTE':
            palette = bytes(body)
        elif kind == b'IDAT':
            idat.append(body)
    if header is None or not idat:
        raise DecodeError("PNG without IHDR or IDAT")
    w, h, depth, ctype, comp, filt, interlace = header
    if (ctype not in _DEPTHS or depth not in _DEPTHS[ctype] or comp or filt
            or interlace > 1 or not w or not h):
        raise DecodeError(f"PNG IHDR {header}")
    channels = _CHANNELS[ctype]
    bits = channels * depth
    bpp = max(1, bits // 8)
    try:
        raw = zlib.decompress(b''.join(idat))
    except zlib.error as e:
        raise DecodeError(f"PNG image data: {e}") from None
    dtype = np.uint16 if depth == 16 else np.uint8
    if interlace:
        img = np.zeros((h, w, channels), dtype)
        raw = memoryview(raw)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue
            row_bytes = (pw * bits + 7) // 8
            rows = tile_decode.png_unfilter(raw[pos:], ph, row_bytes, bpp)
            pos += ph * (row_bytes + 1)
            img[y0::dy, x0::dx] = _unpack(rows, pw, depth, channels)
    else:
        rows = tile_decode.png_unfilter(raw, h, (w * bits + 7) // 8, bpp)
        img = _unpack(rows, w, depth, channels)
    if ctype == 3:
        if palette is None or len(palette) % 3:
            raise DecodeError("palette PNG without a valid PLTE chunk")
        lut = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(palette, np.uint8).reshape(-1, 3)[:256]
        lut[:len(entries)] = entries
        return lut[img[:, :, 0]]
    if ctype == 0:
        img = img[:, :, 0]
        if depth < 8:
            img = img * np.uint8(255 // ((1 << depth) - 1))
        return np.ascontiguousarray(img)
    if ctype == 4:
        img = img[:, :, [0, 0, 0, 1]]
    return np.ascontiguousarray(img)
