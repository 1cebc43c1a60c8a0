"""BMP tiles, decoded with NumPy as ``cv2.imread`` decodes them.

The JAX package reads ``.bmp`` tiles with OpenCV; the port's host has
none. What this reader takes (a ``BITMAPINFOHEADER`` or its V2-V5
extensions):

- 1-, 4- and 8-bit paletted pixels: a palette whose entries are all gray
  (B = G = R, unused entries counting as black, as OpenCV's
  ``IsColorPalette`` reads them) gives (H, W) uint8 gray values, any
  other palette (H, W, 3);
- 24-bit pixels (B, G, R) and 32-bit pixels (B, G, R and a fourth byte,
  with BI_RGB or BI_BITFIELDS: OpenCV ignores the masks and returns the
  fourth byte as alpha only for BI_BITFIELDS, which the readers drop),
  both as (H, W, 3);
- bottom-up rows (positive height) or top-down (negative height), each
  padded to a multiple of 4 bytes.

Colour comes back in RGB order. RLE-compressed (BI_RLE8, BI_RLE4) and
16-bit BMPs, and the OS/2 ``BITMAPCOREHEADER`` (which OpenCV 5.0
misreads), raise :class:`NotImplementedError` naming ROADMAP item 6.
"""

from __future__ import annotations

import struct

import numpy as np

from .tile_decode import DecodeError

_BI_RGB, _BI_RLE8, _BI_RLE4, _BI_BITFIELDS = 0, 1, 2, 3


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} BMP tiles are not ported to image_stitcher_tpu_torch yet "
        "(ROADMAP.md, item 6, 'tile input without OpenCV')")


def decode_bmp(data) -> np.ndarray:
    """Decode a BMP file (bytes-like): (H, W) gray or (H, W, 3) RGB."""
    mv = memoryview(data)
    try:
        if bytes(mv[:2]) != b'BM':
            raise DecodeError("not a BMP file")
        offset, hsize = struct.unpack_from('<II', mv, 10)
        if hsize == 12:
            raise _not_ported("OS/2 (BITMAPCOREHEADER)")
        if hsize < 40:
            raise DecodeError(f"BMP header of {hsize} bytes")
        w, h, _, bpp, comp = struct.unpack_from('<iiHHI', mv, 18)
        used = struct.unpack_from('<I', mv, 46)[0]
    except struct.error:
        raise DecodeError("truncated BMP header") from None
    if comp in (_BI_RLE8, _BI_RLE4):
        raise _not_ported("RLE-compressed")
    if bpp not in (1, 4, 8, 24, 32):
        raise _not_ported(f"{bpp}-bit")
    if comp not in (_BI_RGB, _BI_BITFIELDS) or (comp == _BI_BITFIELDS
                                                and bpp != 32):
        raise _not_ported(f"compression {comp}")
    top_down = h < 0
    h = abs(h)
    if w <= 0 or h == 0:
        raise DecodeError(f"BMP of {w} x {h} pixels")
    row_bytes = (w * bpp + 31) // 32 * 4
    if offset + h * row_bytes > len(mv):
        raise DecodeError("BMP pixel data runs past the file's end")
    rows = np.frombuffer(mv, np.uint8, count=h * row_bytes,
                         offset=offset).reshape(h, row_bytes)
    if not top_down:
        rows = rows[::-1]
    if bpp == 24:
        return np.ascontiguousarray(rows[:, :w * 3].reshape(h, w, 3)[..., ::-1])
    if bpp == 32:
        return np.ascontiguousarray(rows[:, :w * 4].reshape(h, w, 4)[..., 2::-1])
    # paletted
    count = used or (1 << bpp)
    if count > 1 << bpp:
        raise DecodeError(f"BMP palette of {count} entries for {bpp} bits")
    start = 14 + hsize
    if start + count * 4 > len(mv):
        raise DecodeError("BMP palette runs past the file's end")
    lut = np.zeros((256, 3), np.uint8)          # B, G, R
    lut[:count] = np.frombuffer(mv, np.uint8, count=count * 4,
                                offset=start).reshape(count, 4)[:, :3]
    if bpp == 8:
        idx = rows[:, :w]
    else:
        shifts = np.arange(8 - bpp, -1, -bpp, dtype=np.uint8)
        idx = ((rows[:, :, None] >> shifts) & ((1 << bpp) - 1)).reshape(
            h, -1)[:, :w]
    used_lut = lut[:1 << bpp]
    if (used_lut == used_lut[:, :1]).all():
        return np.ascontiguousarray(lut[idx, 0])
    return np.ascontiguousarray(lut[idx][..., ::-1])
