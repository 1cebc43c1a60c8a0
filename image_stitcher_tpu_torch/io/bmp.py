"""BMP tiles, decoded with NumPy and C as ``cv2.imread`` decodes them.

The JAX package reads ``.bmp`` tiles with OpenCV; the port's host has
none. What this reader takes (a ``BITMAPINFOHEADER`` or its V2-V5
extensions):

- 1-, 4- and 8-bit paletted pixels, uncompressed or run-length coded
  (BI_RLE4, BI_RLE8: decoded in C, ``io/tile_decode.py``, with OpenCV's
  rules: skipped pixels take palette entry 0; in RLE4 an EOF ends only
  its row and a delta moves right only): a palette whose entries are all
  gray (B = G = R, unused entries counting as black, as OpenCV's
  ``IsColorPalette`` reads them) gives (H, W) uint8 gray values, any
  other palette (H, W, 3);
- 16-bit pixels: BI_RGB, and BI_BITFIELDS with the 5-5-5 masks, as 5-5-5;
  BI_BITFIELDS with the 5-6-5 masks as 5-6-5; each field shifted to the
  top of its byte, its low bits 0 (OpenCV's ``icvCvt_BGR5552BGR`` and
  ``icvCvt_BGR5652BGR``), as (H, W, 3);
- 24-bit pixels (B, G, R) and 32-bit pixels (B, G, R and a fourth byte,
  with BI_RGB or BI_BITFIELDS: OpenCV ignores the masks and returns the
  fourth byte as alpha only for BI_BITFIELDS, which the readers drop),
  both as (H, W, 3);
- bottom-up rows (positive height) or top-down (negative height), each
  padded to a multiple of 4 bytes.

Colour comes back in RGB order. The OS/2 ``BITMAPCOREHEADER`` (which
OpenCV 5.0 misreads) and 16-bit BI_BITFIELDS masks other than 5-5-5 and
5-6-5 after the header (OpenCV refuses them, V4 and V5 headers
included, whose masks it looks for past the header) raise
:class:`NotImplementedError` naming ROADMAP item 6; an RLE stream OpenCV
cannot decode raises
:class:`~image_stitcher_tpu_torch.io.tile_decode.DecodeError`.
"""

from __future__ import annotations

import struct

import numpy as np

from . import tile_decode
from .tile_decode import DecodeError

_BI_RGB, _BI_RLE8, _BI_RLE4, _BI_BITFIELDS = 0, 1, 2, 3


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} BMP tiles are not ported to image_stitcher_tpu_torch yet "
        "(ROADMAP.md, item 6, 'tile input without OpenCV')")


#: OpenCV's 16-bit layouts by their (red, green, blue) BI_BITFIELDS masks
_MASKS_16 = {(0x7C00, 0x03E0, 0x001F): 555, (0xF800, 0x07E0, 0x001F): 565}


def decode_bmp(data, plain: bool = False) -> np.ndarray:
    """Decode a BMP file (bytes-like): (H, W) gray or (H, W, 3) RGB;
    ``plain`` runs the RLE decoder's plain version."""
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
    if bpp not in (1, 4, 8, 16, 24, 32):
        raise _not_ported(f"{bpp}-bit")
    rle = comp in (_BI_RLE8, _BI_RLE4)
    if rle and bpp != (8 if comp == _BI_RLE8 else 4) or not rle and (
            comp not in (_BI_RGB, _BI_BITFIELDS)
            or comp == _BI_BITFIELDS and bpp not in (16, 32)):
        raise _not_ported(f"{bpp}-bit, compression {comp}")
    layout = 555
    if bpp == 16 and comp == _BI_BITFIELDS:
        # OpenCV reads the masks right after the header, also where a V4 /
        # V5 header holds them inside (and then refuses what follows)
        if len(mv) < 26 + hsize:
            raise DecodeError("truncated BMP header")
        masks = struct.unpack_from('<III', mv, 14 + hsize)
        if masks not in _MASKS_16:
            raise _not_ported(f"16-bit, BI_BITFIELDS masks "
                              f"{tuple(map(hex, masks))}")
        layout = _MASKS_16[masks]
    top_down = h < 0
    h = abs(h)
    if w <= 0 or h == 0:
        raise DecodeError(f"BMP of {w} x {h} pixels")
    if rle:
        if offset > len(mv):
            raise DecodeError("BMP pixel data runs past the file's end")
        try:
            rows = (tile_decode.bmp_rle_decode_plain if plain
                    else tile_decode.bmp_rle_decode)(mv[offset:], w, h, bpp)
        except DecodeError as e:
            raise DecodeError(f"{e} (OpenCV 5.0 cannot decode this "
                              "stream either)") from None
        idx = rows if top_down else rows[::-1]
        return _paletted(mv, hsize, used, bpp, idx)
    row_bytes = (w * bpp + 31) // 32 * 4
    if offset + h * row_bytes > len(mv):
        raise DecodeError("BMP pixel data runs past the file's end")
    rows = np.frombuffer(mv, np.uint8, count=h * row_bytes,
                         offset=offset).reshape(h, row_bytes)
    if not top_down:
        rows = rows[::-1]
    if bpp == 16:
        t = rows[:, :w * 2].copy().view('<u2').astype(np.uint16)
        if layout == 555:
            rgb = (t >> 7, t >> 2, t << 3)
            keep = (0xF8, 0xF8, 0xF8)
        else:
            rgb = (t >> 8, t >> 3, t << 3)
            keep = (0xF8, 0xFC, 0xF8)
        return np.stack([(c & k).astype(np.uint8)
                         for c, k in zip(rgb, keep)], -1)
    if bpp == 24:
        return np.ascontiguousarray(rows[:, :w * 3].reshape(h, w, 3)[..., ::-1])
    if bpp == 32:
        return np.ascontiguousarray(rows[:, :w * 4].reshape(h, w, 4)[..., 2::-1])
    if bpp == 8:
        idx = rows[:, :w]
    else:
        shifts = np.arange(8 - bpp, -1, -bpp, dtype=np.uint8)
        idx = ((rows[:, :, None] >> shifts) & ((1 << bpp) - 1)).reshape(
            h, -1)[:, :w]
    return _paletted(mv, hsize, used, bpp, idx)


def _paletted(mv, hsize: int, used: int, bpp: int,
              idx: np.ndarray) -> np.ndarray:
    """(H, W) gray or (H, W, 3) RGB of palette indices."""
    count = used or (1 << bpp)
    if count > 1 << bpp:
        raise DecodeError(f"BMP palette of {count} entries for {bpp} bits")
    start = 14 + hsize
    if start + count * 4 > len(mv):
        raise DecodeError("BMP palette runs past the file's end")
    lut = np.zeros((256, 3), np.uint8)          # B, G, R
    lut[:count] = np.frombuffer(mv, np.uint8, count=count * 4,
                                offset=start).reshape(count, 4)[:, :3]
    used_lut = lut[:1 << bpp]
    if (used_lut == used_lut[:, :1]).all():
        return np.ascontiguousarray(lut[idx, 0])
    return np.ascontiguousarray(lut[idx][..., ::-1])
