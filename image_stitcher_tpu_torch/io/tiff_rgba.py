"""libtiff's RGBA conversions (``TIFFRGBAImage``, ``tif_getimage.c``), as
OpenCV 5.0's TIFF decoder reaches them.

OpenCV reads a TIFF of 8-bit samples (and a few other layouts, below)
through libtiff's RGBA interface: ``TIFFReadRGBAStrip``/``Tile`` turn
every pixel into 8-bit R, G, B and A, and OpenCV then keeps grey or BGR
as the channel count its header reader chose. The JAX package's
``read_image`` returns that array, BGR flipped to RGB. This module is
that conversion in NumPy, on whole planes:

- MinIsBlack / MinIsWhite samples of 1, 8 or 16 bits through libtiff's
  grey map (``setupMap``): ``v * 255 // max`` or ``(max - v) * 255 //
  max``; 16-bit samples by their high byte (``put16bitbwtile``);
- palette indices of 1, 4 or 8 bits through the ColorMap, its 16-bit
  entries narrowed to their high byte unless every entry is below 256
  (``checkcmap``, ``cvtcmap``);
- CMYK (InkSet 1): ``(255 - k) * (255 - c) // 255`` per colour
  (``putRGBcontig8bitCMYKtile``);
- YCbCr: libtiff's integer tables (``TIFFYCbCrToRGBInit``, built in
  32-bit floats from YCbCrCoefficients and ReferenceBlackWhite) and
  ``TIFFYCbCrtoRGB``; subsampled data units are spread over their block
  as the ``putcontig8bitYCbCr*tile`` routines do, each pixel its own
  luma and the unit's chroma;
- OpenCV's ``icvCvt_BGRA2Gray_8u_C4C1R`` where it keeps one channel:
  ``(4899 R + 9617 G + 1868 B + 8192) >> 14``.

The alpha sample plays no part: the JAX package drops OpenCV's alpha
(and grey + alpha converts to its grey). :func:`ycbcr_planes` is the one
step that works on raw segment bytes; the rest take samples already
unpacked (``io/tile_decode.py``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

#: libtiff's defaults (tif_dir.c): Rec. 601 luma, and the
#: ReferenceBlackWhite it gives a YCbCr image without one
DEFAULT_COEFFICIENTS = (0.299, 0.587, 0.114)
DEFAULT_REFERENCE = (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)


def grey(samples: np.ndarray, bits: int, min_is_white: bool) -> np.ndarray:
    """(H, W) uint8 grey of MinIsBlack (or MinIsWhite) samples of ``bits``
    bits (1, 2, 4, 8 or 16), by libtiff's grey map."""
    top = 255 if bits == 16 else (1 << bits) - 1
    v = np.arange(top + 1, dtype=np.int64)
    lut = (((top - v) if min_is_white else v) * 255 // top).astype(np.uint8)
    if bits == 16:
        samples = samples >> 8
    return lut[samples]


def palette(indices: np.ndarray, colormap: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB of palette indices through a (3, 2**bits)
    ColorMap: 16-bit entries narrowed to their high byte, unless every
    entry fits in 8 bits (libtiff then takes them as they are)."""
    cmap = np.asarray(colormap, np.uint16)
    if (cmap >= 256).any():
        cmap = cmap >> 8
    return np.ascontiguousarray(cmap.astype(np.uint8).T[indices])


def cmyk(samples: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB of (H, W, >=4) 8-bit C, M, Y, K samples."""
    s = samples.astype(np.uint32)
    k = 255 - s[..., 3:4]
    return (k * (255 - s[..., :3]) // 255).astype(np.uint8)


def to_grey(rgb: np.ndarray) -> np.ndarray:
    """OpenCV's BGRA -> grey of libtiff's RGBA pixels, (H, W) uint8."""
    c = rgb.astype(np.uint32)
    return ((c[..., 0] * 4899 + c[..., 1] * 9617 + c[..., 2] * 1868
             + 8192) >> 14).astype(np.uint8)


# ------------------------------------------------------------------ YCbCr

_SHIFT = 16
_ONE_HALF = 1 << (_SHIFT - 1)
_F = np.float32


def _fix(x) -> int:
    """libtiff's FIX: (int32)(x * 65536 + 0.5), x a 32-bit float."""
    return int(np.float64(_F(x) * _F(1 << _SHIFT)) + 0.5)


def _clamp(f, lo, hi):
    return np.where(~(f >= lo), lo, np.where(f > hi, hi, f))


def _code2v(c: np.ndarray, rb, rw, cr: int) -> np.ndarray:
    """libtiff's Code2V in 32-bit floats: ((c - (int)RB) * CR) / (RW - RB,
    or 1 where that is 0)."""
    den = _F(rw) - _F(rb)
    den = den if den != 0 else _F(1)
    return (c - int(np.trunc(_F(rb)))).astype(_F) * _F(cr) / den


def ycbcr_tables(coefficients: Sequence[float] = DEFAULT_COEFFICIENTS,
                 reference: Sequence[float] = DEFAULT_REFERENCE
                 ) -> Tuple[np.ndarray, ...]:
    """libtiff's TIFFYCbCrToRGBInit tables for 8-bit codes: (Y, Cr->R,
    Cb->B, Cr->G, Cb->G), each 256 int64."""
    red, green, blue = (_F(c) for c in coefficients)
    ref = [_F(r) for r in reference]
    f1 = _F(2) - _F(2) * red
    d1 = _fix(_clamp(f1, _F(0), _F(2)))
    f2 = red * f1 / green
    d2 = -_fix(_clamp(f2, _F(0), _F(2)))
    f3 = _F(2) - _F(2) * blue
    d3 = _fix(_clamp(f3, _F(0), _F(2)))
    f4 = blue * f3 / green
    d4 = -_fix(_clamp(f4, _F(0), _F(2)))
    x = np.arange(-128, 128)
    lo, hi = _F(-128 * 32), _F(128 * 32)

    def code(c, rb, rw, cr):
        return np.trunc(_clamp(_code2v(c, rb, rw, cr), lo, hi)).astype(
            np.int64)

    cr = code(x, ref[4] - _F(128), ref[5] - _F(128), 127)
    cb = code(x, ref[2] - _F(128), ref[3] - _F(128), 127)
    y = code(x + 128, ref[0], ref[1], 255)
    return (y, (d1 * cr + _ONE_HALF) >> _SHIFT,
            (d3 * cb + _ONE_HALF) >> _SHIFT, d2 * cr, d4 * cb + _ONE_HALF)


def ycbcr(planes: np.ndarray, tables) -> np.ndarray:
    """(H, W, 3) uint8 RGB of (H, W, 3) 8-bit Y, Cb, Cr samples, by
    libtiff's TIFFYCbCrtoRGB."""
    y_tab, cr_r, cb_b, cr_g, cb_g = tables
    y, cb, cr = (planes[..., k].astype(np.intp) for k in range(3))
    luma = y_tab[y]
    rgb = np.stack([luma + cr_r[cr], luma + ((cb_g[cb] + cr_g[cr])
                                             >> _SHIFT), luma + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def ycbcr_planes(segment: np.ndarray, rows: int, cols: int,
                 subsampling: Tuple[int, int]) -> np.ndarray:
    """(rows, cols, 3) Y, Cb, Cr of one strip or tile of YCbCr data units
    (``subsampling`` (horizontal, vertical)): each unit h·v luma samples
    row by row, then Cb and Cr, the units padding the segment's last
    block row and column."""
    sh, sv = subsampling
    by, bx = -(-rows // sv), -(-cols // sh)
    units = segment[:by * bx * (sh * sv + 2)].reshape(by, bx, sh * sv + 2)
    luma = units[..., :sh * sv].reshape(by, bx, sv, sh).transpose(
        0, 2, 1, 3).reshape(by * sv, bx * sh)
    chroma = np.repeat(np.repeat(units[..., sh * sv:], sv, 0), sh, 1)
    return np.concatenate([luma[..., None], chroma], -1)[:rows, :cols]
