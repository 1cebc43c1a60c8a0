"""Baseline JPEG, the plain version: the specification ``csrc/jpeg.c``
follows, in Python and NumPy integer arithmetic.

The JAX package reads ``.jpg`` tiles with ``cv2.imread(IMREAD_UNCHANGED)``
(then BGR -> RGB) and encodes JPEG OME-TIFF tiles with
``cv2.imencode('.jpg')``; OpenCV 5.0 links libjpeg-turbo. The port's
codec reproduces libjpeg-turbo's integer arithmetic, so its pixels equal
``cv2.imread``'s and its streams ``cv2.imencode``'s, byte for byte:

Decoding (``decode``): baseline (SOF0) and extended-sequential 8-bit
Huffman (SOF1) frames of 1 or 3 components, luma sampling (h, v) in
{1, 2}^2 with chroma 1x1, any number of sequential scans (interleaved or
one component each), restart intervals; APPn and COM segments are
skipped (an EXIF orientation is ignored, as ``IMREAD_UNCHANGED`` ignores
it). Then, as libjpeg-turbo's defaults give it:
- the ``islow`` inverse DCT (``jidctint.c``): two passes of the LL&M
  butterfly with 13-bit constants, pass 1 (columns, dequantised) descaled
  by 11 bits, pass 2 (rows) by 18, the result plus 128 taken through the
  range-limit table of ``jdmaster.c`` (the value masked to 10 bits, then
  clamped to 0..255 for -384..511);
- "fancy" chroma upsampling (``jdsample.c``): h2v1 as (3 near + far + 1
  or 2) >> 2, h2v2 as (3 (3 near + far rows) + the far column's + 8 or
  7) >> 4, h1v2 as (3 near + far + 1 or 2) >> 2, edges replicated; a
  chroma plane at most 2 samples wide is box-upsampled for h2v1 and h2v2
  (libjpeg-turbo's rule);
- YCbCr -> RGB through ``jdcolor.c``'s 16-bit fixed-point tables.
A stream that is not a JPEG this scope covers raises
:class:`NotImplementedError` naming ROADMAP item 19 (remainder):
progressive, arithmetic-coded, lossless or hierarchical frames, other
than 8-bit samples, 2 or 4 components, an Adobe APP14 marker, RGB
component ids without JFIF, or other sampling factors. A stream that
does not decode raises :class:`DecodeError`.

Encoding (``encode``), as libjpeg-turbo writes with ``jpeg_set_defaults``
and ``jpeg_set_quality(q, force_baseline=TRUE)``, OpenCV's settings:
- the Annex K tables scaled by ``q < 50 ? 5000 / q : 200 - 2 q`` ((t s +
  50) / 100 within 1..255);
- RGB -> YCbCr through ``jccolor.c``'s tables (16 fraction bits);
- the image edge-replicated to whole blocks (``jcprepct.c``, ``jcsample.
  c``), chroma downsampled 2x2 as (sum + 1, 2, 1, 2, ...) >> 2, 2x1 as
  (sum + 0, 1, 0, 1, ...) >> 1, 1x2 as (sum + 1) / 2; the rows under the
  last downsampled row copy it; blocks that only fill an MCU are all
  zero with the DC of the block before them (``jccoefct.c``);
- the ``islow`` forward DCT (``jfdctint.c``) and libjpeg-turbo's
  reciprocal quantisation (``jcdctmgr.c``);
- the Annex K Huffman tables (no optimisation); the stream is SOI, a
  JFIF 1.01 APP0, a DQT per table, SOF0, a DHT per table (DC then AC per
  component), DRI when there is a restart interval, one interleaved SOS
  (a single component's scan is not interleaved), the data (bytes 0xFF
  stuffed with 0x00, each interval padded with 1 bits, RST0-7 between
  intervals) and EOI.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from .tile_decode import DecodeError

#: natural (row-major) index of the k-th coefficient in zigzag order
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

#: Annex K quantisation tables, natural order
STD_QUANT = (np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]),
    np.array([
        17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
        24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
        + [99] * 32))

#: Annex K Huffman tables: (BITS (codes of length 1..16), HUFFVAL)
STD_DC = ((bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]),
           bytes(range(12))),
          (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]),
           bytes(range(12))))
STD_AC = ((bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d]),
           bytes.fromhex(
               '01020300041105122131410613516107227114328191a1082342b1c11552'
               'd1f02433627282090a161718191a25262728292a3435363738393a434445'
               '464748494a535455565758595a636465666768696a737475767778797a83'
               '8485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6'
               'b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8'
               'e9eaf1f2f3f4f5f6f7f8f9fa')),
          (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]),
           bytes.fromhex(
               '000102031104052131061241510761711322328108144291a1b1c109233352'
               'f0156272d10a162434e125f11718191a262728292a35363738393a434445'
               '464748494a535455565758595a636465666768696a737475767778797a82'
               '838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5'
               'b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8'
               'e9eaf2f3f4f5f6f7f8f9fa')))

#: the ``islow`` DCTs' constants (13 fraction bits)
F0298, F0390, F0541, F0765 = 2446, 3196, 4433, 6270
F0899, F1175, F1501, F1847 = 7373, 9633, 12299, 15137
F1961, F2053, F2562, F3072 = 16069, 16819, 20995, 25172

_ITEM = "ROADMAP.md, item 19 (remainder), 'JPEG'"


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} JPEG streams are not ported to image_stitcher_tpu_torch "
        f"yet ({_ITEM})")


def quant_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """The luma and chroma tables (natural order) of
    ``jpeg_set_quality(quality, force_baseline=TRUE)``."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in STD_QUANT)


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def _butterfly_inv(c):
    """The islow IDCT's 1-D stage on 8 int64 arrays: the 8 outputs before
    their descale (even part shifted by 13)."""
    z1 = (c[2] + c[6]) * F0541
    tmp2 = z1 - c[6] * F1847
    tmp3 = z1 + c[2] * F0765
    tmp0 = (c[0] + c[4]) << 13
    tmp1 = (c[0] - c[4]) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * F1175
    o0, o1, o2, o3 = o0 * F0298, o1 * F2053, o2 * F3072, o3 * F1501
    z1, z2 = z1 * -F0899, z2 * -F2562
    z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
    o0, o1 = o0 + z1 + z3, o1 + z2 + z4
    o2, o3 = o2 + z2 + z3, o3 + z1 + z4
    return (t10 + o3, t11 + o2, t12 + o1, t13 + o0,
            t13 - o0, t12 - o1, t11 - o2, t10 - o3)


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(N, 64) quantised coefficients (natural order) -> (N, 8, 8) uint8
    samples, as ``jpeg_idct_islow``."""
    c = coef.astype(np.int64).reshape(-1, 8, 8) * quant.reshape(1, 8, 8)
    cols = _butterfly_inv([c[:, k, :] for k in range(8)])
    ws = np.stack([_descale(v, 11) for v in cols], axis=1)
    rows = _butterfly_inv([ws[:, :, k] for k in range(8)])
    out = np.stack([_descale(v, 18) for v in rows], axis=2)
    return _post_idct_limit(out)


def _post_idct_limit(v: np.ndarray) -> np.ndarray:
    """libjpeg's post-IDCT range limit: the value masked to 10 bits,
    then v + 128 clamped to 0..255 for v in -384..511 (the table wraps
    beyond, as libjpeg-turbo's does)."""
    m = v & 1023
    m = np.where(m >= 512, m - 1024, m)
    return np.clip(m + 128, 0, 255).astype(np.uint8)


def _butterfly_fwd(d):
    """The islow FDCT's 1-D stage on 8 int64 arrays: (even outputs 0 and
    4 unshifted sums, then outputs 2, 6, 7, 5, 3, 1 before descale)."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    z1 = (t12 + t13) * F0541
    out2 = z1 + t13 * F0765
    out6 = z1 - t12 * F1847
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * F1175
    tmp4, tmp5, tmp6, tmp7 = (tmp4 * F0298, tmp5 * F2053, tmp6 * F3072,
                              tmp7 * F1501)
    z1, z2 = z1 * -F0899, z2 * -F2562
    z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
    return (t10 + t11, t10 - t11, out2, out6, tmp4 + z1 + z3,
            tmp5 + z2 + z4, tmp6 + z2 + z3, tmp7 + z1 + z4)


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """(N, 8, 8) uint8 samples -> (N, 64) int64 coefficients scaled up by
    8 (natural order), as ``jpeg_fdct_islow`` on samples - 128."""
    x = blocks.astype(np.int64) - 128
    s0, s4, s2, s6, s7, s5, s3, s1 = _butterfly_fwd(
        [x[:, :, k] for k in range(8)])
    rows = [s0 << 2, _descale(s1, 11), _descale(s2, 11), _descale(s3, 11),
            s4 << 2, _descale(s5, 11), _descale(s6, 11), _descale(s7, 11)]
    ws = np.stack(rows, axis=2)
    s0, s4, s2, s6, s7, s5, s3, s1 = _butterfly_fwd(
        [ws[:, k, :] for k in range(8)])
    cols = [_descale(s0, 2), _descale(s1, 15), _descale(s2, 15),
            _descale(s3, 15), _descale(s4, 2), _descale(s5, 15),
            _descale(s6, 15), _descale(s7, 15)]
    return np.stack(cols, axis=1).reshape(-1, 64)


def _reciprocal(divisor: int) -> Tuple[int, int, int]:
    """libjpeg-turbo's ``compute_reciprocal`` (16-bit DCTELEM): (recip,
    correction, total shift)."""
    b = divisor.bit_length() - 1
    r = 16 + b
    fq, fr = divmod(1 << r, divisor)
    c = divisor // 2
    if fr == 0:
        fq >>= 1
        r -= 1
    elif fr <= divisor // 2:
        c += 1
    else:
        fq += 1
    return fq, c, r


def quantize(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(N, 64) FDCT output (scaled by 8) -> quantised coefficients, as
    libjpeg-turbo's ``quantize`` with divisors ``quant << 3``."""
    rcs = [_reciprocal(int(q) << 3) for q in quant]
    recip = np.array([v[0] for v in rcs], np.int64)
    corr = np.array([v[1] for v in rcs], np.int64)
    shift = np.array([v[2] for v in rcs], np.int64)
    mag = ((np.abs(coef) + corr) * recip) >> shift
    return np.where(coef < 0, -mag, mag)


def rgb_to_ycc(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (3, H, W) uint8 Y, Cb, Cr (``jccolor.c``)."""
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    half, off = 1 << 15, 128 << 16
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + off + half - 1) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + off + half - 1) >> 16
    return np.stack([y, cb, cr]).astype(np.uint8)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Y, Cb, Cr planes -> (H, W, 3) uint8 RGB (``jdcolor.c``)."""
    y = y.astype(np.int64)
    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    half = 1 << 15
    r = y + ((91881 * cr + half) >> 16)
    g = y + ((-22554 * cb + half - 46802 * cr) >> 16)
    b = y + ((116130 * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# ----------------------------------------------------------------- encoder

def _huff_codes(bits: bytes, vals: bytes) -> Dict[int, Tuple[int, int]]:
    """{symbol: (code, length)} of a table (Annex C)."""
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def _code_arrays(table) -> Tuple[np.ndarray, np.ndarray]:
    codes = _huff_codes(*table)
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    for sym, (c, n) in codes.items():
        code[sym], length[sym] = c, n
    return code, length


def _nbits(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (JPEG's magnitude category)."""
    a = np.abs(v)
    n = np.zeros(a.shape, np.int64)
    while np.any(a >> n):
        n += (a >> n) > 0
    return n


def _pack(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Bit fields MSB first, padded with 1 bits to a byte, with each 0xFF
    byte followed by a stuffed 0x00."""
    total = int(lengths.sum())
    nbytes = (total + 7) // 8
    bits = np.ones(nbytes * 8, np.uint8)
    start = np.cumsum(lengths) - lengths
    for k in range(int(lengths.max(initial=0))):
        sel = lengths > k
        bits[start[sel] + k] = (values[sel] >> (lengths[sel] - 1 - k)) & 1
    out = np.packbits(bits)
    ff = np.flatnonzero(out == 0xFF)
    return np.insert(out, ff + 1, 0).tobytes()


def _downsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """``jcsample.c``: a plane whose width and height are multiples of
    (fh, fv), downsampled by 2x2, 2x1, 1x2 or not at all."""
    p = plane.astype(np.int64)
    if fh == 2 and fv == 2:
        s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
        bias = np.where(np.arange(s.shape[1]) % 2 == 0, 1, 2)
        return ((s + bias) >> 2).astype(np.uint8)
    if fh == 2:
        bias = np.arange(p.shape[1] // 2) % 2
        return ((p[:, 0::2] + p[:, 1::2] + bias) >> 1).astype(np.uint8)
    if fv == 2:
        return ((p[0::2] + p[1::2] + 1) // 2).astype(np.uint8)
    return plane


def _component_blocks(plane: np.ndarray, h: int, w: int, fh: int, fv: int,
                      rows_b: int, cols_b: int) -> np.ndarray:
    """One component's (rows_b, cols_b, 8, 8) blocks of data: the image
    plane (h, w) edge-replicated, downsampled, the rows past the last
    downsampled row copying it."""
    hp = -(-h // fv) * fv
    wp = max(cols_b * 8 * fh, w)
    ext = np.pad(plane, ((0, hp - h), (0, wp - w)), mode='edge')
    ds = _downsample(ext, fh, fv)[:, :cols_b * 8]
    ds = np.pad(ds, ((0, max(0, rows_b * 8 - ds.shape[0])), (0, 0)),
                mode='edge')[:rows_b * 8]
    return ds.reshape(rows_b, 8, cols_b, 8).transpose(0, 2, 1, 3)


def encode(pixels: np.ndarray, quality: int = 85,
           sampling: Tuple[int, int] = (2, 2), restart: int = 0) -> bytes:
    """A JPEG stream of (H, W) grey or (H, W, 3) RGB uint8 ``pixels``, the
    bytes ``cv2.imencode('.jpg')`` writes with ``IMWRITE_JPEG_QUALITY``
    ``quality``, luma ``sampling`` (h, v) for RGB (chroma 1x1; (2, 2)
    is 4:2:0, cv2's default) and ``IMWRITE_JPEG_RST_INTERVAL``
    ``restart`` (MCUs, 0 for none)."""
    if pixels.dtype != np.uint8 or pixels.ndim not in (2, 3) or (
            pixels.ndim == 3 and pixels.shape[2] != 3):
        raise ValueError("JPEG encode takes (H, W) or (H, W, 3) uint8")
    hgt, wid = pixels.shape[:2]
    if not (0 < hgt < 65536 and 0 < wid < 65536):
        raise ValueError(f"JPEG encode: bad size {hgt}x{wid}")
    if pixels.ndim == 2:
        planes, samp = [pixels], [(1, 1)]
    else:
        if tuple(sampling) not in ((1, 1), (2, 1), (1, 2), (2, 2)):
            raise ValueError(f"JPEG encode: sampling {sampling}")
        planes, samp = list(rgb_to_ycc(pixels)), [tuple(sampling),
                                                  (1, 1), (1, 1)]
    hmax, vmax = samp[0]
    nc = len(planes)
    quants = quant_tables(quality)
    mcux, mcuy = -(-wid // (8 * hmax)), -(-hgt // (8 * vmax))
    grids = []   # (mcuy * v, mcux * h, 64) quantised blocks of each comp
    for ci, (plane, (h, v)) in enumerate(zip(planes, samp)):
        cols_b = -(-wid * h // (hmax * 8))
        rows_b = -(-hgt * v // (vmax * 8))
        blk = _component_blocks(plane, hgt, wid, hmax // h, vmax // v,
                                rows_b, cols_b)
        q = quantize(fdct_islow(blk.reshape(-1, 8, 8)), quants[min(ci, 1)])
        grid = np.zeros((mcuy * v, mcux * h, 64), np.int64)
        grid[:rows_b, :cols_b] = q.reshape(rows_b, cols_b, 64)
        if nc > 1:
            # dummy blocks that fill the last MCUs: all zero, the DC of
            # the block before them in the MCU (left, or the row above's
            # last)
            for x in range(cols_b, mcux * h):
                grid[:rows_b, x, 0] = grid[:rows_b, x - 1, 0]
            for y in range(rows_b, mcuy * v):
                last = grid[y - 1, h - 1::h, 0]
                grid[y, :, 0] = np.repeat(last, h)
        else:
            grid = grid[:rows_b, :cols_b]
        grids.append(grid)
    # blocks in scan order, with each block's component
    if nc == 1:
        blocks = grids[0].reshape(-1, 64)
        comp = np.zeros(blocks.shape[0], np.int64)
        nmcu, per_mcu = blocks.shape[0], 1
    else:
        parts, comp_parts = [], []
        for ci, (h, v) in enumerate(samp):
            g = grids[ci].reshape(mcuy, v, mcux, h, 64).transpose(
                0, 2, 1, 3, 4).reshape(mcuy * mcux, v * h, 64)
            parts.append(g)
            comp_parts.append(np.full(g.shape[:2], ci))
        blocks = np.concatenate(parts, axis=1).reshape(-1, 64)
        comp = np.concatenate(comp_parts, axis=1).reshape(-1)
        nmcu, per_mcu = mcux * mcuy, sum(h * v for h, v in samp)
    zz = blocks[:, ZIGZAG]
    # DC differences, predictions reset at each restart interval
    interval = np.arange(blocks.shape[0]) // per_mcu // (restart or nmcu)
    dc = zz[:, 0]
    diff = np.empty_like(dc)
    for ci in range(nc):
        idx = np.flatnonzero(comp == ci)
        prev = np.concatenate([[0], dc[idx[:-1]]])
        first = np.concatenate([[True],
                                interval[idx[1:]] != interval[idx[:-1]]])
        diff[idx] = dc[idx] - np.where(first, 0, prev)
    tab = np.minimum(comp, 1)
    dc_codes = [_code_arrays(t) for t in STD_DC]
    ac_codes = [_code_arrays(t) for t in STD_AC]

    def extra(v, n):
        return np.where(v < 0, v + (1 << n) - 1, v)

    # items: (block, slot, value, length); slot orders them in a block
    items_b, items_s, items_v, items_l = [], [], [], []

    def add(b, slot, val, length):
        items_b.append(b)
        items_s.append(slot)
        items_v.append(val)
        items_l.append(length)

    nb = np.arange(blocks.shape[0])
    size = _nbits(diff)
    for t in (0, 1):
        sel = tab == t
        add(nb[sel], np.zeros(sel.sum(), np.int64),
            dc_codes[t][0][size[sel]], dc_codes[t][1][size[sel]])
    add(nb, np.ones(nb.size, np.int64), extra(diff, size), size)
    bi, ki = np.nonzero(zz[:, 1:])
    ki = ki + 1
    prev_k = np.zeros_like(ki)
    same = bi[1:] == bi[:-1]
    prev_k[1:][same] = ki[:-1][same]
    run = ki - prev_k - 1
    val = zz[bi, ki]
    asize = _nbits(val)
    if size.max(initial=0) > 11 or asize.max(initial=0) > 10:
        raise ValueError("JPEG encode: a coefficient outside baseline's "
                         "range")
    for z in (1, 2, 3):     # a ZRL (0xF0) for each 16 zeros
        sel = run >= 16 * z
        for t in (0, 1):
            s2 = sel & (tab[bi] == t)
            add(bi[s2], 4 * ki[s2] - 4 + z,
                np.full(s2.sum(), ac_codes[t][0][0xF0]),
                np.full(s2.sum(), ac_codes[t][1][0xF0]))
    sym = ((run % 16) << 4) | asize
    for t in (0, 1):
        s2 = tab[bi] == t
        add(bi[s2], 4 * ki[s2], ac_codes[t][0][sym[s2]],
            ac_codes[t][1][sym[s2]])
    add(bi, 4 * ki + 1, extra(val, asize), asize)
    last = np.zeros(blocks.shape[0], np.int64)
    np.maximum.at(last, bi, ki)
    for t in (0, 1):     # EOB
        sel = (last < 63) & (tab == t)
        add(nb[sel], np.full(sel.sum(), 1000),
            np.full(sel.sum(), ac_codes[t][0][0]),
            np.full(sel.sum(), ac_codes[t][1][0]))
    ib, isl = np.concatenate(items_b), np.concatenate(items_s)
    iv, il = np.concatenate(items_v), np.concatenate(items_l)
    key = np.lexsort((isl, ib))
    ib, iv, il = ib[key], iv[key], il[key]
    # the data, one padded run per restart interval
    data = bytearray()
    item_interval = interval[ib]
    bounds = np.searchsorted(item_interval,
                             np.arange(int(interval[-1]) + 2))
    for j in range(int(interval[-1]) + 1):
        if j:
            data += bytes([0xFF, 0xD0 + (j - 1) % 8])
        lo, hi = bounds[j], bounds[j + 1]
        data += _pack(iv[lo:hi], il[lo:hi])
    return _headers(hgt, wid, samp, quants, restart) + bytes(data) + \
        b'\xff\xd9'


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack('>BBH', 0xFF, marker, len(body) + 2) + body


def _headers(hgt: int, wid: int, samp, quants, restart: int) -> bytes:
    """SOI to SOS, as libjpeg-turbo's ``jcmarker.c`` writes them."""
    nc = len(samp)
    out = b'\xff\xd8' + _segment(0xE0, b'JFIF\0\x01\x01\x00\x00\x01\x00\x01'
                                 b'\x00\x00')
    for t in range(min(nc, 2)):
        out += _segment(0xDB, bytes([t]) + bytes(
            int(v) for v in quants[t][ZIGZAG]))
    sof = struct.pack('>BHHB', 8, hgt, wid, nc)
    for ci, (h, v) in enumerate(samp):
        sof += bytes([ci + 1, (h << 4) | v, min(ci, 1)])
    out += _segment(0xC0, sof)
    for t in range(min(nc, 2)):
        out += _segment(0xC4, bytes([t]) + STD_DC[t][0] + STD_DC[t][1])
        out += _segment(0xC4, bytes([0x10 | t]) + STD_AC[t][0]
                        + STD_AC[t][1])
    if restart:
        out += _segment(0xDD, struct.pack('>H', restart))
    sos = bytes([nc])
    for ci in range(nc):
        sos += bytes([ci + 1, min(ci, 1) * 0x11])
    return out + _segment(0xDA, sos + b'\x00\x3f\x00')


# ----------------------------------------------------------------- decoder

def _lookup(bits: bytes, vals: bytes) -> List[int]:
    """A table's 16-bit lookahead: entry w = symbol << 8 | code length of
    the code that starts the 16 bits w; -1 where no code does."""
    table = np.full(1 << 16, -1, np.int64)
    for sym, (code, length) in _huff_codes(bits, vals).items():
        lo = code << (16 - length)
        table[lo:lo + (1 << (16 - length))] = sym << 8 | length
    return table.tolist()


class _Frame:
    def __init__(self):
        self.quant: Dict[int, np.ndarray] = {}
        self.dc: Dict[int, List[int]] = {}
        self.ac: Dict[int, List[int]] = {}
        self.restart = 0
        self.jfif = self.adobe = False
        self.height = self.width = 0
        self.comps: List[dict] = []
        self.coef: List[np.ndarray] = []


def _parse_sof(f: _Frame, marker: int, body: bytes) -> None:
    if marker in (0xC2, 0xC6, 0xCA, 0xCE):
        raise not_ported("progressive")
    if marker in (0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
        raise not_ported("arithmetic-coded")
    if marker in (0xC3, 0xC7, 0xCB, 0xCF):
        raise not_ported("lossless")
    if marker in (0xC5, 0xC6, 0xC7):
        raise not_ported("hierarchical")
    if f.comps:
        raise DecodeError("JPEG: a second frame header")
    if len(body) < 6:
        raise DecodeError("JPEG: short frame header")
    prec, f.height, f.width, nc = struct.unpack_from('>BHHB', body)
    if prec != 8:
        raise not_ported(f"{prec}-bit")
    if nc not in (1, 3):
        raise not_ported(f"{nc}-component")
    if f.height == 0 or f.width == 0:
        raise DecodeError("JPEG: zero height or width (DNL is not read)")
    if len(body) < 6 + 3 * nc:
        raise DecodeError("JPEG: short frame header")
    for k in range(nc):
        cid, hv, tq = body[6 + 3 * k:9 + 3 * k]
        f.comps.append({'id': cid, 'h': hv >> 4, 'v': hv & 15, 'tq': tq})
    hv = [(c['h'], c['v']) for c in f.comps]
    if hv[0] not in ((1, 1), (2, 1), (1, 2), (2, 2)) or any(
            s != (1, 1) for s in hv[1:]):
        raise not_ported(f"sampling {hv}")


def _sampling(f: _Frame):
    hmax = max(c['h'] for c in f.comps)
    vmax = max(c['v'] for c in f.comps)
    mcux = -(-f.width // (8 * hmax))
    mcuy = -(-f.height // (8 * vmax))
    return hmax, vmax, mcux, mcuy


def _entropy_end(data: bytes, pos: int) -> int:
    """The offset of the first marker after ``pos`` that is neither a
    stuffed 0xFF00 nor RSTn (nor fill bytes)."""
    n = len(data)
    while True:
        pos = data.find(b'\xff', pos)
        if pos < 0 or pos + 1 >= n:
            raise DecodeError("JPEG: no marker after the scan data")
        nxt = data[pos + 1]
        if nxt == 0 or 0xD0 <= nxt <= 0xD7 or nxt == 0xFF:
            pos += 1
            continue
        return pos


def _decode_scan(f: _Frame, body: bytes, data: bytes, pos: int) -> int:
    ns = body[0]
    if ns < 1 or len(body) < 4 + 2 * ns:
        raise DecodeError("JPEG: bad scan header")
    ids = [c['id'] for c in f.comps]
    scomps = []
    for k in range(ns):
        cid, t = body[1 + 2 * k:3 + 2 * k]
        if cid not in ids:
            raise DecodeError(f"JPEG: scan names component {cid}")
        ci = ids.index(cid)
        if (t >> 4) not in f.dc or (t & 15) not in f.ac:
            raise DecodeError("JPEG: scan uses an undefined Huffman table")
        scomps.append((ci, f.dc[t >> 4], f.ac[t & 15]))
    ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
    if ss != 0 or se != 63 or ahal != 0:
        raise DecodeError("JPEG: a sequential scan must cover 0..63")
    hmax, vmax, mcux, mcuy = _sampling(f)
    if ns == 1:
        c = f.comps[scomps[0][0]]
        bw = -(-f.width * c['h'] // (hmax * 8))
        bh = -(-f.height * c['v'] // (vmax * 8))
        units = [[(scomps[0], 0, 0)]]
        nx, ny = bw, bh
    else:
        units = [[(sc, y, x) for sc in scomps
                  for y in range(f.comps[sc[0]]['v'])
                  for x in range(f.comps[sc[0]]['h'])]]
        nx, ny = mcux, mcuy
    mcu = units[0]
    end = _entropy_end(data, pos)
    segments = [data[pos:end]]
    if f.restart:
        segments, start = [], pos
        k = 0
        while True:
            nxt = data.find(bytes([0xFF, 0xD0 + k % 8]), start, end)
            if nxt < 0:
                segments.append(data[start:end])
                break
            segments.append(data[start:nxt])
            start, k = nxt + 2, k + 1
    nmcu = nx * ny
    per = f.restart or nmcu
    if len(segments) != -(-nmcu // per):
        raise DecodeError("JPEG: restart markers do not match the interval")
    coefs = {ci: [0] * (f.coef[ci].size) for ci, _, _ in scomps}
    zz = ZIGZAG.tolist()
    m = 0
    for seg in segments:
        raw = np.frombuffer(seg, np.uint8)
        ff = np.flatnonzero(raw == 0xFF)
        if ff.size and (ff[-1] + 1 == raw.size or np.any(raw[ff + 1] != 0)):
            raise DecodeError("JPEG: a marker inside the scan data")
        raw = np.delete(raw, ff + 1)
        ext = np.concatenate([raw, np.zeros(16, np.uint8)]).astype(np.int64)
        words = ((ext[:-3] << 24) | (ext[1:-2] << 16) | (ext[2:-1] << 8)
                 | ext[3:]).tolist()
        nbits = raw.size * 8
        bp = 0
        preds = {ci: 0 for ci, _, _ in scomps}
        for _ in range(min(per, nmcu - m)):
            my, mx = divmod(m, nx)
            for (ci, dct, act), y, x in mcu:
                c = f.comps[ci]
                if ns == 1:
                    by, bx = my, mx
                else:
                    by, bx = my * c['v'] + y, mx * c['h'] + x
                cols = f.coef[ci].shape[1]
                base = (by * cols + bx) * 64
                out = coefs[ci]
                w = words[bp >> 3]
                e = dct[(w >> (16 - (bp & 7))) & 0xFFFF]
                if e < 0:
                    raise DecodeError("JPEG: bad Huffman code")
                bp += e & 255
                s = e >> 8
                v = 0
                if s:
                    w = words[bp >> 3]
                    v = (w >> (32 - (bp & 7) - s)) & ((1 << s) - 1)
                    bp += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                if bp > nbits:
                    raise DecodeError("JPEG: scan data ends early")
                preds[ci] += v
                out[base] = preds[ci]
                k = 1
                while k < 64:
                    w = words[bp >> 3]
                    e = act[(w >> (16 - (bp & 7))) & 0xFFFF]
                    if e < 0:
                        raise DecodeError("JPEG: bad Huffman code")
                    bp += e & 255
                    r, s = e >> 12, (e >> 8) & 15
                    if s:
                        k += r
                        if k > 63:
                            raise DecodeError("JPEG: coefficient past 63")
                        w = words[bp >> 3]
                        v = (w >> (32 - (bp & 7) - s)) & ((1 << s) - 1)
                        bp += s
                        if v < 1 << (s - 1):
                            v -= (1 << s) - 1
                        out[base + zz[k]] = v
                        k += 1
                    elif r == 15:
                        k += 16
                    else:
                        break
                    if bp > nbits:
                        raise DecodeError("JPEG: scan data ends early")
                if k > 64 or bp > nbits:
                    raise DecodeError("JPEG: corrupt block")
            m += 1
    for ci, vals in coefs.items():
        # JCOEF is 16-bit, as in libjpeg
        f.coef[ci] = np.array(vals, np.int64).astype(np.int16).astype(
            np.int64).reshape(f.coef[ci].shape)
    return end


def _upsample(p: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """libjpeg-turbo's upsampling of a (dh, dw) chroma plane by (fh, fv)
    in {1, 2}^2 ("fancy"; box for h2 planes at most 2 samples wide)."""
    p = p.astype(np.int64)
    if fh == 1 and fv == 1:
        return p
    if fh == 2 and p.shape[1] <= 2:
        return np.repeat(np.repeat(p, fh, axis=1), fv, axis=0)
    if fh == 2 and fv == 1:
        left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
        right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
        out = np.empty((p.shape[0], 2 * p.shape[1]), np.int64)
        out[:, 0::2] = (3 * p + left + 1) >> 2
        out[:, 1::2] = (3 * p + right + 2) >> 2
        return out
    up = np.concatenate([p[:1], p[:-1]])
    down = np.concatenate([p[1:], p[-1:]])
    if fh == 1:
        out = np.empty((2 * p.shape[0], p.shape[1]), np.int64)
        out[0::2] = (3 * p + up + 1) >> 2
        out[1::2] = (3 * p + down + 2) >> 2
        return out
    out = np.empty((2 * p.shape[0], 2 * p.shape[1]), np.int64)
    for r, near in ((0, up), (1, down)):
        s = 3 * p + near
        left = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
        right = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
        out[r::2, 0::2] = (3 * s + left + 8) >> 4
        out[r::2, 1::2] = (3 * s + right + 7) >> 4
    return out


def decode(data) -> np.ndarray:
    """Pixels of a JPEG stream: (H, W) grey or (H, W, 3) RGB uint8, what
    ``cv2.imread(IMREAD_UNCHANGED)`` gives (BGR flipped to RGB)."""
    data = bytes(data)
    if not data.startswith(b'\xff\xd8'):
        raise DecodeError("not a JPEG stream (no SOI)")
    f = _Frame()
    pos, scanned = 2, False
    while True:
        while pos < len(data) and data[pos] == 0xFF and \
                pos + 1 < len(data) and data[pos + 1] == 0xFF:
            pos += 1
        if pos + 2 > len(data) or data[pos] != 0xFF:
            raise DecodeError("JPEG: no marker where one should be")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD8 or marker == 0x01:
            continue
        if pos + 2 > len(data):
            raise DecodeError("JPEG: truncated segment")
        length = struct.unpack_from('>H', data, pos)[0]
        body = data[pos + 2:pos + length]
        if length < 2 or len(body) != length - 2:
            raise DecodeError("JPEG: truncated segment")
        pos += length
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            _parse_sof(f, marker, body)
            _, _, mcux, mcuy = _sampling(f)
            f.coef = [np.zeros((mcuy * c['v'], mcux * c['h'], 64), np.int64)
                      for c in f.comps]
        elif marker == 0xCC:
            raise not_ported("arithmetic-coded")
        elif marker == 0xDB:
            _parse_dqt(f, body)
        elif marker == 0xC4:
            _parse_dht(f, body)
        elif marker == 0xDD:
            if len(body) != 2:
                raise DecodeError("JPEG: bad DRI")
            f.restart = struct.unpack('>H', body)[0]
        elif marker == 0xDA:
            if not f.comps:
                raise DecodeError("JPEG: scan before the frame header")
            pos = _decode_scan(f, body, data, pos)
            scanned = True
        elif marker == 0xE0 and body.startswith(b'JFIF\0'):
            f.jfif = True
        elif marker == 0xEE and body.startswith(b'Adobe'):
            f.adobe = True
        elif marker == 0xDC:
            raise DecodeError("JPEG: DNL is not read")
    if not scanned:
        raise DecodeError("JPEG: no scan")
    return _output(f)


def _parse_dqt(f: _Frame, body: bytes) -> None:
    k = 0
    while k < len(body):
        pq, tq = body[k] >> 4, body[k] & 15
        size = 128 if pq else 64
        if pq > 1 or tq > 3 or k + 1 + size > len(body):
            raise DecodeError("JPEG: bad DQT")
        vals = np.frombuffer(body, '>u2' if pq else np.uint8, 64, k + 1)
        table = np.zeros(64, np.int64)
        table[ZIGZAG] = vals
        f.quant[tq] = table
        k += 1 + size


def _parse_dht(f: _Frame, body: bytes) -> None:
    k = 0
    while k < len(body):
        tc, th = body[k] >> 4, body[k] & 15
        if tc > 1 or th > 3 or k + 17 > len(body):
            raise DecodeError("JPEG: bad DHT")
        bits = body[k + 1:k + 17]
        count = sum(bits)
        vals = body[k + 17:k + 17 + count]
        if count > 256 or len(vals) != count or (
                not tc and any(v > 15 for v in vals)):
            raise DecodeError("JPEG: bad DHT")
        code = 0
        for length in range(1, 17):
            code += bits[length - 1]
            if code > 1 << length:
                raise DecodeError("JPEG: bad DHT")
            code <<= 1
        (f.ac if tc else f.dc)[th] = _lookup(bits, vals)
        k += 17 + count


def _output(f: _Frame) -> np.ndarray:
    hmax, vmax, _, _ = _sampling(f)
    if len(f.comps) == 3:
        ids = [c['id'] for c in f.comps]
        if f.adobe:
            raise not_ported("Adobe-transform (APP14)")
        if not f.jfif and ids == [82, 71, 66]:
            raise not_ported("RGB (component ids 'R', 'G', 'B')")
    planes = []
    for ci, c in enumerate(f.comps):
        if c['tq'] not in f.quant:
            raise DecodeError("JPEG: component uses an undefined table")
        rows, cols = f.coef[ci].shape[:2]
        px = idct_islow(f.coef[ci].reshape(-1, 64), f.quant[c['tq']])
        plane = px.reshape(rows, cols, 8, 8).transpose(0, 2, 1, 3).reshape(
            rows * 8, cols * 8)
        dh = -(-f.height * c['v'] // vmax)
        dw = -(-f.width * c['h'] // hmax)
        up = _upsample(plane[:dh, :dw], hmax // c['h'], vmax // c['v'])
        planes.append(up[:f.height, :f.width])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    return ycc_to_rgb(*planes)
