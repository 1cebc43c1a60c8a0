"""JPEG, the plain version: the specification ``csrc/jpeg.c`` follows,
in Python and NumPy integer arithmetic.

The JAX package reads ``.jpg`` tiles with ``cv2.imread(IMREAD_UNCHANGED)``
(then BGR -> RGB) and encodes JPEG OME-TIFF tiles with
``cv2.imencode('.jpg')``; OpenCV 5.0 links libjpeg-turbo. The port's
codec reproduces libjpeg-turbo's integer arithmetic, so its pixels equal
``cv2.imread``'s and its streams ``cv2.imencode``'s, byte for byte:

Decoding (``decode``): baseline (SOF0), extended-sequential (SOF1) and
progressive (SOF2) 8-bit Huffman frames, their arithmetic-coded twins
(SOF9, SOF10) and lossless Huffman frames (SOF3) of 2..8 bits, of 1, 3
or 4 components, any sampling factors 1..4 whose ratios to the largest
are integral, any number of scans (interleaved, or one component each;
Huffman tables defined or redefined between them), restart intervals.
Progressive scans (``jdphuff.c``): DC first (the difference, shifted by
Al) and refinement (one bit), AC first (a spectral band, with end-of-
band runs) and refinement (correction bits, newly nonzero coefficients
of +-1 << Al). Arithmetic-coded scans (``jdarith.c``): T.81 Annex D's QM
decoder (Table D.2 as ``jaricom.c`` packs it; bytes destuffed, fill
0xFF swallowed, zeros fed from a marker on; C and A registers with a
floating cut) and the statistical models of F.1.4 and G.1.3 (DC
conditioned on the last difference by the DAC bounds L and U, default
0 and 1; AC magnitude bins split at Kx, default 5; sign and refinement
bits at a fixed 0.5 estimate; AC refinement without Huffman's check of
the bit already set), every statistic reset with each restart interval.
Lossless scans (``jdlhuff.c``, ``jdpred.c``, ``jddiffct.c``): Huffman
categories 0..16 (16 meaning 32768), predictors 1..7 mod 2^16, the first
row of the image and of each iMCU row holding a restart 1-D from 2^(P -
Pt - 1), other rows' first sample from above; the samples shifted left
by Pt and kept as they are (not scaled to 8 bits), box-upsampled (no
fancy upsampling from one-sample blocks), 3 components RGB with no
marker or an Adobe transform 0 (libjpeg-turbo does not convert YCbCr in
a lossless frame: OpenCV gives None). APPn and COM segments are skipped
(an EXIF orientation is ignored, as ``IMREAD_UNCHANGED`` ignores it), but
for JFIF (APP0 of 14 bytes or more) and Adobe (APP14 of 12 or more, its
transform flag). Then, as libjpeg-turbo's defaults give it:
- the ``islow`` inverse DCT (``jidctint.c``): two passes of the LL&M
  butterfly with 13-bit constants, pass 1 (columns, dequantised) descaled
  by 11 bits, pass 2 (rows) by 18, the result plus 128 taken through the
  range-limit table of ``jdmaster.c`` (the value masked to 10 bits, then
  clamped to 0..255 for -384..511); no IDCT scaling (this libjpeg-turbo
  scales chroma in the IDCT only when the output is scaled);
- upsampling as ``jdsample.c::jinit_upsampler`` picks it: "fancy" for
  the ratios (2, 1), (2, 2) and (1, 2): h2v1 as (3 near + far + 1 or 2)
  >> 2, h2v2 as (3 (3 near + far rows) + the far column's + 8 or 7) >>
  4, h1v2 as (3 near + far + 1 or 2) >> 2, edges replicated (box for
  the h2 ratios of a plane at most 2 samples wide); box replication
  (``int_upsample``) for any other integral ratio, such as 4:1:1's
  (4, 1);
- the colour space of ``jdapimin.c::default_decompress_parms``: 3
  components are YCbCr after a JFIF marker; else RGB under an Adobe
  transform 0 and YCbCr under any other; else RGB for component ids
  'R', 'G', 'B' and YCbCr otherwise. YCbCr -> RGB goes through
  ``jdcolor.c``'s 16-bit fixed-point tables. 4 components are CMYK, or
  YCCK under a nonzero Adobe transform (``ycck_cmyk_convert``: C, M, Y =
  255 - the YCbCr's RGB), then OpenCV's CMYK -> BGR (each of C, M, Y as
  k - ((255 - v) k >> 8)), given as RGB;
- libjpeg-turbo 3.1's block smoothing of a progressive frame whose scans
  left one of the first 10 zigzag coefficients unrefined
  (``jdcoefct.c::smoothing_ok`` and ``decompress_smooth_data``): each of
  zigzag ACs 1..5 still zero and not known to the last bit estimated
  from the 5x5 neighbours' DCs (Section K.8's estimates widened), and,
  when no AC has been sent, ACs 1..9 and the DC too, each estimate
  clamped below 2^Al (:func:`smooth_blocks`, :func:`smooth_rows`).
A stream libjpeg-turbo does not read (sampling factors over 4,
fractional ratios, interleaved MCUs of more than 10 blocks) or that does
not decode raises :class:`DecodeError`; so do the streams that neither
OpenCV nor the JAX package's imageio fallback (Pillow) gives pixels for,
saying so (:func:`no_pixels`): hierarchical and lossless arithmetic-coded
frames, DCT frames of other than 8 bits, lossless frames over 8 bits,
2 components, lossless YCbCr and YCCK.

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
ZIGZAG_LIST = ZIGZAG.tolist()

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

def no_pixels(what: str) -> DecodeError:
    """The error of a stream OpenCV's libjpeg-turbo does not decode and
    Pillow refuses too: the JAX package's ``read_image`` gives no pixels
    for it either."""
    return DecodeError(
        f"JPEG: {what} frames are not decoded by OpenCV or Pillow, so the "
        "JAX package's read_image gives no pixels for them either")


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


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
               clamp: bool = True) -> np.ndarray:
    """Y, Cb, Cr planes -> (H, W, 3) uint8 RGB (``jdcolor.c``); with
    ``clamp`` False the int64 sums before the range limit."""
    y = y.astype(np.int64)
    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    half = 1 << 15
    r = y + ((91881 * cr + half) >> 16)
    g = y + ((-22554 * cb + half - 46802 * cr) >> 16)
    b = y + ((116130 * cb + half) >> 16)
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8) if clamp else rgb


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


#: jdhuff.c's limit on the blocks of an interleaved scan's MCU
MAX_BLOCKS_IN_MCU = 10
#: the zigzag coefficients whose refinement state decides libjpeg-turbo's
#: progressive block smoothing (``jdcoefct.c``, SAVED_COEFS)
SMOOTHING_COEFS = 10


class _Frame:
    def __init__(self):
        self.quant: Dict[int, np.ndarray] = {}
        self.dc: Dict[int, List[int]] = {}
        self.dc_max: Dict[int, int] = {}
        self.ac: Dict[int, List[int]] = {}
        self.restart = 0
        #: T.81 frame kinds: lossless (SOF3) samples, arithmetic coding
        self.lossless = False
        self.arith = False
        self.precision = 8
        #: arithmetic conditioning by table (DAC; T.81 F.1.4.4 defaults)
        self.dac_l = [0] * 16
        self.dac_u = [1] * 16
        self.dac_k = [5] * 16
        #: per component: a lossless frame's samples, undifferenced
        self.samples: List[np.ndarray] = []
        self.jfif = False
        self.adobe = None        # the APP14 transform flag, when one was seen
        self.progressive = False
        self.height = self.width = 0
        self.comps: List[dict] = []
        #: per component: its blocks' coefficients, flat, natural order
        self.coef: List[List[int]] = []
        #: per component: (block rows, block columns) of the MCU grid
        self.grid: List[Tuple[int, int]] = []
        #: per component and zigzag index: the successive approximation
        #: bit last coded, -1 before any scan (``cinfo->coef_bits``)
        self.coef_bits: List[List[int]] = []


def _parse_sof(f: _Frame, marker: int, body: bytes) -> None:
    if marker in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF):
        raise no_pixels("hierarchical")
    if marker == 0xCB:
        raise no_pixels("lossless arithmetic-coded")
    if f.comps:
        raise DecodeError("JPEG: a second frame header")
    if len(body) < 6:
        raise DecodeError("JPEG: short frame header")
    f.lossless = marker == 0xC3
    f.arith = marker in (0xC9, 0xCA)
    f.progressive = marker in (0xC2, 0xCA)
    prec, f.height, f.width, nc = struct.unpack_from('>BHHB', body)
    f.precision = prec
    if f.lossless and not 2 <= prec <= 16:
        raise DecodeError(f"JPEG: bad lossless precision {prec}")
    if f.lossless and prec > 8:
        raise no_pixels(f"{prec}-bit lossless")
    if not f.lossless and prec != 8:
        raise no_pixels(f"{prec}-bit")
    if nc == 2:
        raise no_pixels("2-component")
    if nc not in (1, 3, 4):
        raise DecodeError(f"JPEG: {nc} components")
    if f.height == 0 or f.width == 0:
        raise DecodeError("JPEG: zero height or width (DNL is not read)")
    if len(body) < 6 + 3 * nc:
        raise DecodeError("JPEG: short frame header")
    for k in range(nc):
        cid, hv, tq = body[6 + 3 * k:9 + 3 * k]
        f.comps.append({'id': cid, 'h': hv >> 4, 'v': hv & 15, 'tq': tq})
    hv = [(c['h'], c['v']) for c in f.comps]
    if any(not (1 <= h <= 4 and 1 <= v <= 4) for h, v in hv):
        raise DecodeError(f"JPEG: bad sampling factors {hv}")
    hmax, vmax, _, _ = _sampling(f)
    if any(hmax % h or vmax % v for h, v in hv):
        # jdsample.c: "Fractional sampling not implemented yet"
        raise DecodeError(f"JPEG: fractional sampling {hv}")


def _sampling(f: _Frame):
    """(hmax, vmax, MCU columns, MCU rows): blocks of 8x8 samples, or of
    one sample in a lossless frame."""
    size = 1 if f.lossless else 8
    hmax = max(c['h'] for c in f.comps)
    vmax = max(c['v'] for c in f.comps)
    mcux = -(-f.width // (size * hmax))
    mcuy = -(-f.height // (size * vmax))
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


class _Bits:
    """An entropy-coded segment, destuffed, read MSB first."""

    def __init__(self, seg: bytes):
        raw = np.frombuffer(seg, np.uint8)
        ff = np.flatnonzero(raw == 0xFF)
        if ff.size and (ff[-1] + 1 == raw.size or np.any(raw[ff + 1] != 0)):
            raise DecodeError("JPEG: a marker inside the scan data")
        raw = np.delete(raw, ff + 1)
        ext = np.concatenate([raw, np.zeros(16, np.uint8)]).astype(np.int64)
        self.words = ((ext[:-3] << 24) | (ext[1:-2] << 16) | (ext[2:-1] << 8)
                      | ext[3:]).tolist()
        self.nbits = raw.size * 8
        self.pos = 0

    def huff(self, table: List[int]) -> int:
        w = self.words[self.pos >> 3]
        e = table[(w >> (16 - (self.pos & 7))) & 0xFFFF]
        if e < 0:
            raise DecodeError("JPEG: bad Huffman code")
        self.pos += e & 255
        return e >> 8

    def get(self, s: int) -> int:
        """The next ``s`` bits (0 <= s <= 16) as an unsigned number."""
        if s == 0:
            return 0
        w = self.words[self.pos >> 3]
        v = (w >> (32 - (self.pos & 7) - s)) & ((1 << s) - 1)
        self.pos += s
        return v

    def extend(self, s: int) -> int:
        """The next ``s`` bits as a coefficient of magnitude category s."""
        v = self.get(s)
        return v - (1 << s) + 1 if s and v < 1 << (s - 1) else v

    def check(self) -> None:
        if self.pos > self.nbits:
            raise DecodeError("JPEG: scan data ends early")


def _decode_sequential(bits: _Bits, dct, act, out: List[int], base: int,
                       pred: List[int]) -> None:
    """One block of a sequential scan: the DC difference and 63 ACs."""
    pred[0] += bits.extend(bits.huff(dct))
    bits.check()
    out[base] = pred[0]
    k = 1
    while k < 64:
        e = bits.huff(act)
        r, s = e >> 4, e & 15
        if s:
            k += r
            if k > 63:
                raise DecodeError("JPEG: coefficient past 63")
            out[base + ZIGZAG_LIST[k]] = bits.extend(s)
            k += 1
        elif r == 15:
            k += 16
        else:
            break
        bits.check()
    if k > 64:
        raise DecodeError("JPEG: corrupt block")
    bits.check()


def _decode_dc_first(bits: _Bits, dct, out: List[int], base: int,
                     pred: List[int], al: int) -> None:
    pred[0] += bits.extend(bits.huff(dct))
    bits.check()
    out[base] = pred[0] << al


def _decode_dc_refine(bits: _Bits, out: List[int], base: int,
                      al: int) -> None:
    if bits.get(1):
        out[base] |= 1 << al
    bits.check()


def _decode_ac_first(bits: _Bits, act, out: List[int], base: int,
                     ss: int, se: int, al: int, eobrun: List[int]) -> None:
    """``jdphuff.c::decode_mcu_AC_first``: one block's band [ss, se]."""
    if eobrun[0] > 0:
        eobrun[0] -= 1
        return
    k = ss
    while k <= se:
        e = bits.huff(act)
        r, s = e >> 4, e & 15
        if s:
            k += r
            if k > 63:
                raise DecodeError("JPEG: coefficient past 63")
            out[base + ZIGZAG_LIST[k]] = bits.extend(s) << al
        elif r == 15:
            k += 15
        else:
            eobrun[0] = (1 << r) + bits.get(r) - 1
            break
        k += 1
    bits.check()


def _decode_ac_refine(bits: _Bits, act, out: List[int], base: int,
                      ss: int, se: int, al: int, eobrun: List[int]) -> None:
    """``jdphuff.c::decode_mcu_AC_refine``: one block's correction bits
    for band [ss, se] and its newly nonzero coefficients."""
    p1, m1 = 1 << al, -1 << al
    k = ss

    def correct(pos: int) -> None:
        if bits.get(1) and out[pos] & p1 == 0:
            out[pos] += p1 if out[pos] >= 0 else m1

    if eobrun[0] == 0:
        while k <= se:
            e = bits.huff(act)
            r, s = e >> 4, e & 15
            if s:
                # the size of a newly nonzero coefficient is 1
                s = p1 if bits.get(1) else m1
            elif r != 15:
                eobrun[0] = (1 << r) + bits.get(r)
                break
            while k <= se:
                pos = base + ZIGZAG_LIST[k]
                if out[pos] != 0:
                    correct(pos)
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if s:
                if k > 63:
                    raise DecodeError("JPEG: coefficient past 63")
                out[base + ZIGZAG_LIST[k]] = s
            k += 1
            bits.check()
    if eobrun[0] > 0:
        while k <= se:
            pos = base + ZIGZAG_LIST[k]
            if out[pos] != 0:
                correct(pos)
            k += 1
        eobrun[0] -= 1
    bits.check()


#: T.81 Table D.2, as libjpeg-turbo's ``jaricom.c`` packs it: Qe << 16 |
#: next index after an MPS << 8 | MPS switch << 7 | next index after an
#: LPS; entry 113 is the fixed 0.5 estimate of sign and refinement bits
ARITAB = [(q << 16) | (m << 8) | (sw << 7) | lps for q, lps, m, sw in (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0))]
#: the fixed estimate's state (``jdarith.c``: fixed_bin[0] = 113)
FIXED_BIN = 113


class _Arith:
    """An arithmetic-coded segment through the QM decoder of T.81 Annex
    D as ``jdarith.c`` runs it: its bytes destuffed (0xFF 0x00 is 0xFF,
    further 0xFF fill bytes are swallowed), zero bytes fed from the first
    marker on, and 16-bit C and A registers with the cut between the
    interval's base and the bit buffer floating with CT."""

    def __init__(self, seg: bytes):
        out = bytearray()
        k, n = 0, len(seg)
        while k < n:
            b = seg[k]
            k += 1
            if b == 0xFF:
                while k < n and seg[k] == 0xFF:
                    k += 1
                if k >= n or seg[k] != 0:
                    break
                k += 1
            out.append(b)
        self.data = bytes(out)
        self.pos = 0
        self.c = self.a = 0
        self.ct = -16

    def decode(self, st: bytearray, i: int) -> int:
        """One binary decision with the statistics bin st[i]."""
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                if self.pos < len(self.data):
                    c = (c << 8) | self.data[self.pos]
                    self.pos += 1
                else:
                    c <<= 8
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                a = qe
                st[i] = (sv & 0x80) ^ nm
            else:
                a = qe
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _arith_dc(ar: _Arith, st: bytearray, ctx: Dict[int, int], ci: int,
              lo: int, hi: int) -> int:
    """A DC difference (F.1.4.1, Figure F.19) in component ci's
    conditioning context ``ctx[ci]``, which it updates with the DAC
    bounds L, U."""
    s0 = ctx[ci]
    if not ar.decode(st, s0):
        ctx[ci] = 0
        return 0
    sign = ar.decode(st, s0 + 1)
    i = s0 + 2 + sign
    m = ar.decode(st, i)
    if m:
        i = 20
        while ar.decode(st, i):
            m <<= 1
            if m == 0x8000:
                raise DecodeError("JPEG: bad arithmetic code")
            i += 1
    if m < (1 << lo) >> 1:
        ctx[ci] = 0
    elif m > (1 << hi) >> 1:
        ctx[ci] = 12 + sign * 4
    else:
        ctx[ci] = 4 + sign * 4
    v = m
    i += 14
    while m > 1:
        m >>= 1
        if ar.decode(st, i):
            v |= m
    v += 1
    return -v if sign else v


def _arith_ac(ar: _Arith, st: bytearray, fixed: bytearray, out: List[int],
              base: int, start: int, end: int, kx: int, al: int) -> None:
    """The ACs start..end of a block (Figure F.20; ``jdarith.c::
    decode_mcu`` and ``decode_mcu_AC_first``), each shifted left by al."""
    k = start - 1
    while k < end:
        i = 3 * k
        if ar.decode(st, i):
            break
        while True:
            k += 1
            if ar.decode(st, i + 1):
                break
            i += 3
            if k >= end:
                raise DecodeError("JPEG: bad arithmetic code")
        sign = ar.decode(fixed, 0)
        i += 2
        m = ar.decode(st, i)
        if m and ar.decode(st, i):
            m <<= 1
            i = 189 if k <= kx else 217
            while ar.decode(st, i):
                m <<= 1
                if m == 0x8000:
                    raise DecodeError("JPEG: bad arithmetic code")
                i += 1
        v = m
        i += 14
        while m > 1:
            m >>= 1
            if ar.decode(st, i):
                v |= m
        v += 1
        out[base + ZIGZAG_LIST[k]] = (-v if sign else v) << al


def _arith_ac_refine(ar: _Arith, st: bytearray, fixed: bytearray,
                     out: List[int], base: int, ss: int, se: int,
                     al: int) -> None:
    """``jdarith.c::decode_mcu_AC_refine``: correction bits of the
    coefficients already nonzero, newly nonzero ones of +-1 << al."""
    p1, m1 = 1 << al, -1 << al
    kex = se
    while kex > 0 and out[base + ZIGZAG_LIST[kex]] == 0:
        kex -= 1
    k = ss - 1
    while k < se:
        i = 3 * k
        if k >= kex and ar.decode(st, i):
            break
        while True:
            k += 1
            pos = base + ZIGZAG_LIST[k]
            if out[pos]:
                if ar.decode(st, i + 2):
                    out[pos] += m1 if out[pos] < 0 else p1
                break
            if ar.decode(st, i + 1):
                out[pos] = m1 if ar.decode(fixed, 0) else p1
                break
            i += 3
            if k >= se:
                raise DecodeError("JPEG: bad arithmetic code")


def _scan_header(f: _Frame, body: bytes):
    """(scan components as (index, DC table, AC table), Ss, Se, Ah, Al),
    checked as libjpeg-turbo checks them."""
    ns = body[0] if body else 0
    if ns < 1 or ns > len(f.comps) or len(body) < 4 + 2 * ns:
        raise DecodeError("JPEG: bad scan header")
    ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
    ah, al = ahal >> 4, ahal & 15
    if f.lossless:
        if not 1 <= ss <= 7 or se != 0 or ah != 0 or al >= f.precision:
            raise DecodeError("JPEG: bad lossless scan parameters")
    elif f.progressive:
        dc = ss == 0
        if ((dc and se != 0) or (not dc and (ss > se or se > 63 or ns != 1))
                or (ah and al != ah - 1) or al > 13):
            raise DecodeError("JPEG: bad progression parameters")
    elif ss != 0 or se != 63 or ahal != 0:
        raise DecodeError("JPEG: a sequential scan must cover 0..63")
    ids = [c['id'] for c in f.comps]
    scomps = []
    for k in range(ns):
        cid, t = body[1 + 2 * k:3 + 2 * k]
        if cid not in ids:
            raise DecodeError(f"JPEG: scan names component {cid}")
        if not f.arith:
            need_dc = (f.lossless or not f.progressive
                       or (ss == 0 and ah == 0))
            need_ac = not f.lossless and (not f.progressive or ss > 0)
            if ((need_dc and (t >> 4) not in f.dc)
                    or (need_ac and (t & 15) not in f.ac)):
                raise DecodeError("JPEG: scan uses an undefined Huffman "
                                  "table")
            if need_dc and f.dc_max[t >> 4] > (16 if f.lossless else 15):
                raise DecodeError("JPEG: bad DHT")
        elif (t >> 4) > 3 or (t & 15) > 3:
            raise DecodeError("JPEG: bad arithmetic table number")
        scomps.append((ids.index(cid), t >> 4, t & 15))
    return scomps, ss, se, ah, al


def _segments(f: _Frame, data: bytes, pos: int, nmcu: int):
    """(end of the scan's data, its entropy-coded segments, MCUs a
    segment)."""
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
    per = f.restart or nmcu
    if len(segments) != -(-nmcu // per):
        raise DecodeError("JPEG: restart markers do not match the interval")
    return end, segments, per


def _decode_scan(f: _Frame, body: bytes, data: bytes, pos: int) -> int:
    scomps, ss, se, ah, al = _scan_header(f, body)
    hmax, vmax, mcux, mcuy = _sampling(f)
    size = 1 if f.lossless else 8
    if len(scomps) == 1:
        c = f.comps[scomps[0][0]]
        nx = -(-f.width * c['h'] // (hmax * size))
        ny = -(-f.height * c['v'] // (vmax * size))
        mcu = [(scomps[0], 0, 0)]
        one = True
    else:
        mcu = [(sc, y, x) for sc in scomps
               for y in range(f.comps[sc[0]]['v'])
               for x in range(f.comps[sc[0]]['h'])]
        if len(mcu) > MAX_BLOCKS_IN_MCU:
            raise DecodeError("JPEG: an MCU of more than 10 blocks")
        nx, ny = mcux, mcuy
        one = False
    if f.lossless:
        if f.restart and f.restart % nx:
            # jddiffct.c: the interval must be whole MCU rows
            raise DecodeError("JPEG: a lossless restart interval that is "
                              "not a multiple of the MCU row")
    else:
        for ci, _, _ in scomps:
            for k in range(ss, se + 1):
                f.coef_bits[ci][k] = al
    nmcu = nx * ny
    end, segments, per = _segments(f, data, pos, nmcu)
    if f.arith:
        dc_st = {t: bytearray(64) for _, t, _ in scomps}
        ac_st = {t: bytearray(256) for _, _, t in scomps}
    m = 0
    for seg in segments:
        if f.arith:
            ar = _Arith(seg)
            fixed = bytearray([FIXED_BIN])
            if not f.progressive or (ss == 0 and ah == 0):
                for st in dc_st.values():
                    st[:] = bytes(64)
            if not f.progressive or ss:
                for st in ac_st.values():
                    st[:] = bytes(256)
        else:
            bits = _Bits(seg)
        preds = {ci: [0] for ci, _, _ in scomps}
        ctx = {ci: 0 for ci, _, _ in scomps}
        eobrun = [0]
        for _ in range(min(per, nmcu - m)):
            my, mx = divmod(m, nx)
            for (ci, td, ta), y, x in mcu:
                c = f.comps[ci]
                if one:
                    by, bx = my, mx
                else:
                    by, bx = my * c['v'] + y, mx * c['h'] + x
                out = f.coef[ci]
                if f.lossless:
                    s_ = bits.huff(f.dc[td])
                    out[by * f.grid[ci][1] + bx] = (
                        32768 if s_ == 16 else bits.extend(s_))
                    bits.check()
                    continue
                base = (by * f.grid[ci][1] + bx) * 64
                if f.arith:
                    if not f.progressive or (ss == 0 and ah == 0):
                        pred = preds[ci]
                        pred[0] += _arith_dc(ar, dc_st[td], ctx, ci,
                                             f.dac_l[td], f.dac_u[td])
                        out[base] = pred[0] << (al if f.progressive else 0)
                    elif ss == 0:
                        if ar.decode(fixed, 0):
                            out[base] |= 1 << al
                    if not f.progressive:
                        _arith_ac(ar, ac_st[ta], fixed, out, base, 1, 63,
                                  f.dac_k[ta], 0)
                    elif ss and ah == 0:
                        _arith_ac(ar, ac_st[ta], fixed, out, base, ss, se,
                                  f.dac_k[ta], al)
                    elif ss:
                        _arith_ac_refine(ar, ac_st[ta], fixed, out, base,
                                         ss, se, al)
                elif not f.progressive:
                    _decode_sequential(bits, f.dc[td], f.ac[ta], out, base,
                                       preds[ci])
                elif ss == 0 and ah == 0:
                    _decode_dc_first(bits, f.dc[td], out, base, preds[ci],
                                     al)
                elif ss == 0:
                    _decode_dc_refine(bits, out, base, al)
                elif ah == 0:
                    _decode_ac_first(bits, f.ac[ta], out, base, ss, se, al,
                                     eobrun)
                else:
                    _decode_ac_refine(bits, f.ac[ta], out, base, ss, se, al,
                                      eobrun)
            m += 1
    if f.lossless:
        for ci, _, _ in scomps:
            _undifference(f, ci, ss, al, one, nx)
    return end


def _undifference(f: _Frame, ci: int, psv: int, pt: int, one: bool,
                  nx: int) -> None:
    """A lossless component's samples from its decoded differences
    (``jdpred.c``): predictor psv (T.81 H.1.2.1) on the previous sample
    Ra, the one above Rb and the one above-left Rc, mod 2^16; a first row
    1-D from 2^(P - Pt - 1), other rows' first sample from Rb. The first
    rows are the image's and, with restarts, that of each iMCU row (v
    sample rows) in which an interval starts: libjpeg-turbo undifferences
    an iMCU row after decoding it whole. Then shifted left by Pt to
    8-bit samples (``jdlossls.c``)."""
    c = f.comps[ci]
    hmax, vmax, _, _ = _sampling(f)
    hib = -(-f.height * c['v'] // vmax)
    wib = -(-f.width * c['h'] // hmax)
    v = c['v']
    diff = np.array(f.coef[ci], np.int64).reshape(f.grid[ci])[:hib, :wib]
    first = np.zeros(hib, bool)
    first[0] = True
    if f.restart:
        every = f.restart // nx
        rows = np.arange(hib) // (1 if one else v)
        start = ((rows % every == 0)
                 & (np.arange(hib) % (1 if one else v) == 0))
        first[(np.arange(hib) // v)[start] * v] = True
    x = np.zeros((hib, wib), np.int64)
    init = 1 << (f.precision - pt - 1)
    mask = 0xFFFF
    for r in range(hib):
        d = diff[r]
        if first[r]:
            x[r] = (init + np.cumsum(d)) & mask
            continue
        b = x[r - 1]
        x0 = (b[0] + d[0]) & mask
        if psv in (1, 4, 5):
            # Ra plus a term of the row above: a running sum
            t = d[1:].copy()
            if psv == 4:
                t += b[1:] - b[:-1]
            elif psv == 5:
                t += (b[1:] - b[:-1]) >> 1
            x[r, 0] = x0
            x[r, 1:] = (x0 + np.cumsum(t)) & mask
        elif psv == 2:
            x[r] = (b + d) & mask
        elif psv == 3:
            x[r, 0] = x0
            x[r, 1:] = (b[:-1] + d[1:]) & mask
        else:
            row = x[r]
            row[0] = ra = x0
            bl, dl = b.tolist(), d.tolist()
            for k in range(1, wib):
                rb, rc = bl[k], bl[k - 1]
                p = rb + ((ra - rc) >> 1) if psv == 6 else (ra + rb) >> 1
                ra = (dl[k] + p) & mask
                row[k] = ra
    f.samples[ci] = (x << pt) & 0xFF


def _smoothed(f: _Frame) -> bool:
    """Whether libjpeg-turbo would smooth this progressive frame's blocks
    (``jdcoefct.c::smoothing_ok``): every component has its quantisation
    table with nonzero values at the smoothed positions and its DC sent,
    and some component has one of its first ``SMOOTHING_COEFS`` zigzag
    coefficients not refined to the last bit."""
    if not f.progressive:
        return False
    useful = False
    for ci, c in enumerate(f.comps):
        q = f.quant.get(c['tq'])
        if q is None or any(q[i] == 0 for i in (0, 1, 8, 16, 9, 2, 3, 10,
                                                17, 24)):
            return False
        bits = f.coef_bits[ci]
        if bits[0] < 0:
            return False
        useful |= any(b != 0 for b in bits[1:SMOOTHING_COEFS])
    return useful


def _upsample(p: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """libjpeg-turbo's upsampling of a (dh, dw) plane by integral (fh, fv)
    (``jdsample.c::jinit_upsampler``): none for (1, 1); "fancy" for (2, 1),
    (2, 2) and (1, 2) (box for the h2 ratios of a plane at most 2 samples
    wide); box replication (``int_upsample``) for any other ratio, such as
    4:1:1's (4, 1)."""
    p = p.astype(np.int64)
    if fh == 1 and fv == 1:
        return p
    if (fh, fv) not in ((2, 1), (2, 2), (1, 2)) or (
            fh == 2 and p.shape[1] <= 2):
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


def decode(data, mode: str = 'cv2') -> np.ndarray:
    """Pixels of a JPEG stream: (H, W) grey or (H, W, 3) RGB uint8, what
    ``cv2.imread(IMREAD_UNCHANGED)`` gives (BGR flipped to RGB). Within a
    TIFF libtiff sets the colour space (``io/tiff.py``): ``mode`` 'raw'
    keeps the components as they are ((H, W, 4) for 4), 'ycc' converts 3
    from YCbCr whatever the markers say."""
    return _output(read(data), mode)


def read(data) -> _Frame:
    """A JPEG stream parsed and entropy-decoded: the frame with its
    quantised coefficients (natural order, per component on the MCU
    grid) or, lossless, its samples."""
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
            f.grid = [(mcuy * c['v'], mcux * c['h']) for c in f.comps]
            per = 1 if f.lossless else 64
            f.coef = [[0] * (r * c * per) for r, c in f.grid]
            f.coef_bits = [[-1] * 64 for _ in f.comps]
            f.samples = [None] * len(f.comps)
        elif marker == 0xCC:
            _parse_dac(f, body)
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
        elif marker == 0xE0 and len(body) >= 14 and body.startswith(
                b'JFIF\0'):
            f.jfif = True     # jdmarker.c reads APP0 of 14 bytes or more
        elif marker == 0xEE and len(body) >= 12 and body.startswith(
                b'Adobe'):
            f.adobe = body[11]     # the transform flag
        elif marker == 0xDC:
            raise DecodeError("JPEG: DNL is not read")
    if not scanned:
        raise DecodeError("JPEG: no scan")
    return f


def _parse_dac(f: _Frame, body: bytes) -> None:
    """DAC (``jdmarker.c::get_dac``): per table, DC conditioning L and U
    (U >= L) or the AC one Kx."""
    if len(body) % 2:
        raise DecodeError("JPEG: bad DAC")
    for k in range(0, len(body), 2):
        index, val = body[k], body[k + 1]
        if index >= 32:
            raise DecodeError("JPEG: bad DAC")
        if index >= 16:
            f.dac_k[index - 16] = val
        else:
            f.dac_l[index], f.dac_u[index] = val & 15, val >> 4
            if val & 15 > val >> 4:
                raise DecodeError("JPEG: bad DAC")


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
                not tc and any(v > 16 for v in vals)):
            raise DecodeError("JPEG: bad DHT")
        code = 0
        for length in range(1, 17):
            code += bits[length - 1]
            if code > 1 << length:
                raise DecodeError("JPEG: bad DHT")
            code <<= 1
        (f.ac if tc else f.dc)[th] = _lookup(bits, vals)
        if not tc:
            # a DC category of 16 is a lossless difference of 32768 only
            f.dc_max[th] = max(vals, default=0)
        k += 17 + count


def _colour_space(f: _Frame) -> str:
    """The stream's colour space as ``jdapimin.c::default_decompress_
    parms`` guesses it: 'grey', 'ycc', 'rgb', 'cmyk' or 'ycck'."""
    nc = len(f.comps)
    if nc == 1:
        return 'grey'
    if nc == 4:
        return 'ycck' if f.adobe not in (None, 0) else 'cmyk'
    if f.jfif:
        return 'ycc'
    if f.adobe is not None:
        return 'rgb' if f.adobe == 0 else 'ycc'
    ids = [c['id'] for c in f.comps]
    # libjpeg-turbo 3 takes a lossless frame with no marker as RGB
    return 'rgb' if ids == [82, 71, 66] or f.lossless else 'ycc'


def cmyk_to_rgb(c, m, y, k) -> np.ndarray:
    """OpenCV's CMYK -> BGR of a 4-component JPEG (``icvCvt_CMYK2BGR_8u_
    C4C3R``: each of C, M, Y as k - ((255 - v) k >> 8)), as RGB."""
    k = k.astype(np.int64)
    return np.stack([k - (((255 - v.astype(np.int64)) * k) >> 8)
                     for v in (c, m, y)], axis=-1).astype(np.uint8)


def _dc_weights(text: str) -> np.ndarray:
    """A 5x5 weight grid from ``jdcoefct.c``'s terms ``w*DCnn`` (DC01..
    DC25 row by row: rows r - 2..r + 2, columns c - 2..c + 2)."""
    grid = np.zeros(25, np.int64)
    for term in text.replace('- ', '+-').replace(' ', '').split('+'):
        w, _, name = term.rpartition('DC')
        grid[int(name) - 1] = int({'': 1, '-': -1}.get(w, w.rstrip('*')))
    return grid.reshape(5, 5)


#: ``decompress_smooth_data``'s estimates, by zigzag index 1..9: the
#: weights of the neighbours' DCs when no AC coefficient has been sent
#: (``change_dc``), and otherwise (None: not estimated then)
_SMOOTH = [
    (_dc_weights('-DC01 - DC02 + DC04 + DC05 - 3*DC06 + 13*DC07 - 13*DC09 '
                 '+ 3*DC10 - 3*DC11 + 38*DC12 - 38*DC14 + 3*DC15 - 3*DC16 '
                 '+ 13*DC17 - 13*DC19 + 3*DC20 - DC21 - DC22 + DC24 + DC25'),
     _dc_weights('-7*DC11 + 50*DC12 - 50*DC14 + 7*DC15')),
    (_dc_weights('-DC01 - 3*DC02 - 3*DC03 - 3*DC04 - DC05 - DC06 + 13*DC07 '
                 '+ 38*DC08 + 13*DC09 - DC10 + DC16 - 13*DC17 - 38*DC18 '
                 '- 13*DC19 + DC20 + DC21 + 3*DC22 + 3*DC23 + 3*DC24 + DC25'),
     _dc_weights('-7*DC03 + 50*DC08 - 50*DC18 + 7*DC23')),
    (_dc_weights('DC03 + 2*DC07 + 7*DC08 + 2*DC09 - 5*DC12 - 14*DC13 '
                 '- 5*DC14 + 2*DC17 + 7*DC18 + 2*DC19 + DC23'),
     _dc_weights('-DC03 + 13*DC08 - 24*DC13 + 13*DC18 - DC23')),
    (_dc_weights('-DC01 + DC05 + 9*DC07 - 9*DC09 - 9*DC17 + 9*DC19 + DC21 '
                 '- DC25'),
     _dc_weights('DC10 + DC16 - 10*DC17 + 10*DC19 - DC02 - DC20 + DC22 '
                 '- DC24 + DC04 - DC06 + 10*DC07 - 10*DC09')),
    (_dc_weights('2*DC07 - 5*DC08 + 2*DC09 + DC11 + 7*DC12 - 14*DC13 '
                 '+ 7*DC14 + DC15 + 2*DC17 - 5*DC18 + 2*DC19'),
     _dc_weights('-DC11 + 13*DC12 - 24*DC13 + 13*DC14 - DC15')),
    (_dc_weights('DC07 - DC09 + 2*DC12 - 2*DC14 + DC17 - DC19'), None),
    (_dc_weights('DC07 - 3*DC08 + DC09 - DC17 + 3*DC18 - DC19'), None),
    (_dc_weights('DC07 - DC09 - 3*DC12 + 3*DC14 + DC17 - DC19'), None),
    (_dc_weights('DC07 + 2*DC08 + DC09 - DC17 - 2*DC18 - DC19'), None),
]
#: the DC's estimate when no AC coefficient has been sent (weights sum
#: to 256: a weighted mean of the 5x5 DCs)
_SMOOTH_DC = _dc_weights(
    '-2*DC01 - 6*DC02 - 8*DC03 - 6*DC04 - 2*DC05 - 6*DC06 + 6*DC07 '
    '+ 42*DC08 + 6*DC09 - 6*DC10 - 8*DC11 + 42*DC12 + 152*DC13 + 42*DC14 '
    '- 8*DC15 - 6*DC16 + 6*DC17 + 42*DC18 + 6*DC19 - 6*DC20 - 2*DC21 '
    '- 6*DC22 - 8*DC23 - 6*DC24 - 2*DC25')


def smooth_rows(hib: int, v: int, imcu_rows: int) -> np.ndarray:
    """The block rows ``decompress_smooth_data`` takes as rows r - 2..
    r + 2 of each of a component's ``hib`` block rows (iMCU rows of v
    block rows): (hib, 5), rows of the MCU grid. It numbers a block row
    by (iMCU row) x (block rows of the iMCU row being output) + (row
    within it), and calls the image (block rows of that iMCU row) x
    (iMCU rows) rows tall: so the rows of the last iMCU row but one may
    take the MCU padding's rows below the image, and, where the last iMCU
    row is shorter than v, rows of the last one may repeat a row that
    the image has a neighbour for."""
    last = imcu_rows - 1
    out = np.empty((hib, 5), np.int64)
    for r in range(hib):
        i, b = divmod(r, v)
        rows = v if i < last else (hib % v or v)
        num, total = i * rows + b, rows * imcu_rows
        prev = r - 1 if num > 0 else r
        nxt = r + 1 if num < total - 1 else r
        out[r] = (r - 2 if num > 1 else prev, prev, r, nxt,
                  r + 2 if num < total - 2 else nxt)
    return out


def smooth_blocks(coef: np.ndarray, dc: np.ndarray, quant: np.ndarray,
                  bits: List[int], rows: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's block smoothing (``jdcoefct.c::decompress_smooth_
    data``) of one component's (hib, wib, 64) coefficients (natural order,
    as stored: DCs shifted by their Al), given the DCs of the whole MCU
    grid ``dc``, the zigzag coefficients' last successive-approximation
    bits ``bits`` (-1: never sent) and the neighbour rows of
    :func:`smooth_rows`: each of the first zigzag ACs
    still zero and not known to the last bit gets an estimate from the
    5x5 neighbours' DCs, clamped below 2^Al; with no AC sent at all, the
    DC too. Columns past an edge repeat the edge's."""
    out = coef.copy()
    wib = coef.shape[1]
    cols = np.clip(np.arange(wib)[:, None] + np.arange(-2, 3), 0, wib - 1)
    # nb[r, c, i, j]: the DC of row rows[r, i], column c + j - 2 (clamped)
    nb = dc[rows[:, None, :, None], cols[None, :, None, :]]
    change_dc = all(b == -1 for b in bits[1:10])
    q00 = int(quant[0])
    for k in range(1, 10):
        weights = _SMOOTH[k - 1][0 if change_dc else 1]
        al = bits[k]
        if weights is None or al == 0:
            continue
        pos = ZIGZAG_LIST[k]
        q = int(quant[pos])
        num = q00 * np.einsum('rcij,ij->rc', nb, weights)
        pred = ((q << 7) + np.abs(num)) // (q << 8)
        if al > 0:
            pred = np.minimum(pred, (1 << al) - 1)
        pred = np.where(num >= 0, pred, -pred)
        zero = out[:, :, pos] == 0
        out[:, :, pos] = np.where(zero, pred, out[:, :, pos])
    if change_dc:
        num = q00 * np.einsum('rcij,ij->rc', nb, _SMOOTH_DC)
        pred = ((q00 << 7) + np.abs(num)) // (q00 << 8)
        out[:, :, 0] = np.where(num >= 0, pred, -pred)
    return out.astype(np.int16).astype(np.int64)


def _space(f: _Frame, mode: str) -> str:
    if mode == 'cv2':
        return _colour_space(f)
    if mode == 'ycc':
        return 'ycc'
    return {1: 'grey', 3: 'rgb', 4: 'raw'}[len(f.comps)]


def _lossless_output(f: _Frame, mode: str) -> np.ndarray:
    """A lossless frame's pixels: its components box-upsampled (libjpeg-
    turbo upsamples "fancy" only from IDCT blocks larger than one sample)
    and, for 3 components, taken as RGB: under a JFIF marker or an Adobe
    transform other than 0 they are YCbCr, which libjpeg-turbo does not
    convert in a lossless frame (OpenCV gives None, Pillow raises); 4
    are CMYK (YCCK under an Adobe transform other than 0: refused)."""
    hmax, vmax, _, _ = _sampling(f)
    planes = []
    for ci, c in enumerate(f.comps):
        if f.samples[ci] is None:
            raise DecodeError("JPEG: a component no scan decoded")
        p = np.repeat(np.repeat(f.samples[ci], vmax // c['v'], axis=0),
                      hmax // c['h'], axis=1)
        planes.append(p[:f.height, :f.width])
    space = _space(f, mode)
    if space in ('ycc', 'ycck'):
        raise no_pixels("lossless YCbCr")
    if space == 'grey':
        return planes[0].astype(np.uint8)
    if space in ('rgb', 'raw'):
        return np.stack(planes, axis=-1).astype(np.uint8)
    return cmyk_to_rgb(*planes)


def _output(f: _Frame, mode: str = 'cv2') -> np.ndarray:
    if f.lossless:
        return _lossless_output(f, mode)
    hmax, vmax, _, mcuy = _sampling(f)
    smooth = _smoothed(f)
    planes = []
    for ci, c in enumerate(f.comps):
        if c['tq'] not in f.quant:
            raise DecodeError("JPEG: component uses an undefined table")
        rows, cols = f.grid[ci]
        # JCOEF is 16-bit, as in libjpeg
        grid = np.array(f.coef[ci], np.int64).astype(np.int16).astype(
            np.int64).reshape(rows, cols, 64)
        dh = -(-f.height * c['v'] // vmax)
        dw = -(-f.width * c['h'] // hmax)
        hib, wib = -(-dh // 8), -(-dw // 8)
        coef = grid[:hib, :wib]
        if smooth:
            coef = smooth_blocks(coef, grid[:, :, 0], f.quant[c['tq']],
                                 f.coef_bits[ci],
                                 smooth_rows(hib, c['v'], mcuy))
        px = idct_islow(coef.reshape(-1, 64), f.quant[c['tq']])
        plane = px.reshape(hib, wib, 8, 8).transpose(0, 2, 1, 3).reshape(
            hib * 8, wib * 8)
        up = _upsample(plane[:dh, :dw], hmax // c['h'], vmax // c['v'])
        planes.append(up[:f.height, :f.width])
    space = _space(f, mode)
    if space == 'grey':
        return planes[0].astype(np.uint8)
    if space in ('rgb', 'raw'):
        return np.stack(planes, axis=-1).astype(np.uint8)
    if space == 'ycc':
        return ycc_to_rgb(*planes)
    if space == 'ycck':
        # jdcolor.c::ycck_cmyk_convert: C, M, Y = 255 - the YCbCr's RGB
        rgb = ycc_to_rgb(*planes[:3], clamp=False)
        planes[:3] = [np.clip(255 - rgb[..., k], 0, 255) for k in range(3)]
    return cmyk_to_rgb(*planes)
