"""General TIFF reader for the tiles the fast path declines.

``io/fast_tiff.py`` maps uncompressed strip TIFFs straight into memory;
everything else it returns None for comes here. The JAX package decodes
such a file with OpenCV (libtiff), and where OpenCV returns None with
imageio's tifffile; this reader gives the array the JAX package's
``read_image`` gives, by the reader that file reaches there (``_route``).
It takes the first IFD only (``cv2.imread`` reads page 0) of a classic or
BigTIFF file in either byte order (``II``, ``MM``), in strips (any
RowsPerStrip, a short last strip) or tiles (edge tiles cropped), with:

- compression 1 (none), 5 (LZW, new- and old-style), 8 and 32946
  (deflate), 32773 (PackBits), 2, 3 and 4 (CCITT Modified Huffman, T.4
  with any T4Options, T.6) and 34925 (LZMA, through the standard
  library's ``lzma``, as imageio reads it); FillOrder 2 (the stored bytes
  bit-reversed before the codec, as libtiff and imageio do);
- compression 7 (JPEG, 8-bit) in strips or tiles through the port's
  JPEG codec, JPEGTables spliced into abbreviated segments, with the
  colour handling libtiff gives each Photometric: YCbCr (every
  YCbCrSubSampling libtiff's RGBA reader takes, the JPEG's sampling
  agreeing) converted by libjpeg, grey, MinIsWhite (inverted), RGB and
  CMYK (libtiff's conversion) as the components are; old-style JPEG
  (6) and JPEG of other than 8 bits give no pixels in the JAX package
  (imageio's tifffile cannot decompress them) and raise ``DecodeError``;
- Predictor 1, 2 (horizontal, undone per sample after the bytes are
  swapped to native order, as libtiff does) or 3 (floating point,
  libtiff's fpAcc, whose output is in native order already); libtiff
  applies them to LZW and deflate only, imageio after any codec;
- OpenCV's own path: 8- to 64-bit samples, unsigned, signed
  (SampleFormat 2) or floating point (SampleFormat 3: 16, 32 or 64 bits;
  Predictor 3 takes no other) for 1 sample (MinIsBlack, or MinIsWhite
  above 8 bits, not inverted) or 3 / 4 samples (RGB, RGB + alpha), and
  10-, 12- and 14-bit samples unpacked and shifted to the top of 16 bits;
  PlanarConfiguration 1 (contiguous), or 2 (one plane per sample) for
  8-bit samples;
- OpenCV through libtiff's RGBA interface (``io/tiff_rgba.py``): 8-bit
  MinIsWhite (inverted), 1-bit bilevel (0 / 255), 1-, 4- and 8-bit
  palettes (RGB from the ColorMap, grey for 1 bit), 8-bit CMYK (InkSet
  1), 8-bit YCbCr with YCbCrSubSampling 1x1 to 4x4, and grey + alpha (its
  grey; 16-bit samples by their high byte);
- imageio's raw samples where OpenCV returns None: 2- and 4-bit grey and
  2-bit palettes (the indices), 16-bit palettes and CMYK, 3-sample CMYK,
  CMYK of another InkSet, 5 samples or more, LZMA, and float16 (which
  OpenCV does not read: Predictor 3 undone after every codec in strips;
  Predictor 2, which imageio sums as floats, Predictor 3 in tiles and 4
  samples raise).

It returns (H, W) or (H, W, channels), samples in the file's order (R, G,
B[, A]), in native byte order. An 8-bit RGBA image whose alpha is
declared unassociated (ExtraSamples 2) comes back premultiplied,
``(v * alpha + 127) // 255``, as OpenCV reads it through libtiff's RGBA
interface. A layout whose JAX array is not its pixels (16-bit and 10- to
14-bit PlanarConfiguration 2 with several samples, which OpenCV reads as
if interleaved; imageio's plane-first arrays; grey + alpha tiles
overhanging the right edge, whose rows libtiff misplaces; FillOrder 2 in
uncompressed tiles) or that this reader does not take raises
:class:`NotImplementedError` naming the ROADMAP item (item 6); a file
that does not hold what its tags
declare raises :class:`~image_stitcher_tpu_torch.io.tile_decode.DecodeError`.
LZW, PackBits, the predictors, the bit reversal, the unpacking and CCITT
run in C (``io/tile_decode.py``), deflate through the stdlib's zlib.

:func:`read_pages` reads back the port's own OME-TIFF output: every page
of a tiled BigTIFF with its SubIFD pyramid levels, raw, deflate or JPEG
tiles (Compression 7, each tile a whole JFIF stream, decoded as above).
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

import numpy as np

from . import jpeg, jpeg_plain, tiff_rgba, tile_decode
from .fast_tiff import _read_values
from .tile_decode import DecodeError

# tag ids
_WIDTH, _LENGTH, _BITS, _COMP, _PHOTO, _FILL = 256, 257, 258, 259, 262, 266
_STRIP_OFFSETS, _SPP, _ROWS_PER_STRIP, _STRIP_COUNTS = 273, 277, 278, 279
_PLANAR, _PREDICTOR = 284, 317
_TILE_W, _TILE_H, _TILE_OFFSETS, _TILE_COUNTS = 322, 323, 324, 325
_EXTRA_SAMPLES, _SAMPLE_FORMAT = 338, 339
_T4_OPTIONS, _COLORMAP, _INK_SET = 292, 320, 332
_YCBCR_COEFFICIENTS, _YCBCR_SUBSAMPLING, _REFERENCE = 529, 530, 532
_JPEG_TABLES = 347
_TAGS = (_WIDTH, _LENGTH, _BITS, _COMP, _PHOTO, _FILL, _STRIP_OFFSETS, _SPP,
         _ROWS_PER_STRIP, _STRIP_COUNTS, _PLANAR, _PREDICTOR, _TILE_W,
         _TILE_H, _TILE_OFFSETS, _TILE_COUNTS, _EXTRA_SAMPLES,
         _SAMPLE_FORMAT, _T4_OPTIONS, _COLORMAP, _INK_SET,
         _YCBCR_COEFFICIENTS, _YCBCR_SUBSAMPLING, _REFERENCE, _JPEG_TABLES)
_RATIONAL, _UNDEFINED = 5, 7

_DEFLATE = (8, 32946)
_CCITT = (2, 3, 4)
_LZMA = 34925
_CODECS = (1, 5, 32773) + _DEFLATE + _CCITT + (_LZMA,)
#: the codecs libtiff runs the Predictor tag with
_PREDICTED = (5,) + _DEFLATE
_UNASSOCIATED_ALPHA = 2
#: PhotometricInterpretation
_MIN_IS_WHITE, _MIN_IS_BLACK, _RGB, _PALETTE, _SEPARATED, _YCBCR = (0, 1, 2,
                                                                    3, 5, 6)
#: the YCbCrSubSampling libtiff's RGBA reader has a routine for
_SUBSAMPLINGS = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))


def _not_ported(what: str, item: str = "item 6, 'tile input without "
                "OpenCV'") -> NotImplementedError:
    return NotImplementedError(
        f"TIFF tiles with {what} are not ported to image_stitcher_tpu_torch "
        f"yet (ROADMAP.md, {item})")


def read_ifd(data) -> Tuple[str, Dict[int, tuple]]:
    """The byte order ('<' or '>') and the tags of the first IFD that
    this reader uses, {tag: values}."""
    mv = memoryview(data)
    if len(mv) < 16 or bytes(mv[:2]) not in (b'II', b'MM'):
        raise DecodeError("not a TIFF file")
    bo = '<' if bytes(mv[:2]) == b'II' else '>'
    version = struct.unpack_from(bo + 'H', mv, 2)[0]
    if version == 42:
        ifd = struct.unpack_from(bo + 'I', mv, 4)[0]
        head, size, inline, cfmt = 2, 12, 4, 'I'
    elif version == 43:
        ifd = struct.unpack_from(bo + 'Q', mv, 8)[0]
        head, size, inline, cfmt = 8, 20, 8, 'Q'
    else:
        raise DecodeError(f"TIFF version {version}")
    try:
        n = struct.unpack_from(bo + ('H' if head == 2 else 'Q'), mv, ifd)[0]
        tags = {}
        for i in range(n):
            off = ifd + head + i * size
            tag, ty = struct.unpack_from(bo + 'HH', mv, off)
            if tag not in _TAGS:
                continue
            count = struct.unpack_from(bo + cfmt, mv, off + 4)[0]
            if ty == _RATIONAL:
                vals = _rationals(mv, bo, count, off + size - inline, inline)
            elif ty == _UNDEFINED:
                vals = _read_values(mv, bo, 1, count,
                                    mv[off + size - inline:off + size],
                                    inline)
            else:
                vals = _read_values(mv, bo, ty, count,
                                    mv[off + size - inline:off + size],
                                    inline)
            if vals is None or len(vals) != count:
                raise DecodeError(f"TIFF tag {tag}: type {ty}")
            tags[tag] = vals
    except struct.error as e:
        raise DecodeError(f"truncated TIFF directory: {e}") from None
    return bo, tags


def _rationals(mv, bo: str, count: int, field: int, inline: int) -> tuple:
    """RATIONAL values as libtiff reads them into floats: the numerator
    over the denominator in 32-bit floats (0 for a 0 denominator)."""
    where = field if 8 * count <= inline else struct.unpack_from(
        bo + ('Q' if inline == 8 else 'I'), mv, field)[0]
    pairs = np.frombuffer(mv, bo + 'u4', 2 * count, where).astype(np.float32)
    num, den = pairs[0::2], pairs[1::2]
    return tuple(float(n / d) if d else 0.0 for n, d in zip(num, den))


def _lzma_decompress(raw, off: int) -> bytes:
    try:
        import lzma
    except ImportError:
        raise ImportError("LZMA TIFF tiles (compression 34925) need the "
                          "Python standard library's lzma module, which "
                          "this Python lacks") from None
    try:
        return lzma.decompress(bytes(raw))
    except lzma.LZMAError as e:
        raise DecodeError(f"TIFF LZMA segment at {off}: {e}") from None


def _segment(data, comp: int, off: int, count: int, size: int,
             plain: bool = False, rows: int = 0, cols: int = 0,
             reverse: bool = False, options: int = 0):
    """One strip or tile decoded to exactly ``size`` bytes (``plain``:
    by the plain versions of the C decoders); ``reverse``: its stored
    bytes bit-reversed first (FillOrder 2); CCITT segments are ``rows``
    rows of ``cols`` pixels, ``options`` their T4Options."""
    raw = data[off:off + count]
    if len(raw) != count:
        raise DecodeError(f"TIFF segment at {off} runs past the file's end")
    if reverse:
        raw = (tile_decode.reverse_bits_plain if plain
               else tile_decode.reverse_bits)(raw)
    if comp == 1:
        out = raw
    elif comp in _CCITT:
        out = (tile_decode.ccitt_decode_plain if plain
               else tile_decode.ccitt_decode)(raw, rows, cols, comp,
                                              options).reshape(-1)
    elif comp == _LZMA:
        out = _lzma_decompress(raw, off)
    elif comp == 5:
        out = (tile_decode.lzw_decode_plain if plain
               else tile_decode.lzw_decode)(raw, size)
    elif comp == 32773:
        out = (tile_decode.packbits_decode_plain if plain
               else tile_decode.packbits_decode)(raw, size)
    else:
        try:
            out = zlib.decompress(raw)
        except zlib.error as e:
            raise DecodeError(f"TIFF deflate segment at {off}: {e}") from None
    if len(out) < size:
        raise DecodeError(f"TIFF segment at {off} holds {len(out)} bytes, "
                          f"its rows need {size}")
    return out


_BIGTIFF_TYPES = {2: (1, 's'), 3: (2, 'H'), 4: (4, 'I'), 16: (8, 'Q'),
                  18: (8, 'Q')}


def _bigtiff_ifd(mv, off: int) -> Tuple[Dict[int, tuple], int]:
    """The tags of the little-endian BigTIFF IFD at ``off`` ({tag:
    values}, ASCII as one str) and the next IFD's offset."""
    n = struct.unpack_from('<Q', mv, off)[0]
    tags = {}
    for i in range(n):
        entry = off + 8 + 20 * i
        tag, ty, count = struct.unpack_from('<HHQ', mv, entry)
        if ty not in _BIGTIFF_TYPES:
            raise DecodeError(f"TIFF tag {tag}: type {ty}")
        size, fmt = _BIGTIFF_TYPES[ty]
        where = (entry + 12 if size * count <= 8
                 else struct.unpack_from('<Q', mv, entry + 12)[0])
        raw = bytes(mv[where:where + size * count])
        tags[tag] = ((raw.rstrip(b'\0').decode('utf-8'),) if ty == 2
                     else struct.unpack(f'<{count}{fmt}', raw))
    return tags, struct.unpack_from('<Q', mv, off + 8 + 20 * n)[0]


def _no_pixels(what: str) -> DecodeError:
    return DecodeError(
        f"TIFF {what}: neither OpenCV's libtiff nor imageio's tifffile "
        "decodes it, so the JAX package's read_image gives no pixels for "
        "it either")


def _jpeg_mode(photo: int, spp: int, sub) -> str:
    """The colour handling libtiff gives a JPEG segment (``tif_jpeg.c``):
    YCbCr (Photometric 6) converted to RGB by libjpeg (the RGBA reader
    sets JPEGCOLORMODE_RGB); the components of grey (0, 1), RGB (2) and
    CMYK (5) as they are (JCS_UNKNOWN), for the RGBA reader to convert.
    Other layouts raise."""
    if photo in (_MIN_IS_WHITE, _MIN_IS_BLACK) and spp == 1:
        return 'raw'
    if (photo, spp) in ((_RGB, 3), (_SEPARATED, 4)):
        return 'raw'
    if photo == _YCBCR and spp == 3 and tuple(sub) in _SUBSAMPLINGS:
        return 'ycc'
    raise DecodeError(f"TIFF JPEG compression with photometric {photo}, "
                      f"{spp} samples a pixel")


def _sof_sampling(raw: bytes) -> list:
    """The (h, v) sampling factors of a JPEG stream's components, from
    its frame header; [] without one."""
    pos = 2
    while pos + 4 <= len(raw) and raw[pos] == 0xFF:
        marker = raw[pos + 1]
        length = struct.unpack_from('>H', raw, pos + 2)[0]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            body = raw[pos + 4:pos + 2 + length]
            return [(b >> 4, b & 15) for b in body[7::3][:body[5]]] \
                if len(body) >= 6 else []
        pos += 2 + length
    return []


def _jpeg_segment(raw, tables: bytes, mode: str, spp: int, sub, rows: int,
                  cols: int, plain: bool = False) -> np.ndarray:
    """One JPEG-in-TIFF strip or tile: (rows, cols, spp) uint8. An
    abbreviated stream takes the JPEGTables spliced in after its SOI. The
    JPEG's sampling must be what libtiff expects (YCbCr: the luma's
    YCbCrSubSampling and chroma 1x1; otherwise all 1x1, as libtiff's raw
    path would hand over downsampled planes); a stream smaller than its
    segment fails (libtiff errors), a larger one is cropped."""
    raw = bytes(raw)
    if tables and raw[:2] == b'\xff\xd8' and tables[:2] == b'\xff\xd8':
        raw = raw[:2] + tables[2:-2] + raw[2:]
    want = [tuple(sub)] + [(1, 1)] * (spp - 1) if mode == 'ycc' else \
        [(1, 1)] * spp
    got = _sof_sampling(raw)
    if got != want:
        raise DecodeError(f"JPEG-in-TIFF segment of sampling {got}, the "
                          f"TIFF says {want}")
    px = (jpeg_plain if plain else jpeg).decode(raw, mode)
    if px.shape[0] < rows or px.shape[1] < cols:
        raise DecodeError(f"JPEG-in-TIFF segment of {px.shape[:2]}, the "
                          f"TIFF needs {rows}x{cols}")
    return px[:rows, :cols].reshape(rows, cols, spp)


def _jpeg_tiff(mv, tags, plain: bool) -> np.ndarray:
    """A JPEG-in-TIFF image (Compression 7) in strips or tiles, as
    OpenCV reads it: each segment through libjpeg in the colour handling
    of :func:`_jpeg_mode`, then MinIsWhite inverted and CMYK converted by
    libtiff's RGBA reader (``io/tiff_rgba.py``). Old-style JPEG (6) and
    JPEG of other than 8 bits give no pixels in the JAX package: OpenCV's
    libtiff lacks them and imageio's tifffile cannot decompress them."""
    def tag(t, default):
        return tags[t][0] if t in tags else default

    w, h = tags[_WIDTH][0], tags[_LENGTH][0]
    spp = tag(_SPP, 1)
    photo = tag(_PHOTO, _MIN_IS_BLACK if spp == 1 else _RGB)
    bits = set(tags.get(_BITS, (8,)))
    sub = tags.get(_YCBCR_SUBSAMPLING, (2, 2))
    if tag(_COMP, 7) == 6:
        raise _no_pixels("old-style JPEG (Compression 6)")
    if bits != {8}:
        raise _no_pixels(f"{sorted(bits)}-bit JPEG")
    if tag(_PLANAR, 1) != 1:
        raise DecodeError("TIFF JPEG compression in PlanarConfiguration 2")
    mode = _jpeg_mode(photo, spp, sub)
    tables = bytes(tags.get(_JPEG_TABLES, ()))
    out = np.empty((h, w, spp), np.uint8)
    if _TILE_OFFSETS in tags:
        tw, tl = tag(_TILE_W, 0), tag(_TILE_H, 0)
        if tw < 1 or tl < 1:
            raise DecodeError("TIFF tiles without TileWidth/TileLength")
        places = [(y, x, tl, tw) for y in range(0, h, tl)
                  for x in range(0, w, tw)]
        offsets, counts = tags[_TILE_OFFSETS], tags.get(_TILE_COUNTS)
    else:
        rps = min(tag(_ROWS_PER_STRIP, h) or h, h)
        places = [(y, 0, min(rps, h - y), w) for y in range(0, h, rps)]
        offsets, counts = tags.get(_STRIP_OFFSETS), tags.get(_STRIP_COUNTS)
    if (offsets is None or counts is None or len(offsets) < len(places)
            or len(counts) < len(places)):
        raise DecodeError(f"TIFF lists too few JPEG segments for "
                          f"{len(places)}")
    for (y, x, rows, cols), off, n in zip(places, offsets, counts):
        raw = mv[off:off + n]
        if len(raw) != n:
            raise DecodeError(f"TIFF segment at {off} runs past the file's "
                              "end")
        seg = _jpeg_segment(raw, tables, mode, spp, sub, rows, cols, plain)
        keep = seg[:min(rows, h - y), :min(cols, w - x)]
        out[y:y + keep.shape[0], x:x + keep.shape[1]] = keep
    if photo == _MIN_IS_WHITE:
        return tiff_rgba.grey(out[..., 0], 8, True)
    if photo == _SEPARATED:
        return tiff_rgba.cmyk(out)
    return out[..., 0] if spp == 1 else out


def _tiled_image(mv, tags: Dict[int, tuple], pool) -> np.ndarray:
    w, h = tags[_WIDTH][0], tags[_LENGTH][0]
    spp = tags.get(_SPP, (1,))[0]
    comp = tags[_COMP][0]
    if comp not in (1, 7) + _DEFLATE:
        raise _not_ported(f"compression {comp}")
    kind = {1: 'u', 2: 'i', 3: 'f'}[tags.get(_SAMPLE_FORMAT, (1,))[0]]
    dtype = np.dtype(f'<{kind}{tags[_BITS][0] // 8}')
    tw, tl = tags[_TILE_W][0], tags[_TILE_H][0]
    across = -(-w // tw)
    out = np.zeros((-(-h // tl) * tl, across * tw, spp), dtype)
    n = tl * tw * spp
    if comp == 7:
        # JPEG tiles (the port's own: grey, or 4:2:0 YCbCr whole JFIF
        # streams), as libtiff decodes them
        if dtype.itemsize != 1:
            raise _no_pixels(f"{8 * dtype.itemsize}-bit JPEG")
        sub = tags.get(_YCBCR_SUBSAMPLING, (2, 2))
        mode = _jpeg_mode(tags.get(_PHOTO, (1,))[0], spp, sub)
        tables = bytes(tags.get(_JPEG_TABLES, ()))

        def unpack(oc):
            return _jpeg_segment(mv[oc[0]:oc[0] + oc[1]], tables, mode, spp,
                                 sub, tl, tw).tobytes()
    else:
        def unpack(oc):
            return _segment(mv, comp, oc[0], oc[1], n * dtype.itemsize)
    segments = pool.map(unpack, zip(tags[_TILE_OFFSETS],
                                    tags[_TILE_COUNTS]))
    for i, seg in enumerate(segments):
        ty, tx = divmod(i, across)
        out[ty * tl:(ty + 1) * tl, tx * tw:(tx + 1) * tw] = np.frombuffer(
            seg, dtype, count=n).reshape(tl, tw, spp)
    out = out[:h, :w]
    return out[..., 0] if spp == 1 else out


def read_pages(data):
    """Every page of a tiled little-endian BigTIFF, as the port's
    ``io/tiffwriter.py`` writes them (deflate, JPEG or raw tiles, one or
    three samples, of the sample type SampleFormat and BitsPerSample
    give): [(ImageDescription or None, [page, SubIFD level 1, ...]),
    ...] along the top-level IFD chain, the thumbnail page last. Tiles
    decode on a thread pool (zlib and the JPEG codec release the
    interpreter lock)."""
    mv = memoryview(data)
    if bytes(mv[:4]) != b'II+\x00':
        raise DecodeError("not a little-endian BigTIFF")
    off = struct.unpack_from('<Q', mv, 8)[0]
    pages = []
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        while off:
            tags, off = _bigtiff_ifd(mv, off)
            levels = [_tiled_image(mv, tags, pool)]
            for sub in tags.get(330, ()):
                levels.append(_tiled_image(mv, _bigtiff_ifd(mv, sub)[0],
                                           pool))
            pages.append((tags.get(270, (None,))[0], levels))
    return pages


def _route(tags, comp: int, bits: int, kind: str, photo: int, spp: int,
           planar: int, predictor: int, fill: int) -> str:
    """Which of the JAX package's readers gives this file's pixels, as
    this reader reproduces it: 'direct' (OpenCV's own sample path),
    'rgba' (OpenCV through libtiff's RGBA interface, ``io/tiff_rgba.py``)
    or 'imageio' (OpenCV returns None; imageio's tifffile gives the raw
    samples). A layout whose JAX array is not its pixels, or that this
    reader does not take, raises :class:`NotImplementedError`."""
    tiled = _TILE_OFFSETS in tags
    where = f"{bits}-bit {kind} samples, {spp} a pixel, photometric {photo}"

    def refuse(why=""):
        return _not_ported(f"{where}{why}")

    if planar not in (1, 2) or predictor not in (1, 2, 3):
        raise _not_ported(f"PlanarConfiguration {planar}, Predictor "
                          f"{predictor}")
    if predictor == 3 and kind != 'f':
        raise DecodeError("TIFF Predictor 3 (floating point) on integer "
                          "samples")
    if fill == 2 and comp == 1 and tiled:
        # OpenCV reads some such files and imageio others (raw samples)
        raise refuse(", FillOrder 2 in uncompressed tiles")
    imageio = comp == _LZMA or spp >= 5
    if bits < 8 or bits in (10, 12, 14):
        if kind != 'u' or predictor != 1 or (planar == 2 and spp > 1):
            raise refuse(f", Predictor {predictor}, PlanarConfiguration "
                         f"{planar}")
        if comp in _CCITT and (bits != 1 or spp != 1):
            raise refuse(f" in CCITT compression {comp}")
        if imageio:      # a bool array, or imageio raises
            raise refuse(f" in compression {comp}")
        if bits in (10, 12, 14):
            if photo in (_MIN_IS_WHITE, _MIN_IS_BLACK, _RGB) and spp in (
                    1, 3, 4):
                return 'direct'
            raise refuse()
        if spp == 1 and (bits == 1 and photo in (_MIN_IS_WHITE,
                                                 _MIN_IS_BLACK, _PALETTE)
                         or bits == 4 and photo == _PALETTE):
            return 'rgba'
        if bits in (2, 4) and photo in (_MIN_IS_WHITE, _MIN_IS_BLACK,
                                        _RGB, _PALETTE):
            return 'imageio'      # OpenCV refuses the header
        raise refuse()
    if comp in _CCITT:
        raise refuse(f" in CCITT compression {comp}")
    if bits not in (8, 16, 32, 64) or (kind == 'f' and bits < 16):
        raise refuse()
    half = kind == 'f' and bits == 16
    if half and (spp not in (1, 3) or predictor == 2
                 or (predictor == 3 and tiled)):
        # the JAX package reads float16 through imageio's tifffile, which
        # sums Predictor 2's differences as floats, has no Predictor 3 for
        # tiles and keeps an alpha sample: none of them gives the pixels
        raise _not_ported(f"float16 samples, {spp} a pixel, Predictor "
                          f"{predictor}, in "
                          f"{'tiles' if tiled else 'strips'}")
    if planar == 2 and bits > 8 and spp > 1:
        # OpenCV 5.0 reads such planes as if they were interleaved;
        # imageio gives the planes first: neither is the pixels
        raise refuse(f", PlanarConfiguration {planar}")
    if imageio or half:
        if planar == 2 and spp > 1:
            raise refuse(", PlanarConfiguration 2 (imageio gives the "
                         "planes first)")
        if predictor == 3 and tiled:
            raise refuse(", Predictor 3 in tiles (imageio raises)")
        if photo == _YCBCR and tags.get(_YCBCR_SUBSAMPLING) != (1, 1):
            raise refuse(", subsampled")
        return 'imageio'
    sub = tags.get(_YCBCR_SUBSAMPLING, (2, 2))
    if spp == 2 and tiled and tags[_WIDTH][0] % tags.get(_TILE_W, (1,))[0]:
        # libtiff's grey + alpha routines misplace the rows of a tile that
        # overhangs the right edge: the JAX array is not the pixels there
        raise refuse(", in tiles overhanging the right edge")
    if bits == 8 and kind in 'ui':
        if photo in (_MIN_IS_WHITE, _MIN_IS_BLACK) and spp in (1, 2):
            return 'rgba'
        if photo == _RGB and spp in (3, 4):
            return 'direct'
        if kind == 'u' and photo == _PALETTE and spp == 1:
            return 'rgba'
        if kind == 'u' and photo == _SEPARATED and spp in (3, 4):
            return ('rgba' if spp == 4 and tags.get(_INK_SET, (1,))[0] == 1
                    else 'imageio')
        if kind == 'u' and photo == _YCBCR and spp == 3 and planar == 1 \
                and sub in _SUBSAMPLINGS \
                and (predictor == 1 or sub == (1, 1)):
            return 'rgba'
        raise refuse()
    if bits == 16 and kind in 'ui':
        if photo in (_MIN_IS_WHITE, _MIN_IS_BLACK) and spp == 2 \
                and kind == 'u':
            return 'rgba'
        if kind == 'u' and (photo == _PALETTE and spp == 1
                            or photo == _SEPARATED and spp == 4
                            or photo == _YCBCR and spp == 3 and tags.get(
                                _YCBCR_SUBSAMPLING) == (1, 1)):
            return 'imageio'
    if (photo, spp) in ((_MIN_IS_WHITE, 1), (_MIN_IS_BLACK, 1), (_RGB, 3),
                        (_RGB, 4)):
        return 'direct'
    raise refuse()


def decode_tiff(data, plain: bool = False) -> np.ndarray:
    """Decode the first image of a TIFF file (bytes-like); ``plain`` runs
    the plain versions of the C decoders (LZW, PackBits, the predictors,
    bit reversal, unpacking, CCITT), which the tests and
    ``chip_smoke.py`` hold the C ones to."""
    return decode(data, plain)[0]


def decode(data, plain: bool = False) -> Tuple[np.ndarray, bool]:
    """:func:`decode_tiff`, and whether the JAX package's array for the
    file comes from imageio, which keeps every sample (its ``read_image``
    drops a fourth sample only from OpenCV's)."""
    mv = memoryview(data)
    bo, tags = read_ifd(mv)

    def tag(t, default):
        return tags[t][0] if t in tags else default

    if _WIDTH not in tags or _LENGTH not in tags:
        raise DecodeError("TIFF without ImageWidth/ImageLength")
    w, h = tags[_WIDTH][0], tags[_LENGTH][0]
    if w < 1 or h < 1:
        raise DecodeError(f"TIFF of {w} x {h} pixels")
    spp = tag(_SPP, 1)
    comp = tag(_COMP, 1)
    bitset = set(tags.get(_BITS, (1,)))
    if comp in (6, 7):
        return _jpeg_tiff(mv, tags, plain), False
    if comp not in _CODECS:
        raise _not_ported(f"compression {comp}")
    if len(bitset) != 1 or not 1 <= next(iter(bitset)) <= 64:
        raise _not_ported(f"{sorted(bitset)}-bit samples")
    bits = next(iter(bitset))
    formats = sorted(set(tags.get(_SAMPLE_FORMAT, (1,))))
    kind = ({1: 'u', 2: 'i', 3: 'f'}.get(formats[0]) if len(formats) == 1
            else None)
    if kind is None:
        raise _not_ported(f"SampleFormat {formats} with {bits}-bit samples")
    photo = tag(_PHOTO, _MIN_IS_BLACK if spp == 1 else _RGB)
    fill = tag(_FILL, 1)
    planar = tag(_PLANAR, 1)
    predictor = tag(_PREDICTOR, 1)
    route = _route(tags, comp, bits, kind, photo, spp, planar, predictor,
                   fill)
    bytewise = bits in (8, 16, 32, 64)
    itemsize = bits // 8 if bytewise else 1
    sspp = spp if planar == 1 else 1     # samples a pixel in a segment
    planes = 1 if planar == 1 else spp
    sub = tags.get(_YCBCR_SUBSAMPLING, (2, 2))
    units = route == 'rgba' and photo == _YCBCR and sub != (1, 1)

    if _TILE_OFFSETS in tags:
        tw, tl = tag(_TILE_W, 0), tag(_TILE_H, 0)
        if tw < 1 or tl < 1:
            raise DecodeError("TIFF tiles without TileWidth/TileLength")
        across, down = -(-w // tw), -(-h // tl)
        offsets, counts = tags[_TILE_OFFSETS], tags.get(_TILE_COUNTS)
        seg_rows = [tl] * (across * down)
        seg_cols = tw
    else:
        rps = min(tag(_ROWS_PER_STRIP, h) or h, h)
        strips = -(-h // rps)
        offsets, counts = tags.get(_STRIP_OFFSETS), tags.get(_STRIP_COUNTS)
        if offsets is None:
            raise DecodeError("TIFF without StripOffsets")
        seg_rows = [min(rps, h - s * rps) for s in range(strips)]
        seg_cols = w
    nseg = planes * len(seg_rows)
    row_bytes = (seg_cols * sspp * bits + 7) // 8
    if units:
        sh, sv = sub
        sizes = [-(-r // sv) * -(-seg_cols // sh) * (sh * sv + 2)
                 for r in seg_rows]
    else:
        sizes = [r * row_bytes for r in seg_rows] * planes
    if counts is None and comp == 1:
        counts = sizes
    if counts is None or len(offsets) < nseg or len(counts) < nseg:
        raise DecodeError(f"TIFF lists {len(offsets)} segments, the image "
                          f"needs {nseg}")
    buf = np.empty(sum(sizes), np.uint8)
    pos = 0
    for off, count, size, rows in zip(offsets, counts, sizes,
                                      seg_rows * planes):
        seg = _segment(mv, comp, off, count, size, plain, rows, seg_cols,
                       fill == 2, tag(_T4_OPTIONS, 0))
        buf[pos:pos + size] = np.frombuffer(seg, np.uint8, count=size)
        pos += size

    if units:
        # YCbCr data units: (Y, Cb, Cr) planes of each segment
        samples = np.concatenate([
            tiff_rgba.ycbcr_planes(buf[a:a + n], r, seg_cols, sub).reshape(
                r, seg_cols * 3)
            for a, n, r in zip(np.cumsum([0] + sizes[:-1]), sizes,
                               seg_rows)])
    elif not bytewise:
        samples = (tile_decode.unpack_samples_plain if plain
                   else tile_decode.unpack_samples)(
            buf, len(buf) // row_bytes, row_bytes, seg_cols * sspp, bits)
    else:
        # imageio undoes the predictor after any codec, libtiff after LZW
        # and deflate only
        predicted = (predictor if comp in _PREDICTED or route == 'imageio'
                     else 1)
        if predicted == 3:
            (tile_decode.undo_fp_predictor_plain if plain
             else tile_decode.undo_fp_predictor)(buf.reshape(-1, row_bytes),
                                                 sspp, itemsize)
        samples = buf.view(np.dtype(f'=u{itemsize}'))
        if bo == '>' and itemsize > 1 and predicted != 3:
            samples.byteswap(inplace=True)
        if predicted == 2:
            (tile_decode.undo_predictor_plain if plain
             else tile_decode.undo_predictor)(
                samples.reshape(-1, seg_cols * sspp), sspp)
        samples = samples.view(np.dtype(f'={kind}{itemsize}'))

    if _TILE_OFFSETS in tags:
        grid = samples.reshape(planes, down, across, tl, tw, sspp)
        img = grid.transpose(0, 1, 3, 2, 4, 5).reshape(
            planes, down * tl, across * tw, sspp)[:, :h, :w]
    else:
        img = samples.reshape(planes, h, w, sspp)
    img = img[0] if planes == 1 else np.moveaxis(img[..., 0], 0, -1)
    img = np.ascontiguousarray(img)
    if route == 'rgba':
        img = _rgba(img, tags, bits, photo)
    elif route == 'direct' and bits in (10, 12, 14):
        img <<= 16 - bits           # OpenCV scales them to 16 bits
    elif (route == 'direct' and spp == 4 and itemsize == 1
          and tag(_EXTRA_SAMPLES, 0) == _UNASSOCIATED_ALPHA):
        alpha = img[:, :, 3:].astype(np.uint32)
        img[:, :, :3] = (img[:, :, :3] * alpha + 127) // 255
    return (img[:, :, 0] if img.ndim == 3 and img.shape[2] == 1
            else img), route == 'imageio'


def _rgba(img: np.ndarray, tags, bits: int, photo: int) -> np.ndarray:
    """What OpenCV keeps of libtiff's RGBA pixels: grey for MinIsBlack /
    MinIsWhite (of a sample and its alpha) and for 1-bit palette indices,
    RGB for palettes of 4 and 8 bits, CMYK and YCbCr."""
    if photo in (_MIN_IS_WHITE, _MIN_IS_BLACK):
        # int8 samples map as their bits, and stay int8
        first = img[:, :, 0]
        out = tiff_rgba.grey(first.view(f'=u{first.itemsize}'), bits,
                             photo == _MIN_IS_WHITE)
        return out.view(img.dtype) if bits == 8 else out
    if photo == _PALETTE:
        cmap = np.asarray(tags.get(_COLORMAP, ()), np.uint16)
        if cmap.size != 3 << bits:
            raise DecodeError(f"TIFF palette of {cmap.size} entries for "
                              f"{bits}-bit indices")
        rgb = tiff_rgba.palette(img[:, :, 0], cmap.reshape(3, -1))
        return tiff_rgba.to_grey(rgb) if bits == 1 else rgb
    if photo == _SEPARATED:
        return tiff_rgba.cmyk(img)
    return tiff_rgba.ycbcr(img, tiff_rgba.ycbcr_tables(
        tags.get(_YCBCR_COEFFICIENTS, tiff_rgba.DEFAULT_COEFFICIENTS),
        tags.get(_REFERENCE, tiff_rgba.DEFAULT_REFERENCE)))
