"""General TIFF reader for the tiles the fast path declines.

``io/fast_tiff.py`` maps uncompressed strip TIFFs straight into memory;
everything else it returns None for comes here, where the JAX package
decodes it with OpenCV (libtiff). This reader takes the first IFD only
(``cv2.imread`` reads page 0) of a classic or BigTIFF file in either
byte order (``II``, ``MM``), in strips (any RowsPerStrip, a short last
strip) or tiles (edge tiles cropped), with:

- compression 1 (none), 5 (LZW), 8 and 32946 (deflate), 32773 (PackBits);
- Predictor 1, 2 (horizontal, undone per sample after the bytes are
  swapped to native order, as libtiff does) or 3 (floating point,
  libtiff's fpAcc, whose output is in native order already); libtiff
  applies them to LZW and deflate only, and so does this reader;
- 8-, 16-, 32- or 64-bit samples, unsigned, signed (SampleFormat 2) or
  floating point (SampleFormat 3: 16, 32 or 64 bits; Predictor 3 takes
  no other); 1 sample (MinIsBlack) or 3 / 4 samples
  (RGB, RGB + alpha); PlanarConfiguration 1 (contiguous), or 2 (one plane
  per sample) for 8-bit samples (OpenCV 5.0 misreads 16-bit planes as
  if they were contiguous, so those raise).

float16 files are what OpenCV does not read: the JAX package reads them
through imageio's tifffile, which the port follows. It undoes Predictor 3
after every codec in strips, and it gives no pixels for Predictor 2
(it sums the differences as floats), for Predictor 3 in tiles, or for
samples beyond 3 a pixel (it keeps the alpha): those raise.

It returns (H, W) or (H, W, spp) in the file's sample order (R, G, B[,
A]), in native byte order. An 8-bit RGBA image whose alpha is declared
unassociated (ExtraSamples 2) comes back premultiplied,
``(v * alpha + 127) // 255``, as OpenCV reads it through libtiff's RGBA
interface. Other layouts, sample types and codecs raise
:class:`NotImplementedError` naming the ROADMAP item that will bring
them (JPEG-in-TIFF: item 19, remainder); a file that does not hold what
its tags declare raises
:class:`~image_stitcher_tpu_torch.io.tile_decode.DecodeError`.
LZW, PackBits and the predictor run in C (``io/tile_decode.py``),
deflate through the stdlib's zlib.

:func:`read_pages` reads back the port's own OME-TIFF output: every page
of a tiled BigTIFF with its SubIFD pyramid levels, raw, deflate or JPEG
tiles (Compression 7, each tile a whole JFIF stream, decoded by the
port's C codec, ``io/jpeg.py``).
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

import numpy as np

from . import jpeg, tile_decode
from .fast_tiff import _read_values
from .tile_decode import DecodeError

# tag ids
_WIDTH, _LENGTH, _BITS, _COMP, _PHOTO, _FILL = 256, 257, 258, 259, 262, 266
_STRIP_OFFSETS, _SPP, _ROWS_PER_STRIP, _STRIP_COUNTS = 273, 277, 278, 279
_PLANAR, _PREDICTOR = 284, 317
_TILE_W, _TILE_H, _TILE_OFFSETS, _TILE_COUNTS = 322, 323, 324, 325
_EXTRA_SAMPLES, _SAMPLE_FORMAT = 338, 339
_YCBCR_SUBSAMPLING = 530
_TAGS = (_WIDTH, _LENGTH, _BITS, _COMP, _PHOTO, _FILL, _STRIP_OFFSETS, _SPP,
         _ROWS_PER_STRIP, _STRIP_COUNTS, _PLANAR, _PREDICTOR, _TILE_W,
         _TILE_H, _TILE_OFFSETS, _TILE_COUNTS, _EXTRA_SAMPLES,
         _SAMPLE_FORMAT)

_DEFLATE = (8, 32946)
_CODECS = (1, 5, 32773) + _DEFLATE
#: the codecs libtiff runs the Predictor tag with
_PREDICTED = (5,) + _DEFLATE
_UNASSOCIATED_ALPHA = 2


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
            vals = _read_values(mv, bo, ty, count,
                                mv[off + size - inline:off + size], inline)
            if vals is None or len(vals) != count:
                raise DecodeError(f"TIFF tag {tag}: type {ty}")
            tags[tag] = vals
    except struct.error as e:
        raise DecodeError(f"truncated TIFF directory: {e}") from None
    return bo, tags


def _segment(data, comp: int, off: int, count: int, size: int,
             plain: bool = False):
    """One strip or tile decoded to exactly ``size`` bytes (``plain``:
    by the plain versions of the C decoders)."""
    raw = data[off:off + count]
    if len(raw) != count:
        raise DecodeError(f"TIFF segment at {off} runs past the file's end")
    if comp == 1:
        out = raw
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
        # the port's JPEG tiles: grey (Photometric 1) or 4:2:0 YCbCr
        # (Photometric 6, YCbCrSubSampling 2 2), decoded to RGB
        photo = tags.get(_PHOTO, (1,))[0]
        if (dtype.itemsize, photo, spp) not in ((1, 1, 1), (1, 6, 3)) or (
                spp == 3 and tags.get(_YCBCR_SUBSAMPLING) != (2, 2)):
            raise _not_ported(f"JPEG tiles of photometric {photo}, {spp} "
                              "samples", "item 19 (remainder), 'JPEG'")

        def unpack(oc):
            tile = jpeg.decode(mv[oc[0]:oc[0] + oc[1]])
            if tile.shape[:2] != (tl, tw):
                raise DecodeError(f"JPEG tile at {oc[0]} is {tile.shape}, "
                                  f"not {tl}x{tw}")
            return tile.tobytes()
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


def decode_tiff(data, plain: bool = False) -> np.ndarray:
    """Decode the first image of a TIFF file (bytes-like); ``plain`` runs
    the plain versions of the C decoders (LZW, PackBits, the predictors),
    which the tests and ``chip_smoke.py`` hold the C ones to."""
    mv = memoryview(data)
    bo, tags = read_ifd(mv)

    def tag(t, default):
        return tags[t][0] if t in tags else default

    if _WIDTH not in tags or _LENGTH not in tags:
        raise DecodeError("TIFF without ImageWidth/ImageLength")
    w, h = tags[_WIDTH][0], tags[_LENGTH][0]
    spp = tag(_SPP, 1)
    comp = tag(_COMP, 1)
    bits = set(tags.get(_BITS, (1,)))
    if comp in (6, 7):
        raise _not_ported("JPEG compression",
                          "item 19 (remainder), 'JPEG-in-TIFF tile input'")
    if comp not in _CODECS:
        raise _not_ported(f"compression {comp}")
    if len(bits) != 1 or next(iter(bits)) not in (8, 16, 32, 64):
        raise _not_ported(f"{sorted(bits)}-bit samples")
    formats = sorted(set(tags.get(_SAMPLE_FORMAT, (1,))))
    kind = ({1: 'u', 2: 'i', 3: 'f'}.get(formats[0]) if len(formats) == 1
            else None)
    if kind is None or (kind == 'f' and next(iter(bits)) < 16):
        raise _not_ported(f"SampleFormat {formats} with {sorted(bits)}-bit "
                          "samples")
    half = kind == 'f' and next(iter(bits)) == 16
    photo = tag(_PHOTO, 1 if spp == 1 else 2)
    if (photo, spp) not in ((1, 1), (2, 3), (2, 4)):
        raise _not_ported(f"photometric {photo} with {spp} samples a pixel")
    if tag(_FILL, 1) != 1:
        raise _not_ported("FillOrder 2")
    planar = tag(_PLANAR, 1)
    predictor = tag(_PREDICTOR, 1)
    itemsize = next(iter(bits)) // 8
    if (planar not in (1, 2) or predictor not in (1, 2, 3)
            or (planar == 2 and itemsize > 1 and spp > 1)):
        raise _not_ported(f"PlanarConfiguration {planar}, Predictor "
                          f"{predictor}, {8 * itemsize}-bit samples")
    if predictor == 3 and kind != 'f':
        raise DecodeError("TIFF Predictor 3 (floating point) on integer "
                          "samples")
    if half and (spp not in (1, 3) or predictor == 2
                 or (predictor == 3 and _TILE_OFFSETS in tags)):
        # the JAX package reads float16 through imageio's tifffile, which
        # sums Predictor 2's differences as floats, has no Predictor 3 for
        # tiles and keeps an alpha sample: none of them gives the pixels
        raise _not_ported(f"float16 samples, {spp} a pixel, Predictor "
                          f"{predictor}, in "
                          f"{'tiles' if _TILE_OFFSETS in tags else 'strips'}")
    sspp = spp if planar == 1 else 1     # samples a pixel in a segment
    planes = 1 if planar == 1 else spp

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
    row_bytes = seg_cols * sspp * itemsize
    if counts is None and comp == 1:
        counts = [r * row_bytes for r in seg_rows] * planes
    if counts is None or len(offsets) < nseg or len(counts) < nseg:
        raise DecodeError(f"TIFF lists {len(offsets)} segments, the image "
                          f"needs {nseg}")
    sizes = [r * row_bytes for r in seg_rows] * planes
    buf = np.empty(sum(sizes), np.uint8)
    pos = 0
    for off, count, size in zip(offsets, counts, sizes):
        seg = _segment(mv, comp, off, count, size, plain)
        buf[pos:pos + size] = np.frombuffer(seg, np.uint8, count=size)
        pos += size
    # imageio (float16) undoes the predictor after any codec, libtiff
    # after LZW and deflate only
    predicted = predictor if comp in _PREDICTED or half else 1
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
    if spp == 1:
        return img[:, :, 0]
    if (spp == 4 and itemsize == 1
            and tag(_EXTRA_SAMPLES, 0) == _UNASSOCIATED_ALPHA):
        alpha = img[:, :, 3:].astype(np.uint32)
        img[:, :, :3] = (img[:, :, :3] * alpha + 127) // 255
    return img
