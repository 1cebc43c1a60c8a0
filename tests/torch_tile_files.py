"""Tile files written without OpenCV: plain encoders (TIFF LZW, PackBits,
the TIFF horizontal predictor, PNG row filters) and writers of TIFF, PNG
and BMP files with any of the layouts the port's readers take.

The port's input tests use them for the layouts OpenCV cannot write
(tiles, big-endian, BigTIFF, interlaced or filter-cycling PNG, odd BMP
headers), with OpenCV reading them back as the oracle; ``chip_smoke.py``
phase 9 uses them on the card's host, which has no OpenCV. NumPy and the
standard library only.
"""

from __future__ import annotations

import itertools
import struct
import zlib

import numpy as np

# ------------------------------------------------------------ encoders


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (libtiff's LZWEncode): MSB-first codes from 9 bits, the
    width growing once the next free code passes 511, 1023 and 2047, a
    ClearCode when the table reaches 4094, EOI at the end."""
    out = bytearray()
    acc = nacc = 0
    nbits, nxt = 9, 258

    def put(code):
        nonlocal acc, nacc
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1

    def added():
        nonlocal nbits, nxt
        nxt += 1
        if nxt == 4094:
            put(256)
            codes.clear()
            nbits, nxt = 9, 258
        elif nxt > (1 << nbits) - 1:
            nbits += 1

    codes = {}
    put(256)
    if data:
        w = data[0]
        for c in data[1:]:
            key = (w << 8) | c
            code = codes.get(key)
            if code is not None:
                w = code
                continue
            put(w)
            codes[key] = nxt
            added()
            w = c
        put(w)
        added()
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 3 or more equal bytes as repeat packets, the
    rest as literal packets (at most 128 bytes each)."""
    a = np.frombuffer(data, np.uint8)
    out = bytearray()
    if a.size == 0:
        return bytes(out)
    starts = np.flatnonzero(np.diff(a)) + 1
    bounds = np.concatenate([[0], starts, [a.size]])
    lit = bytearray()

    def flush():
        for i in range(0, len(lit), 128):
            part = lit[i:i + 128]
            out.append(len(part) - 1)
            out.extend(part)
        lit.clear()

    for s, e in zip(bounds[:-1], bounds[1:]):
        n = int(e - s)
        if n < 3:
            lit.extend(a[s:e].tobytes())
            continue
        flush()
        while n:
            k = min(n, 128)
            if k == 1:
                lit.append(int(a[s]))
            else:
                out.append((257 - k) & 0xFF)
                out.append(int(a[s]))
            n -= k
    flush()
    return bytes(out)


def apply_predictor(arr: np.ndarray, spp: int) -> np.ndarray:
    """TIFF Predictor 2 on (rows, pixels * spp) samples: each sample minus
    the same sample of the pixel before it, wrapping (signed and float
    samples as their unsigned bits, as libtiff takes them)."""
    bits = arr.view(np.dtype(f'=u{arr.dtype.itemsize}'))
    out = bits.copy()
    out[:, spp:] = bits[:, spp:] - bits[:, :-spp]
    return out.view(arr.dtype)


def apply_fp_predictor(arr: np.ndarray, spp: int, byteorder: str = '<'
                       ) -> np.ndarray:
    """TIFF Predictor 3 (libtiff's fpDiff) on (rows, pixels * spp) float
    samples: each row's samples as byte planes, the most significant
    byte's first (whatever ``byteorder``), then each byte minus the byte
    ``spp`` before it, wrapping; (rows, row bytes) uint8."""
    rows, n = arr.shape
    size = arr.dtype.itemsize
    big = np.ascontiguousarray(arr.astype(arr.dtype.newbyteorder('>')))
    planes = big.view(np.uint8).reshape(rows, n, size).transpose(0, 2, 1)
    flat = np.ascontiguousarray(planes).reshape(rows, n * size)
    out = flat.copy()
    out[:, spp:] = flat[:, spp:] - flat[:, :-spp]
    return out


def png_filter(rows: np.ndarray, bpp: int, kinds) -> bytes:
    """PNG-filter (h, row_bytes) uint8 rows, row r with filter type
    kinds[r] (0-4); returns the rows behind their filter bytes."""
    h, n = rows.shape
    x = rows.astype(np.int32)
    out = np.empty((h, n + 1), np.uint8)
    prev = np.zeros(n, np.int32)
    for r in range(h):
        kind = int(kinds[r])
        cur = x[r]
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])[:n]
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])[:n]
        b = prev
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        out[r, 0] = kind
        out[r, 1:] = (cur - pred) & 0xFF
        prev = cur
    return out.tobytes()


# ---------------------------------------------------------------- TIFF

_TYPE_FORMATS = {3: 'H', 4: 'I', 16: 'Q'}   # SHORT, LONG, LONG8


def _compress(comp: int, seg: np.ndarray, row_bytes: int) -> bytes:
    raw = seg.tobytes()
    if comp == 1:
        return raw
    if comp == 5:
        return lzw_encode(raw)
    if comp in (8, 32946):
        return zlib.compress(raw, 6)
    if comp == 32773:   # each row on its own, as the TIFF spec asks
        return b''.join(packbits_encode(raw[i:i + row_bytes])
                        for i in range(0, len(raw), row_bytes))
    raise ValueError(f"no encoder for compression {comp}")


def tiff_bytes(img: np.ndarray, compression: int = 1, predictor: int = 1,
               rows_per_strip=None, tile=None, byteorder: str = '<',
               bigtiff: bool = False, planar: int = 1,
               extra_samples=None) -> bytes:
    """A TIFF file of a (H, W) or (H, W, spp) image of 8- to 64-bit
    unsigned, signed or float samples (SampleFormat 1, 2 or 3) in the
    given compression, predictor (2, or 3 for floats), strip or (tile_w,
    tile_h) tile layout, byte order ('<' or '>'), classic or BigTIFF,
    PlanarConfiguration."""
    bo = byteorder
    h, w = img.shape[:2]
    spp = 1 if img.ndim == 2 else img.shape[2]
    itemsize = img.dtype.itemsize
    src = img.reshape(h, w, spp)
    planes = ([src] if planar == 1 else
              [src[:, :, k:k + 1] for k in range(spp)])
    sspp = spp if planar == 1 else 1
    segs = []
    for plane in planes:
        if tile is None:
            rps = rows_per_strip or h
            blocks = [plane[y:y + rps] for y in range(0, h, rps)]
            cols = w
        else:
            tw, tl = tile
            blocks = []
            for y in range(0, h, tl):
                for x in range(0, w, tw):
                    b = np.zeros((tl, tw, sspp), img.dtype)
                    part = plane[y:y + tl, x:x + tw]
                    b[:part.shape[0], :part.shape[1]] = part
                    blocks.append(b)
            cols = tile[0]
        for b in blocks:
            b = np.ascontiguousarray(b).reshape(b.shape[0], cols * sspp)
            if predictor == 2:
                b = apply_predictor(b, sspp)
            if predictor == 3:
                b = apply_fp_predictor(b, sspp)
            b = b.astype(b.dtype.newbyteorder(bo))
            segs.append(_compress(compression, b, cols * sspp * itemsize))
    head = 16 if bigtiff else 8
    offsets, pos = [], head
    for s in segs:
        offsets.append(pos)
        pos += len(s)
    ifd_off = pos + (pos & 1)
    off_type = 16 if bigtiff else 4
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [itemsize * 8] * spp),
               (259, 3, [compression]), (262, 3, [1 if spp == 1 else 2]),
               (277, 3, [spp]), (284, 3, [planar]),
               (339, 3, [{'u': 1, 'i': 2, 'f': 3}[img.dtype.kind]] * spp)]
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if extra_samples is not None:
        entries.append((338, 3, list(extra_samples)))
    if tile is None:
        entries += [(273, off_type, offsets), (278, 4, [rows_per_strip or h]),
                    (279, off_type, [len(s) for s in segs])]
    else:
        entries += [(322, 4, [tile[0]]), (323, 4, [tile[1]]),
                    (324, off_type, offsets),
                    (325, off_type, [len(s) for s in segs])]
    entries.sort()
    cfmt, inline, esize = ('Q', 8, 20) if bigtiff else ('I', 4, 12)
    ifd = bytearray(struct.pack(bo + ('Q' if bigtiff else 'H'), len(entries)))
    extra_at = ifd_off + len(ifd) + len(entries) * esize + inline
    extra = bytearray()
    for tag, ty, vals in entries:
        payload = struct.pack(bo + _TYPE_FORMATS[ty] * len(vals), *vals)
        if len(payload) <= inline:
            field = payload.ljust(inline, b'\0')
        else:
            field = struct.pack(bo + cfmt, extra_at + len(extra))
            extra += payload + b'\0' * (len(payload) & 1)
        ifd += struct.pack(bo + 'HH', tag, ty) + struct.pack(
            bo + cfmt, len(vals)) + field
    ifd += struct.pack(bo + cfmt, 0)
    if bigtiff:
        header = (b'II' if bo == '<' else b'MM') + struct.pack(
            bo + 'HHHQ', 43, 8, 0, ifd_off)
    else:
        header = (b'II' if bo == '<' else b'MM') + struct.pack(
            bo + 'HI', 42, ifd_off)
    body = b''.join(segs)
    return header + body + b'\0' * (ifd_off - pos) + bytes(ifd) + bytes(extra)


# ----------------------------------------------------------------- PNG

_PNG_SIG = b'\x89PNG\r\n\x1a\n'
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF))


def _png_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, ch) samples -> (h, row_bytes) packed big-endian bytes."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype('>u2').reshape(h, -1).view(np.uint8)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    per = 8 // depth
    flat = samples.reshape(h, -1).astype(np.uint8)
    pad = (-flat.shape[1]) % per
    flat = np.pad(flat, ((0, 0), (0, pad)))
    groups = flat.reshape(h, -1, per)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return np.bitwise_or.reduce(groups << shifts, axis=2).astype(np.uint8)


def png_bytes(img: np.ndarray, ctype: int, depth: int, filters=(0,),
              palette=None, interlace: bool = False, idat_chunks: int = 1,
              level: int = 6, extra_chunks=()) -> bytes:
    """A PNG file: ``img`` is (H, W) or (H, W, channels) samples of
    color type ``ctype`` at bit depth ``depth`` (palette indices for
    type 3, with ``palette`` (n, 3) uint8); rows take the filter types of
    ``filters`` in turn; the image data is split over ``idat_chunks``
    chunks; ``extra_chunks`` are (kind, body) placed before IDAT."""
    h, w = img.shape[:2]
    ch = _PNG_CHANNELS[ctype]
    samples = img.reshape(h, w, ch)
    bpp = max(1, ch * depth // 8)
    kinds = itertools.cycle(filters)
    if interlace:
        parts = [samples[y0::dy, x0::dx] for x0, y0, dx, dy in _ADAM7]
        parts = [p for p in parts if p.size]
    else:
        parts = [samples]
    raw = b''
    for p in parts:
        rows = _png_rows(p, depth)
        raw += png_filter(rows, bpp, [next(kinds) for _ in range(len(rows))])
    data = zlib.compress(raw, level)
    step = -(-len(data) // idat_chunks)
    out = _PNG_SIG + _chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, depth,
                                                 ctype, 0, 0, int(interlace)))
    for kind, body in extra_chunks:
        out += _chunk(kind, body)
    if palette is not None:
        out += _chunk(b'PLTE', np.asarray(palette, np.uint8).tobytes())
    for i in range(0, len(data), step):
        out += _chunk(b'IDAT', data[i:i + step])
    return out + _chunk(b'IEND', b'')


# ----------------------------------------------------------------- BMP

def bmp_bytes(img: np.ndarray, bpp: int, palette=None, top_down=False,
              header: int = 40, compression: int = 0) -> bytes:
    """A BMP file: (H, W) palette indices with ``palette`` (n, 3) RGB for
    1-, 4- and 8-bit pixels, (H, W, 3) RGB for 24-bit, (H, W, 4) RGBA for
    32-bit (BI_RGB, or ``compression=3`` BI_BITFIELDS with the standard
    masks); rows bottom-up unless ``top_down``; a BITMAPCOREHEADER
    (``header=12``), BITMAPINFOHEADER (40) or BITMAPV5HEADER (124)."""
    h, w = img.shape[:2]
    if bpp == 24:
        rows = img[..., ::-1].reshape(h, w * 3)
    elif bpp == 32:
        rows = img[..., [2, 1, 0, 3]].reshape(h, w * 4)
    else:
        per = 8 // bpp
        flat = np.pad(img.astype(np.uint8), ((0, 0), (0, (-w) % per)))
        shifts = np.arange(8 - bpp, -1, -bpp, dtype=np.uint8)
        rows = np.bitwise_or.reduce(flat.reshape(h, -1, per) << shifts,
                                    axis=2).astype(np.uint8)
    row_bytes = (w * bpp + 31) // 32 * 4
    rows = np.pad(rows.astype(np.uint8),
                  ((0, 0), (0, row_bytes - rows.shape[1])))
    if not top_down:
        rows = rows[::-1]
    pal = b''
    if palette is not None:
        bgr = np.asarray(palette, np.uint8)[:, ::-1]
        if header != 12:
            bgr = np.concatenate([bgr, np.zeros((len(bgr), 1), np.uint8)], 1)
        pal = bgr.tobytes()
    masks = b''
    if header == 12:
        info = struct.pack('<IHHHH', 12, w, h, 1, bpp)
    else:
        info = struct.pack('<IiiHHIIiiII', header, w, -h if top_down else h,
                           1, bpp, compression, row_bytes * h, 2835, 2835,
                           0 if palette is None else len(palette), 0)
        if header == 124:
            info += struct.pack('<IIII', 0x00FF0000, 0x0000FF00, 0x000000FF,
                                0xFF000000)
            info = info.ljust(124, b'\0')
        elif compression == 3:
            masks = struct.pack('<III', 0x00FF0000, 0x0000FF00, 0x000000FF)
    offset = 14 + len(info) + len(masks) + len(pal)
    size = offset + row_bytes * h
    return (b'BM' + struct.pack('<IHHI', size, 0, 0, offset) + info + masks
            + pal + rows.tobytes())
