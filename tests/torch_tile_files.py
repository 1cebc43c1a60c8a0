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


def _lzw_width(k: int) -> int:
    """The width libtiff's LZWDecode reads the k-th code after a ClearCode
    with (its table one entry longer each code, early change)."""
    return 9 + (k >= 254) + (k >= 766) + (k >= 1790)


def _code_bits(codes: np.ndarray, width: int) -> np.ndarray:
    """(..., width) bits of each code, most significant first."""
    pairs = np.asarray(codes).astype('>u2')[..., None].view(np.uint8)
    return np.unpackbits(pairs, axis=-1)[..., 16 - width:]


def lzw_encode_literals(data: bytes, table: int = 3000) -> bytes:
    """A TIFF LZW stream (libtiff's LZWDecode reads it) whose codes are
    all literals: a ClearCode, then ``table`` (at most 3838) bytes each
    as its own code at the width the decoder's growing table asks for,
    again and again, then EOI. It compresses nothing, but it is built in
    NumPy, table by table at once, fast enough for 2048^2 tiles on a slow
    host."""
    a = np.frombuffer(data, np.uint8).astype(np.int64)
    full, rest = divmod(a.size, table)

    def tables(rows: np.ndarray, clear_width: int) -> np.ndarray:
        n = rows.shape[1]
        parts = [np.repeat(_code_bits(np.array([256]), clear_width),
                           len(rows), 0)]
        for lo, hi in ((0, 254), (254, 766), (766, 1790), (1790, n)):
            if lo < min(hi, n):
                parts.append(_code_bits(rows[:, lo:min(hi, n)],
                                        _lzw_width(lo)).reshape(len(rows),
                                                                -1))
        return np.concatenate(parts, 1).reshape(-1)

    blocks, clear = [], 9
    body = a[:full * table].reshape(full, table)
    if full:
        blocks.append(tables(body[:1], 9))
        clear = _lzw_width(table)
        if full > 1:
            blocks.append(tables(body[1:], clear))
    if rest or not full:
        blocks.append(tables(a[full * table:][None], clear))
    blocks.append(_code_bits(np.array(257), _lzw_width(rest if rest or not
                                                         full else table)))
    bits = np.concatenate(blocks)
    return np.packbits(bits).tobytes()


def lzw_encode_old(data: bytes) -> bytes:
    """Old-style TIFF LZW (libtiff's LZWDecodeCompat reads it): LSB-first
    codes from 9 bits, the width growing only once the next free code
    passes 512, 1024 and 2048 (no early change), a ClearCode when the
    table reaches 4094, EOI at the end. The stream starts 0x00 0x?1 (the
    ClearCode LSB-first), which is how readers tell it apart."""
    out = bytearray()
    acc = nacc = 0
    nbits, nxt = 9, 258

    def put(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += nbits
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    def added():
        nonlocal nbits, nxt
        nxt += 1
        if nxt == 4094:
            put(256)
            codes.clear()
            nbits, nxt = 9, 258
        elif nxt > (1 << nbits):
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
        out.append(acc & 0xFF)
    return bytes(out)


def reverse_bits(data: bytes) -> bytes:
    """Each byte's bits in reverse order (TIFF FillOrder 2)."""
    a = np.frombuffer(data, np.uint8)
    return np.packbits(np.unpackbits(a).reshape(-1, 8)[:, ::-1]).tobytes()


# CCITT T.4 / T.6 code words (ITU-T T.4 tables 1-3, T.6 table 1), as bit
# strings: terminating codes for runs 0-63, make-up codes for 64-1728 in
# steps of 64, the make-up codes both colours share for 1792-2560
_WHITE_TERM = """00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111
01000 001000 000011 110100 110101 101010 101011 0100111 0001100 0001000
0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 00000010
00000011 00011010 00011011 00010010 00010011 00010100 00010101 00010110
00010111 00101000 00101001 00101010 00101011 00101100 00101101 00000100
00000101 00001010 00001011 01010010 01010011 01010100 01010101 00100100
00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010
00110011 00110100""".split()
_WHITE_MAKEUP = """11011 10010 010111 0110111 00110110 00110111 01100100
01100101 01101000 01100111 011001100 011001101 011010010 011010011
011010100 011010101 011010110 011010111 011011000 011011001 011011010
011011011 010011000 010011001 010011010 011000 010011011""".split()
_BLACK_TERM = """0000110111 010 11 10 011 0011 0010 00011 000101 000100
0000100 0000101 0000111 00000100 00000111 000011000 0000010111 0000011000
0000001000 00001100111 00001101000 00001101100 00000110111 00000101000
00000010111 00000011000 000011001010 000011001011 000011001100
000011001101 000001101000 000001101001 000001101010 000001101011
000011010010 000011010011 000011010100 000011010101 000011010110
000011010111 000001101100 000001101101 000011011010 000011011011
000001010100 000001010101 000001010110 000001010111 000001100100
000001100101 000001010010 000001010011 000000100100 000000110111
000000111000 000000100111 000000101000 000001011000 000001011001
000000101011 000000101100 000001011010 000001100110 000001100111""".split()
_BLACK_MAKEUP = """0000001111 000011001000 000011001001 000001011011
000000110011 000000110100 000000110101 0000001101100 0000001101101
0000001001010 0000001001011 0000001001100 0000001001101 0000001110010
0000001110011 0000001110100 0000001110101 0000001110110 0000001110111
0000001010010 0000001010011 0000001010100 0000001010101 0000001011010
0000001011011 0000001100100 0000001100101""".split()
_EXT_MAKEUP = """00000001000 00000001100 00000001101 000000010010 000000010011
000000010100 000000010101 000000010110 000000010111 000000011100
000000011101 000000011110 000000011111""".split()
_EOL = '000000000001'
_PASS, _HORIZ = '0001', '001'
_VERTICAL = {0: '1', 1: '011', 2: '000011', 3: '0000011', -1: '010',
             -2: '000010', -3: '0000010'}


def _run_code(run: int, black: bool) -> str:
    term, makeup = ((_BLACK_TERM, _BLACK_MAKEUP) if black
                    else (_WHITE_TERM, _WHITE_MAKEUP))
    out = ''
    while run >= 2560:
        out += _EXT_MAKEUP[-1]
        run -= 2560
    if run >= 1792:
        out += _EXT_MAKEUP[(run - 1792) // 64]
        run %= 64
    elif run >= 64:
        out += makeup[run // 64 - 1]
        run %= 64
    return out + term[run]


def _changes(row: np.ndarray) -> list:
    """The changing elements of a 0/1 row: where a pixel differs from the
    one before it (an imaginary white pixel before the first)."""
    padded = np.concatenate([[0], row.astype(np.int8)])
    return np.flatnonzero(np.diff(padded)).tolist()


def _code_1d(row: np.ndarray) -> str:
    w = row.size
    out, pos, black = [], 0, False
    for c in _changes(row) + [w]:
        out.append(_run_code(c - pos, black))
        pos, black = c, not black
    return ''.join(out)


def _code_2d(row: np.ndarray, ref: list) -> str:
    """T.4 2-D / T.6 coding of a row against the reference row's
    changing elements (ITU-T T.4 4.2.1.3)."""
    w = row.size
    cur = _changes(row) + [w, w]
    ref = ref + [w, w]
    out = []
    a0, color, i, j = -1, 0, 0, 0    # i: a1's index in cur, j: b1's in ref
    while a0 < w:
        a1 = cur[i]
        a2 = cur[i + 1]
        j = max(j - 1, 0)
        while j < len(ref) and (ref[j] <= a0 or j % 2 != color):
            j += 1
        b1 = ref[j] if j < len(ref) else w
        b2 = ref[j + 1] if j + 1 < len(ref) else w
        if b2 < a1:                                 # pass mode
            out.append(_PASS)
            a0 = b2
        elif abs(a1 - b1) <= 3:                     # vertical mode
            out.append(_VERTICAL[a1 - b1])
            a0, color, i = a1, 1 - color, i + 1
        else:                                       # horizontal mode
            out.append(_HORIZ + _run_code(a1 - max(a0, 0), color == 1)
                       + _run_code(a2 - a1, color == 0))
            a0, i = a2, i + 2
    return ''.join(out)


def ccitt_encode(img: np.ndarray, compression: int, t4_options: int = 0,
                 k: int = 4) -> bytes:
    """CCITT bilevel coding of (rows, width) 0/1 samples (1 codes as
    black): compression 2 (Modified Huffman: 1-D rows, each starting on a
    byte), 3 (T.4: an EOL before every row; with ``t4_options`` bit 0 each
    EOL carries a tag bit, 1 before a 1-D row and 0 before a 2-D one,
    every ``k``-th row 1-D; bit 2 pads each EOL with zero bits so that it
    ends on a byte boundary) or 4 (T.6: 2-D rows, the first against a
    white row, then EOFB)."""
    bits = []
    ref = []
    done = 0                            # bits so far
    for r, row in enumerate(img):
        if compression == 2:
            code = _code_1d(row)
            bits.append(code + '0' * (-len(code) % 8))
        elif compression == 3:
            two_d = t4_options & 1
            eol = _EOL
            tag = ('1' if r % k == 0 else '0') if two_d else ''
            if t4_options & 4:
                eol = '0' * (-(done + len(_EOL)) % 8) + _EOL
            code = (_code_1d(row) if not two_d or r % k == 0
                    else _code_2d(row, ref))
            bits.append(eol + tag + code)
        else:
            bits.append(_code_2d(row, ref))
        done += len(bits[-1])
        ref = _changes(row)
    if compression == 4:
        bits.append(_EOL * 2)
    stream = ''.join(bits)
    stream += '0' * (-len(stream) % 8)
    return np.packbits(np.frombuffer(stream.encode(), np.uint8)
                       - ord('0')).tobytes()


def pack_samples(rows: np.ndarray, bits: int) -> np.ndarray:
    """(rows, samples) values of ``bits`` bits each, packed MSB-first,
    every row on a byte boundary: (rows, row bytes) uint8."""
    h, n = rows.shape
    shifts = np.arange(bits - 1, -1, -1, dtype=np.uint32)
    flat = ((rows.astype(np.uint32)[..., None] >> shifts) & 1).reshape(h, -1)
    return np.packbits(flat.astype(np.uint8), axis=1)


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

_TYPE_FORMATS = {3: 'H', 4: 'I', 5: 'II', 16: 'Q'}   # SHORT, LONG, RATIONAL


def _compress(comp: int, seg: np.ndarray, row_bytes: int, width: int,
              bits: int, lzw, t4_options: int) -> bytes:
    raw = seg.tobytes()
    if comp == 1:
        return raw
    if comp == 5:
        return lzw(raw)
    if comp in (8, 32946):
        return zlib.compress(raw, 6)
    if comp == 32773:   # each row on its own, as the TIFF spec asks
        return b''.join(packbits_encode(raw[i:i + row_bytes])
                        for i in range(0, len(raw), row_bytes))
    if comp == 34925:
        import lzma
        return lzma.compress(raw)
    if comp in (2, 3, 4):
        if bits != 1:
            raise ValueError("CCITT codes 1-bit samples")
        rows = np.unpackbits(seg.reshape(-1, row_bytes), axis=1)[:, :width]
        return ccitt_encode(rows, comp, t4_options)
    raise ValueError(f"no encoder for compression {comp}")


def _ycbcr_units(block: np.ndarray, sub) -> np.ndarray:
    """(rows, cols, 3) Y, Cb, Cr samples as YCbCr data units of ``sub`` =
    (horizontal, vertical) subsampling: each unit the block's h·v luma
    samples row by row, then one Cb and one Cr (its top-left pixel's);
    the block's edges are padded by repeating the last row and column."""
    sh, sv = sub
    rows, cols = block.shape[:2]
    b = np.pad(block, ((0, -rows % sv), (0, -cols % sh), (0, 0)), 'edge')
    by, bx = b.shape[0] // sv, b.shape[1] // sh
    luma = b[..., 0].reshape(by, sv, bx, sh).transpose(0, 2, 1, 3)
    chroma = b[::sv, ::sh, 1:]
    return np.concatenate([luma.reshape(by, bx, sv * sh), chroma], axis=2)


def tiff_bytes(img: np.ndarray, compression: int = 1, predictor: int = 1,
               rows_per_strip=None, tile=None, byteorder: str = '<',
               bigtiff: bool = False, planar: int = 1,
               extra_samples=None, photometric=None, bits=None,
               fill_order: int = 1, colormap=None, ycbcr_subsampling=None,
               ycbcr_coefficients=None, reference_black_white=None,
               lzw=None, t4_options: int = 0, ink_set=None) -> bytes:
    """A TIFF file of a (H, W) or (H, W, spp) image of 8- to 64-bit
    unsigned, signed or float samples (SampleFormat 1, 2 or 3) in the
    given compression, predictor (2, or 3 for floats), strip or (tile_w,
    tile_h) tile layout, byte order ('<' or '>'), classic or BigTIFF,
    PlanarConfiguration.

    Besides: ``photometric`` (default MinIsBlack for one sample, else
    RGB); ``bits`` below the sample type's (1, 2, 4, 12, ...: the values
    packed MSB-first, each row on a byte boundary); ``fill_order`` 2 (the
    stored bytes of every segment bit-reversed, after the codec);
    ``colormap`` (3, 2**bits) uint16 (Photometric 3); for YCbCr
    (Photometric 6) ``ycbcr_subsampling`` (h, v) with the luma and chroma
    packed in data units, ``ycbcr_coefficients`` and
    ``reference_black_white`` as (numerator, denominator) pairs; ``lzw``,
    the LZW encoder (:func:`lzw_encode` unless given:
    :func:`lzw_encode_old`, :func:`lzw_encode_literals`); compression 2,
    3 (``t4_options``) and
    4 (CCITT, 1-bit) and 34925 (LZMA); ``ink_set`` (tag 332)."""
    bo = byteorder
    h, w = img.shape[:2]
    spp = 1 if img.ndim == 2 else img.shape[2]
    itemsize = img.dtype.itemsize
    bits = bits or itemsize * 8
    packed = bits != itemsize * 8
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
            if ycbcr_subsampling is not None:
                b = _ycbcr_units(b, ycbcr_subsampling)
                b = np.ascontiguousarray(b).reshape(1, -1)
                row_bytes = b.size
            else:
                b = np.ascontiguousarray(b).reshape(b.shape[0], cols * sspp)
            if predictor == 2:
                b = apply_predictor(b, sspp)
            if predictor == 3:
                b = apply_fp_predictor(b, sspp)
            if packed:
                b = pack_samples(b, bits)
            else:
                b = b.astype(b.dtype.newbyteorder(bo))
            if ycbcr_subsampling is None:
                row_bytes = b.nbytes // b.shape[0]
            seg = _compress(compression, b, row_bytes, cols, bits,
                            lzw or lzw_encode, t4_options)
            segs.append(reverse_bits(seg) if fill_order == 2 else seg)
    head = 16 if bigtiff else 8
    offsets, pos = [], head
    for s in segs:
        offsets.append(pos)
        pos += len(s)
    ifd_off = pos + (pos & 1)
    off_type = 16 if bigtiff else 4
    if photometric is None:
        photometric = 1 if spp == 1 else 2
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp),
               (259, 3, [compression]), (262, 3, [photometric]),
               (277, 3, [spp]), (284, 3, [planar]),
               (339, 3, [{'u': 1, 'i': 2, 'f': 3}[img.dtype.kind]] * spp)]
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if extra_samples is not None:
        entries.append((338, 3, list(extra_samples)))
    if fill_order != 1:
        entries.append((266, 3, [fill_order]))
    if colormap is not None:
        entries.append((320, 3, np.asarray(colormap).reshape(-1).tolist()))
    if compression == 3 and t4_options:
        entries.append((292, 4, [t4_options]))
    if ycbcr_subsampling is not None:
        entries.append((530, 3, list(ycbcr_subsampling)))
    if ycbcr_coefficients is not None:
        entries.append((529, 5, [v for p in ycbcr_coefficients for v in p]))
    if reference_black_white is not None:
        entries.append((532, 5, [v for p in reference_black_white
                                 for v in p]))
    if ink_set is not None:
        entries.append((332, 3, [ink_set]))
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
        per = len(_TYPE_FORMATS[ty])
        payload = struct.pack(bo + 'I' * len(vals) if ty == 5 else
                              bo + _TYPE_FORMATS[ty] * len(vals), *vals)
        if len(payload) <= inline:
            field = payload.ljust(inline, b'\0')
        else:
            field = struct.pack(bo + cfmt, extra_at + len(extra))
            extra += payload + b'\0' * (len(payload) & 1)
        ifd += struct.pack(bo + 'HH', tag, ty) + struct.pack(
            bo + cfmt, len(vals) // per) + field
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

def rle_encode(idx: np.ndarray, bits: int) -> bytes:
    """BI_RLE8 (``bits`` 8) or BI_RLE4 (4) data of (H, W) palette indices,
    bottom row first: runs of 3 or more equal pixels as encoded runs,
    stretches of 3 or more others as absolute runs, the rest as runs of 1
    or 2; an EOL after every row but the last, then EOF."""
    out = bytearray()
    h, w = idx.shape
    for r in range(h - 1, -1, -1):
        row = idx[r].astype(np.uint8)
        starts = np.concatenate([[0], np.flatnonzero(np.diff(row)) + 1, [w]])
        runs = [(int(a), int(b - a)) for a, b in zip(starts[:-1], starts[1:])]
        lit = []

        def flush():
            while lit:
                part, lit[:] = lit[:255], lit[255:]
                if len(part) < 3:
                    for v in part:
                        out.extend((1, v * 17 if bits == 4 else v))
                    continue
                out.extend((0, len(part)))
                if bits == 8:
                    body = bytes(part)
                else:
                    body = bytes((part[k] << 4) | (part[k + 1] if k + 1 < len(
                        part) else 0) for k in range(0, len(part), 2))
                out.extend(body + b'\0' * (len(body) & 1))

        for start, n in runs:
            if n < 3:
                lit.extend([int(row[start])] * n)
                continue
            flush()
            while n:
                k = min(n, 255)
                out.extend((k, int(row[start]) * (17 if bits == 4 else 1)))
                n -= k
        flush()
        out.extend((0, 0) if r else (0, 1))
    return bytes(out)


def bmp_bytes(img: np.ndarray, bpp: int, palette=None, top_down=False,
              header: int = 40, compression: int = 0,
              rle_data: bytes = None) -> bytes:
    """A BMP file: (H, W) palette indices with ``palette`` (n, 3) RGB for
    1-, 4- and 8-bit pixels (``compression`` 1 or 2: BI_RLE8 / BI_RLE4,
    coded by :func:`rle_encode` unless ``rle_data`` gives the bytes), (H,
    W, 3) RGB for 16-bit (BI_RGB: 5-5-5 bits, the low bits dropped;
    ``compression=3`` BI_BITFIELDS: 5-6-5) and 24-bit, (H, W, 4) RGBA for
    32-bit (BI_RGB, or ``compression=3`` BI_BITFIELDS with the standard
    masks); rows bottom-up unless ``top_down``; a BITMAPCOREHEADER
    (``header=12``), BITMAPINFOHEADER (40) or BITMAPV5HEADER (124)."""
    h, w = img.shape[:2]
    if bpp == 24:
        rows = img[..., ::-1].reshape(h, w * 3)
    elif bpp == 32:
        rows = img[..., [2, 1, 0, 3]].reshape(h, w * 4)
    elif bpp == 16:
        c = img.astype(np.uint16)
        if compression == 3:
            v = (c[..., 0] >> 3) << 11 | (c[..., 1] >> 2) << 5 | c[..., 2] >> 3
        else:
            v = (c[..., 0] >> 3) << 10 | (c[..., 1] >> 3) << 5 | c[..., 2] >> 3
        rows = v.astype('<u2').view(np.uint8).reshape(h, w * 2)
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
    pixels = rows.tobytes()
    if compression in (1, 2):
        pixels = rle_data if rle_data is not None else rle_encode(img, bpp)
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
                           1, bpp, compression, len(pixels), 2835, 2835,
                           0 if palette is None else len(palette), 0)
        if header == 124:
            info += (struct.pack('<IIII', 0xF800, 0x07E0, 0x001F, 0)
                     if bpp == 16 else
                     struct.pack('<IIII', 0x00FF0000, 0x0000FF00, 0x000000FF,
                                 0xFF000000))
            info = info.ljust(124, b'\0')
        elif compression == 3 and bpp == 16:
            masks = struct.pack('<III', 0xF800, 0x07E0, 0x001F)
        elif compression == 3:
            masks = struct.pack('<III', 0x00FF0000, 0x0000FF00, 0x000000FF)
    offset = 14 + len(info) + len(masks) + len(pal)
    size = offset + len(pixels)
    return (b'BM' + struct.pack('<IHHI', size, 0, 0, offset) + info + masks
            + pal + pixels)
