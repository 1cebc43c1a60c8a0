"""Tile decoders: TIFF LZW (new- and old-style), PackBits, the TIFF
horizontal and floating-point predictors, FillOrder 2 bit reversal,
packed-sample unpacking, CCITT bilevel decoding (Modified Huffman, T.4,
T.6), PNG row unfiltering and BMP run-length decoding.

The C routines (``csrc/tile_decode.c``, built at first use with the
system C compiler by :func:`image_stitcher_tpu_torch.native.load`) are
what the readers call: ctypes releases the interpreter lock around each
call, so the tile loader's threads decode in parallel. Beside each sits
its plain version in Python and NumPy (``*_plain``), which the tests and
``chip_smoke.py`` hold the C routine to, byte for byte; the readers never
run the plain versions, and a decoder that cannot be built raises. The
rules both follow are written in the C source's header.

Deflate is not here: TIFF compression 8 / 32946 and PNG IDAT streams go
through the stdlib's :func:`zlib.decompress` (C, lock released).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None

_ERRORS = {-1: "bad arguments", -2: "corrupt data", -4: "out of memory"}


class DecodeError(ValueError):
    """Compressed or filtered tile data that does not decode."""


def lib() -> ctypes.CDLL:
    """The C decoders, built and bound on first use (raises when no C
    compiler can build them)."""
    global _LIB
    if _LIB is None:
        from ..native import load
        so = load('tile_decode')
        i64, vp, ci = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
        so.tiff_lzw_decode.argtypes = [vp, i64, vp, i64]
        so.tiff_lzw_decode.restype = i64
        so.packbits_decode.argtypes = [vp, i64, vp, i64]
        so.packbits_decode.restype = i64
        so.tiff_predictor_undo.argtypes = [vp, i64, i64, ci, ci]
        so.tiff_predictor_undo.restype = ci
        so.tiff_fp_predictor_undo.argtypes = [vp, i64, i64, ci, ci]
        so.tiff_fp_predictor_undo.restype = ci
        so.png_unfilter.argtypes = [vp, i64, i64, ci, vp]
        so.png_unfilter.restype = ci
        so.reverse_bits.argtypes = [vp, i64]
        so.reverse_bits.restype = None
        so.unpack_samples.argtypes = [vp, i64, i64, i64, ci, vp]
        so.unpack_samples.restype = ci
        so.ccitt_decode.argtypes = [vp, i64, vp, i64, i64, ci, ci]
        so.ccitt_decode.restype = i64
        so.bmp_rle_decode.argtypes = [vp, i64, vp, i64, i64, ci]
        so.bmp_rle_decode.restype = ci
        _LIB = so
    return _LIB


def _src(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    return np.frombuffer(data, np.uint8)


def _check(rc: int, what: str) -> int:
    if rc < 0:
        raise DecodeError(f"{what}: {_ERRORS.get(rc, rc)}")
    return rc


# --------------------------------------------------------------- TIFF LZW

def lzw_decode(data, size: int) -> np.ndarray:
    """Decode one TIFF LZW strip or tile, in C: at most ``size`` bytes
    (fewer when the data ends first)."""
    src = _src(data)
    out = np.empty(size, np.uint8)
    n = _check(lib().tiff_lzw_decode(src.ctypes.data, src.size,
                                     out.ctypes.data, size), "TIFF LZW")
    return out[:n]


def lzw_decode_plain(data, size: int) -> np.ndarray:
    """:func:`lzw_decode` in Python."""
    src = bytes(_src(data))
    if len(src) >= 2 and src[0] == 0 and src[1] & 1:
        return _lzw_compat_plain(src, size)
    table = [bytes([c]) for c in range(256)] + [b'', b'']
    out = bytearray()
    bitbuf = bits = i = 0
    nbits, old = 9, None
    while len(out) < size:
        while bits < nbits:
            if i >= len(src):
                return np.frombuffer(bytes(out), np.uint8)
            bitbuf = ((bitbuf << 8) | src[i]) & 0xFFFFFFFF
            i += 1
            bits += 8
        code = (bitbuf >> (bits - nbits)) & ((1 << nbits) - 1)
        bits -= nbits
        if code == 257:
            break
        if code == 256:
            del table[258:]
            nbits, old = 9, None
            continue
        if old is None:
            if code > 255:
                _check(-2, "TIFF LZW")
        elif code < len(table) or (code == len(table) < 4096):
            if len(table) < 4096:
                entry = table[old] + (table[old] if code == len(table)
                                      else table[code])[:1]
                table.append(entry)
                if len(table) >= (1 << nbits) - 1 and nbits < 12:
                    nbits += 1
        else:
            _check(-2, "TIFF LZW")
        out += table[code][:size - len(out)]
        old = code
    return np.frombuffer(bytes(out), np.uint8)


def _lzw_compat_plain(src: bytes, size: int) -> np.ndarray:
    """Old-style (LSB-first) LZW, libtiff's LZWDecodeCompat."""
    table = [bytes([c]) for c in range(256)] + [b'', b'']
    out = bytearray()
    bitbuf = bits = i = 0
    nbits, old = 9, -1           # -1: no ClearCode yet; -2: a new table
    while len(out) < size:
        while bits < nbits:
            if i >= len(src):
                return np.frombuffer(bytes(out), np.uint8)
            bitbuf |= src[i] << bits
            i += 1
            bits += 8
        code = bitbuf & ((1 << nbits) - 1)
        bitbuf >>= nbits
        bits -= nbits
        if code == 257:
            break
        if code == 256:
            del table[258:]
            nbits, old = 9, -2
            continue
        if old == -1 or (old == -2 and code > 255):
            _check(-2, "TIFF LZW")
        if old == -2:
            out.append(code)
            old = code
            continue
        if code > len(table) or len(table) >= 4096 + 1024:
            _check(-2, "TIFF LZW")
        table.append(table[old] + (table[old] if code == len(table)
                                   else table[code])[:1])
        if len(table) > (1 << nbits) - 1 and nbits < 12:
            nbits += 1
        out += table[code][:size - len(out)]
        old = code
    return np.frombuffer(bytes(out), np.uint8)


# --------------------------------------------------------------- PackBits

def packbits_decode(data, size: int) -> np.ndarray:
    """Decode PackBits, in C: at most ``size`` bytes."""
    src = _src(data)
    out = np.empty(size, np.uint8)
    n = _check(lib().packbits_decode(src.ctypes.data, src.size,
                                     out.ctypes.data, size), "PackBits")
    return out[:n]


def packbits_decode_plain(data, size: int) -> np.ndarray:
    """:func:`packbits_decode` in Python."""
    src = bytes(_src(data))
    out = bytearray()
    i = 0
    while i < len(src) and len(out) < size:
        h = src[i] - 256 if src[i] > 127 else src[i]
        i += 1
        if h >= 0:
            out += src[i:i + h + 1][:size - len(out)]
            i += h + 1
        elif h != -128:
            if i >= len(src):
                break
            out += bytes([src[i]]) * min(1 - h, size - len(out))
            i += 1
    return np.frombuffer(bytes(out), np.uint8)


# ------------------------------------------------------------- predictor

def _predictor_args(arr: np.ndarray, spp: int):
    if arr.ndim != 2 or arr.dtype.kind != 'u' \
            or arr.itemsize not in (1, 2, 4, 8):
        raise ValueError(f"the predictor takes (rows, samples) unsigned "
                         f"8/16/32/64-bit samples, got {arr.shape} "
                         f"{arr.dtype}")
    if not arr.dtype.isnative or spp < 1:
        raise ValueError("the predictor takes native byte order and spp >= 1")


def undo_predictor(arr: np.ndarray, spp: int) -> np.ndarray:
    """Undo the TIFF horizontal predictor in place, in C, over a C-
    contiguous (rows, pixels * spp) array of native unsigned samples;
    returns it."""
    _predictor_args(arr, spp)
    if not arr.flags.c_contiguous or not arr.flags.writeable:
        raise ValueError("the predictor works in place on a writable "
                         "C-contiguous array")
    _check(lib().tiff_predictor_undo(arr.ctypes.data, arr.shape[0],
                                     arr.shape[1], spp, arr.itemsize),
           "TIFF predictor")
    return arr


def undo_predictor_plain(arr: np.ndarray, spp: int) -> np.ndarray:
    """:func:`undo_predictor` in NumPy: a running sum along each row per
    sample, modulo 2^bits (unsigned sums wrap)."""
    _predictor_args(arr, spp)
    rows, n = arr.shape
    px = n // spp
    head = arr[:, :px * spp].reshape(rows, px, spp)
    head[...] = np.cumsum(head, axis=1, dtype=arr.dtype)
    if n % spp:     # a row that is not whole pixels: the tail by hand
        for k in range(px * spp, n):
            arr[:, k] = arr[:, k] + arr[:, k - spp]
    return arr


def _fp_predictor_args(arr: np.ndarray, spp: int, sample_bytes: int):
    if arr.ndim != 2 or arr.dtype != np.uint8 \
            or sample_bytes not in (2, 4, 8) \
            or arr.shape[1] % sample_bytes or spp < 1:
        raise ValueError(f"the floating-point predictor takes (rows, bytes) "
                         f"uint8 rows of whole 2-, 4- or 8-byte samples and "
                         f"spp >= 1, got {arr.shape} {arr.dtype}, "
                         f"{sample_bytes}-byte samples, spp {spp}")


def undo_fp_predictor(arr: np.ndarray, spp: int,
                      sample_bytes: int) -> np.ndarray:
    """Undo the TIFF floating-point predictor (Predictor 3, libtiff's
    fpAcc) in place, in C, over a C-contiguous (rows, row bytes) uint8
    array of ``sample_bytes``-byte samples, ``spp`` a pixel: afterwards
    the rows hold the samples in native byte order. Returns it."""
    _fp_predictor_args(arr, spp, sample_bytes)
    if not arr.flags.c_contiguous or not arr.flags.writeable:
        raise ValueError("the predictor works in place on a writable "
                         "C-contiguous array")
    _check(lib().tiff_fp_predictor_undo(arr.ctypes.data, arr.shape[0],
                                        arr.shape[1], spp, sample_bytes),
           "TIFF floating-point predictor")
    return arr


def undo_fp_predictor_plain(arr: np.ndarray, spp: int,
                            sample_bytes: int) -> np.ndarray:
    """:func:`undo_fp_predictor` in NumPy: a running byte sum along each
    row with stride ``spp`` (modulo 256), then the row's byte planes (the
    most significant first) put back as native-order samples."""
    _fp_predictor_args(arr, spp, sample_bytes)
    rows, n = arr.shape
    acc = np.cumsum(arr.reshape(rows, n // spp, spp), axis=1,
                    dtype=np.uint8).reshape(rows, n)
    planes = acc.reshape(rows, sample_bytes, n // sample_bytes)
    if np.little_endian:
        planes = planes[:, ::-1]
    arr[...] = planes.transpose(0, 2, 1).reshape(rows, n)
    return arr


# ----------------------------------------------------------- PNG filters

def png_unfilter(data, rows: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo PNG row filters, in C: ``data`` holds ``rows`` rows of one
    filter byte and ``row_bytes`` bytes; ``bpp`` is the bytes per
    complete pixel (1 for bit depths under 8). Returns (rows, row_bytes)
    uint8."""
    src = _unfilter_args(data, rows, row_bytes, bpp)
    out = np.empty((rows, row_bytes), np.uint8)
    _check(lib().png_unfilter(src.ctypes.data, rows, row_bytes, bpp,
                              out.ctypes.data), "PNG filter")
    return out


def _unfilter_args(data, rows: int, row_bytes: int, bpp: int) -> np.ndarray:
    src = _src(data)
    if not 1 <= bpp <= 8 or rows < 0 or row_bytes < 0:
        raise ValueError(f"bad PNG row layout: {rows} rows of {row_bytes} "
                         f"bytes, {bpp} bytes per pixel")
    if src.size < rows * (row_bytes + 1):
        raise DecodeError(f"PNG image data holds {src.size} bytes, its rows "
                          f"need {rows * (row_bytes + 1)}")
    return src


def png_unfilter_plain(data, rows: int, row_bytes: int,
                       bpp: int) -> np.ndarray:
    """:func:`png_unfilter` in NumPy and Python (Average and Paeth byte
    by byte)."""
    src = _unfilter_args(data, rows, row_bytes, bpp)
    src = src[:rows * (row_bytes + 1)].reshape(rows, row_bytes + 1)
    out = np.zeros((rows, row_bytes), np.uint8)
    up = np.zeros(row_bytes, np.uint8)
    for r in range(rows):
        kind, line = int(src[r, 0]), src[r, 1:]
        if kind == 0:
            out[r] = line
        elif kind == 1:
            for lane in range(min(bpp, row_bytes)):
                out[r, lane::bpp] = np.cumsum(line[lane::bpp], dtype=np.uint8)
        elif kind == 2:
            out[r] = line + up
        elif kind in (3, 4):
            cur = [0] * row_bytes
            for k in range(row_bytes):
                a = cur[k - bpp] if k >= bpp else 0
                b = int(up[k])
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(up[k - bpp]) if k >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                            else c)
                cur[k] = (int(line[k]) + pred) & 0xFF
            out[r] = cur
        else:
            raise DecodeError(f"PNG filter: {_ERRORS[-2]} (filter type "
                              f"{kind} in row {r})")
        up = out[r]
    return out


# ------------------------------------------------------------ FillOrder 2

def reverse_bits(data) -> np.ndarray:
    """A copy of ``data`` with each byte's bits reversed (TIFF FillOrder
    2), in C."""
    out = _src(data).copy()
    lib().reverse_bits(out.ctypes.data, out.size)
    return out


_REVERSED = np.packbits(np.unpackbits(np.arange(256, dtype=np.uint8)
                                      ).reshape(256, 8)[:, ::-1])


def reverse_bits_plain(data) -> np.ndarray:
    """:func:`reverse_bits` in NumPy."""
    return _REVERSED[_src(data)]


# -------------------------------------------------------- packed samples

def _unpack_args(data, rows: int, row_bytes: int, count: int,
                 bits: int) -> np.ndarray:
    src = _src(data)
    if not 1 <= bits <= 16 or rows < 0 or count < 0 \
            or row_bytes < (count * bits + 7) // 8:
        raise ValueError(f"bad packed layout: {rows} rows of {row_bytes} "
                         f"bytes, {count} samples of {bits} bits")
    if src.size < rows * row_bytes:
        raise DecodeError(f"packed samples hold {src.size} bytes, their "
                          f"rows need {rows * row_bytes}")
    return src


def unpack_samples(data, rows: int, row_bytes: int, count: int,
                   bits: int) -> np.ndarray:
    """(rows, count) samples of ``bits`` (1-16) bits each, packed MSB-first
    in rows of ``row_bytes`` bytes, in C: uint8 up to 8 bits, else uint16,
    values unscaled."""
    src = _unpack_args(data, rows, row_bytes, count, bits)
    out = np.empty((rows, count), np.uint8 if bits <= 8 else np.uint16)
    _check(lib().unpack_samples(src.ctypes.data, rows, row_bytes, count,
                                bits, out.ctypes.data), "packed samples")
    return out


def unpack_samples_plain(data, rows: int, row_bytes: int, count: int,
                         bits: int) -> np.ndarray:
    """:func:`unpack_samples` in NumPy."""
    src = _unpack_args(data, rows, row_bytes, count, bits)
    flat = np.unpackbits(src[:rows * row_bytes].reshape(rows, row_bytes),
                         axis=1)[:, :count * bits].reshape(rows, count, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint32)
    return (flat.astype(np.uint32) @ weights).astype(
        np.uint8 if bits <= 8 else np.uint16)


# ------------------------------------------------------------------ CCITT

# the code words of ITU-T T.4 (tables 1-3), as bit strings: terminating
# codes (runs 0-63) and make-up codes (64-1728) of each colour, then the
# make-up codes both colours share (1792-2560)
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
_SHARED_MAKEUP = """00000001000 00000001100 00000001101 000000010010
000000010011 000000010100 000000010101 000000010110 000000010111
000000011100 000000011101 000000011110 000000011111""".split()


def _run_table(term, makeup):
    table = {c: r for r, c in enumerate(term)}
    table.update({c: 64 * (k + 1) for k, c in enumerate(makeup)})
    table.update({c: 1792 + 64 * k for k, c in enumerate(_SHARED_MAKEUP)})
    return table


_RUNS = (_run_table(_WHITE_TERM, _WHITE_MAKEUP),
         _run_table(_BLACK_TERM, _BLACK_MAKEUP))
#: 2-D mode codes (T.4 table 4): 'P', 'H' or the vertical offset a1 - b1
_MODES = {'0001': 'P', '001': 'H', '1': 0, '011': 1, '000011': 2,
          '0000011': 3, '010': -1, '000010': -2, '0000010': -3}


class _Bits:
    """MSB-first reading of a byte string; bits past its end read 0."""

    def __init__(self, data: np.ndarray):
        self.bits = np.unpackbits(data).tobytes().translate(
            bytes.maketrans(b'\0\1', b'01')).decode() + '0' * 32
        self.n, self.pos = 8 * data.size, 0

    def code(self, table, longest: int):
        if self.pos >= self.n:
            _check(-2, "CCITT")
        for k in range(1, longest + 1):
            value = table.get(self.bits[self.pos:self.pos + k])
            if value is not None:
                self.pos += k
                return value
        _check(-2, "CCITT")

    def run(self, black: bool) -> int:
        total = 0
        while True:
            r = self.code(_RUNS[black], 13)
            total += r
            if r < 64:
                return total


def _row_1d(br: _Bits, width: int) -> list:
    changes, pos, black = [], 0, False
    while True:
        pos += br.run(black)
        if pos > width:
            _check(-2, "CCITT")
        if pos == width:
            return changes
        changes.append(pos)
        black = not black


def _row_2d(br: _Bits, width: int, ref: list) -> list:
    ref = ref + [width] * 3
    changes, a0, color, j = [], -1, 0, 0
    while a0 < width:
        j = max(j - 1, 0)
        while ref[j] <= a0 or j % 2 != color:
            j += 1
        b1, b2 = ref[j], ref[j + 1]
        mode = br.code(_MODES, 7)
        if mode == 'P':
            a0 = b2
            continue
        if mode == 'H':
            r1 = br.run(color == 1)
            r2 = br.run(color == 0)
            a1 = max(a0, 0) + r1
            new = [x for x in (a1, a1 + r2) if x < width]
            if a1 + r2 > width or len(changes) + len(new) > width:
                _check(-2, "CCITT")
            changes += new
            a0 = a1 + r2
            continue
        a1 = b1 + mode
        if a1 < max(a0, 0) or a1 > width or (a1 < width
                                             and len(changes) >= width):
            _check(-2, "CCITT")
        if a1 < width:
            changes.append(a1)
        a0, color = a1, 1 - color
    return changes


def _check_ccitt(data, rows: int, width: int, compression: int) -> np.ndarray:
    if rows < 0 or not 1 <= width <= 1 << 30 or compression not in (2, 3, 4):
        raise ValueError(f"bad CCITT layout: {rows} rows of {width} "
                         f"pixels, compression {compression}")
    return _src(data)


def ccitt_decode(data, rows: int, width: int, compression: int,
                 options: int = 0) -> np.ndarray:
    """Decode one CCITT strip or tile (TIFF compression 2, 3 with
    T4Options ``options``, or 4), in C: (rows, (width + 7) // 8) packed
    rows, MSB-first, 1 for black."""
    src = _check_ccitt(data, rows, width, compression)
    out = np.empty((rows, (width + 7) // 8), np.uint8)
    _check(lib().ccitt_decode(src.ctypes.data, src.size, out.ctypes.data,
                              rows, width, compression, options), "CCITT")
    return out


def ccitt_decode_plain(data, rows: int, width: int, compression: int,
                       options: int = 0) -> np.ndarray:
    """:func:`ccitt_decode` in Python."""
    br = _Bits(_check_ccitt(data, rows, width, compression))
    out = np.zeros((rows, width + 7 & ~7), np.uint8)
    ref = []
    for r in range(rows):
        two_d = compression == 4
        if compression == 3:
            while br.bits[br.pos:br.pos + 11] != '0' * 11:  # SYNC_EOL
                br.pos += 1
                if br.pos >= br.n:
                    _check(-2, "CCITT")
            while br.bits[br.pos] == '0':
                br.pos += 1
                if br.pos >= br.n:
                    _check(-2, "CCITT")
            br.pos += 1
            if options & 1:
                if br.pos >= br.n:
                    _check(-2, "CCITT")
                two_d = br.bits[br.pos] == '0'
                br.pos += 1
        ref = _row_2d(br, width, ref) if two_d else _row_1d(br, width)
        if compression == 2:
            br.pos = (br.pos + 7) & ~7
        for x0, x1 in zip(ref[::2], ref[1::2] + [width]):
            out[r, x0:x1] = 1
    return np.packbits(out, axis=1)


# ---------------------------------------------------------------- BMP RLE

def _check_rle(data, width: int, height: int, bits: int) -> np.ndarray:
    if width < 1 or height < 1 or bits not in (4, 8):
        raise ValueError(f"bad BMP RLE layout: {width} x {height}, {bits} "
                         "bits")
    return _src(data)


def bmp_rle_decode(data, width: int, height: int, bits: int) -> np.ndarray:
    """Decode BI_RLE8 (``bits`` 8) or BI_RLE4 (4) pixel data, in C:
    (height, width) palette indices, rows in the file's order."""
    src = _check_rle(data, width, height, bits)
    out = np.empty((height, width), np.uint8)
    _check(lib().bmp_rle_decode(src.ctypes.data, src.size, out.ctypes.data,
                                width, height, bits), "BMP RLE")
    return out


def bmp_rle_decode_plain(data, width: int, height: int,
                         bits: int) -> np.ndarray:
    """:func:`bmp_rle_decode` in Python."""
    src = bytes(_check_rle(data, width, height, bits))
    out = np.empty((height, width), np.uint8)
    y = x = i = 0
    line_end_flag = False

    def fill(count, value):
        # OpenCV's FillUniColor: row by row, at least one pass, a row
        # filled to its end moves on to the next
        nonlocal y, x
        while True:
            k = min(width - x, count)
            out[y, x:x + k] = value
            x += k
            count -= k
            if x >= width:
                x, y = 0, y + 1
                if y >= height:
                    return
            if count <= 0:
                return

    while True:
        if i + 2 > len(src):
            _check(-2, "BMP RLE")
        n, code = src[i], src[i + 1]
        i += 2
        if n:
            if x + n > width:
                _check(-2, "BMP RLE")
            if bits == 8:
                prev_y = y
                fill(n, code)
                line_end_flag = y != prev_y
                if y >= height:
                    return out
            else:
                out[y, x:x + n] = np.resize([code >> 4, code & 15], n)
                x += n
        elif code > 2:
            size = ((code + 1) & ~1 if bits == 8
                    else (((code + 1) >> 1) + 1) & ~1)
            if x + code > width or i + size > len(src):
                _check(-2, "BMP RLE")
            if bits == 8:
                out[y, x:x + code] = np.frombuffer(src, np.uint8, code, i)
            else:
                packed = np.frombuffer(src, np.uint8, (code + 1) // 2, i)
                out[y, x:x + code] = np.stack(
                    [packed >> 4, packed & 15], 1).reshape(-1)[:code]
            i += size
            x += code
            line_end_flag = False
        else:
            dx, dy = width - x, height - y
            if bits == 4 or code or not line_end_flag or dx < width:
                if code == 2:
                    if i + 2 > len(src):
                        _check(-2, "BMP RLE")
                    dx, dy = src[i], src[i + 1]
                    i += 2
                # RLE4: EOF ends the row as EOL does, a delta moves right
                fill(dx + (dy * width if bits == 8 and code else 0), 0)
            line_end_flag = False
            if y >= height:
                return out
