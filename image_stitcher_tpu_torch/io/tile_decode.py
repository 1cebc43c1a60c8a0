"""Tile decoders: TIFF LZW, PackBits, the TIFF horizontal and
floating-point predictors and PNG row unfiltering.

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

_ERRORS = {-1: "bad arguments", -2: "corrupt data",
           -3: "old-style (LSB-first) LZW", -4: "out of memory"}


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
        _LIB = so
    return _LIB


def _src(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    return np.frombuffer(data, np.uint8)


def _check(rc: int, what: str) -> int:
    if rc < 0:
        if rc == -3:
            raise NotImplementedError(
                "old-style (LSB-first) TIFF LZW is not ported to "
                "image_stitcher_tpu_torch yet (ROADMAP.md, item 6, 'tile "
                "input without OpenCV')")
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
        _check(-3, "TIFF LZW")
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
    if arr.ndim != 2 or arr.dtype != np.uint8 or sample_bytes not in (4, 8) \
            or arr.shape[1] % sample_bytes or spp < 1:
        raise ValueError(f"the floating-point predictor takes (rows, bytes) "
                         f"uint8 rows of whole 4- or 8-byte samples and "
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
