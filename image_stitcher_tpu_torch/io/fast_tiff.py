"""Zero-copy reader for uncompressed TIFF tiles (a copy of the JAX
package's ``io/fast_tiff.py``).

Squid acquisitions store tiles as plain uncompressed strip TIFFs. This
reader handles exactly that case (classic or BigTIFF, uncompressed,
contiguous samples) with a header parse and ``np.frombuffer``, and
returns None for anything else, which ``read_image`` then decodes with
the port's general readers (``io/tiff.py`` for compressed or tiled
TIFF; see ``io/acquisition.py``).
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

# tag ids
_WIDTH, _LENGTH, _BITS, _COMP, _PHOTO = 256, 257, 258, 259, 262
_STRIP_OFFSETS, _SPP, _ROWS_PER_STRIP, _STRIP_COUNTS = 273, 277, 278, 279
_SAMPLE_FORMAT, _PLANAR = 339, 284

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
               10: 8, 11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: 'B', 3: 'H', 4: 'I', 8: 'h', 9: 'i', 16: 'Q', 17: 'q'}


def _read_values(data, bo, ty, count, payload, inline_size):
    size = _TYPE_SIZES.get(ty)
    if size is None or ty not in _TYPE_FMT:
        return None
    total = size * count
    if total <= inline_size:
        raw = payload[:total]
    else:
        off = struct.unpack(bo + ('Q' if inline_size == 8 else 'I'),
                            payload)[0]
        raw = data[off:off + total]
    return struct.unpack(bo + _TYPE_FMT[ty] * count, raw)


def read_tiff_fast(path: str,
                   use_mmap: bool = False,
                   prefetch: bool = False) -> Optional[np.ndarray]:
    """Read an uncompressed striped TIFF; None if the file needs libtiff.

    With ``use_mmap`` the returned array is a zero-copy view over a
    memory-mapped file (contiguous-strip case): no bytes move until the
    caller touches them, so consumers that read only a row band (the
    streaming fuser) or a row decimation (flatfield sampling) pull just
    those pages from the page cache. The mmap stays alive through the
    array's ``.base`` chain. ``prefetch`` additionally kicks off kernel
    readahead for the whole map (madvise WILLNEED) so cold-cache
    consumers that WILL touch most of the file overlap disk I/O with
    their compute instead of stalling on page faults.
    """
    try:
        if use_mmap:
            import mmap as _mmap
            with open(path, 'rb') as f:
                try:
                    data = _mmap.mmap(f.fileno(), 0,
                                      access=_mmap.ACCESS_READ)
                    if prefetch and hasattr(data, 'madvise'):
                        data.madvise(_mmap.MADV_WILLNEED)
                except (ValueError, OSError):
                    data = f.read()  # empty/special file
        else:
            with open(path, 'rb') as f:
                data = f.read()
        if len(data) < 16:
            return None
        if data[:2] == b'II':
            bo = '<'
        elif data[:2] == b'MM':
            bo = '>'
        else:
            return None
        version = struct.unpack(bo + 'H', data[2:4])[0]
        if version == 42:  # classic
            ifd_off = struct.unpack(bo + 'I', data[4:8])[0]
            n_entries = struct.unpack(bo + 'H', data[ifd_off:ifd_off + 2])[0]
            entry_start, entry_size, inline = ifd_off + 2, 12, 4
            count_fmt = 'I'
        elif version == 43:  # BigTIFF
            ifd_off = struct.unpack(bo + 'Q', data[8:16])[0]
            n_entries = struct.unpack(bo + 'Q', data[ifd_off:ifd_off + 8])[0]
            entry_start, entry_size, inline = ifd_off + 8, 20, 8
            count_fmt = 'Q'
        else:
            return None

        tags = {}
        for i in range(n_entries):
            off = entry_start + i * entry_size
            tag, ty = struct.unpack(bo + 'HH', data[off:off + 4])
            count = struct.unpack(bo + count_fmt,
                                  data[off + 4:off + 4 + (8 if inline == 8 else 4)])[0]
            payload = data[off + entry_size - inline:off + entry_size]
            if tag in (_WIDTH, _LENGTH, _BITS, _COMP, _STRIP_OFFSETS, _SPP,
                       _ROWS_PER_STRIP, _STRIP_COUNTS, _SAMPLE_FORMAT,
                       _PLANAR, _PHOTO):
                vals = _read_values(data, bo, ty, count, payload, inline)
                if vals is None:
                    return None
                tags[tag] = vals

        if _WIDTH not in tags or _LENGTH not in tags or _STRIP_OFFSETS not in tags:
            return None
        if tags.get(_COMP, (1,))[0] != 1:
            return None  # compressed -> libtiff
        spp = tags.get(_SPP, (1,))[0]
        if tags.get(_PLANAR, (1,))[0] != 1:
            return None
        bits = tags.get(_BITS, (8,))[0]
        if bits not in (8, 16, 32, 64):
            return None
        sfmt = tags.get(_SAMPLE_FORMAT, (1,))[0]
        base = {1: 'u', 2: 'i', 3: 'f'}.get(sfmt)
        if base is None:
            return None
        dtype = np.dtype(f'{bo}{base}{bits // 8}')

        w = tags[_WIDTH][0]
        h = tags[_LENGTH][0]
        offsets = tags[_STRIP_OFFSETS]
        counts = tags.get(_STRIP_COUNTS)
        row_bytes = w * spp * dtype.itemsize
        expected = h * row_bytes

        # a declared strip must actually HOLD the pixels: a short strip
        # (truncated writer, oversized ImageLength) would otherwise let
        # frombuffer read adjacent file bytes — IFD entries, tag data —
        # as image content instead of falling back. Vectorized: strip-
        # per-2-rows writers (cv2) put ~1k strips per tile, and this
        # check runs on every band-touch re-read of every tile.
        if counts is not None and len(counts) == len(offsets):
            cnt_a = np.asarray(counts, np.int64)
            off_a = np.asarray(offsets, np.int64)
            covered = bool(cnt_a.sum() >= expected)
            contiguous = len(offsets) == 1 and covered or (
                covered
                and bool((off_a[:-1] + cnt_a[:-1] == off_a[1:]).all()))
        else:
            covered = False
            contiguous = len(offsets) == 1 and counts is None
        if contiguous:
            start = offsets[0]
            if start + expected > len(data):
                return None
            arr = np.frombuffer(data, dtype, count=h * w * spp, offset=start)
        else:
            if counts is None or len(counts) != len(offsets):
                return None
            remaining = expected
            parts = []
            for off, cnt in zip(offsets, counts):
                cnt = min(cnt, remaining)
                parts.append(np.frombuffer(data, dtype,
                                           count=cnt // dtype.itemsize,
                                           offset=off))
                remaining -= cnt
            arr = np.concatenate(parts)
            if arr.size != h * w * spp:
                return None
        arr = arr.reshape((h, w) if spp == 1 else (h, w, spp))
        if bo == '>':
            arr = arr.astype(arr.dtype.newbyteorder('='))
        return arr
    except Exception:
        return None


def write_tiff_fast(path: str, img: np.ndarray) -> None:
    """Write a mono plane of 8- to 64-bit unsigned, signed or float
    samples as the tiles this reader takes: a classic little-endian TIFF
    of one uncompressed strip, the pixels after the header (a raw camera
    tile, as Squid saves it), SampleFormat 1, 2 or 3 by the dtype."""
    img = np.ascontiguousarray(img)
    sample_format = {'u': 1, 'i': 2, 'f': 3}.get(img.dtype.kind)
    if (img.ndim != 2 or sample_format is None
            or img.dtype.itemsize not in (1, 2, 4, 8)
            or (sample_format == 3 and img.dtype.itemsize < 4)):
        raise ValueError(f"a mono plane of 8- to 64-bit integer or 32-/64-"
                         f"bit float samples, got {img.shape} {img.dtype}")
    h, w = img.shape
    data_off = 160
    entries = [(_WIDTH, 4, w), (_LENGTH, 4, h),
               (_BITS, 3, img.dtype.itemsize * 8), (_COMP, 3, 1),
               (_PHOTO, 3, 1), (_STRIP_OFFSETS, 4, data_off), (_SPP, 3, 1),
               (_ROWS_PER_STRIP, 4, h), (_STRIP_COUNTS, 4, img.nbytes),
               (_PLANAR, 3, 1), (_SAMPLE_FORMAT, 3, sample_format)]
    head = bytearray(b'II' + struct.pack('<HI', 42, 8))
    head += struct.pack('<H', len(entries))
    for tag, typ, val in entries:
        payload = (struct.pack('<HH', val, 0) if typ == 3
                   else struct.pack('<I', val))
        head += struct.pack('<HHI', tag, typ, 1) + payload
    head += struct.pack('<I', 0)
    with open(path, 'wb') as f:
        f.write(bytes(head.ljust(data_off, b'\0')))
        img.astype(img.dtype.newbyteorder('<'), copy=False).tofile(f)
