"""Zarr v2 storage without tensorstore: metadata JSON and raw chunk files.

The counterpart of the JAX package's ``io/zarr_store.py`` (metadata) and
``io/raw_zarr.py::RawV2SlabWriter`` (chunk bodies), for the one layout the
port writes: uncompressed (``compressor: null``) zarr v2 arrays with
``/``-separated chunk keys and fill value 0. ``.zarray`` carries the same
fields tensorstore writes for ``create_zarr_array(..., cname=None)``, so
either package's output opens with either reader.

A chunk body is the C-order bytes of a full chunk; edge chunks are
zero-padded to the full chunk size, and rows a write never touches stay
sparse file zeros, which read as the fill value.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

_DTYPE_TO_ZARR = {
    np.dtype('uint8'): '|u1', np.dtype('int8'): '|i1',
    np.dtype('uint16'): '<u2', np.dtype('int16'): '<i2',
    np.dtype('uint32'): '<u4', np.dtype('int32'): '<i4',
    np.dtype('uint64'): '<u8', np.dtype('int64'): '<i8',
    np.dtype('float32'): '<f4', np.dtype('float64'): '<f8',
}
_ZARR_TO_DTYPE = {v: k for k, v in _DTYPE_TO_ZARR.items()}


def zarr_dtype_str(dtype) -> str:
    return _DTYPE_TO_ZARR[np.dtype(dtype)]


def clamp_chunks(chunks: Sequence[int], shape: Sequence[int]) -> Tuple[int, ...]:
    """Chunk shape clipped to the array shape (as tensorstore records it)."""
    return tuple(min(int(c), int(s)) if s > 0 else int(c)
                 for c, s in zip(chunks, shape))


def zarray_meta(shape: Sequence[int], chunks: Sequence[int], dtype) -> Dict:
    """The ``.zarray`` of a raw zarr v2 array."""
    return {
        'chunks': list(clamp_chunks(chunks, shape)),
        'compressor': None,
        'dimension_separator': '/',
        'dtype': zarr_dtype_str(dtype),
        'fill_value': 0,
        'filters': None,
        'order': 'C',
        'shape': [int(s) for s in shape],
        'zarr_format': 2,
    }


def _write_json_atomic(path: str, obj, indent: Optional[int] = 4) -> None:
    """tmp + rename, so a reader never sees a torn file."""
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        with open(tmp, 'w') as f:
            if indent is None:
                json.dump(obj, f, separators=(',', ':'), sort_keys=True)
            else:
                json.dump(obj, f, indent=indent)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_group(path: str, attrs: Optional[Dict] = None) -> None:
    """Make ``path`` a zarr v2 group (.zgroup, and .zattrs if given)."""
    os.makedirs(path, exist_ok=True)
    _write_json_atomic(os.path.join(path, '.zgroup'), {'zarr_format': 2})
    if attrs is not None:
        _write_json_atomic(os.path.join(path, '.zattrs'), attrs)


class RawZarrArray:
    """A raw zarr v2 array, created on construction (any previous array
    at ``path`` is replaced), written by plane slabs."""

    def __init__(self, path: str, shape: Sequence[int],
                 chunks: Sequence[int], dtype):
        self.path = path
        self.shape = tuple(int(s) for s in shape)
        self.chunks = clamp_chunks(chunks, self.shape)
        self.dtype = np.dtype(dtype)
        if len(self.shape) != 5 or self.chunks[:3] != (1, 1, 1):
            raise ValueError("raw zarr arrays are (T, C, Z, Y, X) with one "
                             "plane per chunk")
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.makedirs(path)
        _write_json_atomic(os.path.join(path, '.zarray'),
                           zarray_meta(self.shape, self.chunks, self.dtype),
                           indent=None)
        self.chunk_bytes = self.chunks[3] * self.chunks[4] * self.dtype.itemsize
        self._made_dirs = set()

    def _chunk_file(self, t: int, c: int, z: int, cyi: int, cxi: int) -> str:
        d = os.path.join(self.path, str(t), str(c), str(z), str(cyi))
        if d not in self._made_dirs:
            os.makedirs(d, exist_ok=True)
            self._made_dirs.add(d)
        return os.path.join(d, str(cxi))

    def write_plane_rows(self, t: int, c: int, z: int, y0: int,
                         plane: np.ndarray) -> None:
        """Write ``plane`` (h, w) at rows [y0, y0+h), columns [0, w) of
        plane (t, c, z). The chunk columns that [0, w) touches are written
        over their full width (zeros past ``w``); chunks are written whole
        where the rows cover them and are sparse-extended otherwise."""
        h, w = plane.shape
        if h == 0 or w == 0:
            return
        if (plane.dtype != self.dtype or y0 < 0 or y0 + h > self.shape[3]
                or w > self.shape[4]):
            raise ValueError(f"slab {plane.shape} {plane.dtype} at row {y0} "
                             f"does not fit {self.shape} {self.dtype}")
        cy, cx = self.chunks[3], self.chunks[4]
        pitch = cx * self.dtype.itemsize
        for cyi in range(y0 // cy, (y0 + h - 1) // cy + 1):
            ry0, ry1 = max(y0, cyi * cy), min(y0 + h, (cyi + 1) * cy)
            full_rows = ry1 - ry0 == cy
            for cxi in range((w - 1) // cx + 1):
                x0, x1 = cxi * cx, min(w, (cxi + 1) * cx)
                body = np.zeros((ry1 - ry0, cx), self.dtype)
                body[:, :x1 - x0] = plane[ry0 - y0:ry1 - y0, x0:x1]
                fpath = self._chunk_file(t, c, z, cyi, cxi)
                fd = os.open(fpath, os.O_WRONLY | os.O_CREAT, 0o644)
                try:
                    if not full_rows and os.fstat(fd).st_size < self.chunk_bytes:
                        os.ftruncate(fd, self.chunk_bytes)
                    data = memoryview(body).cast('B')
                    off = (ry0 - cyi * cy) * pitch
                    done = 0
                    while done < len(data):
                        done += os.pwrite(fd, data[done:], off + done)
                finally:
                    os.close(fd)


def read_array(path: str) -> np.ndarray:
    """Decode a raw zarr v2 array (any chunking, '/' or '.' keys)."""
    with open(os.path.join(path, '.zarray')) as f:
        meta = json.load(f)
    if meta.get('compressor') is not None or meta.get('filters'):
        raise NotImplementedError(f"{path}: only raw zarr v2 arrays are read")
    shape = tuple(meta['shape'])
    chunks = tuple(meta['chunks'])
    dtype = _ZARR_TO_DTYPE[meta['dtype']]
    sep = meta.get('dimension_separator', '.')
    out = np.full(shape, meta.get('fill_value') or 0, dtype)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*[len(g) for g in grid]):
        fpath = os.path.join(path, sep.join(str(i) for i in idx))
        if not os.path.exists(fpath):
            continue
        body = np.fromfile(fpath, dtype).reshape(chunks)
        sel = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(idx, chunks, shape))
        out[sel] = body[tuple(slice(0, s.stop - s.start) for s in sel)]
    return out
