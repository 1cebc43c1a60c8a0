"""Zarr storage without tensorstore: metadata, chunk writers, a reader.

The counterpart of the JAX package's ``io/zarr_store.py`` (tensorstore's
zarr v2 store) and ``io/raw_zarr.py::RawV2SlabWriter``: zarr v2 arrays
with ``/``-separated chunk keys and fill value 0, their chunks either
raw (``compressor: null``) or blosc of any codec (``io/blosc.py``).
``.zarray`` carries the fields tensorstore writes, so either package's
output opens with either reader. The zarr v3 shard writers are in
``io/zarr_shard.py``.

- :class:`RawZarrArray`: a raw chunk body is the C-order bytes of a full
  chunk; edge chunks are zero-padded to the full chunk size, and rows a
  write never touches stay sparse file zeros, which read as the fill
  value. Writes are synchronous, from the caller's thread: a slab's rows
  as one ``pwritev`` of the strided rows and a shared zero pad
  (``csrc/hostops.c::write_rows_contig``, as the JAX raw writer), or
  packed and written O_DIRECT where ``io/directio.py`` decides so (same
  bytes); a chunk-column block (``try_write_block``) as one contiguous
  ``pwrite`` a chunk file, from any thread.
- :class:`BloscZarrArray` (blosc chunks of any cname, clevel and
  shuffle, or raw chunks that span several planes): rows are copied into
  a buffer per chunk row of a chunk group (:class:`ChunkRowBuffer`; a
  group is the planes that share chunk files), so the caller's slab may
  change as soon as the call returns; once every plane of the group has
  written or passed each row of a chunk row (or the array is flushed),
  each of its chunks is encoded once on an :class:`EncodePool` thread and
  written as one file. A chunk equal to the fill value is not stored, as
  tensorstore stores none.

:func:`open_array` opens raw and blosc arrays (every codec, byte or bit
shuffle) of either format for windowed reads, which decode only the
chunks a window touches; :func:`read_array` decodes a whole array.
"""

from __future__ import annotations

import collections
import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Sequence, Set, Tuple

import numpy as np

from ..utils.profiling import carry, span
from . import blosc

_DTYPE_TO_ZARR = {
    np.dtype('uint8'): '|u1', np.dtype('int8'): '|i1',
    np.dtype('uint16'): '<u2', np.dtype('int16'): '<i2',
    np.dtype('uint32'): '<u4', np.dtype('int32'): '<i4',
    np.dtype('uint64'): '<u8', np.dtype('int64'): '<i8',
    np.dtype('float32'): '<f4', np.dtype('float64'): '<f8',
}
_ZARR_TO_DTYPE = {v: k for k, v in _DTYPE_TO_ZARR.items()}

#: the JAX writer's backpressure window for asynchronous chunk writes
DEFAULT_MAX_PENDING_BYTES = 512 << 20


def zarr_dtype_str(dtype) -> str:
    return _DTYPE_TO_ZARR[np.dtype(dtype)]


def fill_value(dtype):
    """The fill value 0 as tensorstore records it: 0.0 for a float
    dtype, 0 otherwise."""
    return 0.0 if np.dtype(dtype).kind == 'f' else 0


def clamp_chunks(chunks: Sequence[int], shape: Sequence[int]) -> Tuple[int, ...]:
    """Chunk shape clipped to the array shape (as tensorstore records it)."""
    return tuple(min(int(c), int(s)) if s > 0 else int(c)
                 for c, s in zip(chunks, shape))


def blosc_meta(cname: str, clevel: int, shuffle: int) -> Dict:
    """The zarr v2 ``compressor`` of a blosc array, as tensorstore
    writes it."""
    return {'blocksize': 0, 'clevel': int(clevel), 'cname': cname,
            'id': 'blosc', 'shuffle': int(shuffle)}


def zarray_meta(shape: Sequence[int], chunks: Sequence[int], dtype,
                compressor: Optional[Dict] = None) -> Dict:
    """The ``.zarray`` of a zarr v2 array."""
    return {
        'chunks': list(clamp_chunks(chunks, shape)),
        'compressor': compressor,
        'dimension_separator': '/',
        'dtype': zarr_dtype_str(dtype),
        'fill_value': fill_value(dtype),
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


def write_group(path: str, attrs: Optional[Dict] = None,
                zarr_format: int = 2) -> None:
    """Make ``path`` a zarr group: v2 (.zgroup, and .zattrs if given) or
    v3 (zarr.json, node_type group, the attributes inline)."""
    os.makedirs(path, exist_ok=True)
    if zarr_format == 3:
        meta: Dict = {'zarr_format': 3, 'node_type': 'group'}
        if attrs is not None:
            meta['attributes'] = attrs
        _write_json_atomic(os.path.join(path, 'zarr.json'), meta)
        return
    _write_json_atomic(os.path.join(path, '.zgroup'), {'zarr_format': 2})
    if attrs is not None:
        _write_json_atomic(os.path.join(path, '.zattrs'), attrs)


def _fresh_array_dir(path: str) -> None:
    """Replace any previous array at ``path`` by an empty directory."""
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path)


def _write_file(path: str, data) -> None:
    with span('chunk.write', len(data)), open(path, 'wb') as f:
        f.write(data)


class EncodePool:
    """Threads that encode and write chunks, with the JAX writer's
    backpressure: once ``max_pending_bytes`` of raw chunk bytes are in
    flight, :meth:`submit` waits for the oldest tasks. A failed task
    raises from the :meth:`submit` that waits for it, or from
    :meth:`close`, which waits for every task and re-raises the first
    failure; :meth:`abort` stops it on a failed run. Sized as
    tensorstore sizes its own pool: one thread per CPU this process may
    run on."""

    def __init__(self, max_pending_bytes: int = DEFAULT_MAX_PENDING_BYTES,
                 workers: Optional[int] = None):
        from ..params import _available_cpus
        self.workers = workers or _available_cpus()
        self._pool = ThreadPoolExecutor(self.workers,
                                        thread_name_prefix='zarr-encode')
        self._max = max_pending_bytes
        self._pending: collections.deque = collections.deque()
        self._pending_bytes = 0
        self._lock = threading.Lock()

    def submit(self, nbytes: int, fn: Callable, *args) -> None:
        fut = self._pool.submit(carry(fn), *args)
        drain = []
        with self._lock:
            self._pending.append((fut, nbytes))
            self._pending_bytes += nbytes
            while self._pending_bytes > self._max and self._pending:
                old, n = self._pending.popleft()
                self._pending_bytes -= n
                drain.append(old)
        if drain:
            with span('encode.wait'):
                for old in drain:
                    old.result()

    def close(self) -> None:
        with self._lock:
            pending = [f for f, _ in self._pending]
            self._pending.clear()
            self._pending_bytes = 0
        first = None
        for fut in pending:
            try:
                fut.result()
            except Exception as e:  # every task ends before the first raises
                first = first or e
        self._pool.shutdown(wait=True)
        if first is not None:
            raise first

    def abort(self) -> None:
        """Drop the tasks not yet started, wait for those running and stop
        the threads, raising none of their failures: nothing is written
        once this returns. Safe after :meth:`close` and twice."""
        with self._lock:
            self._pending.clear()
            self._pending_bytes = 0
        self._pool.shutdown(wait=True, cancel_futures=True)


class _RawWriter:
    """Raw chunk bodies written from a plane's rows, buffered or O_DIRECT
    (shared by the v2 chunk writer and the v3 shard writer), and whole
    chunk-column blocks written as one contiguous ``pwrite`` each.

    Buffered rows go out through ``csrc/hostops.c::write_rows_contig``:
    one ``pwritev`` of the strided rows, each followed by a shared zero
    pad up to the chunk pitch, so no chunk body is assembled in memory.
    The library is built when the writer is made; a failed build raises
    (no plain fallback)."""

    path: str
    shape: Tuple[int, ...]
    chunks: Tuple[int, ...]
    dtype: np.dtype
    direct: bool

    def _init_rows(self, direct_io: str, pitch: int, chunk_bytes: int) -> None:
        """The row writer: ``csrc/hostops.c`` and a zero pad of one row
        ``pitch``; O_DIRECT when ``io/directio.use_direct_io`` says so for
        this array's directory and every offset and length this writer
        produces is block-aligned (all are multiples of ``pitch`` or
        ``chunk_bytes``)."""
        from ..native import hostops
        from .directio import ALIGN, AlignedStaging, use_direct_io
        self._lib = hostops()
        self._pad = np.zeros(pitch, np.uint8)
        self.direct = (all(s > 0 and s % ALIGN == 0
                           for s in (pitch, chunk_bytes))
                       and use_direct_io(os.path.dirname(self.path) or '.',
                                         direct_io))
        self._staging = (AlignedStaging(max(pitch, chunk_bytes))
                         if self.direct else None)
        # band threads write level-0 blocks at once; a block the O_DIRECT
        # path refuses falls back to the rows, which share the staging
        self._staging_lock = threading.Lock()

    def _open(self, fpath: str) -> Tuple[int, bool]:
        """(fd, is_direct): O_DIRECT when enabled; a filesystem that
        refuses it (tmpfs) turns it off for good."""
        if self.direct:
            try:
                return os.open(fpath, os.O_WRONLY | os.O_CREAT | os.O_DIRECT,
                               0o644), True
            except OSError:
                self.direct = False
        return os.open(fpath, os.O_WRONLY | os.O_CREAT, 0o644), False

    def _pwrite_rows(self, fd: int, is_direct: bool, plane: np.ndarray,
                     row0: int, col0: int, nrows: int, cols: int,
                     pitch_elems: int, off: int, fpath: str) -> None:
        """Write ``nrows`` rows of ``plane`` (unit-stride columns) from
        (row0, col0), ``cols`` wide and zero-padded to ``pitch_elems``,
        as one contiguous region at byte ``off``."""
        item = self.dtype.itemsize
        if is_direct:
            # packed, then one contiguous pwrite: the JAX package measured
            # a gather straight from strided rows 15-20 % slower on
            # O_DIRECT (the kernel pins and splits every 4 KiB segment)
            from .directio import pwrite_direct
            with self._staging_lock, span('chunk.write',
                                          nrows * pitch_elems * item):
                pwrite_direct(fd, self._staging, plane, self.dtype, row0,
                              col0, nrows, cols * item, pitch_elems * item,
                              off)
            return
        pad = (pitch_elems - cols) * item
        with span('chunk.write', nrows * pitch_elems * item):
            rc = self._lib.write_rows_contig(
                fd, plane.ctypes.data + row0 * plane.strides[0] + col0 * item,
                plane.strides[0], nrows, cols * item,
                self._pad.ctypes.data if pad else None, pad, off)
        if rc < 0:
            raise OSError(int(-rc), os.strerror(int(-rc)), fpath)

    def _check_slab(self, y0: int, x0: int, plane: np.ndarray) -> np.ndarray:
        """``plane`` with unit-stride columns, or ValueError when it does
        not fit at (y0, x0), or x0 is not on a chunk column."""
        h, w = plane.shape
        if (plane.dtype != self.dtype or y0 < 0 or y0 + h > self.shape[3]
                or x0 < 0 or x0 % self.chunks[4] or x0 + w > self.shape[4]):
            raise ValueError(f"slab {plane.shape} {plane.dtype} at ({y0}, "
                             f"{x0}) does not fit {self.shape} {self.dtype}")
        if plane.strides[1] != plane.itemsize:
            plane = np.ascontiguousarray(plane)
        return plane

    def block_spec(self) -> Tuple[int, int]:
        """(chunk_rows, chunk_cols): this writer takes chunk-column blocks
        (:meth:`try_write_block`), each chunk file one contiguous write."""
        return self.chunks[3], self.chunks[4]

    def _block_fits(self, y0: int, cxi: int, block: np.ndarray) -> bool:
        """The block contract of the JAX raw writers
        (``try_write_block``): a C-contiguous (rows, chunk_cols) block of
        the array's dtype, ``y0`` on a chunk row, inside the array's rows
        and chunk columns; page-aligned when the writer is O_DIRECT."""
        cy, cx = self.chunks[3], self.chunks[4]
        rows = block.shape[0] if block.ndim else 0
        if (block.dtype != self.dtype or block.ndim != 2
                or block.shape[1] != cx or not block.flags.c_contiguous
                or y0 % cy != 0 or rows <= 0 or y0 + rows > self.shape[3]
                or cxi < 0 or cxi >= -(-self.shape[4] // cx)):
            return False
        return not (self.direct and block.ctypes.data % 4096 != 0)


def _pwrite_all(fd: int, data, off: int) -> None:
    done = 0
    with span('chunk.write', len(data)):
        while done < len(data):
            done += os.pwrite(fd, data[done:], off + done)


class RawZarrArray(_RawWriter):
    """A raw zarr v2 array, created on construction (any previous array
    at ``path`` is replaced), written by plane slabs or chunk-column
    blocks."""

    def __init__(self, path: str, shape: Sequence[int],
                 chunks: Sequence[int], dtype, direct_io: str = 'auto'):
        self.path = path
        self.shape = tuple(int(s) for s in shape)
        self.chunks = clamp_chunks(chunks, self.shape)
        self.dtype = np.dtype(dtype)
        if len(self.shape) != 5 or self.chunks[:3] != (1, 1, 1):
            raise ValueError("raw zarr arrays written by rows are (T, C, Z, "
                             "Y, X) with one plane per chunk (chunks over "
                             "several planes: BloscZarrArray, cname None)")
        self.chunk_bytes = self.chunks[3] * self.chunks[4] * self.dtype.itemsize
        # every write offset and length is a multiple of the row pitch
        self._init_rows(direct_io, self.chunks[4] * self.dtype.itemsize,
                        self.chunk_bytes)
        _fresh_array_dir(path)
        _write_json_atomic(os.path.join(path, '.zarray'),
                           zarray_meta(self.shape, self.chunks, self.dtype),
                           indent=None)
        self._made_dirs = set()

    def _chunk_file(self, t: int, c: int, z: int, cyi: int, cxi: int) -> str:
        d = os.path.join(self.path, str(t), str(c), str(z), str(cyi))
        if d not in self._made_dirs:
            os.makedirs(d, exist_ok=True)
            self._made_dirs.add(d)
        return os.path.join(d, str(cxi))

    def write_plane_rows(self, t: int, c: int, z: int, y0: int,
                         plane: np.ndarray, x0: int = 0) -> None:
        """Write ``plane`` (h, w) at rows [y0, y0+h), columns [x0, x0+w)
        of plane (t, c, z), ``x0`` on a chunk column. The chunk columns
        that it touches are written over their full width (zeros past
        its last column); chunks are written whole where the rows cover
        them and are sparse-extended otherwise."""
        h, w = plane.shape
        if h == 0 or w == 0:
            return
        plane = self._check_slab(y0, x0, plane)
        cy, cx = self.chunks[3], self.chunks[4]
        pitch = cx * self.dtype.itemsize
        for cyi in range(y0 // cy, (y0 + h - 1) // cy + 1):
            ry0, ry1 = max(y0, cyi * cy), min(y0 + h, (cyi + 1) * cy)
            full_rows = ry1 - ry0 == cy
            for cxi in range(x0 // cx, (x0 + w - 1) // cx + 1):
                gx0, gx1 = cxi * cx, min(x0 + w, (cxi + 1) * cx)
                fpath = self._chunk_file(t, c, z, cyi, cxi)
                fd, is_direct = self._open(fpath)
                try:
                    if not full_rows and os.fstat(fd).st_size < self.chunk_bytes:
                        os.ftruncate(fd, self.chunk_bytes)
                    self._pwrite_rows(fd, is_direct, plane, ry0 - y0,
                                      gx0 - x0, ry1 - ry0, gx1 - gx0, cx,
                                      (ry0 - cyi * cy) * pitch, fpath)
                finally:
                    os.close(fd)

    def try_write_block(self, t: int, c: int, z: int, y0: int, cxi: int,
                        block: np.ndarray) -> bool:
        """Write one chunk-column block: ``block`` is (rows, chunk_cols)
        C-contiguous, canvas rows [y0, y0+rows) of chunk column ``cxi``,
        its columns past the array's width already zero (the bytes a
        chunk file stores). ``y0`` sits on a chunk row; each chunk row of
        the block is contiguous, so each chunk file gets one ``pwrite``,
        and a bottom chunk row the block leaves short is sparse-extended.
        Returns False, writing nothing, for a block outside that contract
        (:meth:`_block_fits`)."""
        if not self._block_fits(y0, cxi, block):
            return False
        cy = self.chunks[3]
        pitch = self.chunks[4] * self.dtype.itemsize
        rows = block.shape[0]
        flat = block.reshape(-1).view(np.uint8).data
        for j, ry0 in enumerate(range(0, rows, cy)):
            nrows = min(cy, rows - ry0)
            fd, _ = self._open(self._chunk_file(t, c, z, y0 // cy + j, cxi))
            try:
                if nrows < cy and os.fstat(fd).st_size < self.chunk_bytes:
                    os.ftruncate(fd, self.chunk_bytes)
                _pwrite_all(fd, flat[ry0 * pitch:(ry0 + nrows) * pitch], 0)
            finally:
                os.close(fd)
        return True


class BufferMeter:
    """The host bytes that a writer's :class:`ChunkRowBuffer` s hold, and
    their peak (one meter shared by every level of a writer)."""

    def __init__(self):
        self.held = 0
        self.peak = 0
        self._lock = threading.Lock()

    def add(self, nbytes: int) -> None:
        with self._lock:
            self.held += nbytes
            self.peak = max(self.peak, self.held)


class ChunkRowBuffer:
    """Plane rows gathered per chunk row of a chunk group until each chunk
    row can be encoded whole. A chunk group is the planes that share
    chunk files: (t // ct, c // cc, z // cz) for chunks (ct, cc, cz, cy,
    cx). ``store(key, row)`` gets ``key`` = (t // ct, c // cc, z // cz,
    cyi), the chunk-grid index of the row's chunks, and ``row``, an owned
    (ncx, ct, cc, cz, cy, cx) array whose chunks are C-contiguous, zero
    where nothing was written (planes and rows past the array's edge
    too, as tensorstore pads edge chunks with the fill value).

    Each plane's rows arrive in order (a write may skip rows): a write
    starting at row y0 settles the plane's rows above y0, written or
    not. A group's chunk row goes to ``store`` once every row of it is
    settled in every plane of the group that lies inside the array (a
    single-plane group: once its rows are written or a write starts
    below it), or at :meth:`flush`. Rows written again after their chunk
    row was stored raise: each chunk is encoded once (no
    read-modify-write). ``meter`` counts the bytes held."""

    def __init__(self, shape: Sequence[int], chunks: Sequence[int], dtype,
                 store: Callable, meter: Optional[BufferMeter] = None):
        self.shape = tuple(shape)
        self.ct, self.cc, self.cz, self.cy, self.cx = chunks
        self.ncx = -(-self.shape[4] // self.cx)
        self.dtype = np.dtype(dtype)
        self._store = store
        self.meter = meter or BufferMeter()
        # group -> {chunk row: (row, settled (ct, cc, cz, rows))}
        self._open: Dict[Tuple[int, int, int],
                         Dict[int, Tuple[np.ndarray, np.ndarray]]] = {}
        self._stored: Dict[Tuple[int, int, int], Set[int]] = {}
        # group -> the first row of each plane's latest write
        self._start: Dict[Tuple[int, int, int], np.ndarray] = {}

    def _new_row(self, group, cyi: int) -> Tuple[np.ndarray, np.ndarray]:
        ct, cc, cz, cy = self.ct, self.cc, self.cz, self.cy
        row = np.zeros((self.ncx, ct, cc, cz, cy, self.cx), self.dtype)
        settled = np.zeros((ct, cc, cz, min(cy, self.shape[3] - cyi * cy)),
                           bool)
        # planes past the array's edge are never written: they stay zero
        settled[max(0, self.shape[0] - group[0] * ct):] = True
        settled[:, max(0, self.shape[1] - group[1] * cc):] = True
        settled[:, :, max(0, self.shape[2] - group[2] * cz):] = True
        start = self._start[group]
        for plane in zip(*np.nonzero(start > cyi * cy)):
            settled[plane][:start[plane] - cyi * cy] = True
        self.meter.add(row.nbytes)
        return row, settled

    def write(self, t: int, c: int, z: int, y0: int,
              plane: np.ndarray) -> None:
        h, w = plane.shape
        if h == 0 or w == 0:
            return
        if (plane.dtype != self.dtype or y0 < 0 or y0 + h > self.shape[3]
                or w > self.shape[4]):
            raise ValueError(f"slab {plane.shape} {plane.dtype} at row {y0} "
                             f"does not fit {self.shape} {self.dtype}")
        cy, cx = self.cy, self.cx
        group = (t // self.ct, c // self.cc, z // self.cz)
        local = (t % self.ct, c % self.cc, z % self.cz)
        rows = self._open.setdefault(group, {})
        stored = self._stored.setdefault(group, set())
        start = self._start.setdefault(
            group, np.zeros((self.ct, self.cc, self.cz), np.int64))
        start[local] = max(start[local], y0)
        # this plane's rows above y0 are settled
        for cyi in sorted(rows):
            settled = rows[cyi][1][local]
            settled[:max(0, start[local] - cyi * cy)] = True
            if rows[cyi][1].all():
                self._emit(group, cyi)
        for cyi in range(y0 // cy, (y0 + h - 1) // cy + 1):
            if cyi in stored:
                raise ValueError(f"rows of chunk row {cyi} of plane "
                                 f"{(t, c, z)} written after it was encoded")
            if cyi not in rows:
                rows[cyi] = self._new_row(group, cyi)
            row, settled = rows[cyi]
            ry0, ry1 = max(y0, cyi * cy), min(y0 + h, (cyi + 1) * cy)
            for cxi in range((w - 1) // cx + 1):
                x0, x1 = cxi * cx, min(w, (cxi + 1) * cx)
                row[(cxi,) + local + (slice(ry0 - cyi * cy, ry1 - cyi * cy),
                                      slice(0, x1 - x0))] = \
                    plane[ry0 - y0:ry1 - y0, x0:x1]
            settled[local][ry0 - cyi * cy:ry1 - cyi * cy] = True
            if settled.all():
                self._emit(group, cyi)

    def _emit(self, group, cyi: int) -> None:
        row, _ = self._open[group].pop(cyi)
        self._stored[group].add(cyi)
        self.meter.add(-row.nbytes)
        self._store(group + (cyi,), row)

    def flush(self, t: Optional[int] = None, z: Optional[int] = None
              ) -> None:
        """Store every open chunk row, or with ``t`` (and ``z``) given
        those of the chunk groups that hold T index ``t`` (and plane
        ``z``): the caller has written every row it will write there."""
        for group in sorted(self._open):
            if ((t is None or group[0] == t // self.ct)
                    and (z is None or group[2] == z // self.cz)):
                for cyi in sorted(self._open[group]):
                    self._emit(group, cyi)


class BloscZarrArray:
    """A zarr v2 array whose chunks are gathered whole and then encoded
    once: blosc (codec ``cname``, ``clevel``, ``shuffle``), or with
    ``cname`` None raw (the C-order bytes of the chunk). Created on
    construction (any previous array at ``path`` is replaced), written by
    plane slabs through a :class:`ChunkRowBuffer`; each chunk is encoded
    and written on ``pool``, and a chunk equal to the fill value is not
    stored, as tensorstore stores none. Raw arrays take this path when a
    chunk spans several planes (:class:`RawZarrArray` writes one-plane
    chunks from the rows); their files are written buffered, never
    O_DIRECT. :meth:`flush` hands over what is buffered; the owner closes
    the pool."""

    def __init__(self, path: str, shape: Sequence[int],
                 chunks: Sequence[int], dtype, pool: EncodePool,
                 clevel: int = 5, shuffle: int = 1,
                 cname: Optional[str] = 'lz4',
                 meter: Optional[BufferMeter] = None):
        self.path = path
        self.shape = tuple(int(s) for s in shape)
        self.chunks = clamp_chunks(chunks, self.shape)
        self.dtype = np.dtype(dtype)
        if len(self.shape) != 5:
            raise ValueError("zarr arrays are (T, C, Z, Y, X)")
        compressor = None
        if cname is not None:
            blosc.check_settings(cname, clevel, shuffle)
            compressor = blosc_meta(cname, clevel, shuffle)
        # build the codecs (and the zero test) now: a missing compiler
        # raises here
        blosc.lib()
        self.cname, self.clevel, self.shuffle = cname, int(clevel), int(shuffle)
        self.pool = pool
        _fresh_array_dir(path)
        _write_json_atomic(
            os.path.join(path, '.zarray'),
            zarray_meta(self.shape, self.chunks, self.dtype, compressor),
            indent=None)
        self.rows = ChunkRowBuffer(self.shape, self.chunks, self.dtype,
                                   self._store_row, meter)

    def write_plane_rows(self, t: int, c: int, z: int, y0: int,
                         plane: np.ndarray) -> None:
        self.rows.write(t, c, z, y0, plane)

    def flush(self) -> None:
        self.rows.flush()

    def _store_row(self, key, row: np.ndarray) -> None:
        d = os.path.join(self.path, *map(str, key))
        for cxi in range(row.shape[0]):
            self.pool.submit(row[cxi].nbytes, self._store_chunk,
                             os.path.join(d, str(cxi)), row[cxi])

    def _store_chunk(self, fpath: str, chunk: np.ndarray) -> None:
        if blosc.all_zero(chunk):
            return   # equal to the fill value: not stored
        if self.cname is None:
            frame = chunk.reshape(-1).view(np.uint8).data
        else:
            with span('chunk.encode', chunk.nbytes):
                frame = blosc.compress(chunk, self.dtype.itemsize,
                                       self.clevel, self.shuffle, self.cname)
        os.makedirs(os.path.dirname(fpath), exist_ok=True)
        _write_file(fpath, frame)


# ------------------------------------------------------------------ reading

def _pread_exact(fd: int, n: int, off: int, into: np.ndarray,
                 fpath: str) -> None:
    """Fill the uint8 array ``into`` (``n`` bytes) from byte ``off``."""
    view = memoryview(into).cast('B')
    done = 0
    while done < n:
        got = os.preadv(fd, [view[done:n]], off + done)
        if got <= 0:
            raise ValueError(f"{fpath}: {n} bytes expected at {off}, the "
                             f"file ends after {done}")
        done += got


def _raw_window(fpath: str, base: int, chunk_shape, dtype,
                box: Tuple[slice, ...]) -> np.ndarray:
    """The ``box`` of one raw C-order chunk stored at byte ``base`` of
    ``fpath``: only the bytes from the box's first element to its last
    are read."""
    first = int(np.ravel_multi_index([s.start for s in box], chunk_shape))
    last = int(np.ravel_multi_index([s.stop - 1 for s in box], chunk_shape))
    flat = np.empty(int(np.prod(chunk_shape)), dtype)
    item = flat.itemsize
    fd = os.open(fpath, os.O_RDONLY)
    try:
        _pread_exact(fd, (last + 1 - first) * item, base + first * item,
                     flat[first:last + 1].view(np.uint8), fpath)
    finally:
        os.close(fd)
    return flat.reshape(chunk_shape)[box]


def _normalize(sel, shape) -> Tuple[Tuple[slice, ...], tuple]:
    """(bounding box of step-1 slices, index applied to the box after
    the read) for a basic NumPy selection (ints, slices, Ellipsis)."""
    if not isinstance(sel, tuple):
        sel = (sel,)
    if sum(s is Ellipsis for s in sel) > 1:
        raise IndexError("an index can only have a single ellipsis")
    if Ellipsis in sel:
        k = sel.index(Ellipsis)
        sel = sel[:k] + (slice(None),) * (len(shape) - len(sel) + 1) \
            + sel[k + 1:]
    if len(sel) > len(shape):
        raise IndexError(f"too many indices for an array of {len(shape)} "
                         "dimensions")
    sel = sel + (slice(None),) * (len(shape) - len(sel))
    box, post = [], []
    for s, n in zip(sel, shape):
        if isinstance(s, slice):
            start, stop, step = s.indices(n)
            if step < 0:
                raise IndexError("negative steps are not read")
            stop = max(start, stop)
            box.append(slice(start, stop))
            post.append(slice(0, stop - start, step))
        else:
            i = int(s)
            if not -n <= i < n:
                raise IndexError(f"index {i} is out of bounds for an axis "
                                 f"of {n}")
            i %= n
            box.append(slice(i, i + 1))
            post.append(0)
    return tuple(box), tuple(post)


class ZarrArray:
    """A zarr array opened for windowed reads: v2 (raw or blosc, '/' or
    '.' chunk keys) or v3 (raw or blosc chunks, sharded or not).
    ``arr[sel]`` / :meth:`read` decode only the chunks the selection
    touches; of a raw chunk only the bytes between the window's first
    and last element are read; of a shard, its index and then the inner
    chunks the window touches. A chunk (or shard, or inner chunk) that is
    not stored reads as the fill value. ``chunks`` is the read chunk:
    the inner chunk of a sharded array."""

    def __init__(self, path: str):
        self.path = path
        v3 = os.path.join(path, 'zarr.json')
        if os.path.exists(v3):
            with open(v3) as f:
                self._init_v3(json.load(f))
        else:
            with open(os.path.join(path, '.zarray')) as f:
                self._init_v2(json.load(f))
        self.ndim = len(self.shape)

    def _init_v2(self, meta: Dict) -> None:
        comp = meta.get('compressor')
        if meta.get('filters') or (comp is not None
                                   and comp.get('id') != 'blosc'):
            raise NotImplementedError(f"{self.path}: only raw and blosc zarr "
                                      "v2 arrays are read")
        if meta['dtype'] not in _ZARR_TO_DTYPE:
            raise NotImplementedError(f"{self.path}: dtype {meta['dtype']}")
        if meta.get('order', 'C') != 'C':
            raise NotImplementedError(f"{self.path}: Fortran-order chunks")
        self.zarr_format = 2
        self.shape = tuple(int(s) for s in meta['shape'])
        self.chunks = tuple(int(c) for c in meta['chunks'])
        self.dtype = _ZARR_TO_DTYPE[meta['dtype']]
        self.fill_value = meta.get('fill_value') or 0
        self._blosc = comp is not None
        self._sep = meta.get('dimension_separator') or '.'
        self._grid = self.chunks
        self._shard = None

    def _init_v3(self, meta: Dict) -> None:
        self.zarr_format = 3
        self.shape = tuple(int(s) for s in meta['shape'])
        self.dtype = np.dtype(meta['data_type'])
        self.fill_value = meta.get('fill_value') or 0
        enc = meta.get('chunk_key_encoding', {'name': 'default'})
        if enc.get('name', 'default') != 'default':
            raise NotImplementedError(f"{self.path}: chunk key encoding "
                                      f"{enc.get('name')}")
        self._sep = enc.get('configuration', {}).get('separator', '/')
        self._grid = tuple(int(c) for c in
                           meta['chunk_grid']['configuration']['chunk_shape'])
        codecs = meta['codecs']
        if codecs[0]['name'] == 'sharding_indexed':
            cfg = codecs[0]['configuration']
            if cfg.get('index_location', 'end') != 'end':
                raise NotImplementedError("shard index at the start")
            names = [c['name'] for c in cfg['index_codecs']]
            if names != ['bytes', 'crc32c']:
                raise NotImplementedError(f"shard index codecs {names}")
            self._shard = cfg
            self.chunks = tuple(int(c) for c in cfg['chunk_shape'])
            codecs = cfg['codecs']
        else:
            self._shard = None
            self.chunks = self._grid
        names = [c['name'] for c in codecs]
        if names not in (['bytes'], ['bytes', 'blosc']):
            raise NotImplementedError(f"zarr v3 codecs {names} are not read")
        if (self.dtype.itemsize > 1 and codecs[0].get('configuration', {})
                .get('endian', 'little') != 'little'):
            raise NotImplementedError(f"{self.path}: big-endian chunks")
        self._blosc = len(names) == 2

    def __getitem__(self, sel) -> np.ndarray:
        return self.read(sel)

    def read(self, sel=Ellipsis, out: Optional[np.ndarray] = None
             ) -> np.ndarray:
        """The selection (ints, step slices, Ellipsis) as a new array, or
        written into ``out`` (the window's shape, any strides; integer
        indices keep their axis there) and returned."""
        box, post = _normalize(sel, self.shape)
        want = tuple(s.stop - s.start for s in box)
        if out is None:
            buf = np.empty(want, self.dtype)
        else:
            if tuple(out.shape) != want or out.dtype != self.dtype:
                raise ValueError(f"out is {out.shape} {out.dtype}, the "
                                 f"window {want} {self.dtype}")
            buf = out
        if all(want):
            for idx in np.ndindex(*((s.stop - 1) // g - s.start // g + 1
                                    for s, g in zip(box, self._grid))):
                key = tuple(s.start // g + i
                            for s, g, i in zip(box, self._grid, idx))
                self._read_grid_cell(key, box, buf)
        return buf if out is not None else buf[post]

    def _clip(self, origin, size, box):
        """(window slices inside a block at ``origin`` of ``size``, the
        same window relative to ``box``), or None when they miss."""
        inner, dst = [], []
        for o, n, s in zip(origin, size, box):
            a, b = max(o, s.start), min(o + n, s.stop)
            if a >= b:
                return None
            inner.append(slice(a - o, b - o))
            dst.append(slice(a - s.start, b - s.start))
        return tuple(inner), tuple(dst)

    def _read_grid_cell(self, key, box, buf: np.ndarray) -> None:
        """Fill the part of ``buf`` that grid cell ``key`` (a chunk, or a
        shard) covers."""
        origin = tuple(k * g for k, g in zip(key, self._grid))
        if self.zarr_format == 2:
            fpath = os.path.join(self.path, self._sep.join(map(str, key)))
        else:
            fpath = os.path.join(self.path, 'c' + self._sep
                                 + self._sep.join(map(str, key)))
        if not os.path.exists(fpath):
            hit = self._clip(origin, self._grid, box)
            if hit is not None:
                buf[hit[1]] = self.fill_value
            return
        if self._shard is None:
            self._read_chunk(fpath, 0, None, origin, box, buf)
        else:
            self._read_shard(fpath, origin, box, buf)

    def _read_chunk(self, fpath: str, base: int, nbytes: Optional[int],
                    origin, box, buf: np.ndarray) -> None:
        """One stored chunk at byte ``base`` of ``fpath`` (``nbytes``
        long, or the whole file), the part inside ``box``."""
        hit = self._clip(origin, self.chunks, box)
        if hit is None:
            return
        inner, dst = hit
        if not self._blosc:
            buf[dst] = _raw_window(fpath, base, self.chunks, self.dtype,
                                   inner)
            return
        with open(fpath, 'rb') as f:
            f.seek(base)
            frame = f.read() if nbytes is None else f.read(nbytes)
        chunk = np.empty(self.chunks, self.dtype)
        blosc.decompress(frame, chunk.reshape(-1).view(np.uint8))
        buf[dst] = chunk[inner]

    def _read_shard(self, fpath: str, origin, box, buf: np.ndarray) -> None:
        import struct
        from .zarr_shard import MISSING, crc32c
        inner_grid = [-(-s // c) for s, c in zip(self._grid, self.chunks)]
        n = int(np.prod(inner_grid))
        size = os.path.getsize(fpath)
        if size < 16 * n + 4:
            raise ValueError(f"{fpath}: shard index is truncated")
        idx = np.empty(16 * n + 4, np.uint8)
        fd = os.open(fpath, os.O_RDONLY)
        try:
            _pread_exact(fd, idx.size, size - idx.size, idx, fpath)
        finally:
            os.close(fd)
        raw = idx.tobytes()
        if struct.unpack('<I', raw[-4:])[0] != crc32c(raw[:-4]):
            raise ValueError(f"{fpath}: shard index fails its CRC-32C")
        for lin, pos in enumerate(np.ndindex(*inner_grid)):
            corner = tuple(o + p * c
                           for o, p, c in zip(origin, pos, self.chunks))
            hit = self._clip(corner, self.chunks, box)
            if hit is None:
                continue
            off, nbytes = struct.unpack_from('<QQ', raw, 16 * lin)
            if off == MISSING and nbytes == MISSING:
                buf[hit[1]] = self.fill_value
                continue
            want = int(np.prod(self.chunks)) * self.dtype.itemsize
            if not self._blosc and nbytes != want:
                raise ValueError(f"{fpath}: raw chunk of {nbytes} bytes, "
                                 f"expected {want}")
            self._read_chunk(fpath, off, nbytes, corner, box, buf)


def open_array(path: str) -> ZarrArray:
    """Open the zarr array at ``path`` for windowed reads."""
    return ZarrArray(path)


def read_array(path: str) -> np.ndarray:
    """Decode a whole zarr array: v2 (raw or blosc, any chunking, '/' or
    '.' keys) or v3 (raw or blosc chunks, sharded or not)."""
    return open_array(path)[...]


def read_attrs(path: str) -> Dict:
    """Group attributes: v2 ``.zattrs``, or v3 ``zarr.json``
    'attributes'."""
    v3 = os.path.join(path, 'zarr.json')
    if os.path.exists(v3) and not os.path.exists(
            os.path.join(path, '.zattrs')):
        with open(v3) as f:
            return json.load(f).get('attributes', {})
    with open(os.path.join(path, '.zattrs')) as f:
        return json.load(f)
