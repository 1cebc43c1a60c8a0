"""Zarr v3 arrays with the ``sharding_indexed`` codec, without tensorstore.

The counterpart of the JAX package's ``io/zarr_store.py::
create_zarr3_sharded_array`` (tensorstore's zarr3 store) and
``io/raw_zarr.py::RawV3ShardWriter``. A shard file holds its inner
chunks' encoded bodies, then an index of one (offset, nbytes) u64 LE pair
per inner chunk of the shard's nominal grid, (2^64-1, 2^64-1) for a chunk
that is not stored, then the CRC-32C of the index. Shards are one chunk
row tall and ``shard_multiple`` chunks wide (the JAX package's Y-thin
layout, which band writes cover whole), as deep as the chunk in T, C
and Z, at ``c/t/c/z/sy/sx`` (chunk-grid indices).

- :class:`RawShardArray` (inner codecs ``bytes``): the JAX raw shard
  writer's layout byte for byte: a shard is created sparse at its full
  size, every inner chunk inside the array present at its C-order
  ordinal, the index written once, and band rows land at known offsets
  (O_DIRECT where ``io/directio.py`` decides so).
- :class:`BloscShardArray` (inner codecs ``bytes`` + ``blosc`` of any
  cname, always byte-shuffled as the JAX package writes them, or raw
  inner chunks that span several planes): rows are gathered per chunk
  row of a chunk group (``zarr_store.ChunkRowBuffer``), each
  chunk is encoded once on an ``EncodePool`` thread, and the last of a
  shard's chunks to finish writes the shard: the bodies of the chunks
  that differ from the fill value, in C order; a shard with none is not
  written, as tensorstore writes none.

``io/zarr_store.py::ZarrArray`` reads both.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import blosc
from .zarr_store import (BufferMeter, ChunkRowBuffer, EncodePool, fill_value,
                         _pwrite_all, _RawWriter, _fresh_array_dir,
                         _write_file, _write_json_atomic, clamp_chunks)

MISSING = 0xFFFFFFFFFFFFFFFF
_CRC32C_TABLE: Optional[List[int]] = None


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the zarr v3 index checksum."""
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        tbl = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
            tbl.append(c)
        _CRC32C_TABLE = tbl
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC32C_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def compute_shard_shape(shape: Sequence[int], chunks: Sequence[int],
                        shard_multiple: int = 16):
    """(clamped inner chunk shape, shard shape): shards are one chunk row
    tall and ``shard_multiple`` chunks wide, clipped to the array and
    kept a multiple of the chunk (the JAX package's rule)."""
    chunks = list(clamp_chunks(chunks, shape))
    shard = list(chunks)
    shard[-1] = min(int(shape[-1]), chunks[-1] * shard_multiple)
    shard[-1] -= shard[-1] % chunks[-1]
    shard[-1] = max(shard[-1], chunks[-1])
    return tuple(chunks), tuple(shard)


def zarr3_array_meta(shape: Sequence[int], chunks: Sequence[int],
                     shard: Sequence[int], dtype,
                     blosc_config: Optional[Dict] = None) -> Dict:
    """The ``zarr.json`` of a sharded array, as tensorstore writes it."""
    dtype = np.dtype(dtype)
    bytes_codec: Dict = {'name': 'bytes'}
    if dtype.itemsize > 1:
        bytes_codec['configuration'] = {'endian': 'little'}
    inner = [bytes_codec]
    if blosc_config is not None:
        inner.append({'configuration': dict(blosc_config,
                                            typesize=dtype.itemsize),
                      'name': 'blosc'})
    return {
        'chunk_grid': {'configuration': {'chunk_shape': list(shard)},
                       'name': 'regular'},
        'chunk_key_encoding': {'name': 'default'},
        'codecs': [{
            'configuration': {
                'chunk_shape': list(chunks),
                'codecs': inner,
                'index_codecs': [
                    {'configuration': {'endian': 'little'}, 'name': 'bytes'},
                    {'name': 'crc32c'}],
            },
            'name': 'sharding_indexed'}],
        'data_type': dtype.name,
        'fill_value': fill_value(dtype),
        'node_type': 'array',
        'shape': [int(s) for s in shape],
        'zarr_format': 3,
    }


def index_bytes(entries: Sequence[Tuple[int, int]]) -> bytes:
    """A shard index: (offset, nbytes) pairs, then their CRC-32C."""
    raw = b''.join(struct.pack('<QQ', off, n) for off, n in entries)
    return raw + struct.pack('<I', crc32c(raw))


class _ShardGrid:
    """A (T, C, Z, Y, X) sharded array's directory, metadata and grid."""

    def _init_grid(self, path: str, shape: Sequence[int],
                   chunks: Sequence[int], dtype, shard_multiple: int,
                   blosc_config: Optional[Dict]) -> None:
        self.path = path
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.chunks, self.shard = compute_shard_shape(self.shape, chunks,
                                                      shard_multiple)
        if len(self.shape) != 5:
            raise ValueError("zarr arrays are (T, C, Z, Y, X)")
        self.per_shard = self.shard[4] // self.chunks[4]
        self.chunk_nbytes = (self.chunks[3] * self.chunks[4]
                             * self.dtype.itemsize)
        _fresh_array_dir(path)
        _write_json_atomic(os.path.join(path, 'zarr.json'),
                           zarr3_array_meta(self.shape, self.chunks,
                                            self.shard, self.dtype,
                                            blosc_config), indent=None)
        self._made_dirs = set()

    def _shard_file(self, t: int, c: int, z: int, sy: int, sx: int) -> str:
        d = os.path.join(self.path, 'c', str(t), str(c), str(z), str(sy))
        if d not in self._made_dirs:
            os.makedirs(d, exist_ok=True)
            self._made_dirs.add(d)
        return os.path.join(d, str(sx))

    def _chunks_in_array(self, sx: int) -> int:
        """How many of shard column ``sx``'s inner chunks start inside
        the array."""
        x0 = sx * self.shard[4]
        return min(self.per_shard, -(-(self.shape[4] - x0) // self.chunks[4]))


class RawShardArray(_ShardGrid, _RawWriter):
    """A raw (inner codecs ``bytes``) sharded zarr v3 array, written by
    plane slabs or chunk-column blocks straight into its shard files."""

    def __init__(self, path: str, shape: Sequence[int],
                 chunks: Sequence[int], dtype, shard_multiple: int = 16,
                 direct_io: str = 'auto'):
        self.path = path
        self.dtype = np.dtype(dtype)
        chunks = clamp_chunks(chunks, shape)
        if tuple(chunks[:3]) != (1, 1, 1):
            raise ValueError("raw shards written by rows hold one plane per "
                             "chunk (chunks over several planes: "
                             "BloscShardArray, cname None)")
        # body offsets are ordinal * chunk_nbytes + k * pitch
        self._init_rows(direct_io, chunks[4] * self.dtype.itemsize,
                        chunks[3] * chunks[4] * self.dtype.itemsize)
        self._init_grid(path, shape, chunks, dtype, shard_multiple, None)

    def _ensure_shard(self, fd: int, present: int) -> None:
        """Size a new shard and write its index: ``present`` bodies, the
        rest of the nominal grid missing."""
        index_offset = present * self.chunk_nbytes
        total = index_offset + 16 * self.per_shard + 4
        if os.fstat(fd).st_size >= total:
            return
        os.ftruncate(fd, total)
        idx = index_bytes([(k * self.chunk_nbytes, self.chunk_nbytes)
                           if k < present else (MISSING, MISSING)
                           for k in range(self.per_shard)])
        _pwrite_all(fd, idx, index_offset)

    def _open_shard(self, t: int, c: int, z: int, sy: int,
                    sx: int) -> Tuple[int, bool, str]:
        """(fd, is_direct, path) of a shard, sized with its index written
        (through a plain fd when the bodies go O_DIRECT: the index is
        byte-grained)."""
        fpath = self._shard_file(t, c, z, sy, sx)
        present = self._chunks_in_array(sx)
        if self.direct:
            pfd = os.open(fpath, os.O_WRONLY | os.O_CREAT, 0o644)
            try:
                self._ensure_shard(pfd, present)
            finally:
                os.close(pfd)
        fd, is_direct = self._open(fpath)
        if not is_direct:
            try:
                self._ensure_shard(fd, present)
            except BaseException:
                os.close(fd)
                raise
        return fd, is_direct, fpath

    def write_plane_rows(self, t: int, c: int, z: int, y0: int,
                         plane: np.ndarray, x0: int = 0) -> None:
        """Write ``plane`` (h, w) at rows [y0, y0+h), columns [x0, x0+w)
        of plane (t, c, z), ``x0`` on a chunk column; the inner chunks
        that it touches are written over their full width (zeros past
        its last column)."""
        h, w = plane.shape
        if h == 0 or w == 0:
            return
        plane = self._check_slab(y0, x0, plane)
        cy, cx = self.chunks[3], self.chunks[4]
        pitch = cx * self.dtype.itemsize
        for sy in range(y0 // cy, (y0 + h - 1) // cy + 1):
            ry0, ry1 = max(y0, sy * cy), min(y0 + h, (sy + 1) * cy)
            for sx in range(x0 // self.shard[4],
                            (x0 + w - 1) // self.shard[4] + 1):
                fd, is_direct, fpath = self._open_shard(t, c, z, sy, sx)
                try:
                    for k in range(self._chunks_in_array(sx)):
                        gx0 = sx * self.shard[4] + k * cx
                        if gx0 < x0:
                            continue
                        if gx0 >= x0 + w:
                            break
                        self._pwrite_rows(
                            fd, is_direct, plane, ry0 - y0, gx0 - x0,
                            ry1 - ry0, min(x0 + w, gx0 + cx) - gx0, cx,
                            k * self.chunk_nbytes + (ry0 - sy * cy) * pitch,
                            fpath)
                finally:
                    os.close(fd)

    def try_write_block(self, t: int, c: int, z: int, y0: int, cxi: int,
                        block: np.ndarray) -> bool:
        """The v3 twin of ``RawZarrArray.try_write_block`` (same contract
        and refusals): each chunk row of the block lands as one
        contiguous write at its inner chunk's ordinal in its shard, the
        shard sized and its index written as the row path writes them."""
        if not self._block_fits(y0, cxi, block):
            return False
        cy = self.chunks[3]
        sx, k = divmod(cxi, self.per_shard)
        rows = block.shape[0]
        flat = block.reshape(-1).view(np.uint8).data
        pitch = self.chunks[4] * self.dtype.itemsize
        for ry0 in range(0, rows, cy):
            nrows = min(cy, rows - ry0)
            fd, _, _ = self._open_shard(t, c, z, (y0 + ry0) // cy, sx)
            try:
                _pwrite_all(fd, flat[ry0 * pitch:(ry0 + nrows) * pitch],
                            k * self.chunk_nbytes)
            finally:
                os.close(fd)
        return True


class BloscShardArray(_ShardGrid):
    """A sharded zarr v3 array whose inner chunks are gathered whole and
    then encoded once: blosc (codec ``cname``, ``clevel``), or with
    ``cname`` None raw (inner codecs ``bytes``; raw arrays take this path
    when a chunk spans several planes). Written by plane slabs through a
    ``ChunkRowBuffer``, its chunks encoded on ``pool``. Blosc chunks are
    byte-shuffled whatever the run's ``compressor_shuffle``: the JAX
    package's v3 metadata always says ``'shuffle': 'shuffle'``."""

    def __init__(self, path: str, shape: Sequence[int],
                 chunks: Sequence[int], dtype, pool: EncodePool,
                 shard_multiple: int = 16, clevel: int = 5,
                 cname: Optional[str] = 'lz4',
                 meter: Optional[BufferMeter] = None):
        config = None
        if cname is not None:
            blosc.check_settings(cname, clevel, 1)
            config = {'blocksize': 0, 'clevel': int(clevel), 'cname': cname,
                      'shuffle': 'shuffle'}
        blosc.lib()   # build the codecs now: a missing compiler raises here
        self.cname, self.clevel = cname, int(clevel)
        self._init_grid(path, shape, chunks, dtype, shard_multiple, config)
        self.pool = pool
        self.rows = ChunkRowBuffer(self.shape, self.chunks, self.dtype,
                                   self._store_row, meter)

    def write_plane_rows(self, t: int, c: int, z: int, y0: int,
                         plane: np.ndarray) -> None:
        self.rows.write(t, c, z, y0, plane)

    def flush(self) -> None:
        self.rows.flush()

    def _store_row(self, key, row: np.ndarray) -> None:
        for sx in range(-(-self.shape[4] // self.shard[4])):
            present = self._chunks_in_array(sx)
            k0 = sx * self.per_shard
            shard = _PendingShard(
                os.path.join(self.path, 'c', *map(str, key), str(sx)),
                self.per_shard, present)
            for k in range(present):
                self.pool.submit(row[k0 + k].nbytes, self._encode, shard, k,
                                 row[k0 + k])

    def _encode(self, shard: '_PendingShard', k: int,
                chunk: np.ndarray) -> None:
        if blosc.all_zero(chunk):
            frame = None
        elif self.cname is None:
            frame = chunk.reshape(-1).view(np.uint8).data
        else:
            frame = blosc.compress(chunk, self.dtype.itemsize, self.clevel, 1,
                                   self.cname)
        shard.done(k, frame)


class _PendingShard:
    """A shard whose chunks are being encoded on several threads; the
    thread that delivers the last one writes the file."""

    def __init__(self, fpath: str, nominal: int, present: int):
        self.fpath = fpath
        self.frames: List = [None] * nominal
        self.left = present
        self._lock = threading.Lock()

    def done(self, k: int, frame) -> None:
        with self._lock:
            self.frames[k] = frame
            self.left -= 1
            if self.left:
                return
        entries, off = [], 0
        for frame in self.frames:
            if frame is None:
                entries.append((MISSING, MISSING))
            else:
                entries.append((off, len(frame)))
                off += len(frame)
        if off == 0:
            return   # every chunk equals the fill value: no shard file
        body = b''.join(bytes(f) for f in self.frames if f is not None)
        os.makedirs(os.path.dirname(self.fpath), exist_ok=True)
        _write_file(self.fpath, body + index_bytes(entries))
