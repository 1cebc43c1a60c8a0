"""The port's blosc codecs against tensorstore's c-blosc, one cname at a
time: shared by ``test_torch_blosc_ts_*.py`` (split by codec so the
files run in parallel).

For a cname, every clevel of {0, 1, 5, 9}, shuffle of {0, 1, 2, -1} and
dtype of u8/u16:
- on a (2048, 2048 + 203) plane in 2048^2 chunks (a full chunk and the
  main path's right edge chunk, zero-padded as both writers pad it):
  the port's writer and tensorstore write the same ``.zarray`` and the
  same chunk files; each port frame's header bytes 0-3 (but the
  memcpyed flag, which says how the body is stored), ``nbytes`` and
  ``blocksize`` equal tensorstore's frame's; the port's C decoder reads
  tensorstore's frames and tensorstore reads the port's array;
- on a small array with odd chunks (block sizes under 32 KiB, a tail
  of elements not a multiple of 8 under bit shuffle): the same, and the
  plain decoder reads tensorstore's frames and the port's, and the C
  frames are byte-equal to the plain version's;
- for blosclz (c-blosc 1.x's entropy-probed encoder), lz4 and lz4hc
  (liblz4's ``LZ4_compress_fast`` and ``LZ4_compress_HC`` rules),
  snappy (snappy 1.2's compressor), zlib
  (Chromium's zlib 1.3.1 deflate) and zstd at clevel 1 to 9 (libzstd
  1.5.7's levels 1, 3, 5, ..., 15 and 22), each whole frame is
  byte-equal to tensorstore's, the memcpyed flag included; for lz4 and lz4hc the C
  frame of a 256-row cut of the plane (streams of liblz4's larger hash,
  and past lz4hc's 64 KiB window) is byte-equal to the plain version's.
"""

import functools
import json
import os
import struct

import numpy as np

from image_stitcher_tpu.io.zarr_store import create_zarr_array, open_zarr_array
from image_stitcher_tpu_torch.io import blosc
from image_stitcher_tpu_torch.io.zarr_store import (BloscZarrArray,
                                                    EncodePool, read_array)

CLEVELS = (0, 1, 5, 9)
#: the clevels whose zstd frames follow libzstd 1.5.7 (levels 1, 3, 5,
#: ..., 15 and 22): all of them
ZSTD_LIB_CLEVELS = (1, 2, 3, 4, 5, 6, 7, 8, 9)
SHUFFLES = (0, 1, 2, -1)
DTYPES = (np.uint8, np.uint16)
TILE, EDGE = 2048, 203


def _texture(rng, shape, dtype):
    """Dark Poisson background, sparse bright blobs, smooth ramps and a
    band of full-entropy rows: long matches, short ones, literals and
    stored streams."""
    img = rng.poisson(100, shape).astype(np.float64)
    img += (rng.random(shape) > 0.995) * rng.uniform(500, 3000, shape)
    img[: shape[0] // 8] = np.linspace(0, 4000, shape[1])[None]
    img = np.clip(img, 0, 65535)
    if dtype == np.uint8:
        img = img / 16
    out = img.astype(dtype)
    out[shape[0] // 2:shape[0] // 2 + 6] = rng.integers(
        0, np.iinfo(dtype).max, (6, shape[1]), dtype=dtype)
    return out.reshape((1, 1, 1) + shape)


@functools.lru_cache(maxsize=2)
def plane(dtype) -> np.ndarray:
    rng = np.random.default_rng(2048 + np.dtype(dtype).itemsize)
    return _texture(rng, (TILE, TILE + EDGE), dtype)


def small(dtype) -> np.ndarray:
    rng = np.random.default_rng(7 + np.dtype(dtype).itemsize)
    return _texture(rng, (90, 131), dtype)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names
                  if not n.startswith('.'))


def _read(path):
    with open(path, 'rb') as f:
        return f.read()


def _write_both(root, name, data, chunks, cname, clevel, shuffle):
    ts_path, port_path = str(root / f"ts_{name}"), str(root / f"port_{name}")
    dtype = data.dtype
    create_zarr_array(ts_path, data.shape, chunks, dtype, cname=cname,
                      clevel=clevel, shuffle=shuffle).write(data).result()
    pool = EncodePool(workers=2)
    arr = BloscZarrArray(port_path, data.shape, chunks, dtype, pool, clevel,
                         shuffle, cname)
    arr.write_plane_rows(0, 0, 0, 0, data[0, 0, 0])
    arr.flush()
    pool.close()
    return ts_path, port_path


def _chunk(data, rel, chunks):
    """The C-order bytes of chunk ``rel`` of ``data``, zero-padded."""
    idx = [int(k) for k in rel.split(os.sep)]
    out = np.zeros(chunks, data.dtype)
    src = data[tuple(slice(i * c, (i + 1) * c) for i, c in zip(idx, chunks))]
    out[tuple(slice(0, s) for s in src.shape)] = src
    return out.tobytes()


def check(root, cname, clevel, shuffle, dtype):
    for name, data, chunks in (
            ('plane', plane(dtype), (1, 1, 1, TILE, TILE)),
            ('small', small(dtype), (1, 1, 1, 64, 67))):
        ts_path, port_path = _write_both(root, name, data, chunks, cname,
                                         clevel, shuffle)
        with open(os.path.join(ts_path, '.zarray')) as f, \
                open(os.path.join(port_path, '.zarray')) as g:
            assert json.load(g) == json.load(f)
        files = _files(ts_path)
        assert files and _files(port_path) == files
        for rel in files:
            ts_frame = _read(os.path.join(ts_path, rel))
            frame = _read(os.path.join(port_path, rel))
            # the memcpyed flag (0x02) follows the body: one encoder may
            # fit a frame the other stores as it is
            assert (frame[:2], frame[2] & ~0x02, frame[3]) == \
                (ts_frame[:2], ts_frame[2] & ~0x02, ts_frame[3]), \
                (rel, frame[:4], ts_frame[:4])
            assert struct.unpack_from('<ii', frame, 4) == \
                struct.unpack_from('<ii', ts_frame, 4), rel
            raw = _chunk(data, rel, chunks)
            if cname in ('blosclz', 'lz4', 'lz4hc', 'snappy', 'zlib') or (
                    cname == 'zstd' and clevel in ZSTD_LIB_CLEVELS):
                # c-blosc's blosclz, liblz4's, snappy's, zlib's and
                # libzstd's own rules: whole frames byte-equal
                assert frame == ts_frame, rel
                if name == 'plane' and cname in ('lz4', 'lz4hc'):
                    # streams of at least 64 KiB + 11 (liblz4's larger
                    # hash) through the plain version
                    cut = np.frombuffer(raw, dtype)[:256 * TILE]
                    assert blosc.compress_plain(
                        cut, data.itemsize, clevel, shuffle, cname) == \
                        blosc.compress(cut, data.itemsize, clevel, shuffle,
                                       cname), rel
            assert blosc.decompress(ts_frame).tobytes() == raw, rel
            if name == 'small':
                assert blosc.decompress_plain(ts_frame) == raw, rel
                assert blosc.decompress_plain(frame) == raw, rel
                assert frame == blosc.compress_plain(
                    np.frombuffer(raw, dtype), data.itemsize, clevel,
                    shuffle, cname), rel
        got = np.asarray(open_zarr_array(port_path).read().result())
        np.testing.assert_array_equal(got, data)
        np.testing.assert_array_equal(read_array(ts_path), data)
