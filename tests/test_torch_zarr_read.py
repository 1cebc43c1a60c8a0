"""The port's windowed zarr reader (``io/zarr_store.open_array``) against
tensorstore and against whole-array reads.

Arrays are made by tensorstore (zarr v2 raw and blosc-lz4 with '/' and
'.' chunk keys; zarr v3 raw and blosc-lz4 shards), by hand (zarr v3 raw
and blosc-lz4 chunks without sharding, which tensorstore reads back)
and by the port's own writers, with edge chunks and chunks never written (read as
the fill value); windows cross chunk and shard borders, take integer
indices, steps and Ellipsis. The reader decodes only the chunks a
window touches, and of a raw chunk reads only the bytes the window
spans.
"""

import json
import os

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from image_stitcher_tpu.io.zarr_store import (create_zarr3_sharded_array,
                                              create_zarr_array,
                                              open_zarr_array, read_attrs
                                              as jax_read_attrs)
from image_stitcher_tpu_torch.io import blosc
from image_stitcher_tpu_torch.io import zarr_store
from image_stitcher_tpu_torch.io.zarr_store import (open_array, read_array,
                                                    read_attrs)

SHAPE = (2, 2, 1, 150, 170)
CHUNKS = (1, 1, 1, 32, 48)


def _data(seed=0, dtype=np.uint16):
    rng = np.random.default_rng(seed)
    return rng.integers(0, np.iinfo(dtype).max, SHAPE, dtype=dtype)


class _V3Chunks:
    """A zarr v3 array without sharding, written by hand: one file a
    chunk at c/t/c/z/y/x, raw or a blosc-lz4 frame from the port's codec
    (tensorstore reads it back in the tests below). ``arr[sel].write(a)``
    stores the chunks that ``sel`` (leading whole axes, then a row slice
    and an optional column slice from 0) covers whole or at the array's
    edge."""

    def __init__(self, path, cname):
        self.path, self.cname = path, cname
        codecs = [{'name': 'bytes', 'configuration': {'endian': 'little'}}]
        if cname:
            codecs.append({'name': 'blosc', 'configuration': {
                'cname': cname, 'clevel': 5, 'shuffle': 'shuffle',
                'typesize': 2, 'blocksize': 0}})
        os.makedirs(path)
        with open(os.path.join(path, 'zarr.json'), 'w') as f:
            json.dump({'zarr_format': 3, 'node_type': 'array',
                       'shape': list(SHAPE), 'data_type': 'uint16',
                       'fill_value': 0, 'codecs': codecs,
                       'chunk_key_encoding': {'name': 'default'},
                       'chunk_grid': {'name': 'regular', 'configuration':
                                      {'chunk_shape': list(CHUNKS)}}}, f)

    def __getitem__(self, sel):
        return _V3Window(self, sel)


class _V3Window:
    def __init__(self, arr, sel):
        self.arr, self.sel = arr, sel

    def write(self, data):
        box = tuple(s.indices(n)[:2] for s, n in zip(
            self.sel + (slice(None),) * (5 - len(self.sel)), SHAPE))
        for idx in np.ndindex(*[-(-n // c) for n, c in zip(SHAPE, CHUNKS)]):
            lo = [i * c for i, c in zip(idx, CHUNKS)]
            hi = [min(a + c, n) for a, c, n in zip(lo, CHUNKS, SHAPE)]
            if any(a < b0 or b > b1 for a, b, (b0, b1) in zip(lo, hi, box)):
                continue
            chunk = np.zeros(CHUNKS, np.uint16)
            chunk[tuple(slice(0, b - a) for a, b in zip(lo, hi))] = data[
                tuple(slice(a - b0, b - b0)
                      for a, b, (b0, _) in zip(lo, hi, box))]
            body = (chunk.tobytes() if not self.arr.cname else
                    bytes(blosc.compress(chunk, 2, 5, 1)))
            fpath = os.path.join(self.arr.path, 'c', *map(str, idx))
            os.makedirs(os.path.dirname(fpath), exist_ok=True)
            with open(fpath, 'wb') as f:
                f.write(body)
        return self

    def result(self):
        return None


LAYOUTS = {
    'v2-raw-slash': lambda p: create_zarr_array(p, SHAPE, CHUNKS, np.uint16,
                                                cname=None),
    'v2-raw-dot': lambda p: create_zarr_array(p, SHAPE, CHUNKS, np.uint16,
                                              cname=None,
                                              dimension_separator='.'),
    'v2-lz4-slash': lambda p: create_zarr_array(p, SHAPE, CHUNKS, np.uint16,
                                                cname='lz4', clevel=5),
    'v2-lz4-dot': lambda p: create_zarr_array(p, SHAPE, CHUNKS, np.uint16,
                                              cname='lz4', clevel=5,
                                              dimension_separator='.'),
    'v3-raw-shard': lambda p: create_zarr3_sharded_array(
        p, SHAPE, CHUNKS, np.uint16, shard_multiple=2, cname=None),
    'v3-lz4-shard': lambda p: create_zarr3_sharded_array(
        p, SHAPE, CHUNKS, np.uint16, shard_multiple=2, cname='lz4',
        clevel=5),
    'v3-lz4-shard-tall': lambda p: create_zarr3_sharded_array(
        p, SHAPE, CHUNKS, np.uint16, shard_multiple=2, shard_multiple_y=2,
        cname='lz4', clevel=5),
    'v3-raw-chunks': lambda p: _V3Chunks(p, None),
    'v3-lz4-chunks': lambda p: _V3Chunks(p, 'lz4'),
}


@pytest.fixture(scope="module", params=list(LAYOUTS))
def stored(request, tmp_path_factory):
    """(path, expected array): the data written everywhere but a block of
    rows and columns at the bottom right, which stays unwritten (its
    chunks and inner chunks are not stored)."""
    path = str(tmp_path_factory.mktemp("zread") / request.param)
    arr = LAYOUTS[request.param](path)
    data = _data()
    want = np.zeros_like(data)
    want[:, :, :, :96] = data[:, :, :, :96]
    want[:, :, :, 96:, :48] = data[:, :, :, 96:, :48]
    arr[:, :, :, :96].write(data[:, :, :, :96]).result()
    arr[:, :, :, 96:, :48].write(data[:, :, :, 96:, :48]).result()
    return path, want


def test_whole_reads_equal_tensorstore_and_read_array(stored):
    path, want = stored
    a = open_array(path)
    assert a.shape == SHAPE and a.dtype == np.uint16 and a.ndim == 5
    assert a.chunks == CHUNKS
    np.testing.assert_array_equal(a[...], want)
    np.testing.assert_array_equal(read_array(path), want)
    np.testing.assert_array_equal(
        np.asarray(open_zarr_array(path).read().result()), want)


@settings(max_examples=60, deadline=None, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(data=st.data())
def test_windows_equal_numpy_slices(stored, data):
    """Random windows (slices with starts, stops and steps, integer
    indices) read what NumPy slicing of the whole array gives."""
    path, want = stored
    a = open_array(path)
    sel = []
    for n in SHAPE:
        if data.draw(st.booleans()) and n > 1:
            sel.append(data.draw(st.integers(-n, n - 1)))
        else:
            lo = data.draw(st.integers(0, n))
            hi = data.draw(st.integers(lo, n))
            step = data.draw(st.sampled_from([None, 1, 2, 3]))
            sel.append(slice(lo, hi, step))
    sel = tuple(sel)
    np.testing.assert_array_equal(a[sel], want[sel])


@pytest.mark.parametrize("sel", [
    (0, 1, 0, slice(30, 34), slice(40, 52)),      # 2x2 chunks, one row each
    (Ellipsis, slice(95, 97), slice(47, 49)),      # the unwritten corner
    (1, Ellipsis, -1, slice(None)),                # the last (edge) row
    (slice(None), 0),                               # a leading index
    Ellipsis, (), 0], ids=str)
def test_selection_forms(stored, sel):
    path, want = stored
    np.testing.assert_array_equal(open_array(path)[sel], want[sel])


def test_out_and_errors(stored):
    path, want = stored
    a = open_array(path)
    out = np.full((1, 2, 1, 40, 60), 7, np.uint16)
    assert a.read((0, slice(None), slice(None), slice(20, 60), slice(30, 90)),
                  out=out) is out
    np.testing.assert_array_equal(out[0], want[0, :, :, 20:60, 30:90])
    with pytest.raises(ValueError, match="out is"):
        a.read((0,), out=np.empty((2, 2), np.uint16))
    with pytest.raises(IndexError):
        a[2]
    with pytest.raises(IndexError):
        a[0, 0, 0, 0, 0, 0]
    with pytest.raises(IndexError):
        a[..., ::-1]


def test_reads_only_the_chunks_and_bytes_a_window_needs(tmp_path,
                                                        monkeypatch):
    """A window inside one chunk decodes one chunk; a raw window reads
    only the bytes from its first element to its last."""
    raw = str(tmp_path / 'raw')
    lz4 = str(tmp_path / 'lz4')
    data = _data(1)
    for path, cname in ((raw, None), (lz4, 'lz4')):
        create_zarr_array(path, SHAPE, CHUNKS, np.uint16,
                          cname=cname).write(data).result()
    decoded = []
    real = blosc.decompress
    monkeypatch.setattr(zarr_store.blosc, 'decompress',
                        lambda f, out=None: decoded.append(1) or real(f, out))
    win = (1, 0, 0, slice(33, 40), slice(50, 60))
    np.testing.assert_array_equal(open_array(lz4)[win], data[win])
    assert len(decoded) == 1
    read = []
    real_preadv = os.preadv
    monkeypatch.setattr(zarr_store.os, 'preadv', lambda fd, bufs, off:
                        read.append(sum(len(b) for b in bufs))
                        or real_preadv(fd, bufs, off))
    np.testing.assert_array_equal(open_array(raw)[win], data[win])
    # rows 1..7 of the chunk, from column 2 of the first to 11 of the last
    assert sum(read) == (6 * 48 + 10) * 2


def test_port_writer_outputs_read_back(tmp_path):
    """Arrays from the port's own writers (raw v2 with sparse rows, blosc
    v2, raw and blosc v3 shards) read back what was written."""
    from image_stitcher_tpu_torch.io.zarr_shard import (BloscShardArray,
                                                        RawShardArray)
    from image_stitcher_tpu_torch.io.zarr_store import (BloscZarrArray,
                                                        EncodePool,
                                                        RawZarrArray)
    data = _data(2)
    want = np.zeros_like(data)
    want[..., 10:75, :130] = data[..., 10:75, :130]
    pool = EncodePool()
    arrays = [RawZarrArray(str(tmp_path / 'a'), SHAPE, CHUNKS, np.uint16,
                           direct_io='off'),
              BloscZarrArray(str(tmp_path / 'b'), SHAPE, CHUNKS, np.uint16,
                             pool),
              RawShardArray(str(tmp_path / 'c'), SHAPE, CHUNKS, np.uint16,
                            shard_multiple=2, direct_io='off'),
              BloscShardArray(str(tmp_path / 'd'), SHAPE, CHUNKS, np.uint16,
                              pool, shard_multiple=2)]
    for arr in arrays:
        for t, c, z in np.ndindex(*SHAPE[:3]):
            arr.write_plane_rows(t, c, z, 10, np.ascontiguousarray(
                data[t, c, z, 10:75, :130]))
        getattr(arr, 'flush', lambda: None)()
    pool.close()
    for name in 'abcd':
        a = open_array(str(tmp_path / name))
        np.testing.assert_array_equal(a[...], want)
        win = (Ellipsis, slice(60, 80), slice(120, 140))
        np.testing.assert_array_equal(a[win], want[win])


def test_corrupt_shard_index_raises(tmp_path):
    path = str(tmp_path / 's')
    create_zarr3_sharded_array(path, SHAPE, CHUNKS, np.uint16,
                               cname=None).write(_data()).result()
    shard = os.path.join(path, 'c', '0', '0', '0', '0', '0')
    with open(shard, 'r+b') as f:
        f.seek(-6, os.SEEK_END)
        b = f.read(1)
        f.seek(-6, os.SEEK_END)
        f.write(bytes([b[0] ^ 1]))
    with pytest.raises(ValueError, match="CRC-32C"):
        open_array(path)[0, 0, 0, :4, :4]
    np.testing.assert_array_equal(open_array(path)[1, 1, 0, :4, :4],
                                  _data()[1, 1, 0, :4, :4])


@pytest.mark.parametrize("fmt", [2, 3])
def test_read_attrs_equals_the_jax_read_attrs(tmp_path, fmt):
    from image_stitcher_tpu_torch.io.zarr_store import write_group
    attrs = {'multiscales': [{'name': 'x'}], 'n': 3}
    write_group(str(tmp_path), attrs, zarr_format=fmt)
    assert read_attrs(str(tmp_path)) == jax_read_attrs(str(tmp_path)) == attrs
    if fmt == 3:
        with open(tmp_path / 'zarr.json') as f:
            assert json.load(f)['attributes'] == attrs
