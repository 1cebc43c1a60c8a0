"""The port's raw zarr writers against the JAX package's
(``image_stitcher_tpu/io/raw_zarr.py``): chunk-column block writes, their
refusals, and the row path through ``csrc/hostops.c::write_rows_contig``.

- ``RawZarrArray.try_write_block`` (v2) and ``RawShardArray.
  try_write_block`` (v3) write files byte-equal to the JAX
  ``RawV2SlabWriter`` and ``RawV3ShardWriter.try_write_block`` on the
  same page-aligned block pool: full chunks, a band of two chunk rows, a
  partial bottom band (sparse-extended), an edge column carrying its own
  zero padding; u8 and u16; buffered and O_DIRECT.
- Each refusal is the JAX writer's, on the JAX test's bad shapes and
  more, and a refused block writes nothing.
- The row path (one ``pwritev`` of the strided rows and a shared zero
  pad) writes files byte-equal to the JAX raw writers' and to the
  port's previous pack-and-``pwrite`` writer, O_DIRECT included; a
  failed write raises ``OSError`` naming the file; without a C compiler
  the writer raises when it is made.
- ``MultiscaleWriter.write_level_block`` writes a refused block through
  the level's rows, and raises on a level without block writes.

Every comparison is exact (bytes of every chunk and shard file).
"""

import mmap
import os

import numpy as np
import pytest

from torch_helpers import small_disk_probe, tree_files  # noqa: F401
from image_stitcher_tpu.io.raw_zarr import RawV2SlabWriter, RawV3ShardWriter
from image_stitcher_tpu.io.zarr_store import (compute_shard_shape,
                                              create_zarr3_sharded_array,
                                              create_zarr_array)
from image_stitcher_tpu_torch.io.omezarr import MultiscaleWriter
from image_stitcher_tpu_torch.io.zarr_shard import RawShardArray
from image_stitcher_tpu_torch.io.zarr_store import RawZarrArray, read_array

SHARD_MULTIPLE = 2


def _direct_supported(path):
    probe = os.path.join(str(path), '.dprobe')
    try:
        os.close(os.open(probe, os.O_WRONLY | os.O_CREAT | os.O_DIRECT,
                         0o644))
        os.unlink(probe)
        return True
    except OSError:
        return False


def _chunk_files(root):
    """{relative path: bytes} of the chunk and shard files (no metadata)."""
    out = {}
    for rel in tree_files(root):
        if os.path.basename(rel).startswith('.') or rel == 'zarr.json':
            continue
        with open(os.path.join(root, rel), 'rb') as f:
            out[rel] = f.read()
    return out


def _port_writer(fmt, path, shape, chunks, dtype, direct_io):
    if fmt == 'v2':
        return RawZarrArray(path, shape, chunks, dtype, direct_io=direct_io)
    return RawShardArray(path, shape, chunks, dtype,
                         shard_multiple=SHARD_MULTIPLE, direct_io=direct_io)


def _jax_writer(fmt, path, shape, chunks, dtype, direct_io):
    if fmt == 'v2':
        create_zarr_array(path, shape, chunks, dtype, cname=None)
        return RawV2SlabWriter(path, shape, chunks, dtype,
                               direct_io=direct_io)
    cl, sh = compute_shard_shape(shape, chunks, SHARD_MULTIPLE)
    create_zarr3_sharded_array(path, shape, chunks, dtype,
                               shard_multiple=SHARD_MULTIPLE, cname=None)
    return RawV3ShardWriter(path, shape, cl, sh, dtype, direct_io=direct_io)


def _block_pool(ncx, band, cx, dtype):
    """A page-aligned (ncx, band, cx) pool, as the band fuser's."""
    n = ncx * band * cx
    mm = mmap.mmap(-1, n * np.dtype(dtype).itemsize)
    return np.frombuffer(mm, dtype, count=n).reshape(ncx, band, cx)


@pytest.mark.parametrize("direct", ['off', 'on'])
@pytest.mark.parametrize("dtype", [np.uint16, np.uint8], ids=['u16', 'u8'])
@pytest.mark.parametrize("fmt", ['v2', 'v3'])
def test_block_writes_equal_jax(tmp_path, fmt, dtype, direct):
    """Blocks of two bands (two chunk rows, then a 44-row bottom band)
    over two chunk columns, the second past the 3000-px width: the JAX
    writer's files, byte for byte, and the array reads back."""
    if direct == 'on' and not _direct_supported(tmp_path):
        pytest.skip("O_DIRECT unsupported on this filesystem")
    shape, chunks = (1, 2, 1, 300, 3000), (1, 1, 1, 128, 2048)
    cy, cx, ncx, band = 128, 2048, 2, 256
    rng = np.random.default_rng(1)
    full = rng.integers(0, np.iinfo(dtype).max, (2, 300, 3000),
                        endpoint=True).astype(dtype)
    port = _port_writer(fmt, str(tmp_path / 'port'), shape, chunks, dtype,
                        direct)
    jax = _jax_writer(fmt, str(tmp_path / 'jax'), shape, chunks, dtype,
                      direct)
    assert port.block_spec() == jax.block_spec() == (cy, cx)
    # a u8 row of 2048 bytes is no whole page: buffered either way
    assert port.direct == jax.direct == (
        direct == 'on' and cx * np.dtype(dtype).itemsize % 4096 == 0)
    pool = _block_pool(ncx, band, cx, dtype)
    for c in range(2):
        for band0 in (0, 256):
            rows = min(band, 300 - band0)
            blocks = pool[:, :rows]
            blocks.fill(0)
            for cxi in range(ncx):
                x0, x1 = cxi * cx, min((cxi + 1) * cx, 3000)
                blocks[cxi][:, :x1 - x0] = full[c, band0:band0 + rows, x0:x1]
                assert port.try_write_block(0, c, 0, band0, cxi, blocks[cxi])
                assert jax.try_write_block(0, c, 0, band0, cxi, blocks[cxi])
    got, want = _chunk_files(str(tmp_path / 'port')), \
        _chunk_files(str(tmp_path / 'jax'))
    assert got and sorted(got) == sorted(want)
    for rel in want:
        assert got[rel] == want[rel], rel
    np.testing.assert_array_equal(read_array(str(tmp_path / 'port'))[0, :, 0],
                                  full)


def _bad_blocks(dtype):
    good = np.zeros((128, 2048), dtype)
    other = np.uint8 if dtype == np.uint16 else np.uint16
    return {
        'wrong_cx': (0, 0, good[:, :100]),
        'y0_misaligned': (64, 0, good),
        'cxi_out_of_grid': (0, 1, good),
        'cxi_negative': (0, -1, good),
        'past_bottom': (192, 0, good),
        'dtype': (0, 0, good.astype(other)),
        'not_contiguous': (0, 0, np.zeros((128, 4096), dtype)[:, ::2]),
        'not_2d': (0, 0, good[None]),
        'no_rows': (0, 0, good[:0]),
    }


@pytest.mark.parametrize("case", list(_bad_blocks(np.uint16)))
@pytest.mark.parametrize("fmt", ['v2', 'v3'])
def test_block_refusals_equal_jax_and_write_nothing(tmp_path, fmt, case):
    shape, chunks = (1, 1, 1, 256, 2048), (1, 1, 1, 128, 2048)
    port = _port_writer(fmt, str(tmp_path / 'port'), shape, chunks,
                        np.uint16, 'off')
    jax = _jax_writer(fmt, str(tmp_path / 'jax'), shape, chunks, np.uint16,
                      'off')
    y0, cxi, block = _bad_blocks(np.uint16)[case]
    assert port.try_write_block(0, 0, 0, y0, cxi, block) is False
    assert jax.try_write_block(0, 0, 0, y0, cxi, block) is False
    assert _chunk_files(str(tmp_path / 'port')) == {}
    good = np.ones((128, 2048), np.uint16)
    assert port.try_write_block(0, 0, 0, 128, 0, good)
    assert jax.try_write_block(0, 0, 0, 128, 0, good)
    assert _chunk_files(str(tmp_path / 'port')) \
        == _chunk_files(str(tmp_path / 'jax'))


@pytest.mark.parametrize("fmt", ['v2', 'v3'])
def test_o_direct_block_needs_a_page_aligned_source(tmp_path, fmt):
    """An O_DIRECT writer refuses a block that does not start on a page,
    as the JAX writer does, and writes nothing; the aligned one lands."""
    if not _direct_supported(tmp_path):
        pytest.skip("O_DIRECT unsupported on this filesystem")
    shape, chunks = (1, 1, 1, 256, 2048), (1, 1, 1, 128, 2048)
    port = _port_writer(fmt, str(tmp_path / 'port'), shape, chunks,
                        np.uint16, 'on')
    jax = _jax_writer(fmt, str(tmp_path / 'jax'), shape, chunks, np.uint16,
                      'on')
    raw = np.frombuffer(mmap.mmap(-1, 2 * 128 * 2048 * 2 + 4096), np.uint8)
    shifted = raw[2:2 + 128 * 2048 * 2].view(np.uint16).reshape(128, 2048)
    assert shifted.ctypes.data % 4096 != 0
    assert port.try_write_block(0, 0, 0, 0, 0, shifted) is False
    assert jax.try_write_block(0, 0, 0, 0, 0, shifted) is False
    assert _chunk_files(str(tmp_path / 'port')) == {}
    aligned = raw[:128 * 2048 * 2].view(np.uint16).reshape(128, 2048)
    aligned[:] = 7
    assert port.try_write_block(0, 0, 0, 0, 0, aligned)
    assert jax.try_write_block(0, 0, 0, 0, 0, aligned)
    assert _chunk_files(str(tmp_path / 'port')) \
        == _chunk_files(str(tmp_path / 'jax'))


def _pack_and_pwrite(self, fd, is_direct, plane, row0, col0, nrows, cols,
                     pitch_elems, off, fpath):
    """The port's previous buffered row writer: each chunk region packed
    into a zeroed body, then ``os.pwrite``."""
    if is_direct:
        return type(self)._pwrite_rows(self, fd, is_direct, plane, row0,
                                       col0, nrows, cols, pitch_elems, off,
                                       fpath)
    body = np.zeros((nrows, pitch_elems), self.dtype)
    body[:, :cols] = plane[row0:row0 + nrows, col0:col0 + cols]
    data = memoryview(body).cast('B')
    done = 0
    while done < len(data):
        done += os.pwrite(fd, data[done:], off + done)


ROW_SLABS = [   # (y0, rows, width): band slabs as the fusers write them
    (0, 256, 3000), (256, 100, 3000), (356, 344, 3000),   # level 0
]


@pytest.mark.parametrize("direct", ['off', 'on'])
@pytest.mark.parametrize("fmt", ['v2', 'v3'])
def test_row_path_equals_jax_and_previous_writer(tmp_path, fmt, direct):
    """Band slabs over partial chunk rows, from strided source rows (a
    column window of a wider band): the JAX writer's files, and the
    files of the port's previous pack-and-pwrite writer."""
    if direct == 'on' and not _direct_supported(tmp_path):
        pytest.skip("O_DIRECT unsupported on this filesystem")
    shape, chunks = (1, 1, 1, 700, 3000), (1, 1, 1, 128, 2048)
    rng = np.random.default_rng(2)
    band = rng.integers(0, 65535, (700, 3100), dtype=np.uint16)
    trees = {}
    for name in ('port', 'previous', 'jax'):
        path = str(tmp_path / name)
        if name == 'jax':
            w = _jax_writer(fmt, path, shape, chunks, np.uint16, direct)
        else:
            w = _port_writer(fmt, path, shape, chunks, np.uint16, direct)
            if name == 'previous':
                w._pwrite_rows = _pack_and_pwrite.__get__(w)
        for y0, rows, width in ROW_SLABS:
            plane = band[y0:y0 + rows, 50:50 + width]   # strided rows
            if name == 'jax':
                sel = (slice(0, 1),) * 3 + (slice(y0, y0 + rows),
                                            slice(0, width))
                assert w.try_write(sel, plane[None, None, None])
            else:
                w.write_plane_rows(0, 0, 0, y0, plane)
        trees[name] = _chunk_files(path)
    assert trees['port'] and sorted(trees['port']) == sorted(trees['jax'])
    for rel in trees['jax']:
        assert trees['port'][rel] == trees['jax'][rel] \
            == trees['previous'][rel], rel
    np.testing.assert_array_equal(read_array(str(tmp_path / 'port'))
                                  [0, 0, 0], band[:, 50:3050])


@pytest.mark.parametrize("fmt", ['v2', 'v3'])
def test_row_path_at_a_chunk_column_offset(tmp_path, fmt):
    """``write_plane_rows(x0=)`` (the fallback of a refused block) writes
    the chunk column's files as a block write of the same pixels does."""
    shape, chunks = (1, 1, 1, 300, 3000), (1, 1, 1, 128, 2048)
    rng = np.random.default_rng(3)
    cols = rng.integers(0, 65535, (300, 952), dtype=np.uint16)
    rows_w = _port_writer(fmt, str(tmp_path / 'rows'), shape, chunks,
                          np.uint16, 'off')
    rows_w.write_plane_rows(0, 0, 0, 0, cols, x0=2048)
    blocks_w = _port_writer(fmt, str(tmp_path / 'blocks'), shape, chunks,
                            np.uint16, 'off')
    block = np.zeros((300, 2048), np.uint16)
    block[:, :952] = cols
    assert blocks_w.try_write_block(0, 0, 0, 0, 1, block)
    assert _chunk_files(str(tmp_path / 'rows')) \
        == _chunk_files(str(tmp_path / 'blocks'))
    with pytest.raises(ValueError, match="does not fit"):
        rows_w.write_plane_rows(0, 0, 0, 0, cols, x0=100)


def test_failed_row_write_raises_naming_the_file(tmp_path):
    w = RawZarrArray(str(tmp_path / 'a'), (1, 1, 1, 64, 64),
                     (1, 1, 1, 32, 32), np.uint16, direct_io='off')

    class FailingLib:
        @staticmethod
        def write_rows_contig(*args):
            return -28   # ENOSPC

    w._lib = FailingLib()
    with pytest.raises(OSError) as err:
        w.write_plane_rows(0, 0, 0, 0, np.ones((16, 64), np.uint16))
    assert err.value.errno == 28
    assert err.value.filename == os.path.join(str(tmp_path / 'a'),
                                              '0', '0', '0', '0', '0')


@pytest.mark.parametrize("fmt", ['v2', 'v3'])
def test_missing_compiler_raises_no_plain_writer(tmp_path, monkeypatch, fmt):
    """No C compiler: a raw writer raises when it is made (nothing falls
    back to the pack-and-pwrite writer) and makes no array."""
    from image_stitcher_tpu_torch import native
    monkeypatch.setattr(native, 'BUILD_ROOT', str(tmp_path / 'build'))
    monkeypatch.setattr(native, '_LIBS', {})
    monkeypatch.delenv('CC', raising=False)
    monkeypatch.setenv('PATH', str(tmp_path / 'empty'))
    with pytest.raises(RuntimeError, match="no C compiler"):
        _port_writer(fmt, str(tmp_path / 'a'), (1, 1, 1, 8, 8),
                     (1, 1, 1, 8, 8), np.uint16, 'off')
    assert not (tmp_path / 'a').exists()


@pytest.mark.parametrize("fmt", [2, 3], ids=['v2', 'v3'])
def test_multiscale_block_fallback_and_refusal(tmp_path, fmt):
    """A block the raw writer refuses (here: not C-contiguous) lands
    through the level's rows, the same files as an accepted block, and
    the call says which way it went; a blosc level has no block path and
    raises."""
    kw = dict(base_shape=(1, 1, 1, 300, 3000), num_levels=1,
              dtype=np.uint16, chunks=(1, 1, 1, 128, 2048), name='x',
              dz_um=1.0, pixel_size_um=1.0, channel_names=['c'],
              channel_colors=[0xFFFFFF], zarr_format=fmt, direct_io='off')
    rng = np.random.default_rng(4)
    block = np.zeros((256, 2048), np.uint16)
    block[:, :952] = rng.integers(0, 65535, (256, 952), dtype=np.uint16)
    strided = np.zeros((256, 4096), np.uint16)[:, ::2]
    strided[:] = block
    trees = {}
    for name, b in (('accepted', block), ('refused', strided)):
        w = MultiscaleWriter(str(tmp_path / name), cname=None, **kw)
        assert w.block_spec(0) == (128, 2048)
        assert w.write_level_block(0, 0, 0, 0, 1, b) is (name == 'accepted')
        w.close()
        trees[name] = _chunk_files(os.path.join(str(tmp_path / name), '0'))
    assert trees['accepted'] and trees['accepted'] == trees['refused']
    w = MultiscaleWriter(str(tmp_path / 'lz4'), cname='lz4', **kw)
    assert w.block_spec(0) is None
    with pytest.raises(ValueError, match="takes no block writes"):
        w.write_level_block(0, 0, 0, 0, 0, block)
    w.abort()
