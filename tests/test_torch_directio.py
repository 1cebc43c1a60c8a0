"""O_DIRECT writes of the port's raw chunk and shard writers
(``io/directio.py``), against the buffered path and the JAX package.

The port of ``tests/test_raw_zarr.py``'s O_DIRECT tests: chunk files and
shard files written with ``direct_io='on'`` are byte-identical to
``'off'`` (and to the JAX package's raw writers' files), a row pitch
that is not block-aligned never goes direct, a filesystem that refuses
O_DIRECT falls back to buffered writes for good, the disk probe runs
once and is cached, and 'auto' follows the probe as the JAX package's
rule does.
"""

import os

import numpy as np
import pytest
import torch

from fixtures import write_synthetic_acquisition
from torch_helpers import small_disk_probe, tree_files  # noqa: F401
from image_stitcher_tpu.io.raw_zarr import RawV2SlabWriter, RawV3ShardWriter
from image_stitcher_tpu.io.zarr_store import (compute_shard_shape,
                                              create_zarr3_sharded_array,
                                              create_zarr_array)
import image_stitcher_tpu_torch as port
from image_stitcher_tpu_torch.io import directio
from image_stitcher_tpu_torch.io.zarr_shard import RawShardArray
from image_stitcher_tpu_torch.io.zarr_store import RawZarrArray

CPU = torch.device('cpu')


def _direct_supported(tmp_path):
    try:
        fd = os.open(str(tmp_path / ".dprobe"),
                     os.O_WRONLY | os.O_CREAT | os.O_DIRECT, 0o644)
        os.close(fd)
        os.unlink(str(tmp_path / ".dprobe"))
        return True
    except OSError:
        return False


def _assert_files_equal(a, b):
    files = [f for f in tree_files(a) if not os.path.basename(f)
             .startswith('.') and f != 'zarr.json']
    assert files and files == [f for f in tree_files(b)
                               if not os.path.basename(f).startswith('.')
                               and f != 'zarr.json']
    for rel in files:
        with open(os.path.join(a, rel), 'rb') as f, \
                open(os.path.join(b, rel), 'rb') as g:
            assert f.read() == g.read(), rel


def test_direct_io_byte_parity_v2(tmp_path, rng):
    """O_DIRECT chunk files are byte-identical to the buffered path's and
    to the JAX raw writer's (same bodies, padding, sparse rows)."""
    if not _direct_supported(tmp_path):
        pytest.skip("O_DIRECT unsupported on this filesystem")
    shape, chunks = (1, 1, 1, 700, 4096), (1, 1, 1, 256, 2048)
    slabs = [(0, rng.integers(0, 65535, (256, 4096), dtype=np.uint16)),
             (512, rng.integers(0, 65535, (188, 4096), dtype=np.uint16))]
    for mode in ("off", "on"):
        w = RawZarrArray(str(tmp_path / mode), shape, chunks, np.uint16,
                         direct_io=mode)
        assert w.direct == (mode == "on")   # pitch 4096 aligns
        for y0, data in slabs:
            w.write_plane_rows(0, 0, 0, y0, data)
        assert w.direct == (mode == "on")
    d = str(tmp_path / "jax")
    create_zarr_array(d, shape, chunks, np.uint16, cname=None)
    jw = RawV2SlabWriter(d, shape, chunks, np.uint16, direct_io='off')
    for y0, data in slabs:
        sel = (slice(0, 1),) * 3 + (slice(y0, y0 + len(data)),
                                    slice(0, 4096))
        assert jw.try_write(sel, data[None, None, None])
    _assert_files_equal(str(tmp_path / "off"), str(tmp_path / "on"))
    _assert_files_equal(str(tmp_path / "off"), d)


def test_direct_io_byte_parity_v3(tmp_path, rng):
    if not _direct_supported(tmp_path):
        pytest.skip("O_DIRECT unsupported on this filesystem")
    shape, chunks = (1, 1, 1, 512, 4096), (1, 1, 1, 256, 2048)
    data = rng.integers(0, 65535, (512, 4096), dtype=np.uint16)
    for mode in ("off", "on"):
        w = RawShardArray(str(tmp_path / mode), shape, chunks, np.uint16,
                          shard_multiple=2, direct_io=mode)
        assert w.direct == (mode == "on")
        w.write_plane_rows(0, 0, 0, 0, data)
    d = str(tmp_path / "jax")
    cl, sh = compute_shard_shape(shape, chunks, 2)
    create_zarr3_sharded_array(d, shape, chunks, np.uint16,
                               shard_multiple=2, cname=None)
    jw = RawV3ShardWriter(d, shape, cl, sh, np.uint16, direct_io='off')
    assert jw.try_write(None, data[None, None, None])
    _assert_files_equal(str(tmp_path / "off"), str(tmp_path / "on"))
    _assert_files_equal(str(tmp_path / "off"), d)


def test_direct_io_misaligned_pitch_stays_buffered(tmp_path):
    """Chunk widths whose row pitch is not block-aligned never take the
    O_DIRECT path, even when forced on."""
    w = RawZarrArray(str(tmp_path / "mis"), (1, 1, 1, 256, 1000),
                     (1, 1, 1, 128, 1000), np.uint16, direct_io="on")
    assert not w.direct  # pitch 2000 % 4096 != 0


def test_refused_o_direct_falls_back_for_good(tmp_path, rng, monkeypatch):
    """A filesystem that refuses O_DIRECT (tmpfs): the first refused open
    turns direct writes off for the writer, and the bytes are the
    buffered path's."""
    real_open = os.open
    refused = []

    def no_direct(path, flags, *a):
        if flags & os.O_DIRECT:
            refused.append(path)
            raise OSError(22, "Invalid argument", path)
        return real_open(path, flags, *a)

    shape, chunks = (1, 1, 1, 600, 4096), (1, 1, 1, 256, 2048)
    data = rng.integers(0, 65535, (600, 4096), dtype=np.uint16)
    RawZarrArray(str(tmp_path / "off"), shape, chunks, np.uint16,
                 direct_io="off").write_plane_rows(0, 0, 0, 0, data)
    monkeypatch.setattr(os, "open", no_direct)
    w = RawZarrArray(str(tmp_path / "on"), shape, chunks, np.uint16,
                     direct_io="on")
    assert w.direct
    w.write_plane_rows(0, 0, 0, 0, data)
    assert not w.direct and len(refused) == 1
    _assert_files_equal(str(tmp_path / "off"), str(tmp_path / "on"))


def test_direct_io_probe_cached(tmp_path, monkeypatch):
    """The buffered-vs-direct probe runs once and lands in the disk
    cache; the second call is served from it."""
    monkeypatch.setattr(directio, "_cache_path",
                        lambda: str(tmp_path / "cache.json"))
    monkeypatch.setattr(directio, "_mem_cache", {})
    e1 = directio.probe_direct_io(str(tmp_path), force=True)
    assert e1 is not None and "direct_mbps" in e1
    assert (tmp_path / "cache.json").exists()
    monkeypatch.setattr(directio, "_mem_cache", {})
    monkeypatch.setattr(directio, "_write_arm", None)   # no second probe
    assert directio.probe_direct_io(str(tmp_path)) == e1
    assert not [n for n in os.listdir(tmp_path)
                if n.startswith('.directio_probe')]


@pytest.mark.parametrize("entry, want", [
    ({"ts": 0.0, "buffered_mbps": 1000.0, "direct_mbps": 700.0}, True),
    ({"ts": 0.0, "buffered_mbps": 1000.0, "direct_mbps": 699.0}, False),
    ({"ts": 0.0, "buffered_mbps": 0.0, "direct_mbps": 0.0,
      "unsupported": True}, False)])
def test_auto_follows_the_probe_as_jax(tmp_path, monkeypatch, entry, want):
    from image_stitcher_tpu.io import directio as jdirectio
    monkeypatch.setattr(jdirectio, "probe_direct_io", lambda d: entry)
    monkeypatch.setattr(directio, "probe_direct_io", lambda d: entry)
    monkeypatch.delenv("ISTPU_DIRECT_IO", raising=False)
    assert directio.use_direct_io(str(tmp_path)) is want
    assert jdirectio.use_direct_io(str(tmp_path)) is want
    assert directio.use_direct_io(str(tmp_path), 'on')
    assert not directio.use_direct_io(str(tmp_path), 'off')


def test_pipeline_direct_on_and_off_write_equal_trees(tmp_path):
    """A raw run with direct_io='on' writes the bytes of 'off'."""
    acq = str(tmp_path / "acq")
    # u16 chunks 2048 wide: a 4096-byte row pitch, block-aligned
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=1, tile_w=1100,
                                tile_h=64, overlap=64, seed=8)
    for mode in ('off', 'on'):
        port.stitch(acq, device=CPU, options=port.EngineOptions(
            compressor_cname=None, direct_io=mode,
            chunks=(1, 1, 1, 32, 2048), output_folder=str(tmp_path / mode)))
    _assert_files_equal(str(tmp_path / "off"), str(tmp_path / "on"))
