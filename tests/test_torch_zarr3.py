"""The port's zarr v3 output (sharded levels, OME-NGFF 0.5) against the
JAX package's.

``zarr_format=3`` writes each level as a ``sharding_indexed`` array of
Y-thin shards (one chunk row tall, up to 16 chunks wide), with raw inner
chunks (the JAX package's raw shard writer's layout, byte for byte) or
blosc-lz4 ones (tensorstore's shards on the JAX side: chunks equal to
the fill value absent from the index, shards without chunks not
written), and the group's attributes under 'ome' in ``zarr.json``. For
the band and the in-RAM path, both compressors, uint8 and uint16: the
same files, the same ``zarr.json`` documents, arrays that decode equal
with tensorstore and with the port's reader; raw shards byte-equal. 32-px
chunks on a 544-px canvas end each row of shards in a partial shard
(out-of-array index entries) and each level-1 row in a partial chunk.
Then the lz4 tree against the v2 tree, and the shard index itself.
"""

import os
import struct

import numpy as np
import pytest
import torch

from fixtures import write_synthetic_acquisition
from torch_helpers import (assert_outputs_equal, small_disk_probe,  # noqa: F401
                           tree_files, zarr_groups)
from image_stitcher_tpu import EngineOptions as JaxOptions
from image_stitcher_tpu import stitch as jax_stitch
import image_stitcher_tpu_torch as port
from image_stitcher_tpu_torch.io.zarr_shard import (MISSING, crc32c,
                                                    index_bytes)
from image_stitcher_tpu_torch.io.zarr_store import open_array, read_array

CPU = torch.device('cpu')
WELLS = ["A1", "B1", "C1", "D1"]
COMMON = dict(chunks=(1, 1, 1, 64, 32), device_band_multiple=1)


def _acquisition(root, dtype):
    acq = str(root / "acq")
    write_synthetic_acquisition(
        acq, grid_cols=4, grid_rows=2, tile_w=160, tile_h=96, overlap=32,
        regions=WELLS, dtype=dtype, seed=29,
        gt_quantize_bits=12 if dtype == np.uint16 else 5,
        acq_params_overrides={"pixel_binning": 2})
    return acq


def _runs(tmp_path, acq, streaming, cname):
    jpipe = jax_stitch(acq, use_registration=True, options=JaxOptions(
        fusion_device='device', streaming=streaming, compressor_cname=cname,
        output_folder=str(tmp_path / "jax"), zarr_format=3, **COMMON))
    pipe = port.stitch(acq, use_registration=True, device=CPU,
                       state=port.state_from_reference(shifts=jpipe.shifts),
                       options=port.EngineOptions(
                           streaming=streaming, compressor_cname=cname,
                           output_folder=str(tmp_path / "port"),
                           zarr_format=3, **COMMON))
    assert pipe.num_pyramid_levels == 2
    return str(tmp_path / "jax"), str(tmp_path / "port")


@pytest.mark.parametrize("streaming", ['on', 'off'], ids=['band', 'inram'])
@pytest.mark.parametrize("cname, dtype", [('lz4', np.uint16),
                                          ('lz4', np.uint8),
                                          (None, np.uint16),
                                          (None, np.uint8)],
                         ids=['lz4-u16', 'lz4-u8', 'raw-u16', 'raw-u8'])
def test_v3_tree_equals_jax(tmp_path, streaming, cname, dtype):
    jax_out, port_out = _runs(tmp_path, _acquisition(tmp_path, dtype),
                              streaming, cname)
    assert_outputs_equal(jax_out, port_out)
    shards = [f for g in zarr_groups(port_out)
              for f in tree_files(os.path.join(port_out, g))
              if f.startswith('0/c/')]
    assert shards
    if cname is None:
        # raw shards: the JAX raw shard writer's bytes
        for g in zarr_groups(port_out):
            for rel in tree_files(os.path.join(port_out, g)):
                if '/c/' not in '/' + rel:
                    continue
                with open(os.path.join(jax_out, g, rel), 'rb') as f:
                    want = f.read()
                with open(os.path.join(port_out, g, rel), 'rb') as f:
                    assert f.read() == want, rel


def test_v3_lz4_decodes_equal_to_v2(tmp_path):
    acq = _acquisition(tmp_path, np.uint16)
    outs = {}
    for fmt in (2, 3):
        out = str(tmp_path / f"v{fmt}")
        port.stitch(acq, use_registration=True, device=CPU,
                    options=port.EngineOptions(output_folder=out,
                                               zarr_format=fmt, **COMMON))
        outs[fmt] = out
    groups = zarr_groups(outs[2])
    assert groups == zarr_groups(outs[3])
    for g in groups:
        for lv in ('0', '1'):
            np.testing.assert_array_equal(
                read_array(os.path.join(outs[3], g, lv)),
                read_array(os.path.join(outs[2], g, lv)))


def _one_shard_array(root, body: bytes, width: int):
    """A (1, 1, 1, 1, width) uint8 raw sharded array, inner chunks 10
    wide, whose one shard file holds ``body``, opened for reading."""
    import json
    from image_stitcher_tpu_torch.io.zarr_shard import zarr3_array_meta
    shape = (1, 1, 1, 1, width)
    os.makedirs(root / 'c' / '0' / '0' / '0' / '0')
    (root / 'zarr.json').write_text(json.dumps(zarr3_array_meta(
        shape, (1, 1, 1, 1, 10), shape, np.uint8)))
    (root / 'c' / '0' / '0' / '0' / '0' / '0').write_bytes(body)
    return open_array(str(root))


def test_shard_index_layout_and_crc(tmp_path):
    """(offset, nbytes) u64 LE pairs, 2^64-1 for absent chunks, then the
    CRC-32C of the pairs; a flipped index byte fails the check."""
    assert crc32c(b"123456789") == 0xE3069283   # the CRC-32C check value
    entries = [(0, 10), (MISSING, MISSING), (10, 4)]
    idx = index_bytes(entries)
    assert len(idx) == 3 * 16 + 4
    assert struct.unpack('<6Q', idx[:48]) == (0, 10, MISSING, MISSING, 10, 4)
    # a body shorter than a raw chunk
    with pytest.raises(ValueError, match="raw chunk"):
        _one_shard_array(tmp_path / 'a', bytes(range(14)) + idx, 30)[...]
    entries = [(0, 10), (MISSING, MISSING)]
    got = _one_shard_array(tmp_path / 'b', bytes(range(10))
                           + index_bytes(entries), 20)[...]
    np.testing.assert_array_equal(got[0, 0, 0, 0],
                                  list(range(10)) + [0] * 10)
    bad = bytearray(bytes(range(10)) + index_bytes(entries))
    bad[-6] ^= 1
    with pytest.raises(ValueError, match="CRC-32C"):
        _one_shard_array(tmp_path / 'c', bytes(bad), 20)[...]
