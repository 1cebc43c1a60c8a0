"""The port's OME-Zarr trees with every blosc codec against the JAX
package's, and the port reading the JAX package's zstd and bit-shuffled
trees.

Both packages stitch the same acquisition with the same ``compressor_*``
options, the JAX package through tensorstore's c-blosc, the port through
its own codecs (``io/blosc.py``, ``csrc/blosc.c``): on zarr v2 and v3,
the band path (``streaming='on'``) and the in-RAM path, the trees hold
the same files, equal ``.zarray``/``zarr.json``/``.zattrs`` JSON and
arrays that decode equal with tensorstore and the port's reader. The
cases cover zstd-1 with byte shuffle (the reference's production
setting), zstd with bit shuffle, shuffle -1 on u8 and u16, and each
other cname; every zstd tree (clevel 1 in v2 and v3, bands and in RAM;
clevel 5, the JAX package's default: bit shuffle in bands, byte shuffle
in RAM; clevel 6 to 9), the zstd-1 merge trees and every blosclz (clevel
5 in v3 bands, clevel 9 bit-shuffled u8 in v2 in RAM), snappy and zlib
tree hold byte-identical chunk and shard files (the port's zstd at
every clevel follows libzstd 1.5.7, its blosclz c-blosc 1.x's encoder,
its snappy snappy 1.2 and its zlib Chromium's zlib 1.3.1). On v3 both
packages
byte-shuffle whatever ``compressor_shuffle`` says (the JAX package's
metadata always reads ``'shuffle': 'shuffle'``). Then ``read_array`` and
``open_stitched`` on JAX trees written with zstd-1 and with bit shuffle,
and the merges in zstd.
"""

import json
import os

import numpy as np
import pytest
import torch

from fixtures import write_synthetic_acquisition
from torch_helpers import (assert_chunk_files_equal, assert_outputs_equal,
                           small_disk_probe, zarr_groups)  # noqa: F401
from image_stitcher_tpu import EngineOptions as JaxOptions
from image_stitcher_tpu import stitch as jax_stitch
import image_stitcher_tpu_torch as port
from image_stitcher_tpu_torch.io.zarr_store import read_array

CPU = torch.device('cpu')
WELLS = ["A1", "B1"]

# (cname, clevel, shuffle, zarr format, streaming, dtype)
CASES = [
    ('zstd', 1, 1, 2, 'on', np.uint16),
    ('zstd', 1, 1, 2, 'off', np.uint16),
    ('zstd', 1, 1, 3, 'on', np.uint16),
    ('zstd', 1, 1, 3, 'off', np.uint16),
    ('zstd', 5, 2, 2, 'on', np.uint16),
    ('zstd', 5, 1, 2, 'off', np.uint16),
    ('zstd', 6, 2, 2, 'on', np.uint8),
    ('zstd', 7, 1, 3, 'on', np.uint16),
    ('zstd', 8, -1, 2, 'off', np.uint16),
    ('zstd', 9, 2, 3, 'off', np.uint16),
    ('lz4hc', 9, 1, 2, 'off', np.uint16),
    ('blosclz', 5, 0, 3, 'on', np.uint16),
    ('blosclz', 9, 2, 2, 'off', np.uint8),
    ('snappy', 5, -1, 2, 'on', np.uint8),
    ('snappy', 1, -1, 2, 'off', np.uint16),
    ('zlib', 1, 2, 2, 'off', np.uint8),
    ('zlib', 5, 1, 3, 'on', np.uint16),
    ('lz4', 9, 2, 2, 'on', np.uint8),
]


def _id(case):
    cname, clevel, shuffle, fmt, streaming, dtype = case
    return (f"{cname}-{clevel}-shuffle{shuffle}-v{fmt}-"
            f"{'band' if streaming == 'on' else 'inram'}-"
            f"{np.dtype(dtype).name}")


def _acquisition(root, dtype):
    acq = str(root / "acq")
    write_synthetic_acquisition(
        acq, grid_cols=3, grid_rows=2, tile_w=128, tile_h=96, overlap=24,
        regions=WELLS, dtype=dtype,
        gt_quantize_bits=12 if dtype == np.uint16 else 5, seed=31)
    return acq


def _options(cname, clevel, shuffle, fmt, streaming, out):
    return dict(compressor_cname=cname, compressor_clevel=clevel,
                compressor_shuffle=shuffle, zarr_format=fmt,
                streaming=streaming, chunks=(1, 1, 1, 64, 64),
                device_band_multiple=1, output_folder=out)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_tree_equals_jax(tmp_path, case):
    cname, clevel, shuffle, fmt, streaming, dtype = case
    acq = _acquisition(tmp_path, dtype)
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    jpipe = jax_stitch(acq, use_registration=True, options=JaxOptions(
        fusion_device='device', **_options(cname, clevel, shuffle, fmt,
                                           streaming, jax_out)))
    port.stitch(acq, use_registration=True, device=CPU,
                state=port.state_from_reference(shifts=jpipe.shifts),
                options=port.EngineOptions(**_options(
                    cname, clevel, shuffle, fmt, streaming, port_out)))
    assert_outputs_equal(jax_out, port_out)
    if cname in ('blosclz', 'snappy', 'zlib') or (cname == 'zstd'
                                                  and clevel >= 1):
        # c-blosc 1.x's blosclz, snappy 1.2's, Chromium zlib 1.3.1's and
        # libzstd 1.5.7's rules: byte-identical chunk files
        assert_chunk_files_equal(jax_out, port_out)
    level0 = os.path.join(port_out, zarr_groups(port_out)[0], '0')
    chunk = None
    for d, _, names in os.walk(level0):
        for n in names:
            if n[0].isdigit():
                chunk = os.path.join(d, n)
    with open(chunk, 'rb') as f:
        frame = f.read()
    if fmt == 3:
        with open(os.path.join(level0, 'zarr.json')) as f:
            inner = json.load(f)['codecs'][0]['configuration']['codecs']
        assert inner[1]['configuration']['shuffle'] == 'shuffle'
        frame = _last_inner_frame(chunk)
        mode = 1      # byte shuffle, whatever compressor_shuffle says
    else:
        mode = (2 if dtype == np.uint8 else 1) if shuffle < 0 else shuffle
    assert frame[2] >> 5 == {'blosclz': 0, 'lz4': 1, 'lz4hc': 1,
                             'snappy': 2, 'zlib': 3, 'zstd': 4}[cname]
    if not frame[2] & 0x02:
        assert frame[2] & 0x05 == {0: 0, 1: 1, 2: 4}[mode]


def _last_inner_frame(shard):
    """The frame of a shard's last stored inner chunk, found through
    its index (16-byte (offset, nbytes) entries, then a CRC)."""
    import struct
    with open(shard, 'rb') as f:
        data = f.read()
    n = (len(data) - 4) // 16
    entries = [struct.unpack_from('<QQ', data, len(data) - 4 - 16 * (n - k))
               for k in range(n)]
    off, size = [e for e in entries if e[0] != 2 ** 64 - 1][-1]
    return data[off:off + size]


@pytest.mark.parametrize("shuffle", [1, 2], ids=['zstd1', 'zstd1_bit'])
def test_port_reads_jax_zstd_trees(tmp_path, shuffle):
    """read_array, open_stitched and list_outputs on a JAX run written
    with zstd-1 (byte or bit shuffle), with both merges: each array equal
    to tensorstore's reading."""
    from image_stitcher_tpu.io.zarr_store import open_zarr_array
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=2, tile_w=64,
                                tile_h=64, overlap=16, regions=WELLS,
                                timepoints=2, seed=4)
    out = str(tmp_path / "jax")
    jax_stitch(acq, use_registration=True, merge_timepoints=True,
               merge_hcs_regions=True, options=JaxOptions(
                   compressor_cname='zstd', compressor_clevel=1,
                   compressor_shuffle=shuffle, chunks=(1, 1, 1, 32, 32),
                   output_folder=out))
    listing = port.list_outputs(out)
    paths = listing['regions'] + listing['time_series'] + listing['hcs']
    assert len(listing['regions']) == 4 and listing['hcs']
    for path in paths:
        if path in listing['hcs']:     # a plate: its first well's image
            path = os.path.join(path, 'A', '1', '0')
        img = port.open_stitched(path)
        for level in range(img.num_levels):
            want = np.asarray(open_zarr_array(
                os.path.join(path, str(level))).read().result())
            np.testing.assert_array_equal(img.read(level), want)
            np.testing.assert_array_equal(
                read_array(os.path.join(path, str(level))), want)
        with open(os.path.join(path, '0', '.zarray')) as f:
            comp = json.load(f)['compressor']
        assert (comp['cname'], comp['shuffle']) == ('zstd', shuffle)


def test_merges_in_zstd_equal_jax(tmp_path):
    """A two-well, two-timepoint run with both merges in zstd-1: the
    port's whole output (regions, time series, plates) equals the JAX
    package's, every chunk file byte for byte."""
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=2, tile_w=64,
                                tile_h=64, overlap=16, regions=WELLS,
                                timepoints=2, seed=6)
    kw = dict(use_registration=True, merge_timepoints=True,
              merge_hcs_regions=True)
    opts = dict(compressor_cname='zstd', compressor_clevel=1,
                chunks=(1, 1, 1, 32, 32))
    jpipe = jax_stitch(acq, options=JaxOptions(
        output_folder=str(tmp_path / "jax"), **opts), **kw)
    port.stitch(acq, device=CPU,
                state=port.state_from_reference(shifts=jpipe.shifts),
                options=port.EngineOptions(
                    output_folder=str(tmp_path / "port"), **opts), **kw)
    assert_outputs_equal(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert_chunk_files_equal(str(tmp_path / "jax"), str(tmp_path / "port"))
