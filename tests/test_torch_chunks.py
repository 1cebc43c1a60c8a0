"""Chunks over several planes: the port's trees against the JAX package's.

A ``chunks`` 5-tuple whose (T, C, Z) extent is not (1, 1, 1) puts
several planes in one chunk file. The JAX package writes such arrays
through tensorstore (its raw writers step aside); the port gathers the
planes of a chunk row (``io/zarr_store.py::ChunkRowBuffer``) and encodes
each chunk once. The same seeded acquisition (3 channels, 3 z planes, so
the chunk groups at the C and Z edges are partial) goes through both
packages, the JAX run's flatfields and shifts carried into the port, on
the port's band path, in-RAM path, host fuser and a mesh of two CPU
devices, with chunks (1, 3, 1), (1, 1, 2) and (1, 2, 2) in Y-X chunks of
32, stored as zarr v2 raw, lz4 and zstd and v3 raw and lz4. Bars
(``torch_helpers.assert_trees_equal``, plus raw chunk files compared
byte for byte): the same files (a chunk equal to the fill value is not
stored, the tensorstore rule), the same JSON, raw and lz4 chunk files
byte-equal, every array decoded equal; feathered output within 1 LSB.
Then the merges with two timepoints a chunk, the zero-chunk rule against
one-plane raw chunks, the writer's buffer bound, and resume refusing
other chunks.
"""

import json
import os

import numpy as np
import pytest
import torch

from fixtures import write_synthetic_acquisition
from torch_helpers import (JSON_FILES, array_dirs,  # noqa: F401
                           assert_outputs_equal, small_disk_probe, tree_files,
                           zarr_groups)
from image_stitcher_tpu import EngineOptions as JaxOptions
from image_stitcher_tpu import stitch as jax_stitch
import image_stitcher_tpu_torch as port
from image_stitcher_tpu_torch.io.zarr_store import read_array

CPU = torch.device('cpu')
CHANNELS = ["Fluorescence 405 nm Ex", "Fluorescence 488 nm Ex",
            "Fluorescence 561 nm Ex"]
CHUNKS = {'c3': (1, 3, 1, 32, 32), 'z2': (1, 1, 2, 32, 32),
          'c2z2': (1, 2, 2, 32, 32)}
#: (zarr format, compressor cname)
STORES = {'v2-raw': (2, None), 'v2-lz4': (2, 'lz4'), 'v2-zstd': (2, 'zstd'),
          'v3-raw': (3, None), 'v3-lz4': (3, 'lz4')}
#: the port's paths: options, devices
PATHS = {'band': (dict(streaming='on'), CPU),
         'inram': (dict(streaming='off'), CPU),
         'host': (dict(streaming='on', fusion_device='host'), CPU),
         'mesh': (dict(mesh_shape=(1, 2)), [CPU] * 2)}
KW = dict(use_registration=True, apply_flatfield=True)


def _options(chunks, store, out, **extra):
    fmt, cname = STORES[store]
    return dict(chunks=CHUNKS[chunks], zarr_format=fmt,
                compressor_cname=cname, compressor_clevel=1 if cname ==
                'zstd' else 5, device_band_multiple=1, fusion_batch=4,
                output_folder=out, **extra)


@pytest.fixture(scope='module')
def acquisition(tmp_path_factory):
    root = tmp_path_factory.mktemp('chunks')
    acq = str(root / 'acq')
    write_synthetic_acquisition(acq, grid_cols=3, grid_rows=2, tile_w=64,
                                tile_h=64, overlap=16, channels=CHANNELS,
                                num_z=3, gt_quantize_bits=12, seed=23)
    return root, acq


_JAX_RUNS = {}


def _jax_run(root, acq, chunks, store, **extra):
    """The JAX package's tree (band path) of these options, run once per
    module, with the pipeline its flatfields and shifts come from."""
    key = (chunks, store, tuple(sorted(extra.items())))
    if key not in _JAX_RUNS:
        out = str(root / ('jax-' + '-'.join(map(str, key[:2]))
                          + ''.join(f'-{v}' for _, v in key[2])))
        pipe = jax_stitch(acq, options=JaxOptions(
            fusion_device='device', **_options(chunks, store, out,
                                               streaming='on', **extra)),
            **KW)
        _JAX_RUNS[key] = (out, pipe)
    return _JAX_RUNS[key]


def _port_run(acq, out, jpipe, chunks, store, path, **extra):
    opts, device = PATHS[path]
    return port.stitch(acq, device=device, state=port.state_from_reference(
        flatfields=jpipe.flatfields, shifts=jpipe.shifts),
        options=port.EngineOptions(**_options(chunks, store, out, **opts,
                                              **extra)), **KW)


def assert_raw_chunks_byte_equal(want_out, got_out):
    """Every raw chunk or shard file of two outputs byte for byte (the
    trees' lz4 v2 chunks are compared by ``assert_trees_equal``)."""
    for group in zarr_groups(want_out):
        root = os.path.join(want_out, group)
        for arr in array_dirs(root):
            meta = os.path.join(root, arr, '.zarray')
            if not os.path.exists(meta):
                meta = os.path.join(root, arr, 'zarr.json')
            with open(meta) as f:
                if 'blosc' in f.read():
                    continue
            for rel in tree_files(os.path.join(root, arr)):
                if os.path.basename(rel) in JSON_FILES:
                    continue
                with open(os.path.join(root, arr, rel), 'rb') as f, \
                        open(os.path.join(got_out, group, arr, rel),
                             'rb') as g:
                    assert g.read() == f.read(), (group, arr, rel)


CASES = [(chunks, store, path) for chunks in CHUNKS for store in STORES
         for path in PATHS
         if path == 'band' or store in ('v2-raw', 'v2-lz4', 'v3-lz4')]


@pytest.mark.parametrize("chunks,store,path", CASES,
                         ids=['-'.join(c) for c in CASES])
def test_tree_equals_jax(acquisition, chunks, store, path):
    root, acq = acquisition
    jax_out, jpipe = _jax_run(root, acq, chunks, store)
    out = str(root / f'port-{chunks}-{store}-{path}')
    pipe = _port_run(acq, out, jpipe, chunks, store, path)
    assert_outputs_equal(jax_out, out)
    assert_raw_chunks_byte_equal(jax_out, out)
    if path != 'inram':
        assert pipe.fuse_stats['A1_t0']['peak_buffer_bytes'] > 0


def test_feather_within_one_lsb(acquisition):
    root, acq = acquisition
    jax_out, jpipe = _jax_run(root, acq, 'c2z2', 'v2-lz4',
                              blend_method='feather', feather_px=12)
    out = str(root / 'port-feather')
    _port_run(acq, out, jpipe, 'c2z2', 'v2-lz4', 'band',
              blend_method='feather', feather_px=12)
    groups = zarr_groups(jax_out)
    assert groups and zarr_groups(out) == groups
    for g in groups:
        arrays = array_dirs(os.path.join(jax_out, g))
        assert arrays == array_dirs(os.path.join(out, g))
        for rel in arrays:
            a = read_array(os.path.join(jax_out, g, rel)).astype(np.int64)
            b = read_array(os.path.join(out, g, rel)).astype(np.int64)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, rel


@pytest.mark.parametrize("merge", ['time_series', 'complete_plate'])
@pytest.mark.parametrize("store", ['v2-lz4', 'v3-raw'])
def test_merges_with_two_timepoints_a_chunk(tmp_path, merge, store):
    """A 2-well, 3-timepoint plate merged with chunks (2, 3, 1, 32, 32):
    the last T chunk holds one timepoint. Every store of the output
    (regions, time series or complete plate) equals the JAX package's."""
    acq = str(tmp_path / 'plate')
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=2, tile_w=64,
                                tile_h=64, overlap=16, regions=['A1', 'B1'],
                                timepoints=3, channels=CHANNELS, seed=9)
    fmt, cname = STORES[store]
    opts = dict(chunks=(2, 3, 1, 32, 32), zarr_format=fmt,
                compressor_cname=cname)
    kw = dict(use_registration=True, merge_timepoints=True,
              merge_hcs_regions=merge == 'complete_plate')
    jpipe = jax_stitch(acq, options=JaxOptions(
        output_folder=str(tmp_path / 'jax'), **opts), **kw)
    pipe = port.stitch(acq, device=CPU,
                       state=port.state_from_reference(shifts=jpipe.shifts),
                       options=port.EngineOptions(
                           output_folder=str(tmp_path / 'port'), **opts),
                       **kw)
    merged = ('hcs_timepoints/complete_hcs.ome.zarr'
              if merge == 'complete_plate'
              else 'region_time_series/A1_time_series.ome.zarr')
    assert merged in zarr_groups(str(tmp_path / 'jax'))
    assert_outputs_equal(str(tmp_path / 'jax'), str(tmp_path / 'port'))
    assert_raw_chunks_byte_equal(str(tmp_path / 'jax'), str(tmp_path / 'port'))
    assert pipe.merge_stats.bands > 0


def _chunk_files(out, level='0'):
    root = os.path.join(out, '0_stitched', 'A1_stitched.ome.zarr', level)
    return {rel for rel in tree_files(root) if rel[0].isdigit()}


def test_zero_chunks_follow_the_jax_package(acquisition):
    """The registered canvas's bottom rows hold no tile: a multi-plane raw
    chunk there equals the fill value and is not stored (tensorstore's
    rule, which the JAX package runs), while the one-plane raw writers
    store every chunk a write touches (the in-RAM path touches all), as
    the JAX raw writer does."""
    root, acq = acquisition
    outs = {}
    for chunks in ('c3', 'one'):
        for pkg in ('jax', 'port'):
            out = str(root / f'zero-{chunks}-{pkg}')
            opts = _options('c3', 'v2-raw', out, streaming='off')
            if chunks == 'one':
                opts['chunks'] = (1, 1, 1, 32, 32)
            if pkg == 'jax':
                jpipe = jax_stitch(acq, options=JaxOptions(
                    fusion_device='device', **opts), **KW)
            else:
                port.stitch(acq, device=CPU, state=port.state_from_reference(
                    flatfields=jpipe.flatfields, shifts=jpipe.shifts),
                    options=port.EngineOptions(**opts), **KW)
            outs[chunks, pkg] = out
        assert _chunk_files(outs[chunks, 'port']) == \
            _chunk_files(outs[chunks, 'jax'])
    level0 = read_array(os.path.join(outs['one', 'port'], '0_stitched',
                                     'A1_stitched.ome.zarr', '0'))
    h, w = level0.shape[3:]
    blocks = {(z, y, x): level0[0, :, z, y * 32:(y + 1) * 32,
                                x * 32:(x + 1) * 32].any()
              for z in range(3) for y in range(-(-h // 32))
              for x in range(-(-w // 32))}
    assert not all(blocks.values())    # the registered canvas's empty foot
    assert _chunk_files(outs['one', 'port']) == {
        f'0/{c}/{z}/{y}/{x}' for c in range(3) for z, y, x in blocks}
    assert _chunk_files(outs['c3', 'port']) == {
        f'0/0/{z}/{y}/{x}' for (z, y, x), full in blocks.items() if full}


@pytest.mark.parametrize("chunks", sorted(CHUNKS))
@pytest.mark.parametrize("path", ['band', 'host', 'mesh'])
def test_gathering_buffer_holds_one_band_row_of_a_z_group(acquisition,
                                                           chunks, path):
    """The writer's chunk-row buffers (every level) hold at most one
    chunk row of every plane of one z group at each level: the band
    writers hand bands over chunk group by chunk group (the host fuser's
    threads: of the two z groups their bands straddle). Bands here are
    one chunk row (32 rows) tall."""
    root, acq = acquisition
    _, jpipe = _jax_run(root, acq, chunks, 'v2-lz4')
    out = str(root / f'bound-{chunks}-{path}')
    pipe = _port_run(acq, out, jpipe, chunks, 'v2-lz4', path,
                     host_fusion_threads=2)
    peak = pipe.fuse_stats['A1_t0']['peak_buffer_bytes']
    _, cc, cz, cy, cx = CHUNKS[chunks]
    planes = -(-3 // cc) * cc * cz     # every channel group of a z group
    level0 = read_array(os.path.join(out, '0_stitched',
                                     'A1_stitched.ome.zarr', '0'))
    w = level0.shape[4]
    per_level = [planes * cy * -(-(w >> lv) // cx) * cx * 2
                 for lv in range(pipe.num_pyramid_levels) if w >> lv]
    # the host fuser's two threads may hold the last band of one z group
    # and the first of the next
    groups = 2 if path == 'host' and cz < 3 else 1
    assert per_level[0] <= peak <= groups * sum(per_level), (peak,
                                                              per_level)


def test_resume_with_other_chunks_is_refused(tmp_path):
    """A stopped run's folder resumed with other ``chunks`` is refused,
    as the JAX package refuses it (the manifest's option fingerprint)."""
    acq = str(tmp_path / 'acq')
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=1, tile_w=32,
                                tile_h=32, overlap=8, channels=CHANNELS[:2],
                                seed=5)
    for name, stitch, opts in (('jax', jax_stitch, JaxOptions),
                               ('port', port.stitch, port.EngineOptions)):
        out = str(tmp_path / name)
        kw = {} if name == 'jax' else dict(device=CPU)
        stitch(acq, options=opts(chunks=(1, 2, 1, 16, 16),
                                 output_folder=out), **kw)
        with open(os.path.join(out, '.stitch_manifest.json')) as f:
            assert json.load(f)['engine_options']['chunks'] == [1, 2, 1, 16,
                                                                 16]
        with pytest.raises(ValueError, match="refusing to resume"):
            stitch(acq, resume=True, options=opts(
                chunks=(1, 1, 1, 16, 16), output_folder=out), **kw)
        stitch(acq, resume=True, options=opts(
            chunks=(1, 2, 1, 16, 16), output_folder=out), **kw)


def test_port_reads_jax_multi_plane_stores(acquisition):
    """``read_array``, ``open_stitched`` windows and ``list_outputs`` on a
    JAX tree of chunks (1, 2, 2), v2 zstd and v3 lz4: equal to
    tensorstore's reading."""
    from image_stitcher_tpu.io.zarr_store import open_zarr_array
    root, acq = acquisition
    for store in ('v2-zstd', 'v3-lz4'):
        out, _ = _jax_run(root, acq, 'c2z2', store)
        path = port.list_outputs(out)['regions'][0]
        img = port.open_stitched(path)
        for level in range(img.num_levels):
            want = np.asarray(open_zarr_array(
                os.path.join(path, str(level))).read().result())
            np.testing.assert_array_equal(img.read(level), want)
            np.testing.assert_array_equal(
                img.level(level)[0, 1:3, 1:, 5:40, 7:50],
                want[0, 1:3, 1:, 5:40, 7:50])
