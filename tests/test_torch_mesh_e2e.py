"""End-to-end stitching over a device mesh: the port against the JAX
package, and against its own single-device run.

The JAX package runs ``stitch`` with ``mesh_shape`` on the 8 virtual CPU
devices of ``tests/conftest.py`` (its ``ShardedCanvas``, the canvas
assembled and saved whole); the port runs the same ``mesh_shape`` over
``[torch.device('cpu')] * 8`` (its ``ShardedCanvas``, each band streamed
to the writer), with the JAX run's flatfields and shifts carried in.
Bars: every OME-Zarr group equal (``torch_helpers.assert_trees_equal``);
feathered level arrays within 1 LSB (the bar of
``tests/test_torch_feather.py``); every ``.ome.tiff`` page and level
equal to the JAX mesh run's, and the file byte-equal to the JAX
package's band writer's (its mesh run saves the assembled canvas, which
lays the same tiles out in another order). The port's mesh tree is also
equal, exactly, to the port's single-device tree.
"""

import os

import numpy as np
import pytest
import torch

from fixtures import write_synthetic_acquisition
from torch_helpers import (array_dirs, assert_outputs_equal,  # noqa: F401
                           assert_tiff_outputs_equal, small_disk_probe,
                           tiff_outputs, zarr_groups)
from image_stitcher_tpu import EngineOptions as JaxOptions
from image_stitcher_tpu import stitch as jax_stitch
import image_stitcher_tpu_torch as port
from image_stitcher_tpu_torch.io.zarr_store import read_array

CPU = torch.device('cpu')
CPU8 = [CPU] * 8
CHANNELS = ["Fluorescence 488 nm Ex", "Fluorescence 561 nm Ex"]

# (id, mesh shape, output format, options common to both packages)
CASES = [
    # 208 rows in bands of 64 (the chunk rows): devices 4-7 hold nothing
    ('overwrite-raw-empty-devices', (1, 8), '.ome.zarr',
     dict(chunks=(1, 1, 1, 64, 64), compressor_cname=None)),
    ('feather-lz4', (2, 4), '.ome.zarr',
     dict(chunks=(1, 1, 1, 32, 32), blend_method='feather', feather_px=12)),
    ('zarr3', (1, 3), '.ome.zarr',
     dict(chunks=(1, 1, 1, 32, 32), zarr_format=3)),
    ('lz4-mean', (1, 8), '.ome.zarr',
     dict(chunks=(1, 1, 1, 16, 32), pyramid_downsample='mean')),
    ('ome-tiff', (1, 2), '.ome.tiff', dict()),
]


def _acquisition(tmp_path, name):
    acq = str(tmp_path / name)
    write_synthetic_acquisition(acq, grid_cols=3, grid_rows=3, tile_w=64,
                                tile_h=64, overlap=16, channels=CHANNELS,
                                seed=7)
    return acq


def _feather_outputs_close(want_out, got_out):
    groups = zarr_groups(want_out)
    assert groups and zarr_groups(got_out) == groups
    for g in groups:
        arrays = array_dirs(os.path.join(want_out, g))
        assert arrays == array_dirs(os.path.join(got_out, g))
        for rel in arrays:
            a = read_array(os.path.join(want_out, g, rel)).astype(np.int64)
            b = read_array(os.path.join(got_out, g, rel)).astype(np.int64)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, rel


def _tiff_pages_equal(want_out, got_out):
    """The same ``.ome.tiff`` files, page by page: descriptions, levels
    and pixels equal."""
    from image_stitcher_tpu_torch.io.tiff import read_pages
    files = tiff_outputs(want_out)
    assert files and tiff_outputs(got_out) == files
    for rel in files:
        with open(os.path.join(want_out, rel), 'rb') as f:
            want = read_pages(f.read())
        with open(os.path.join(got_out, rel), 'rb') as f:
            got = read_pages(f.read())
        assert len(got) == len(want)
        for (wd, wl), (gd, gl) in zip(want, got):
            assert gd == wd and len(gl) == len(wl)
            for a, b in zip(wl, gl):
                np.testing.assert_array_equal(b, a, rel)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_mesh_stitch_matches_jax_and_single_device(tmp_path, case):
    name, mesh_shape, fmt, common = case
    acq = _acquisition(tmp_path, 'acq')
    kw = dict(use_registration=True, apply_flatfield=True,
              output_format=fmt)
    jpipe = jax_stitch(acq, options=JaxOptions(
        mesh_shape=mesh_shape, fusion_batch=4,
        output_folder=str(tmp_path / 'jax'), **common), **kw)
    state = port.state_from_reference(flatfields=jpipe.flatfields,
                                      shifts=jpipe.shifts)
    pipe = port.stitch(acq, device=CPU8, state=state,
                       options=port.EngineOptions(
                           mesh_shape=mesh_shape, fusion_batch=4,
                           output_folder=str(tmp_path / 'mesh'), **common),
                       **kw)
    single = port.stitch(acq, device=CPU, state=state,
                         options=port.EngineOptions(
                             fusion_batch=4,
                             output_folder=str(tmp_path / 'single'),
                             **common), **kw)
    stats = pipe.fuse_stats['A1_t0']
    assert 'sharded_fuse_save' in pipe.timers.as_dict()
    assert 'sharded_fuse_save' not in single.timers.as_dict()
    assert len(stats['bands']) <= mesh_shape[1]
    assert stats['band_rows'] % pipe.options.write_band_rows() == 0
    if name == 'overwrite-raw-empty-devices':
        assert len(stats['bands']) == 4     # 4 of the 8 devices empty
    if fmt == '.ome.tiff':
        # the JAX mesh run saves the assembled canvas page by page, the
        # port's streams bands: the same pages and levels, laid out in the
        # file as the JAX package's own band writer lays them out
        jax_stitch(acq, options=JaxOptions(
            fusion_device='device', streaming='on', fusion_batch=4,
            output_folder=str(tmp_path / 'jax_bands'), **common), **kw)
        assert_tiff_outputs_equal(str(tmp_path / 'jax_bands'),
                                  str(tmp_path / 'mesh'))
        for other in ('jax', 'single'):
            _tiff_pages_equal(str(tmp_path / other), str(tmp_path / 'mesh'))
        return
    if common.get('blend_method') == 'feather':
        _feather_outputs_close(str(tmp_path / 'jax'), str(tmp_path / 'mesh'))
    else:
        assert_outputs_equal(str(tmp_path / 'jax'), str(tmp_path / 'mesh'))
    assert_outputs_equal(str(tmp_path / 'single'), str(tmp_path / 'mesh'))


def test_mesh_hcs_plate_with_merges_matches_jax(tmp_path):
    """Two wells at two timepoints over a (1, 4) mesh with both merges:
    every region store and merged plate equal to the JAX package's."""
    acq = str(tmp_path / 'plate')
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=2, tile_w=64,
                                tile_h=64, overlap=16, regions=['B2', 'C3'],
                                timepoints=2, seed=11)
    kw = dict(use_registration=True, merge_timepoints=True,
              merge_hcs_regions=True)
    common = dict(chunks=(1, 1, 1, 32, 32), mesh_shape=(1, 4))
    jpipe = jax_stitch(acq, options=JaxOptions(
        output_folder=str(tmp_path / 'jax'), **common), **kw)
    port.stitch(acq, device=CPU8,
                state=port.state_from_reference(shifts=jpipe.shifts),
                options=port.EngineOptions(
                    output_folder=str(tmp_path / 'port'), **common), **kw)
    assert 'hcs_timepoints/complete_hcs.ome.zarr' in zarr_groups(
        str(tmp_path / 'jax'))
    assert_outputs_equal(str(tmp_path / 'jax'), str(tmp_path / 'port'))


def test_mesh_larger_than_the_devices_raises(tmp_path):
    """No fallback: a mesh of more devices than given raises the JAX
    package's ValueError, before anything is written."""
    acq = _acquisition(tmp_path, 'acq')
    out = str(tmp_path / 'out')
    with pytest.raises(ValueError, match=r"mesh shape \(2, 4\) needs 8 "
                                         r"devices, only 3 available"):
        port.stitch(acq, device=[CPU] * 3, options=port.EngineOptions(
            mesh_shape=(2, 4), output_folder=out))
    assert not os.path.exists(os.path.join(out, '0_stitched',
                                           'A1_stitched.ome.zarr'))


def test_mesh_tree_is_the_band_paths_file_for_file(tmp_path):
    """The mesh writes what the band path writes: with bands of 16 rows
    the registered canvas's tile-less bottom bands stay unwritten (read
    as the fill value) in both, and every file is byte-equal."""
    acq = _acquisition(tmp_path, 'acq')
    common = dict(chunks=(1, 1, 1, 16, 16), compressor_cname=None,
                  device_band_multiple=1, fusion_batch=4)
    runs = {}
    for name, dev, extra in (('bands', CPU, dict(streaming='on')),
                             ('mesh', CPU8, dict(mesh_shape=(1, 8)))):
        runs[name] = port.stitch(
            acq, use_registration=True, apply_flatfield=True, device=dev,
            options=port.EngineOptions(output_folder=str(tmp_path / name),
                                       **common, **extra))
    files = {}
    for name in runs:
        root = tmp_path / name / '0_stitched' / 'A1_stitched.ome.zarr'
        files[name] = {str(p.relative_to(root)): p.read_bytes()
                       for p in root.rglob('*') if p.is_file()}
    assert files['mesh'] == files['bands']
    width, height = runs['mesh']._region_dimensions(0, 'A1')
    rows = {int(k.split('/')[4]) for k in files['mesh'] if k.startswith('0/')
            and k.count('/') == 5}
    assert max(rows) + 1 < -(-height // 16)     # tile-less rows unwritten
    assert 2 <= len(runs['mesh'].fuse_stats['A1_t0']['bands']) <= 8


@pytest.mark.parametrize("where", ['band', 'writer'])
def test_a_failing_band_or_writer_raises(tmp_path, monkeypatch, where):
    """No fallback: a launch that fails on one band, or a write that
    fails, raises out of the run; the writer thread is gone after it."""
    import threading
    from image_stitcher_tpu_torch.models import streaming
    from image_stitcher_tpu_torch.parallel import sharded_fuse
    acq = _acquisition(tmp_path, 'acq')
    if where == 'band':
        real = sharded_fuse.cuda_fuse.fuse_overwrite
        calls = []

        def flaky(canvas, *a, **k):
            calls.append(canvas.data_ptr())
            if len(set(calls)) == 2:
                raise RuntimeError("kernel launch failed on band 1")
            return real(canvas, *a, **k)

        monkeypatch.setattr(sharded_fuse.cuda_fuse, 'fuse_overwrite', flaky)
        err = (RuntimeError, "kernel launch failed on band 1")
    else:
        def full(*a, **k):
            raise OSError("no space left on the disk")

        monkeypatch.setattr(streaming, 'write_band_levels', full)
        err = (OSError, "no space left")
    with pytest.raises(err[0], match=err[1]):
        port.stitch(acq, device=CPU8, options=port.EngineOptions(
            mesh_shape=(1, 4), chunks=(1, 1, 1, 32, 32),
            output_folder=str(tmp_path / 'out')))
    assert not any(t.name == 'band-writer' for t in threading.enumerate())
