"""The port's merge passes against the JAX package's, end to end.

Each run stitches a two-well, two-timepoint acquisition whose region
canvases differ between the timepoints (t=1 moves one column of A1 40 px
right, t=0 moves one tile of B2 24 px down, so each merged well pads one
timepoint to the larger shape), with ``merge_timepoints`` and
``merge_hcs_regions`` (the complete plate through ``run()``), then calls
the two other passes on the finished pipeline. The JAX package and the
port write the same trees (same files, equal JSON, arrays decoded equal
by tensorstore and by the port's reader) for raw and blosc-lz4 chunks on
zarr v2 and v3, from region stores written by the band fuser and by the
in-RAM path. The port folds the merged pyramids on the pipeline's device
(here the CPU) with the 2x2 mean.
"""

import csv
import os
import threading

import numpy as np
import pytest
import torch

from fixtures import write_synthetic_acquisition
from torch_helpers import (array_dirs, assert_trees_equal,  # noqa: F401
                           small_disk_probe, tree_files, zarr_groups)
import image_stitcher_tpu as jax_pkg
from image_stitcher_tpu.models import merge as jax_merge
from image_stitcher_tpu.utils.progress import \
    ProgressReporter as JaxReporter
import image_stitcher_tpu_torch as port
from image_stitcher_tpu_torch.io.zarr_store import read_array
from image_stitcher_tpu_torch.models import merge
from image_stitcher_tpu_torch.utils.progress import ProgressReporter

CPU = torch.device('cpu')
LAYOUTS = {'v2-raw': dict(compressor_cname=None, zarr_format=2),
           'v2-lz4': dict(compressor_cname='lz4', zarr_format=2),
           'v3-raw': dict(compressor_cname=None, zarr_format=3),
           'v3-lz4': dict(compressor_cname='lz4', zarr_format=3)}
CASES = [('v2-raw', 'on'), ('v2-raw', 'off'), ('v2-lz4', 'on'),
         ('v2-lz4', 'off'), ('v3-raw', 'on'), ('v3-lz4', 'off')]
PASSES = {'complete': ['hcs_timepoints/complete_hcs.ome.zarr'],
          'per-timepoint': ['hcs_timepoints/0_hcs.ome.zarr',
                            'hcs_timepoints/1_hcs.ome.zarr'],
          'time-series': ['region_time_series/A1_time_series.ome.zarr',
                          'region_time_series/B2_time_series.ome.zarr']}


def _move_tile(acq, t, region, fov, column, px):
    path = os.path.join(acq, str(t), 'coordinates.csv')
    with open(path) as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        if r['region'] == region and r['fov'] == str(fov):
            r[column] = repr(float(r[column]) + px)
    with open(path, 'w', newline='') as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def make_acquisition(folder, seed=5, tile_w=576, tile_h=320):
    """Two wells (A1, B2), two timepoints, a 2x1 grid each: canvases of
    ~1.1k columns, so the plate's pyramid has two levels. A1 is 40 px
    wider at t=1, B2 24 px taller at t=0."""
    acq = write_synthetic_acquisition(
        folder, grid_cols=2, grid_rows=1, tile_w=tile_w, tile_h=tile_h,
        overlap=32, regions=['A1', 'B2'], timepoints=2, seed=seed)
    mm = acq.pixel_size_um / 1000
    _move_tile(folder, 1, 'A1', 1, 'x (mm)', 40 * mm)
    _move_tile(folder, 0, 'B2', 1, 'y (mm)', 24 * mm)
    return folder


def options(pkg, out, layout, streaming, **extra):
    kw = dict(LAYOUTS[layout], chunks=(1, 1, 1, 128, 128),
              streaming=streaming, output_folder=out, **extra)
    if pkg is jax_pkg:
        kw['fusion_device'] = 'device'
    return pkg.EngineOptions(**kw)


def run_both(root, layout, streaming, **params):
    """(JAX pipeline, port pipeline) after both stitched the same
    acquisition into root/jax_out and root/port_out."""
    pipes = []
    for name, pkg in (('jax', jax_pkg), ('port', port)):
        acq = make_acquisition(str(root / name))
        kw = dict(device=CPU) if pkg is port else {}
        pipes.append(pkg.stitch(
            acq, options=options(pkg, str(root / f'{name}_out'), layout,
                                 streaming), **params, **kw))
    return pipes


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{layout}-{'band' if s == 'on' else 'inram'}"
                     for layout, s in CASES])
def merged(request, tmp_path_factory):
    layout, streaming = request.param
    root = tmp_path_factory.mktemp(f"merge_{layout}_{streaming}")
    jax_pipe, port_pipe = run_both(root, layout, streaming,
                                   merge_timepoints=True,
                                   merge_hcs_regions=True)
    for fn in ('merge_timepoints_per_region',
               'create_hcs_ome_zarr_per_timepoint'):
        getattr(jax_merge, fn)(jax_pipe)
        getattr(merge, fn)(port_pipe)
    return root, port_pipe


@pytest.mark.parametrize("merge_pass", list(PASSES))
def test_merge_trees_equal_the_jax_trees(merged, merge_pass):
    root, pipe = merged
    assert pipe.num_pyramid_levels == 2
    for rel in PASSES[merge_pass]:
        assert_trees_equal(str(root / 'jax_out' / rel),
                           str(root / 'port_out' / rel))


def test_whole_output_folder_matches(merged):
    """Every file of the JAX run's folder is in the port's, the region
    stores equal too; the manifests agree apart from the input path."""
    import json
    root, _ = merged
    want, got = root / 'jax_out', root / 'port_out'
    assert tree_files(str(got)) == tree_files(str(want))
    for rel in zarr_groups(str(want)):
        if '_stitched' in rel:
            assert_trees_equal(str(want / rel), str(got / rel))
    manifests = []
    for out in (want, got):
        with open(out / '.stitch_manifest.json') as f:
            m = json.load(f)
        m['params'].pop('input_folder')
        manifests.append(m)
    assert manifests[1] == manifests[0]
    assert manifests[1]['merges_done'] and manifests[1]['finished']


def test_padded_timepoints_and_the_mean_fold(merged):
    """Merged level 0 at [t] is region t's level 0, zero-padded to the
    largest shape; level 1 is the 2x2 mean (sum >> 2) of level 0, not
    the regions' 'nearest' level 1."""
    root, pipe = merged
    out = root / 'port_out'
    plate = out / 'hcs_timepoints' / 'complete_hcs.ome.zarr'
    for region, well in (('A1', 'A/1'), ('B2', 'B/2')):
        merged0 = read_array(str(plate / well / '0' / '0'))
        merged1 = read_array(str(plate / well / '0' / '1'))
        shapes = []
        for t in (0, 1):
            src = read_array(str(out / f'{t}_stitched'
                                 / f'{region}_stitched.ome.zarr' / '0'))[0]
            shapes.append(src.shape)
            h, w = src.shape[-2:]
            np.testing.assert_array_equal(merged0[t, ..., :h, :w], src)
            assert not merged0[t, ..., h:, :].any()
            assert not merged0[t, ..., :, w:].any()
        assert shapes[0] != shapes[1]
        lv0 = merged0.astype(np.uint32)
        h2, w2 = merged1.shape[-2] * 2, merged1.shape[-1] * 2
        s = (lv0[..., 0:h2:2, 0:w2:2] + lv0[..., 0:h2:2, 1:w2:2]
             + lv0[..., 1:h2:2, 0:w2:2] + lv0[..., 1:h2:2, 1:w2:2])
        np.testing.assert_array_equal(merged1, (s >> 2).astype(np.uint16))
        nearest = read_array(str(out / '0_stitched'
                                 / f'{region}_stitched.ome.zarr' / '1'))
        assert not np.array_equal(
            merged1[0, ..., :nearest.shape[-2], :nearest.shape[-1]],
            nearest[0])


@pytest.mark.parametrize("flags", [
    dict(merge_timepoints=True), dict(merge_hcs_regions=True),
    dict(merge_timepoints=True, merge_hcs_regions=True)],
    ids=lambda d: '+'.join(sorted(d)))
def test_run_writes_the_jax_folder_for_each_flag(tmp_path, flags):
    """run() dispatches like the JAX package: the same merge outputs,
    nothing more, and the same return path."""
    jax_pipe, port_pipe = run_both(tmp_path, 'v2-lz4', 'auto', **flags)
    want, got = tmp_path / 'jax_out', tmp_path / 'port_out'
    assert tree_files(str(got)) == tree_files(str(want))
    for rel in zarr_groups(str(want)):
        assert_trees_equal(str(want / rel), str(got / rel))
    assert 'merge' in port_pipe.timers.as_dict()


def _corrupt(acq, t, region):
    tdir = os.path.join(acq, str(t))
    bad = sorted(f for f in os.listdir(tdir) if f.startswith(f'{region}_'))
    with open(os.path.join(tdir, bad[-1]), 'wb') as f:
        f.write(b'not an image')


def test_missing_unit_is_skipped_as_the_jax_package_skips_it(tmp_path):
    """A unit that fails under continue_on_error stays out of the
    manifest; the complete plate and the per-timepoint plates skip it
    with the JAX package's messages and write the JAX package's trees."""
    msgs = {}
    for name, pkg, reporter in (('jax', jax_pkg, JaxReporter),
                                ('port', port, ProgressReporter)):
        acq = make_acquisition(str(tmp_path / name))
        _corrupt(acq, 1, 'B2')
        got = msgs[name] = []
        rep = reporter(status=lambda m, s=False, got=got: got.append(m)
                       if m.startswith('merge:') else None,
                       error=lambda m, got=got: got.append('error'))
        kw = dict(device=CPU) if pkg is port else {}
        pipe = pkg.stitch(
            acq, merge_timepoints=True, merge_hcs_regions=True, reporter=rep,
            options=options(pkg, str(tmp_path / f'{name}_out'), 'v2-raw',
                            'auto', continue_on_error=True), **kw)
        (jax_merge if pkg is jax_pkg else merge) \
            .create_hcs_ome_zarr_per_timepoint(pipe)
    assert msgs['port'] == msgs['jax']
    assert msgs['port'] == [
        'error', 'merge: skipping region B2 (missing stitched output for '
        'timepoint(s) [1])', 'merge: plate t=1 skips missing region(s) '
        "['B2']"]
    want, got = tmp_path / 'jax_out', tmp_path / 'port_out'
    assert tree_files(str(got)) == tree_files(str(want))
    for rel in zarr_groups(str(want)):
        assert_trees_equal(str(want / rel), str(got / rel))
    assert not (got / 'hcs_timepoints' / 'complete_hcs.ome.zarr'
                / 'B').exists()


def test_one_and_four_workers_write_the_same_tree(tmp_path, monkeypatch):
    outs = []
    for workers in (1, 4):
        monkeypatch.setattr(merge, '_merge_worker_count',
                            lambda n, w=workers: w)
        name = f'w{workers}'
        acq = make_acquisition(str(tmp_path / name))
        pipe = port.stitch(acq, merge_timepoints=True, device=CPU,
                           options=options(port, str(tmp_path / f'{name}_out'),
                                           'v2-lz4', 'auto'))
        merge.create_hcs_ome_zarr_per_timepoint(pipe)
        outs.append(tmp_path / f'{name}_out')
    assert tree_files(str(outs[0])) == tree_files(str(outs[1]))
    merged_arrays = [a for a in array_dirs(str(outs[0]))
                     if '_stitched' not in a]
    assert len(merged_arrays) == 12
    for rel in merged_arrays:
        np.testing.assert_array_equal(read_array(str(outs[0] / rel)),
                                      read_array(str(outs[1] / rel)))


def test_failed_unit_aborts_its_writer_and_the_run_raises(tmp_path,
                                                          monkeypatch):
    """A merge unit that fails stops its encode pool (nothing is written
    after the error) and fails the run; the manifest keeps merges_done
    False, so a resumed run merges again."""
    import json
    real = merge._stream_volume_banded

    def failing(pipeline, writer, sources, num_levels):
        if any(ti == 1 for ti, _ in sources):
            raise RuntimeError("band read failed")
        return real(pipeline, writer, sources, num_levels)

    monkeypatch.setattr(merge, '_stream_volume_banded', failing)
    acq = make_acquisition(str(tmp_path / 'acq'))
    out = tmp_path / 'out'
    with pytest.raises(RuntimeError, match="band read failed"):
        port.stitch(acq, merge_timepoints=True, device=CPU,
                    options=options(port, str(out), 'v2-lz4', 'auto'))
    assert not [t for t in threading.enumerate()
                if t.name.startswith(('zarr-encode', 'merge'))]
    with open(out / '.stitch_manifest.json') as f:
        m = json.load(f)
    assert not m['merges_done'] and not m['finished']
    assert len(m['completed']) == 4


def test_ome_tiff_merges_still_raise_naming_item_10(tmp_path):
    """OME-TIFF output is ported (item 10); merges stay zarr-only: with
    ``.ome.tiff`` output both packages report "merge passes require
    .ome.zarr output; skipping merges" and return the last saved path,
    and write no merged store."""
    acq = make_acquisition(str(tmp_path / 'acq'))
    kw = dict(output_format='.ome.tiff', merge_timepoints=True,
              merge_hcs_regions=True)
    errors = {'jax': [], 'port': []}
    jpipe = jax_pkg.stitch(acq, reporter=JaxReporter(
        error=errors['jax'].append), options=jax_pkg.EngineOptions(
            fusion_device='device', output_folder=str(tmp_path / 'jax')),
        **kw)
    pipe = port.stitch(acq, device=CPU, reporter=ProgressReporter(
        error=errors['port'].append), options=port.EngineOptions(
            output_folder=str(tmp_path / 'port')), **kw)
    assert errors['port'] == errors['jax'] == [
        "merge passes require .ome.zarr output; skipping merges"]
    assert merge.run_merges(pipe) == pipe.saved_paths[-1]
    assert pipe.saved_paths[-1].endswith('1_stitched/B2_stitched.ome.tiff')
    for out, p in (('jax', jpipe), ('port', pipe)):
        assert sorted(os.listdir(tmp_path / out)) == [
            '.stitch_manifest.json', '0_stitched', '1_stitched'], out
    assert sorted(os.listdir(tmp_path / 'port' / '0_stitched')) == [
        'A1_stitched.ome.tiff', 'B2_stitched.ome.tiff']


def test_merge_fold_raises_on_a_cuda_pipeline_without_cuda(tmp_path):
    """No fallback to the host: a CUDA pipeline needs CUDA, merges
    included."""
    if torch.cuda.is_available():
        return   # the card runs the fold (tests/test_torch_cuda.py)
    acq = make_acquisition(str(tmp_path / 'acq'))
    with pytest.raises(RuntimeError, match="cuda"):
        port.stitch(acq, merge_timepoints=True)


def test_merge_stats_lose_no_update_under_many_workers():
    """Merge workers add their seconds and bytes to one MergeStats: with
    more threads than cores and a short switch interval, no add is
    lost."""
    import sys
    stats = merge.MergeStats()
    n_threads, n_adds = 4 * (os.cpu_count() or 1), 2000

    def work():
        for _ in range(n_adds):
            stats.add(bands=1, bytes_read=3, read_s=0.5)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    got = stats.as_dict()
    assert got['bands'] == n_threads * n_adds
    assert got['bytes_read'] == 3 * n_threads * n_adds
    assert got['read_s'] == 0.5 * n_threads * n_adds
