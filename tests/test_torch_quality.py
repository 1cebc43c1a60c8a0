"""The port's maximum-quality path against the JAX package's, end to end.

The path: every adjacent pair registered in batches (the device version
of the phase correlation; torch on the CPU here), the global per-tile
position solve, subpixel placement (a bilinear shift at load time) and
feathered blending in device bands. The JAX side runs
``fusion_device='device', streaming='on'`` on the CPU, on jittered
fixtures (``jitter=3``). The port runs its band fuser
(``streaming='on'``), and for the carried-state check also its in-RAM
path (``streaming='off'``). Three checks per configuration:
- with the JAX run's flatfields, shifts and global positions carried in
  (``state_from_reference``): level arrays within 1 LSB (feather sums:
  XLA may contract a multiply-add) and every metadata file equal;
- with the port's own fit and registration: the same solved tiles, float
  positions within 0.1 px of the JAX package's, the same grid shifts;
- the all-pairs scope (median of every pair, overwrite, no flatfield):
  equal aggregated shifts and an identical output tree.
"""

import json
import os

import numpy as np
import pytest
import torch

from fixtures import write_synthetic_acquisition
from torch_helpers import small_disk_probe  # noqa: F401
from image_stitcher_tpu import EngineOptions as JaxOptions
from image_stitcher_tpu import stitch as jax_stitch
from image_stitcher_tpu.io.zarr_store import open_zarr_array
import image_stitcher_tpu_torch as port
from image_stitcher_tpu_torch.io.zarr_store import read_array
from image_stitcher_tpu_torch.models.streaming import (band_canvas_shape,
                                                       band_rows_for)
from image_stitcher_tpu_torch.ops import cuda_fuse

CPU = torch.device('cpu')
CHANNELS = ["Fluorescence 488 nm Ex", "Fluorescence 561 nm Ex"]
# small batches of pairs go to the device version of the phase
# correlation in both packages, as the 90-pair batches of a 10x10 grid do
COMMON = dict(chunks=(1, 1, 1, 64, 64), device_band_multiple=1,
              registration_device_threshold=4, feather_px=24)
QUALITY = dict(registration_scope='global', subpixel_placement=True,
               blend_method='feather')
# (cols, rows, tile_w, tile_h, overlap, channels, regions)
CONFIGS = [
    (3, 3, 96, 96, 32, 1, ["A1"]),
    (4, 3, 112, 80, 28, 2, ["A1", "B2"]),    # non-square, two wells
]


def _tree(root):
    """{relative path: decoded array or parsed JSON} of an OME-Zarr tree."""
    out = {}
    for d, _, names in os.walk(root):
        rel = os.path.relpath(d, root)
        if '.zarray' in names:
            out[rel] = np.asarray(open_zarr_array(d).read().result())
        for n in names:
            if n in ('.zarray', '.zattrs', '.zgroup'):
                with open(os.path.join(d, n)) as f:
                    out[os.path.join(rel, n)] = json.load(f)
    return out


def _zarr_dirs(out):
    return sorted(os.path.join(d, f) for d in (os.path.join(out, t)
                  for t in os.listdir(out) if t.endswith('_stitched'))
                  for f in os.listdir(d) if f.endswith('.ome.zarr'))


def _acquisition(root, index):
    cols, rows, tw, th, ov, nch, regions = CONFIGS[index]
    acq = str(root / "acq")
    write_synthetic_acquisition(
        acq, grid_cols=cols, grid_rows=rows, tile_w=tw, tile_h=th,
        overlap=ov, channels=CHANNELS[:nch], regions=regions,
        seed=31 + index, jitter=3, acq_params_overrides={"pixel_binning": 2})
    return acq


@pytest.fixture(scope="module", params=range(len(CONFIGS)),
                ids=[f"cfg{i}" for i in range(len(CONFIGS))])
def jax_run(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"quality{request.param}")
    acq = _acquisition(root, request.param)
    out = str(root / "jax")
    pipe = jax_stitch(acq, use_registration=True, apply_flatfield=True,
                      options=JaxOptions(fusion_device='device',
                                         streaming='on',
                                         compressor_cname=None,
                                         output_folder=out, **COMMON,
                                         **QUALITY))
    assert pipe.global_positions_float
    return acq, out, pipe


def _port_run(acq, out, state=None, streaming='on'):
    return port.stitch(acq, use_registration=True, apply_flatfield=True,
                       device=CPU, state=state,
                       options=port.EngineOptions(output_folder=out,
                                                  streaming=streaming,
                                                  compressor_cname=None,
                                                  **COMMON, **QUALITY))


def test_carried_state_within_one_lsb(jax_run, tmp_path):
    acq, jax_out, jpipe = jax_run
    out = str(tmp_path / "port")
    state = port.state_from_reference(
        jpipe.flatfields, jpipe.shifts, jpipe.global_positions,
        jpipe.global_positions_float)
    pipe = _port_run(acq, out, state)
    assert pipe.global_positions == state.global_positions
    # tiles are placed with a fractional residual, shifted at load time
    # (the solve of integer jitter leaves residuals near 0 and near 1)
    jobs = pipe._build_jobs(0, sorted(pipe.global_positions)[0])
    assert any(job.fy or job.fx for job in jobs)
    _assert_trees_within_one_lsb(jax_out, out)


def test_in_ram_carried_state_within_one_lsb(jax_run, tmp_path):
    """Feathered fusion of whole canvases (no top apron: tiles at y = 0
    keep their ramps from the whole crop window) stays within 1 LSB of
    the JAX package's band streamer."""
    acq, jax_out, jpipe = jax_run
    out = str(tmp_path / "port")
    pipe = _port_run(acq, out, port.state_from_reference(
        jpipe.flatfields, jpipe.shifts, jpipe.global_positions,
        jpipe.global_positions_float), streaming='off')
    assert 'stream_fuse_save' not in pipe.timers.as_dict()
    assert all(s_['batches'] > 0 for s_ in pipe.fuse_stats.values())
    _assert_trees_within_one_lsb(jax_out, out)


def _assert_trees_within_one_lsb(jax_out, out):
    jdirs, pdirs = _zarr_dirs(jax_out), _zarr_dirs(out)
    assert [os.path.relpath(p, out) for p in pdirs] == \
        [os.path.relpath(p, jax_out) for p in jdirs]
    for jd, pd_ in zip(jdirs, pdirs):
        want, got = _tree(jd), _tree(pd_)
        assert sorted(got) == sorted(want)
        for key in want:
            if isinstance(want[key], np.ndarray):
                assert got[key].shape == want[key].shape, key
                diff = np.abs(got[key].astype(np.int64)
                              - want[key].astype(np.int64))
                assert diff.max() <= 1, key
                np.testing.assert_array_equal(
                    read_array(os.path.join(pd_, key)), got[key])
            else:
                assert got[key] == want[key], key


def test_padded_band_pitch_within_one_lsb(jax_run, tmp_path, monkeypatch):
    """The feathered band fuser accumulates into (acc, wsum) canvases whose
    rows are padded to a multiple of 8 floats; its tree stays within
    1 LSB of the JAX package's."""
    acq, jax_out, jpipe = jax_run
    shapes = []
    accumulate = cuda_fuse.fuse_feather

    def spy(acc, wsum, *args, **kwargs):
        shapes.append((tuple(acc.shape), tuple(wsum.shape)))
        return accumulate(acc, wsum, *args, **kwargs)

    monkeypatch.setattr(cuda_fuse, 'fuse_feather', spy)
    out = str(tmp_path / "port")
    pipe = _port_run(acq, out, port.state_from_reference(
        jpipe.flatfields, jpipe.shifts, jpipe.global_positions,
        jpipe.global_positions_float))
    th, tw = pipe.acq.input_height, pipe.acq.input_width
    band = band_rows_for(pipe.options.write_band_rows()
                         * pipe.options.device_band_multiple,
                         pipe.num_pyramid_levels)
    want = {band_canvas_shape(th, tw, band, pipe._region_dimensions(0, r)[0])
            for r in pipe.acq.regions}
    assert shapes and {a for a, _ in shapes} <= want
    assert all(a == w and a[3] % 8 == 0 for a, w in shapes)
    _assert_trees_within_one_lsb(jax_out, out)


def test_own_registration_positions_within_a_tenth(jax_run, tmp_path):
    acq, _, jpipe = jax_run
    pipe = _port_run(acq, str(tmp_path / "port"))
    assert pipe.device_pairs > 0
    assert pipe.shifts == port.state_from_reference(
        shifts=jpipe.shifts).shifts
    assert pipe._global_rejected == jpipe._global_rejected
    assert sorted(pipe.global_positions_float) == \
        sorted(jpipe.global_positions_float)
    for region, cells in jpipe.global_positions_float.items():
        got = pipe.global_positions_float[region]
        assert sorted(got) == sorted(cells)
        for key, (y, x) in cells.items():
            assert abs(got[key][0] - y) <= 0.1, (region, key)
            assert abs(got[key][1] - x) <= 0.1, (region, key)


@pytest.mark.parametrize("index", range(len(CONFIGS)),
                         ids=[f"cfg{i}" for i in range(len(CONFIGS))])
def test_all_pairs_shifts_equal(tmp_path, index):
    acq = _acquisition(tmp_path, index)
    opts = dict(COMMON, registration_scope='all-pairs')
    jpipe = jax_stitch(acq, use_registration=True,
                       options=JaxOptions(fusion_device='device',
                                          streaming='on',
                                          compressor_cname=None,
                                          output_folder=str(tmp_path / "jax"),
                                          **opts))
    pipe = port.stitch(acq, use_registration=True, device=CPU,
                       options=port.EngineOptions(
                           output_folder=str(tmp_path / "port"),
                           streaming='on', compressor_cname=None, **opts))
    assert pipe.device_pairs > 0
    assert pipe.shifts == port.state_from_reference(
        shifts=jpipe.shifts).shifts
    assert not pipe.global_positions
    for jd, pd_ in zip(_zarr_dirs(str(tmp_path / "jax")),
                       _zarr_dirs(str(tmp_path / "port"))):
        want, got = _tree(jd), _tree(pd_)
        assert sorted(got) == sorted(want)
        for key in want:
            if isinstance(want[key], np.ndarray):
                np.testing.assert_array_equal(got[key], want[key], key)
            else:
                assert got[key] == want[key], key


def test_cli_runs_the_maximum_quality_path_on_cpu(tmp_path):
    from image_stitcher_tpu_torch.cli import create_options, main, parse_args
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=2, tile_w=64,
                                tile_h=64, overlap=16, seed=3, jitter=2,
                                acq_params_overrides={"pixel_binning": 2})
    assert main(['-i', acq, '-r', '-ff', '--registration-scope', 'global',
                 '--subpixel-placement', '--blend-method', 'feather',
                 '--chunk-size', '64', '--device', 'cpu']) == 0
    outs = [d for d in os.listdir(tmp_path) if d.startswith('acq_stitched_')]
    assert len(outs) == 1
    level0 = read_array(str(tmp_path / outs[0] / '0_stitched'
                            / 'A1_stitched.ome.zarr' / '0'))
    assert level0.shape[:3] == (1, 1, 1) and level0.any()
    # --dynamic-registration selects all-pairs unless a scope is given
    opts = create_options(parse_args(['-i', acq, '--dynamic-registration']))
    assert opts.registration_scope == 'all-pairs'
    opts = create_options(parse_args(['-i', acq, '--dynamic-registration',
                                      '--registration-scope', 'center']))
    assert opts.registration_scope == 'center'
