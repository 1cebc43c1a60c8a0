"""The port's registration report and debug images against the JAX
package's.

Both packages measure the same acquisition with ``registration_report``
(and ``debug_visuals`` for the center pairs) and write
``registration_report.json`` and the strip PNGs into their output
folders. The reports must have the same keys, equal integers, strings
and aggregated shifts, per-pair dy/dx and solve residuals within 0.1 px
and confidences within 1e-3 relative: for the center scope, all pairs,
the global solve, a global solve that is rejected, and a 1x1 region.
The debug PNGs (written with ``cv2.imwrite`` by the JAX package and with
the port's own encoder) must decode, with ``cv2.imread``, to equal
arrays.
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from fixtures import write_synthetic_acquisition
from torch_helpers import small_disk_probe  # noqa: F401
from image_stitcher_tpu import EngineOptions as JaxOptions
from image_stitcher_tpu import stitch as jax_stitch
from image_stitcher_tpu.ops import globalopt as jax_globalopt
import image_stitcher_tpu_torch as port
from image_stitcher_tpu_torch.io.png import encode_gray8, write_gray8
from image_stitcher_tpu_torch.ops import globalopt as port_globalopt

CPU = torch.device('cpu')
CHUNKS = dict(chunks=(1, 1, 1, 64, 64))
PX_KEYS = ('dy', 'dx', 'residual_rms_px', 'residual_max_px')


def _assert_close(got, want, path='report'):
    """Same structure; px values within 0.1, confidences within 1e-3
    relative, everything else equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for key in want:
            _assert_close(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for k, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{path}[{k}]")
    elif path.endswith(PX_KEYS) and want is not None:
        assert abs(got - want) <= 0.1, (path, got, want)
    elif path.endswith('confidence'):
        assert abs(got - want) <= 1e-3 * abs(want), (path, got, want)
    else:
        assert got == want and type(got) is type(want), (path, got, want)


def _run_both(tmp_path, acq, options, **params):
    jpipe = jax_stitch(acq, use_registration=True, options=JaxOptions(
        fusion_device='device', streaming='off', compressor_cname=None,
        output_folder=str(tmp_path / "jax"), registration_report=True,
        **CHUNKS, **options), **params)
    pipe = port.stitch(acq, use_registration=True, device=CPU,
                       options=port.EngineOptions(
                           output_folder=str(tmp_path / "port"),
                           streaming='off', registration_report=True,
                           compressor_cname=None, **CHUNKS, **options),
                       **params)
    reports = []
    for out in (tmp_path / "port", tmp_path / "jax"):
        with open(out / "registration_report.json") as f:
            reports.append(json.load(f))
    return pipe, jpipe, reports[0], reports[1]


def test_center_report_and_debug_images(tmp_path):
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(acq, grid_cols=3, grid_rows=3, tile_w=96,
                                tile_h=80, overlap=24, seed=12,
                                acq_params_overrides={"pixel_binning": 2})
    pipe, jpipe, got, want = _run_both(tmp_path, acq,
                                       dict(debug_visuals=True),
                                       scan_pattern='S-Pattern')
    _assert_close(got, want)
    assert got['regions']['A1']['scope'] == 'center'
    names = sorted(n for n in os.listdir(tmp_path / "jax")
                   if n.endswith('.png'))
    assert names == ['horizontal.png', 'horizontal_rev.png', 'vertical.png']
    assert sorted(n for n in os.listdir(tmp_path / "port")
                  if n.endswith('.png')) == names
    # overlap_estimate: the 24 px overlap fudged by 1.05, halved, binned x2
    ox = oy = round(24 * 1.05) // 2 * 2
    shapes = {'horizontal.png': (80 - 2 * 20, 2 * ox),
              'horizontal_rev.png': (80 - 2 * 20, 2 * ox),
              'vertical.png': (2 * oy, 96 - 2 * 24)}
    for name in names:
        want_img = cv2.imread(str(tmp_path / "jax" / name),
                              cv2.IMREAD_UNCHANGED)
        got_img = cv2.imread(str(tmp_path / "port" / name),
                             cv2.IMREAD_UNCHANGED)
        assert got_img.dtype == np.uint8 and got_img.shape == shapes[name]
        np.testing.assert_array_equal(got_img, want_img)


@pytest.mark.parametrize("device_threshold", [32, 2],
                         ids=['host_twin', 'device_batch'])
def test_all_pairs_report(tmp_path, device_threshold):
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(acq, grid_cols=3, grid_rows=3, tile_w=96,
                                tile_h=96, overlap=32, jitter=2, seed=13,
                                acq_params_overrides={"pixel_binning": 2})
    _, _, got, want = _run_both(
        tmp_path, acq, dict(registration_scope='all-pairs',
                            registration_device_threshold=device_threshold))
    _assert_close(got, want)
    region = got['regions']['A1']
    assert region['scope'] == 'all-pairs' and len(region['pairs']) == 12
    assert 'global' not in region


def test_global_report(tmp_path):
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(acq, grid_cols=3, grid_rows=3, tile_w=96,
                                tile_h=96, overlap=32, jitter=3, seed=14,
                                regions=["A1", "B2"],
                                acq_params_overrides={"pixel_binning": 2})
    pipe, _, got, want = _run_both(tmp_path, acq,
                                   dict(registration_scope='global'))
    _assert_close(got, want)
    assert sorted(got['regions']) == ['A1', 'B2']
    for region in got['regions'].values():
        g = region['global']
        assert g['rejected'] is False and g['tiles_solved'] == 9
        assert g['residual_rms_px'] < 1.0
    assert pipe.global_positions.keys() == {'A1', 'B2'}


def test_rejected_global_report(tmp_path, monkeypatch):
    """A solve whose positions fly off the stage extent whatever is
    dropped: the region falls back to the grid model and the report
    says so, with the dropped constraints."""
    def flying(pairs, n_tiles):
        return np.arange(n_tiles, dtype=np.float64)[:, None] * [1e6, 1e6]

    monkeypatch.setattr(jax_globalopt, 'solve_positions', flying)
    monkeypatch.setattr(port_globalopt, 'solve_positions', flying)
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(acq, grid_cols=3, grid_rows=2, tile_w=96,
                                tile_h=96, overlap=32, seed=15,
                                acq_params_overrides={"pixel_binning": 2})
    pipe, jpipe, got, want = _run_both(tmp_path, acq,
                                       dict(registration_scope='global'))
    _assert_close(got, want)
    g = got['regions']['A1']['global']
    assert g['rejected'] is True and len(g['pairs_dropped']) == 3
    assert 'grid shift model used instead' in g['reason']
    assert pipe._global_rejected == jpipe._global_rejected == {'A1'}


def test_single_tile_region_report(tmp_path):
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(acq, grid_cols=1, grid_rows=1, tile_w=96,
                                tile_h=96, overlap=32,
                                acq_params_overrides={"pixel_binning": 2})
    _, _, got, want = _run_both(tmp_path, acq,
                                dict(registration_scope='global'))
    _assert_close(got, want)
    region = got['regions']['A1']
    assert region['pairs'] == []
    assert region['global']['residual_rms_px'] is None


def test_no_report_without_the_option(tmp_path):
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=1, tile_w=64,
                                tile_h=64, overlap=16,
                                acq_params_overrides={"pixel_binning": 2})
    pipe = port.stitch(acq, use_registration=True, device=CPU,
                       options=port.EngineOptions(
                           output_folder=str(tmp_path / "port"), **CHUNKS))
    assert not pipe.registration_reports
    # the run's folder holds its stores and its manifest, no report
    assert sorted(os.listdir(tmp_path / "port")) == ['.stitch_manifest.json',
                                                     '0_stitched']


@pytest.mark.parametrize("shape", [(1, 1), (7, 300), (64, 3), (128, 96)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_png_decodes_to_its_pixels(tmp_path, shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "a.png")
    write_gray8(path, img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                  img)
    with pytest.raises(ValueError):
        encode_gray8(img.astype(np.uint16))
