"""Acquisitions stored as PNG, BMP and LZW-compressed TIFF, scanned and
stitched by the port and by the JAX package (OpenCV), on the in-RAM path
and through the band fuser (``streaming='on'``): equal scans, equal
registration shifts and equal OME-Zarr trees."""

import os

import cv2
import numpy as np
import pytest
import torch

from fixtures import write_synthetic_acquisition
from torch_helpers import assert_outputs_equal, small_disk_probe  # noqa: F401
from image_stitcher_tpu import EngineOptions as JaxOptions
from image_stitcher_tpu import stitch as jax_stitch
from image_stitcher_tpu.io.acquisition import scan_acquisition as jax_scan
import image_stitcher_tpu_torch as port
from image_stitcher_tpu_torch.io.acquisition import scan_acquisition
from image_stitcher_tpu_torch.io.tiff import read_ifd

CPU = torch.device('cpu')
FORMATS = {'png': dict(ext='png', dtype=np.uint16),
           'bmp': dict(ext='bmp', dtype=np.uint8),
           'lzw_tiff': dict(ext='tiff', dtype=np.uint16)}
SCAN_FIELDS = ('timepoints', 'pixel_size_um', 'regions', 'channel_names',
               'monochrome_channels', 'monochrome_colors', 'num_c',
               'num_fovs_per_region', 'input_height', 'input_width', 'dtype',
               'rgb_channels')
OPTIONS = dict(compressor_cname=None, chunks=(1, 1, 1, 64, 64))


def write_acquisition(folder, fmt):
    """A 3x2 grid, two channels, in ``fmt``; 'lzw_tiff' rewrites each
    uncompressed tile with OpenCV's default TIFF writer (LZW, Predictor
    2)."""
    kw = FORMATS[fmt]
    write_synthetic_acquisition(
        folder, grid_cols=3, grid_rows=2, tile_w=80, tile_h=64, overlap=16,
        channels=["Fluorescence 488 nm Ex", "Fluorescence 561 nm Ex"],
        seed=17, acq_params_overrides={"pixel_binning": 2}, **kw)
    if fmt == 'lzw_tiff':
        tdir = os.path.join(folder, '0')
        for name in os.listdir(tdir):
            if name.endswith('.tiff'):
                path = os.path.join(tdir, name)
                assert cv2.imwrite(path, cv2.imread(path, cv2.IMREAD_UNCHANGED))
                with open(path, 'rb') as f:
                    assert read_ifd(f.read())[1][259] == (5,)
    return folder


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_scan_matches_jax(tmp_path, fmt):
    acq = write_acquisition(str(tmp_path / "acq"), fmt)
    want, got = jax_scan(acq), scan_acquisition(acq)
    for name in SCAN_FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    assert [r.filepath for r in got.tiles.values()] == \
        [r.filepath for r in want.tiles.values()]


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("streaming", ['off', 'on'], ids=['inram', 'band'])
def test_stitch_matches_jax(tmp_path, fmt, streaming):
    acq = write_acquisition(str(tmp_path / "acq"), fmt)
    jpipe = jax_stitch(acq, use_registration=True, options=JaxOptions(
        fusion_device='device', streaming=streaming,
        output_folder=str(tmp_path / "jax"), **OPTIONS))
    pipe = port.stitch(acq, use_registration=True, device=CPU,
                       options=port.EngineOptions(
                           streaming=streaming,
                           output_folder=str(tmp_path / "port"), **OPTIONS))
    assert pipe.shifts.h_shift == jpipe.shifts.h_shift
    assert pipe.shifts.v_shift == jpipe.shifts.v_shift
    assert ('stream_fuse_save' in pipe.timers.as_dict()) == (streaming == 'on')
    assert_outputs_equal(str(tmp_path / "jax"), str(tmp_path / "port"))
