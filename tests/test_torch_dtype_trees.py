"""Whole runs of the JAX package and the port on tiles of every sample
type the port stitches beyond uint8/uint16.

One seeded 3x2 grid of 128x96 tiles a sample type (two channels, jitter, the JAX fixture's
writer), stitched by the JAX package on the CPU and by the port on
``torch.device('cpu')`` through each path of :data:`PATHS`, the JAX run's
fields, shifts and positions carried into the port's. The bars:

- overwrite, every dtype: the trees are equal, byte for byte where the
  JAX package's files are raw or lz4 (``torch_helpers.assert_trees_equal``);
  on a mesh of two devices (the JAX package's virtual CPU devices, the
  port's ``[cpu] * 2``) the levels decode equal (the JAX mesh path saves
  the assembled canvas, the port's streams its bands, as
  ``tests/test_torch_mesh_e2e.py`` says);
- feathered float32, float64 and int32: every level within
  :data:`FEATHER_ULPS` float32 ulps of the JAX package's. XLA on the CPU
  contracts each term of the feathered sum, ``acc + ramp * tile``, into a
  fused multiply-add; the port (its plain version and its CUDA kernel,
  bit for bit) rounds the product first. A term's product then differs
  by at most half an ulp, a pixel of these grids sums at most four
  terms, and the quotient rounds once more: a few ulps. For
  8- and 16-bit integers the final round to an integer hides it, and
  those trees are equal;
- where the JAX package raises (uint32 with a field or feathering on
  the device paths, whose jitted clips take no uint32 bound; int8, int32,
  uint32 and float16 with subpixel placement, which OpenCV's warpAffine
  does not take; float16 to OME-Zarr, which its writer has no type for),
  the port raises too: ``OverflowError`` for uint32, as the JAX
  package; ``TypeError`` where the JAX package raises ``cv2.error`` or
  ``KeyError``. Its host fuser (``fusion_device='host'``) clips in NumPy
  and takes uint32 with a field, in both packages.

float16 tiles reach ``.ome.tiff`` only, in both packages: its grid is
the uint16 grid's values / 16 rewritten as deflate + Predictor 3 TIFFs
(OpenCV, the fixture's writer, writes no float16), and :data:`TIFF_PATHS`
stitch it, and the uint16 grid, to ``.ome.tiff`` on every path that
writes one. Overwrite files are the JAX package's byte for byte, but on
the host-fused band path, whose tiles' data both packages lay out in the
order their band threads finish, and on a mesh, whose JAX run saves the
assembled canvas: there the pages, descriptions and SubIFD levels decode
equal. Feathered float16 pages are within :data:`FEATHER_F16_ULPS`
float16 ulp (the FMA's float32 difference can straddle a float16
rounding boundary).
"""

import glob
import os

import cv2
import numpy as np
import pytest
import torch

from fixtures import write_synthetic_acquisition
from torch_helpers import (assert_outputs_equal, assert_tiff_outputs_equal,
                           small_disk_probe, zarr_groups)  # noqa: F401
from image_stitcher_tpu import EngineOptions as JaxOptions
from image_stitcher_tpu import stitch as jax_stitch
import image_stitcher_tpu_torch as port
from image_stitcher_tpu_torch.io.zarr_store import read_array

CPU = torch.device('cpu')
CHANNELS = ["Fluorescence 405 nm Ex", "Fluorescence 488 nm Ex"]
RAW = dict(chunks=(1, 1, 1, 64, 64), device_band_multiple=1,
           compressor_cname=None)
REG_FF = dict(use_registration=True, apply_flatfield=True)
#: path -> (stitch keywords, engine options)
PATHS = {
    'inram': (REG_FF, dict(RAW, streaming='off')),
    'bands': (REG_FF, dict(RAW, streaming='on')),
    'bands_no_field': (dict(use_registration=True),
                       dict(RAW, streaming='on')),
    'host': (REG_FF, dict(RAW, fusion_device='host', streaming='on')),
    'feather': (REG_FF, dict(RAW, blend_method='feather', streaming='on')),
    'global_subpixel': (dict(use_registration=True),
                        dict(RAW, registration_scope='global',
                             subpixel_placement=True,
                             blend_method='feather', streaming='on')),
    'mean': (REG_FF, dict(RAW, pyramid_downsample='mean', streaming='on',
                          chunks=(1, 1, 1, 32, 32))),
    'ome_tiff': (dict(REG_FF, output_format='.ome.tiff'),
                 dict(streaming='off')),
    'zstd': (dict(use_registration=True),
             dict(RAW, compressor_cname='zstd', compressor_clevel=1,
                  streaming='on')),
    'merges': (dict(use_registration=True, merge_timepoints=True,
                    merge_hcs_regions=True), dict(RAW, streaming='on')),
    'mesh': (REG_FF, dict(RAW, mesh_shape=(1, 2))),
}
FEATHERED = ('feather', 'global_subpixel')
FEATHER_ULPS = 4
FEATHER_F16_ULPS = 1
TIFF = dict(output_format='.ome.tiff')
#: path -> (stitch keywords, engine options): every path that writes
#: ``.ome.tiff``
TIFF_PATHS = {
    'bands': (dict(REG_FF, **TIFF), dict(streaming='on',
                                         device_band_multiple=1)),
    'host': (dict(REG_FF, **TIFF), dict(fusion_device='host',
                                        streaming='off')),
    'host_bands': (dict(REG_FF, **TIFF), dict(fusion_device='host',
                                              streaming='on')),
    'host_feather': (dict(REG_FF, **TIFF), dict(fusion_device='host',
                                                blend_method='feather',
                                                streaming='off')),
    'feather': (dict(REG_FF, **TIFF), dict(blend_method='feather',
                                           streaming='on')),
    'feather_inram': (dict(REG_FF, **TIFF), dict(blend_method='feather',
                                                 streaming='off')),
    'mean': (dict(REG_FF, **TIFF), dict(pyramid_downsample='mean',
                                        streaming='on')),
    'mean_inram': (dict(REG_FF, **TIFF), dict(pyramid_downsample='mean',
                                              streaming='off')),
    'mesh': (dict(REG_FF, **TIFF), dict(mesh_shape=(1, 2))),
    # both packages skip the merges of an .ome.tiff run
    'merges': (dict(use_registration=True, merge_timepoints=True,
                    merge_hcs_regions=True, **TIFF), dict(streaming='on')),
    'subpixel': (dict(use_registration=True, **TIFF),
                 dict(registration_scope='global', subpixel_placement=True,
                      blend_method='feather', streaming='on')),
}


def acquisition(root, dtype, merges: bool) -> str:
    acq = str(root / f"acq_{dtype.name}{'_merge' if merges else ''}")
    if not os.path.exists(acq):
        extra = dict(regions=['A1', 'B1'], timepoints=2) if merges else {}
        half = dtype == np.float16
        write_synthetic_acquisition(
            acq, grid_cols=3, grid_rows=2, tile_w=128, tile_h=96,
            overlap=24, channels=CHANNELS,
            dtype=np.uint16 if half else dtype, seed=5, jitter=2,
            acq_params_overrides={"pixel_binning": 2}, **extra)
        if half:
            from torch_tile_files import tiff_bytes
            for path in glob.glob(acq + "/*/*.tiff"):
                img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
                with open(path, 'wb') as f:
                    f.write(tiff_bytes((img.astype(np.float32) / 16)
                                       .astype(np.float16), 8, 3))
    return acq


def assert_within_ulps(want_out: str, got_out: str, ulps: int) -> None:
    """Every level array of two runs' OME-Zarr groups within ``ulps``
    float32 ulps of each other (floats as float32 bits, integers by the
    float32 spacing at their value; 0: decoded equal)."""
    groups = zarr_groups(want_out)
    assert groups and zarr_groups(got_out) == groups
    for rel in groups:
        for lv in sorted(glob.glob(os.path.join(want_out, rel, '[0-9]'))):
            want = read_array(lv)
            got = read_array(os.path.join(got_out, rel,
                                          os.path.basename(lv)))
            assert got.shape == want.shape and got.dtype == want.dtype
            if want.dtype.kind == 'f':
                a = want.astype(np.float32).view(np.int32).astype(np.int64)
                b = got.astype(np.float32).view(np.int32).astype(np.int64)
                assert np.abs(a - b).max(initial=0) <= ulps, lv
            else:
                diff = np.abs(want.astype(np.int64) - got.astype(np.int64))
                room = ulps * np.spacing(np.abs(want).astype(np.float32))
                assert (diff <= room).all(), lv


def refusal(dtype: np.dtype, path: str, paths=PATHS):
    """(the JAX package's exception, the port's, what the port's message
    names) where the JAX package refuses the path for the dtype, else
    None."""
    kw, opts = paths[path]
    tiff = kw.get('output_format') == '.ome.tiff'
    if dtype.name == 'float16' and not tiff:
        return KeyError, TypeError, 'float16'
    if opts.get('subpixel_placement') and dtype.name in ('int8', 'int32',
                                                         'uint32', 'float16'):
        return cv2.error, TypeError, dtype.name
    if (dtype.name == 'uint32' and opts.get('fusion_device') != 'host'
            and (kw.get('apply_flatfield')
                 or opts.get('blend_method') == 'feather')):
        return OverflowError, OverflowError, 'uint32'
    return None


def run_path(tmp_path_factory, dtype, path: str, paths=PATHS) -> None:
    """Stitch the dtype's grid through ``paths[path]`` with both packages
    and hold the port's output to the JAX package's (see the module's
    bars)."""
    dtype = np.dtype(dtype)
    kw, opts = paths[path]
    root = tmp_path_factory.getbasetemp() / f"dtype_trees_{dtype.name}"
    root.mkdir(exist_ok=True)
    acq = acquisition(root, dtype, path == 'merges')
    tag = 'tiff_' if paths is TIFF_PATHS else ''
    jax_out = str(root / f"{tag}{path}_jax")
    out = str(root / f"{tag}{path}_port")
    device = [CPU] * 2 if opts.get('mesh_shape') else CPU
    refused = refusal(dtype, path, paths)
    if refused is not None:
        jax_error, error, match = refused
        with pytest.raises(jax_error):
            jax_stitch(acq, options=JaxOptions(output_folder=jax_out,
                                               **opts), **kw)
        with pytest.raises(error, match=match):
            port.stitch(acq, device=device, options=port.EngineOptions(
                output_folder=out, **opts), **kw)
        return
    jpipe = jax_stitch(acq, options=JaxOptions(output_folder=jax_out,
                                               **opts), **kw)
    state = port.state_from_reference(jpipe.flatfields, jpipe.shifts,
                                      jpipe.global_positions,
                                      jpipe.global_positions_float)
    port.stitch(acq, device=device, state=state,
                options=port.EngineOptions(output_folder=out, **opts), **kw)
    if kw.get('output_format') == '.ome.tiff':
        feathered = opts.get('blend_method') == 'feather'
        assert_tiff_outputs_equal(
            jax_out, out,
            lsb=(FEATHER_F16_ULPS if feathered and dtype.name == 'float16'
                 else 0),
            decoded=(opts.get('fusion_device') == 'host'
                     and opts.get('streaming') == 'on'
                     or 'mesh_shape' in opts))
    elif path in FEATHERED and dtype.name in ('float32', 'float64', 'int32'):
        assert_within_ulps(jax_out, out, FEATHER_ULPS)
    elif opts.get('mesh_shape'):
        assert_within_ulps(jax_out, out, 0)
    else:
        assert_outputs_equal(jax_out, out)


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("dtype", ['int8', 'int16', 'int32', 'uint32',
                                   'float16', 'float32', 'float64'])
def test_tree_equals_the_jax_package(tmp_path_factory, dtype, path):
    run_path(tmp_path_factory, dtype, path)


@pytest.mark.parametrize("path", list(TIFF_PATHS))
@pytest.mark.parametrize("dtype", ['uint16', 'float16'])
def test_ome_tiff_equals_the_jax_package(tmp_path_factory, dtype, path):
    """float16 and uint16 grids to ``.ome.tiff`` on every path that writes
    it (the host-fused band path by decoded pages: both packages lay its
    tiles' data out in the order their band threads finish)."""
    run_path(tmp_path_factory, dtype, path, TIFF_PATHS)
