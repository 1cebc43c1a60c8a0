"""The port's main stitching path against the JAX package's, end to end.

The JAX side runs its device band-streaming path on the CPU
(fusion_device='device', streaming='on', raw chunks); the port runs the
same acquisition on torch.device('cpu'), where its fusion wrapper takes
the plain PyTorch version, through its band fuser (streaming='on') and,
for the carried-state case, also through its in-RAM path
(streaming='off'), which must write the same tree. Two cases per
configuration:
- with the JAX run's flatfields and shifts carried in
  (state_from_reference): every level array and every metadata file of
  the output tree must be identical;
- with the port's own flatfield fit and registration: the shifts must be
  equal, and level 0 within 1 LSB on at most 0.1 % of pixels (the fit's
  resamples reach the pixels through the reciprocal field).
"""

import json
import os

import numpy as np
import pytest
import torch

from fixtures import write_synthetic_acquisition
from image_stitcher_tpu import EngineOptions as JaxOptions
from image_stitcher_tpu import stitch as jax_stitch
from image_stitcher_tpu.io.zarr_store import open_zarr_array
import image_stitcher_tpu_torch as port
from image_stitcher_tpu_torch.io.zarr_store import read_array
from image_stitcher_tpu_torch.models.streaming import (band_canvas_shape,
                                                       band_rows_for)
from image_stitcher_tpu_torch.ops import cuda_fuse

CPU = torch.device('cpu')
CHANNELS = ["Fluorescence 405 nm Ex", "Fluorescence 488 nm Ex",
            "Fluorescence 561 nm Ex"]
# (cols, rows, tile_w, tile_h, overlap, channels, z, jitter, regions,
# engine options), in the style of tests/test_backend_fuzz.py::CONFIGS,
# registration and flatfield on
BANDS = dict(chunks=(1, 1, 1, 64, 64), device_band_multiple=1)
CONFIGS = [
    (4, 2, 128, 128, 32, 1, 1, 0, ["A1"], BANDS),
    (2, 4, 128, 64, 24, 2, 1, 2, ["A1"], BANDS),      # non-square, jitter
    (3, 3, 96, 80, 24, 3, 2, 0, ["A1", "B2"], BANDS),  # deep z, two wells
    # eight wells: two pyramid levels; taller bands over narrower chunks,
    # mean pyramid
    (3, 3, 128, 128, 32, 1, 1, 0, [f"{r}1" for r in "ABCDEFGH"],
     dict(chunks=(1, 1, 1, 32, 64), device_band_multiple=2,
          pyramid_downsample='mean')),
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


@pytest.fixture(scope="module", params=range(len(CONFIGS)),
                ids=[f"cfg{i}" for i in range(len(CONFIGS))])
def jax_run(request, tmp_path_factory):
    cols, rows, tw, th, ov, nch, nz, jitter, regions, opts = \
        CONFIGS[request.param]
    root = tmp_path_factory.mktemp(f"slice{request.param}")
    acq = str(root / "acq")
    write_synthetic_acquisition(
        acq, grid_cols=cols, grid_rows=rows, tile_w=tw, tile_h=th,
        overlap=ov, channels=CHANNELS[:nch], num_z=nz, regions=regions,
        seed=17 + request.param, jitter=jitter,
        acq_params_overrides={"pixel_binning": 2})
    out = str(root / "jax")
    pipe = jax_stitch(acq, use_registration=True, apply_flatfield=True,
                      options=JaxOptions(
                          fusion_device='device', streaming='on',
                          compressor_cname=None, output_folder=out, **opts))
    assert pipe.num_pyramid_levels == (2 if len(regions) == 8 else 1)
    return acq, out, pipe, opts


def _port_run(acq, out, opts, state=None, streaming='on'):
    return port.stitch(acq, use_registration=True, apply_flatfield=True,
                       device=CPU, state=state,
                       options=port.EngineOptions(output_folder=out,
                                                  streaming=streaming,
                                                  **opts))


def _zarr_dirs(out):
    return sorted(os.path.join(d, f) for d in (os.path.join(out, t)
                  for t in os.listdir(out) if t.endswith('_stitched'))
                  for f in os.listdir(d) if f.endswith('.ome.zarr'))


def test_carried_state_tree_identical(jax_run, tmp_path):
    acq, jax_out, jpipe, opts = jax_run
    out = str(tmp_path / "port")
    pipe = _port_run(acq, out, opts, port.state_from_reference(
        jpipe.flatfields, jpipe.shifts))
    assert pipe.shifts == port.state_from_reference(
        shifts=jpipe.shifts).shifts
    _assert_trees_identical(jax_out, out)


def _assert_trees_identical(jax_out, out):
    jdirs, pdirs = _zarr_dirs(jax_out), _zarr_dirs(out)
    assert [os.path.relpath(p, out) for p in pdirs] == \
        [os.path.relpath(p, jax_out) for p in jdirs]
    for jd, pd_ in zip(jdirs, pdirs):
        want, got = _tree(jd), _tree(pd_)
        assert sorted(got) == sorted(want)
        for key in want:
            if isinstance(want[key], np.ndarray):
                np.testing.assert_array_equal(got[key], want[key], key)
                # the port's own reader decodes its tree the same way
                np.testing.assert_array_equal(
                    read_array(os.path.join(pd_, key)), want[key], key)
            else:
                assert got[key] == want[key], key


def test_padded_band_pitch_tree_identical(jax_run, tmp_path, monkeypatch):
    """The band fuser hands the kernel canvases whose rows are padded to
    a multiple of 8 elements; the tree stays identical to the JAX
    package's."""
    acq, jax_out, jpipe, opts = jax_run
    shapes = []
    place = cuda_fuse.fuse_overwrite

    def spy(canvas, *args, **kwargs):
        shapes.append(tuple(canvas.shape))
        return place(canvas, *args, **kwargs)

    monkeypatch.setattr(cuda_fuse, 'fuse_overwrite', spy)
    out = str(tmp_path / "port")
    pipe = _port_run(acq, out, opts, port.state_from_reference(
        jpipe.flatfields, jpipe.shifts))
    th, tw = pipe.acq.input_height, pipe.acq.input_width
    band = band_rows_for(pipe.options.write_band_rows()
                         * pipe.options.device_band_multiple,
                         pipe.num_pyramid_levels)
    want = {band_canvas_shape(th, tw, band, pipe._region_dimensions(0, r)[0])
            for r in pipe.acq.regions}
    assert shapes and set(shapes) <= want
    assert all(s[3] % 8 == 0 for s in shapes)
    _assert_trees_identical(jax_out, out)


def test_in_ram_tree_identical(jax_run, tmp_path, monkeypatch):
    """The in-RAM path (one whole canvas per region, pyramid built from
    it) writes the tree the JAX package's band streamer writes; the
    kernel gets the whole (C, Z, Hp, Wp) canvas, rows padded to 8."""
    acq, jax_out, jpipe, opts = jax_run
    shapes = []
    place = cuda_fuse.fuse_overwrite

    def spy(canvas, *args, **kwargs):
        shapes.append(tuple(canvas.shape))
        return place(canvas, *args, **kwargs)

    monkeypatch.setattr(cuda_fuse, 'fuse_overwrite', spy)
    out = str(tmp_path / "port")
    pipe = _port_run(acq, out, opts, port.state_from_reference(
        jpipe.flatfields, jpipe.shifts), streaming='off')
    acqd = pipe.acq
    want = set()
    for r in acqd.regions:
        w, h = pipe._region_dimensions(0, r)
        want.add((acqd.num_c, acqd.num_z, h + acqd.input_height,
                  -(-(w + acqd.input_width) // 8) * 8))
        jobs = len(pipe._build_jobs(0, r))
        assert pipe.fuse_stats[f"{r}_t0"] == {
            'batches': -(-jobs // pipe.options.fusion_batch)}
    assert set(shapes) == want
    assert 'stream_fuse_save' not in pipe.timers.as_dict()
    _assert_trees_identical(jax_out, out)


@pytest.mark.parametrize("width, tile_w", [(18635, 2048), (340, 120),
                                           (1, 1), (96, 32), (1100, 1100)])
def test_band_canvas_shape_pads_rows_to_eight(width, tile_w):
    shape = band_canvas_shape(100, tile_w, 64, width)
    assert shape[:3] == (1, 1, 100 + 64 + 100)
    assert shape[3] % 8 == 0
    assert width + tile_w <= shape[3] < width + tile_w + 8
    if width == 18635:   # the main path's band: 20683 padded to 20688
        assert shape[3] == 20688


def test_own_fit_within_one_lsb(jax_run, tmp_path):
    acq, jax_out, jpipe, opts = jax_run
    out = str(tmp_path / "port")
    pipe = _port_run(acq, out, opts)
    assert pipe.shifts == port.state_from_reference(
        shifts=jpipe.shifts).shifts
    for jd, pd_ in zip(_zarr_dirs(jax_out), _zarr_dirs(out)):
        want = np.asarray(open_zarr_array(os.path.join(jd, '0'))
                          .read().result()).astype(np.int64)
        got = read_array(os.path.join(pd_, '0')).astype(np.int64)
        assert got.shape == want.shape
        diff = np.abs(got - want)
        assert diff.max() <= 1
        assert (diff > 0).mean() <= 1e-3


def test_cli_runs_the_slice_on_cpu(tmp_path):
    from image_stitcher_tpu_torch.cli import main
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=2, tile_w=64,
                                tile_h=64, overlap=16, seed=3,
                                acq_params_overrides={"pixel_binning": 2})
    assert main(['-i', acq, '-r', '-ff', '--chunk-size', '64',
                 '--device', 'cpu']) == 0
    outs = [d for d in os.listdir(tmp_path) if d.startswith('acq_stitched_')]
    assert len(outs) == 1
    zarr = tmp_path / outs[0] / '0_stitched' / 'A1_stitched.ome.zarr' / '0'
    # registered canvas: the reference's geometry (its height formula
    # adds the vertical overlap instead of removing it)
    assert read_array(str(zarr)).shape == (1, 1, 1, 144, 112)


@pytest.mark.parametrize("option", [
    # feather and the global scope run; with an unported companion
    # option they still raise, naming it
    dict(blend_method='feather', zarr_format=3),
    dict(registration_scope='global', fusion_device='host'),
    dict(fusion_device='host'),
    dict(zarr_format=3), dict(compressor_cname='lz4'),
    dict(mesh_shape=(1, 2)),
    dict(work_shard=(0, 2), output_folder='/nonexistent')],
    ids=lambda d: next(iter(d)))
def test_unported_options_raise(tmp_path, option):
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=1, tile_w=32,
                                tile_h=32, overlap=8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.stitch(acq, device=CPU, options=port.EngineOptions(**option))


@pytest.mark.parametrize("param", [dict(output_format='.ome.tiff'),
                                   dict(merge_timepoints=True),
                                   dict(merge_hcs_regions=True),
                                   dict(resume=True)],
                         ids=lambda d: next(iter(d)))
def test_unported_parameters_raise(tmp_path, param):
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=1, tile_w=32,
                                tile_h=32, overlap=8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.stitch(acq, device=CPU, **param)


def test_cuda_by_default_and_never_a_silent_cpu_run(tmp_path):
    from image_stitcher_tpu_torch.models.pipeline import resolve_device
    if torch.cuda.is_available():
        assert resolve_device().type == 'cuda'
        return
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=1, tile_w=32,
                                tile_h=32, overlap=8)
    with pytest.raises(RuntimeError, match="cuda"):
        port.stitch(acq)
    assert not any(d.startswith('acq_stitched_') for d in os.listdir(tmp_path))


@pytest.mark.parametrize("compressible", [False, True])
def test_compressor_auto_stores_raw_or_refuses(tmp_path, compressible):
    """'auto' stores raw chunks for content that does not compress, and
    refuses (blosc-lz4 is not ported) for content that does."""
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=1, tile_w=64,
                                tile_h=64, overlap=16,
                                gt_quantize_bits=12 if compressible else 0)
    options = port.EngineOptions(compressor_cname='auto',
                                 output_folder=str(tmp_path / "out"))
    if compressible:
        with pytest.raises(NotImplementedError, match="blosc-lz4"):
            port.stitch(acq, device=CPU, options=options)
        return
    port.stitch(acq, device=CPU, options=options)
    with open(tmp_path / "out" / "0_stitched" / "A1_stitched.ome.zarr" / "0"
              / ".zarray") as f:
        assert json.load(f)["compressor"] is None
