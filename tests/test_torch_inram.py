"""The port's in-RAM path against the JAX package's, end to end.

Canvases under ``streaming_threshold_bytes`` (every well of an HCS
plate) are fused whole on the device and saved with a pyramid built on
the device. The JAX side runs that path on the CPU
(``fusion_device='device', streaming='off'``); the port runs
``streaming='off'`` on ``torch.device('cpu')``, where the fusion
wrappers take their plain versions. Per configuration (overwrite and
feather, one to eight wells, Z = 2, both pyramid modes):
- with the JAX run's flatfields and shifts carried in: every level array
  and metadata file equal, feathered trees included;
- with the port's own fit and registration: equal shifts, level 0
  within 1 LSB on at most 0.1 % of pixels;
- the pipelined save writes the tree the unpipelined save writes.
Then the save's failure modes, cancellation, the path choice, and the
device flatfield solver inside the pipeline.
"""

import json
import os
import threading

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
from image_stitcher_tpu_torch.models.pipeline import StitchPipeline
from image_stitcher_tpu_torch.ops import cuda_fuse

CPU = torch.device('cpu')
CHANNELS = ["Fluorescence 405 nm Ex", "Fluorescence 488 nm Ex"]
CHUNKS = dict(chunks=(1, 1, 1, 64, 64))
# (cols, rows, tile_w, tile_h, overlap, channels, z, wells, options)
CONFIGS = [
    (3, 3, 96, 80, 24, 2, 2, ["A1"], {}),
    (4, 2, 112, 96, 28, 1, 1, ["A1", "B2"],
     dict(blend_method='feather', feather_px=24)),
    # eight wells: two pyramid levels, mean pyramid
    (3, 3, 128, 128, 32, 1, 2, [f"{r}1" for r in "ABCDEFGH"],
     dict(pyramid_downsample='mean')),
    (2, 3, 96, 96, 24, 2, 2, ["A1", "A2"],
     dict(blend_method='feather', feather_px=16, pyramid_downsample='mean')),
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


def _assert_trees(want_root, got_root):
    wdirs, gdirs = _zarr_dirs(want_root), _zarr_dirs(got_root)
    assert [os.path.relpath(p, got_root) for p in gdirs] == \
        [os.path.relpath(p, want_root) for p in wdirs]
    for wd, gd in zip(wdirs, gdirs):
        want, got = _tree(wd), _tree(gd)
        assert sorted(got) == sorted(want)
        for key in want:
            if not isinstance(want[key], np.ndarray):
                assert got[key] == want[key], key
                continue
            np.testing.assert_array_equal(got[key], want[key], key)
            np.testing.assert_array_equal(read_array(os.path.join(gd, key)),
                                          got[key])


def _acquisition(root, index, **kw):
    cols, rows, tw, th, ov, nch, nz, wells, _ = CONFIGS[index]
    acq = str(root / "acq")
    write_synthetic_acquisition(
        acq, grid_cols=cols, grid_rows=rows, tile_w=tw, tile_h=th,
        overlap=ov, channels=CHANNELS[:nch], num_z=nz, regions=wells,
        seed=41 + index, acq_params_overrides={"pixel_binning": 2}, **kw)
    return acq


@pytest.fixture(scope="module", params=range(len(CONFIGS)),
                ids=[f"cfg{i}" for i in range(len(CONFIGS))])
def jax_run(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"inram{request.param}")
    acq = _acquisition(root, request.param)
    opts = dict(CHUNKS, **CONFIGS[request.param][-1])
    out = str(root / "jax")
    pipe = jax_stitch(acq, use_registration=True, apply_flatfield=True,
                      options=JaxOptions(fusion_device='device',
                                         streaming='off',
                                         compressor_cname=None,
                                         output_folder=out, **opts))
    if len(CONFIGS[request.param][-2]) == 8:
        assert pipe.num_pyramid_levels == 2
    return acq, out, pipe, opts


def _port_run(acq, out, opts, state=None, **extra):
    return port.stitch(acq, use_registration=True, apply_flatfield=True,
                       device=CPU, state=state,
                       options=port.EngineOptions(output_folder=out,
                                                  streaming='off',
                                                  compressor_cname=None,
                                                  **dict(opts, **extra)))


def _carried(jpipe):
    return port.state_from_reference(jpipe.flatfields, jpipe.shifts)


def test_carried_state_tree_equal(jax_run, tmp_path):
    acq, jax_out, jpipe, opts = jax_run
    out = str(tmp_path / "port")
    pipe = _port_run(acq, out, opts, _carried(jpipe))
    timers = pipe.timers.as_dict()
    assert 'fuse' in timers and 'save' in timers
    assert 'stream_fuse_save' not in timers
    assert sorted(pipe.fuse_stats) == sorted(f"{r}_t0"
                                             for r in pipe.acq.regions)
    _assert_trees(jax_out, out)


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


def test_pipelined_save_writes_the_unpipelined_tree(jax_run, tmp_path):
    acq, _, jpipe, opts = jax_run
    outs = {}
    for pipelined in (False, True):
        outs[pipelined] = str(tmp_path / f"port_{pipelined}")
        _port_run(acq, outs[pipelined], opts, _carried(jpipe),
                  pipelined_save=pipelined)
    _assert_trees(outs[False], outs[True])


def _two_wells(tmp_path):
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=2, tile_w=64,
                                tile_h=64, overlap=16, regions=["A1", "B2"],
                                seed=9, acq_params_overrides={
                                    "pixel_binning": 2})
    return acq


def _failing_save(monkeypatch, region='A1'):
    save = StitchPipeline.save_region

    def flaky(self, t, reg, canvas, **kw):
        if reg == region:
            raise OSError(f"disk full while saving {reg}")
        return save(self, t, reg, canvas, **kw)

    monkeypatch.setattr(StitchPipeline, 'save_region', flaky)


@pytest.mark.parametrize("pipelined", [False, True])
def test_failed_save_raises(tmp_path, monkeypatch, pipelined):
    acq = _two_wells(tmp_path)
    _failing_save(monkeypatch)
    with pytest.raises(OSError, match="disk full while saving A1"):
        port.stitch(acq, device=CPU, options=port.EngineOptions(
            output_folder=str(tmp_path / "out"), streaming='off',
            pipelined_save=pipelined, **CHUNKS))


@pytest.mark.parametrize("pipelined", [False, True])
def test_failed_save_skipped_under_continue_on_error(tmp_path, monkeypatch,
                                                     pipelined):
    acq = _two_wells(tmp_path)
    _failing_save(monkeypatch)
    errors = []
    pipe = port.stitch(acq, device=CPU,
                       reporter=port.ProgressReporter(error=errors.append),
                       options=port.EngineOptions(
                           output_folder=str(tmp_path / "out"),
                           streaming='off', pipelined_save=pipelined,
                           continue_on_error=True, **CHUNKS))
    assert len(errors) == 1 and "region A1 t0 failed: disk full" in errors[0]
    assert [os.path.basename(p) for p in pipe.saved_paths] == \
        ["B2_stitched.ome.zarr"]
    assert not os.path.exists(str(tmp_path / "out" / "0_stitched"
                                  / "A1_stitched.ome.zarr" / "0" / "0"))


def test_cancel_between_regions(tmp_path):
    """A stop between regions ends the run with StitchCancelled once the
    region in flight has saved."""
    acq = _two_wells(tmp_path)
    stop = threading.Event()
    with pytest.raises(port.StitchCancelled):
        port.stitch(acq, device=CPU, stop_event=stop,
                    reporter=port.ProgressReporter(
                        starting_saving=lambda merged: stop.set()),
                    options=port.EngineOptions(
                        output_folder=str(tmp_path / "out"), streaming='off',
                        **CHUNKS))
    level0 = tmp_path / "out" / "0_stitched" / "A1_stitched.ome.zarr" / "0"
    assert read_array(str(level0)).any()
    assert not (tmp_path / "out" / "0_stitched" / "B2_stitched.ome.zarr"
                ).exists()


@pytest.mark.parametrize("streaming, threshold, streams", [
    ('auto', 256 << 20, False), ('auto', 1000, True), ('on', 256 << 20, True),
    ('off', 1000, False)])
def test_path_choice(tmp_path, streaming, threshold, streams):
    """'auto' streams only canvases over the threshold (unpadded
    (C, Z, H, W) bytes: 112 x 112 u16 = 25088 here); 'on' and 'off'
    force the path."""
    acq = _two_wells(tmp_path)
    pipe = port.stitch(acq, device=CPU, options=port.EngineOptions(
        output_folder=str(tmp_path / "out"), streaming=streaming,
        streaming_threshold_bytes=threshold, **CHUNKS))
    assert pipe._should_stream(0, 'A1') is streams
    timers = pipe.timers.as_dict()
    assert ('stream_fuse_save' in timers) is streams
    assert ('fuse' in timers and 'save' in timers) is not streams
    assert all(('fuse' in s_) is streams for s_ in pipe.fuse_stats.values())


def test_device_flatfield_matches_jax(tmp_path):
    """flatfield_device='device': each channel's stack padded by cycling
    to flatfield_max_tiles + flatfield_tiles_per_timepoint, fitted with
    the torch solver (on the CPU here), stretched on the host: the fields
    within 1e-4 of the JAX package's device fit."""
    acq = _acquisition(tmp_path, 0)
    opts = dict(CHUNKS, flatfield_device='device')
    jpipe = jax_stitch(acq, apply_flatfield=True, options=JaxOptions(
        fusion_device='device', streaming='off', compressor_cname=None,
        output_folder=str(tmp_path / "jax"), **opts))
    pipe = port.stitch(acq, apply_flatfield=True, device=CPU,
                       options=port.EngineOptions(
                           output_folder=str(tmp_path / "port"),
                           streaming='off', compressor_cname=None, **opts))
    assert sorted(pipe.flatfields) == sorted(jpipe.flatfields) == [0, 1]
    for idx, field in jpipe.flatfields.items():
        np.testing.assert_allclose(pipe.flatfields[idx], np.asarray(field),
                                   rtol=0, atol=1e-4)
    target = (pipe.options.flatfield_max_tiles
              + pipe.options.flatfield_tiles_per_timepoint)
    stacks = list(pipe.flatfield_stacks())
    assert [idx for idx, _ in stacks] == [0, 1]
    assert all(s_.shape == (target, 96, 96) for _, s_ in stacks)


def test_kernel_extents_are_checked():
    """The kernels index extents as C ints (offsets in 64 bits), the
    feather grid up to 65535 x 16 rows, the finalize grid up to 65535
    planes: the wrappers refuse what lies beyond. The largest in-RAM
    canvas the default threshold admits stays inside."""
    cuda_fuse.check_extents((3, 2, 6554 + 2048, 5734 + 2048))
    # 256 MiB of one-row u8 canvas, the apron added
    cuda_fuse.check_extents((1, 1, 1 + 2048, (256 << 20) + 2048),
                            max_rows=cuda_fuse.FEATHER_MAX_ROWS)
    with pytest.raises(ValueError, match="extents"):
        cuda_fuse.check_extents((1, 1, 8, 2 ** 31))
    with pytest.raises(ValueError, match="extents"):
        cuda_fuse.check_extents((1, 1, 65535 * 16 + 1, 8),
                                max_rows=cuda_fuse.FEATHER_MAX_ROWS)
    with pytest.raises(ValueError, match="extents"):
        cuda_fuse.check_extents((256, 256, 8, 8),
                                max_planes=cuda_fuse.MAX_PLANES)
