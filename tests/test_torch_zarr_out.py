"""The port's OME-Zarr output at default options against the JAX package's.

Both packages stitch the same acquisition with their default compressor
(blosc-lz4, clevel 5, byte shuffle): the JAX package through
tensorstore, the port through its own codec (``io/blosc.py``) and chunk
writer (``io/zarr_store.py``). For the band path (``streaming='on'``)
and the in-RAM path (``streaming='off'``), uint8 and uint16,
compressible and full-entropy content, the two trees must hold the same
files (chunks equal to the fill value are not stored by either), the
same JSON metadata, and arrays that decode equal with tensorstore and
with the port's reader. Four wells give two pyramid levels, whose band
slabs cover half a chunk row; the registered canvas ends in empty rows.
Then the 'auto' compressor against the JAX package's decision, the
output-affecting defaults, and a region that fails with chunks still
queued for encoding.
"""

import threading
import time

import numpy as np
import pytest
import torch

from fixtures import write_synthetic_acquisition
from torch_helpers import (assert_outputs_equal, small_disk_probe,  # noqa: F401
                           tree_files)
from image_stitcher_tpu import EngineOptions as JaxOptions
from image_stitcher_tpu import scan_acquisition as jax_scan
from image_stitcher_tpu import stitch as jax_stitch
import image_stitcher_tpu_torch as port

CPU = torch.device('cpu')
WELLS = ["A1", "B1", "C1", "D1"]
COMMON = dict(chunks=(1, 1, 1, 64, 64), device_band_multiple=1)


def _acquisition(root, dtype, compressible):
    acq = str(root / "acq")
    bits = (12 if dtype == np.uint16 else 5) if compressible else 0
    write_synthetic_acquisition(
        acq, grid_cols=4, grid_rows=2, tile_w=160, tile_h=96, overlap=32,
        regions=WELLS, dtype=dtype, gt_quantize_bits=bits, seed=23,
        acq_params_overrides={"pixel_binning": 2})
    return acq


@pytest.mark.parametrize("streaming", ['on', 'off'],
                         ids=['band', 'inram'])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16],
                         ids=['u8', 'u16'])
@pytest.mark.parametrize("compressible", [True, False],
                         ids=['compressible', 'full_entropy'])
def test_default_tree_equals_jax(tmp_path, streaming, dtype, compressible):
    acq = _acquisition(tmp_path, dtype, compressible)
    jpipe = jax_stitch(acq, use_registration=True, options=JaxOptions(
        fusion_device='device', streaming=streaming,
        output_folder=str(tmp_path / "jax"), **COMMON))
    pipe = port.stitch(acq, use_registration=True, device=CPU,
                       state=port.state_from_reference(shifts=jpipe.shifts),
                       options=port.EngineOptions(
                           streaming=streaming,
                           output_folder=str(tmp_path / "port"), **COMMON))
    assert pipe.options.compressor_cname == jpipe.options.compressor_cname \
        == 'lz4'
    assert pipe.num_pyramid_levels == 2
    assert_outputs_equal(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_output_affecting_defaults_equal_jax():
    jax, torch_ = JaxOptions(), port.EngineOptions()
    for name in JaxOptions.OUTPUT_AFFECTING:
        want = getattr(jax, name)
        got = getattr(torch_, name)
        assert (list(got) if isinstance(got, tuple) else got) == \
            (list(want) if isinstance(want, tuple) else want), name
    assert torch_.compressor_cname == 'lz4'


# ------------------------------------------------------------- 'auto'

PROBES = {
    # the better arm against 300 MB/s x cores
    'fast_disk': {"ts": 0.0, "buffered_mbps": 1e7, "direct_mbps": 2e6},
    'slow_disk': {"ts": 0.0, "buffered_mbps": 20.0, "direct_mbps": 35.0},
    'unsupported': {"ts": 0.0, "buffered_mbps": 0.0, "direct_mbps": 0.0,
                    "unsupported": True},
}


@pytest.mark.parametrize("probe", sorted(PROBES))
@pytest.mark.parametrize("compressible", [True, False],
                         ids=['compressible', 'full_entropy'])
def test_auto_compressor_decides_as_jax(tmp_path, monkeypatch, probe,
                                        compressible):
    """Both packages, fed the same tiles and the same disk-probe entry,
    choose the same chunks: lz4 only for compressible content on a disk
    slower than the cores' lz4 (or of unknown speed)."""
    from image_stitcher_tpu.io import directio as jdirectio
    from image_stitcher_tpu.models.pipeline import (
        StitchPipeline as JaxPipeline)
    from image_stitcher_tpu.params import (
        StitchingParameters as JaxParams)
    from image_stitcher_tpu_torch.io import directio
    from image_stitcher_tpu_torch.models.pipeline import StitchPipeline
    entry = PROBES[probe]
    monkeypatch.setattr(jdirectio, "probe_direct_io", lambda d: entry)
    monkeypatch.setattr(directio, "probe_direct_io", lambda d: entry)
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(acq, grid_cols=3, grid_rows=1, tile_w=64,
                                tile_h=64, overlap=16, seed=5,
                                gt_quantize_bits=12 if compressible else 0)
    out = str(tmp_path / "out")
    jpipe = JaxPipeline(JaxParams(input_folder=acq), JaxOptions(
        compressor_cname='auto', output_folder=out))
    jpipe.acq = jax_scan(acq)
    pipe = StitchPipeline(port.StitchingParameters(input_folder=acq),
                          port.EngineOptions(compressor_cname='auto',
                                             output_folder=out), device=CPU)
    pipe.acq = port.scan_acquisition(acq)
    choices = [tuple(p.resolved_compressor()) for p in (jpipe, pipe)]
    assert choices[1] == choices[0]
    want = ('lz4', 5, 1) if compressible and probe != 'fast_disk' \
        else (None, 0, 0)
    assert choices[1] == want


# ------------------------------------------------- a region that fails

def _encode_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith('zarr-encode')]


@pytest.mark.parametrize("path", ['band', 'inram'])
def test_failed_region_stops_its_encode_pool(tmp_path, monkeypatch, path):
    """A region that fails while chunks wait in its encode pool (a cancel
    between bands; a pyramid error after level 0 is handed over) raises
    with no encode thread alive, and nothing lands in its tree
    afterwards: the queued chunks are dropped, not written."""
    from image_stitcher_tpu_torch import params as tparams
    from image_stitcher_tpu_torch.io import blosc
    from image_stitcher_tpu_torch.io.acquisition import scan_acquisition
    from image_stitcher_tpu_torch.io.omezarr import MultiscaleWriter
    from image_stitcher_tpu_torch.io.readers import TileJob
    from image_stitcher_tpu_torch.models.pipeline import StitchPipeline
    from image_stitcher_tpu_torch.models.streaming import DeviceStreamingFuser
    from image_stitcher_tpu_torch.ops import pyramid

    # one encode thread, slower than the fuser: chunks queue up
    monkeypatch.setattr(tparams, '_available_cpus', lambda: 1)
    encoded = []
    real = blosc.compress

    def slow(*a, **k):
        time.sleep(0.02)
        encoded.append(1)
        return real(*a, **k)

    monkeypatch.setattr(blosc, 'compress', slow)
    before = _encode_threads()
    acq_dir = str(tmp_path / "acq")
    write_synthetic_acquisition(acq_dir, grid_cols=3, grid_rows=3,
                                tile_w=48, tile_h=40, overlap=12, seed=7)
    acq = scan_acquisition(acq_dir)
    th, tw = acq.input_height, acq.input_width
    height, width = 2 * (th - 12) + th, 2 * (tw - 12) + tw
    out = tmp_path / "out"
    if path == 'band':
        rec = min(acq.tiles.values(), key=lambda r: r.filepath)
        jobs = [TileJob(rec.filepath, -1, 0, 0, gy * (th - 12),
                        gx * (tw - 12), (0, 0, 0, 0), 0.0, 0.0)
                for gy in range(3) for gx in range(3)]
        writer = MultiscaleWriter(str(out / "x.ome.zarr"),
                                  (1, 1, 1, height, width), 1, np.uint16,
                                  (1, 1, 1, 8, 16), "A1_t0", 1.0, 1.0,
                                  ["c0"], [0xFFFFFF], cname='lz4')
        fuser = DeviceStreamingFuser(writer, height, width, th, tw,
                                     np.uint16, 1, chunk_rows=8,
                                     batch_size=1, reader_threads=1,
                                     device=CPU)
        calls = []

        def stop_check():
            calls.append(1)
            if len(calls) > 12 and encoded:
                raise RuntimeError("cancelled")

        with pytest.raises(RuntimeError, match="cancelled"):
            fuser.run(jobs, stop_check=stop_check)
    else:
        pipe = StitchPipeline(
            port.StitchingParameters(input_folder=acq_dir),
            port.EngineOptions(output_folder=str(out),
                               chunks=(1, 1, 1, 8, 16)), device=CPU)
        pipe.acq = acq
        real_levels = pyramid.iter_levels

        def failing_levels(*a, **k):
            yield next(iter(real_levels(*a, **k)))
            while not encoded:   # level 0 is queued and being encoded
                time.sleep(0.001)
            raise OSError("disk gone")

        monkeypatch.setattr(pyramid, 'iter_levels', failing_levels)
        rng = np.random.default_rng(8)
        canvas = torch.from_numpy(
            rng.integers(1, 4096, (1, 1, height, width)).astype(np.uint16))
        with pytest.raises(OSError, match="disk gone"):
            pipe.save_region(0, "A1", canvas, num_levels=2)
    assert _encode_threads() == before

    def chunk_files():
        return [f for f in tree_files(str(out))
                if not f.endswith(('.zarray', '.zattrs', '.zgroup'))]

    written = chunk_files()
    # every chunk encoded was written before the error surfaced; the
    # rest of the queue was dropped
    assert written and len(written) == len(encoded) < 8 * 12
    time.sleep(0.2)
    assert chunk_files() == written
