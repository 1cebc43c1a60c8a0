"""The port's host fuser (``fusion_device='host'``) against the JAX
package's, and ``csrc/hostops.c`` against its plain versions.

``hostops.c`` is the JAX package's source, built with its flags (GNU C,
so the feather sums contract into fused multiply-adds as the JAX build's
do). Every entry point is byte-equal to its plain NumPy version (the
feather's plain sum is a correctly rounded FMA, ``ops/flatfield.fma32``)
and to the JAX package's build of the same source on this CPU: placement
(u8/u16, with and without the field), feather (two ramp widths),
finalize, the 2x folds (nearest and mean, odd extents, strided ``out=``)
and the row writer. ``HostCanvas`` equals the JAX ``HostCanvas``;
``stitch(fusion_device='host')`` trees equal the JAX package's host
trees, in RAM and in bands, overwrite and feather, and for overwrite the
port's own device-path trees. The flatfield gate behaves as the JAX
gate; a gated run equals an ungated one, and a failed fit surfaces. A
failed build raises (no plain fallback), and ``fusion_device='auto'``
stays on the device.
"""

import ctypes
import os
import threading
import time

import numpy as np
import pytest
import torch

from fixtures import write_synthetic_acquisition
from torch_helpers import (assert_outputs_equal,  # noqa: F401
                           assert_tiff_outputs_equal, assert_trees_equal,
                           small_disk_probe)
import image_stitcher_tpu as jax_pkg
from image_stitcher_tpu import native as jax_native
from image_stitcher_tpu.models.streaming import FlatfieldGate as JaxGate
from image_stitcher_tpu.ops import host_fuse as jhf
import image_stitcher_tpu_torch as port
from image_stitcher_tpu_torch import native
from image_stitcher_tpu_torch.models.streaming import FlatfieldGate
from image_stitcher_tpu_torch.ops import host_fuse as hf
from image_stitcher_tpu_torch.ops.pyramid import (host_downsample,
                                                  host_downsample_plain)
from image_stitcher_tpu_torch.utils.progress import StitchCancelled

CPU = torch.device('cpu')
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {'u8': np.uint8, 'u16': np.uint16}


def jax_lib():
    lib = jax_native.get_lib()
    assert lib is not None, "the JAX package's hostops build failed"
    return lib


def test_hostops_source_is_the_jax_source():
    with open(os.path.join(REPO, 'image_stitcher_tpu', 'native',
                           'hostops.c'), 'rb') as f:
        want = f.read()
    with open(os.path.join(native.CSRC, 'hostops.c'), 'rb') as f:
        assert f.read() == want
    assert not any(f.startswith('-std') for f in
                   native.SOURCE_CC_FLAGS['hostops'])


def window_cases(th, tw):
    """(y0, y1, x0, x1, cy, cx) windows: whole tile, cropped, clamped."""
    return [(0, th, 0, tw, 3, 5), (4, th - 7, 9, tw - 2, 0, 0),
            (1, 6, 0, tw, 40, 1), (0, th, tw - 3, tw, 2, 90)]


def jax_ff(ff):
    """The JAX wrapper takes only a C-contiguous field (the port's takes
    the strided window the tests pass it)."""
    return None if ff is None else np.ascontiguousarray(ff)


def tile_and_field(rng, dtype, th=37, tw=53):
    top = np.iinfo(dtype).max
    tile = rng.integers(0, top, (th, tw), endpoint=True).astype(dtype)
    ff = (1.0 / rng.uniform(0.4, 1.6, (th + 3, tw + 5))).astype(np.float32)
    return tile, ff[:th, :tw]


@pytest.mark.parametrize("field", [False, True], ids=['plain', 'field'])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_place_equals_plain_and_jax(dtype, field):
    rng = np.random.default_rng(1)
    tile, ff = tile_and_field(rng, dtype)
    ff = ff if field else None
    for y0, y1, x0, x1, cy, cx in window_cases(*tile.shape):
        start = rng.integers(0, 200, (80, 100)).astype(dtype)
        got, plain, want = start.copy(), start.copy(), start.copy()
        hf.place_window(got, tile, ff, y0, y1, x0, x1, cy, cx)
        hf.place_window_plain(plain, tile, ff, y0, y1, x0, x1, cy, cx)
        assert jhf.place_window_native(want, tile, jax_ff(ff), y0, y1,
                                       x0, x1, cy, cx)
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_array_equal(got, want)
        assert (got != start).any()


@pytest.mark.parametrize("window", [
    (0, 38, 0, 53, 0, 0), (0, 37, 0, 53, 44, 0), (0, 37, 0, 53, 0, 48),
    (5, 4, 0, 53, 0, 0), (0, 10, 0, 10, -1, 0)],
    ids=['tile-rows', 'dst-rows', 'dst-cols', 'reversed', 'negative'])
def test_place_window_outside_its_arrays_raises(window):
    """The C loops write through raw pointers: a window that leaves the
    tile, the field or the destination is refused before the call."""
    tile = np.zeros((37, 53), np.uint16)
    dst = np.zeros((80, 100), np.uint16)
    with pytest.raises(ValueError, match="does not fit"):
        hf.place_window(dst, tile, None, *window)
    with pytest.raises(ValueError, match="does not fit"):
        hf.place_window(dst, tile, np.ones((10, 10), np.float32),
                        0, 37, 0, 53, 0, 0)


def test_place_window_layout_the_c_loop_does_not_take_raises():
    """A uint16 tile into a destination of another dtype, or one with
    strided columns, raises; a float tile (no C loop) takes the plain
    version."""
    tile = np.arange(37 * 53, dtype=np.uint16).reshape(37, 53)
    for dst in (np.zeros((80, 100), np.uint8),
                np.zeros((80, 200), np.uint16)[:, ::2]):
        with pytest.raises(ValueError, match="C loop takes"):
            hf.place_window(dst, tile, None, 0, 37, 0, 53, 0, 0)
    ftile = tile.astype(np.float32) / 7
    got, want = np.zeros((2, 80, 100), np.float32)
    hf.place_window(got, ftile, None, 2, 30, 1, 50, 3, 4)
    hf.place_window_plain(want, ftile, None, 2, 30, 1, 50, 3, 4)
    np.testing.assert_array_equal(got, want)
    assert got.any()


@pytest.mark.parametrize("blend_px", [64, 7])
@pytest.mark.parametrize("field", [False, True], ids=['plain', 'field'])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_feather_equals_plain_and_jax_bit_for_bit(dtype, field, blend_px):
    """Accumulators start from seeded sums of a few tiles, so a product
    rounded before the add (no FMA) would differ in the last bit; with a
    ramp of 64 px every product is exact, with 7 px it is not."""
    rng = np.random.default_rng(2)
    tile, ff = tile_and_field(rng, dtype)
    ff = ff if field else None
    th, tw = tile.shape
    top = float(np.iinfo(dtype).max)
    for y0, y1, x0, x1, cy, cx in window_cases(th, tw):
        window = (y0 if y0 < 4 else 2, th - 1, 0, tw, 1.0 / blend_px)
        acc0 = rng.uniform(0, 3 * top, (80, 100)).astype(np.float32)
        wsum0 = rng.uniform(0, 2, (80, 100)).astype(np.float32)
        out = {}
        for name in ('c', 'plain', 'jax'):
            acc, wsum = acc0.copy(), wsum0.copy()
            if name == 'c':
                hf.place_window((acc, wsum), tile, ff, y0, y1, x0, x1,
                                cy, cx, feather=window)
            elif name == 'plain':
                hf.place_window_plain((acc, wsum), tile, ff, y0, y1, x0,
                                      x1, cy, cx, feather=window)
            else:
                assert jhf.place_window_native((acc, wsum), tile,
                                               jax_ff(ff), y0, y1, x0, x1,
                                               cy, cx, feather=window)
            out[name] = (acc, wsum)
        for name in ('plain', 'jax'):
            for a, b in zip(out['c'], out[name]):
                assert a.tobytes() == b.tobytes(), name
        assert (out['c'][0] != acc0).any()


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_finalize_equals_plain_and_jax(dtype):
    rng = np.random.default_rng(3)
    top = float(np.iinfo(dtype).max)
    wsum = rng.uniform(0, 3, (2, 3, 41, 67)).astype(np.float32)
    wsum[..., :5, :] = 0
    wsum[..., 5:9, :] = 1e-7
    acc = (wsum * rng.uniform(-5, top + 5, wsum.shape)).astype(np.float32)
    acc[..., 9, :7] = wsum[..., 9, :7] * np.float32(2.5)   # ties to even
    got = hf.finalize_feather_host(acc, wsum, dtype)
    assert got.dtype == dtype and got.shape == acc.shape
    np.testing.assert_array_equal(got, hf.finalize_feather_plain(acc, wsum,
                                                                 dtype))
    np.testing.assert_array_equal(got, jhf.finalize_feather_host(acc, wsum,
                                                                 dtype))
    np.testing.assert_array_equal(
        hf.finalize_feather_host(acc, wsum, np.float32),
        jhf.finalize_feather_host(acc, wsum, np.float32))


@pytest.mark.parametrize("shape", [(64, 96), (37, 53), (3, 2, 9, 1)],
                         ids=lambda s: 'x'.join(map(str, s)))
@pytest.mark.parametrize("mode", ['nearest', 'mean'])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_fold_equals_plain_and_jax(dtype, mode, shape):
    rng = np.random.default_rng(4)
    x = rng.integers(0, np.iinfo(dtype).max, shape, endpoint=True
                     ).astype(dtype)
    got = host_downsample(x, mode)
    np.testing.assert_array_equal(got, host_downsample_plain(x, mode))
    np.testing.assert_array_equal(got, jhf.host_downsample(x, mode))
    strided = np.ascontiguousarray(np.repeat(x, 2, axis=-1))[..., ::2]
    np.testing.assert_array_equal(host_downsample(strided, mode), got)


@pytest.mark.parametrize("mode", ['nearest', 'mean'])
def test_fold_into_strided_out(mode):
    """The C fold of each 64-column block into its columns of a wider
    level (strided output rows): the plain fold's and the JAX build's
    pixels, and no write outside the block's columns."""
    rng = np.random.default_rng(5)
    for dtype in DTYPES.values():
        blocks = rng.integers(0, np.iinfo(dtype).max, (3, 48, 64),
                              endpoint=True).astype(dtype)
        level = np.full((24, 3 * 32 + 5), 7, dtype)
        want = level.copy()
        for i in range(3):
            hf.downsample2x_native(blocks[i], mode,
                                   level[:, i * 32:(i + 1) * 32])
            want[:, i * 32:(i + 1) * 32] = host_downsample_plain(blocks[i],
                                                                 mode)
            np.testing.assert_array_equal(want[:, i * 32:(i + 1) * 32],
                                          jhf.host_downsample(blocks[i],
                                                              mode))
        np.testing.assert_array_equal(level, want)


def test_write_rows_contig_equals_plain_and_jax(tmp_path):
    """Strided rows, each followed by zero padding, written as one
    contiguous file region."""
    rng = np.random.default_rng(6)
    band = rng.integers(0, 255, (2100, 300), dtype=np.uint8)
    rows = band[:, 40:240]          # strided: 300-byte pitch, 200 bytes
    pad = np.zeros(56, np.uint8)
    files = {}
    for name, lib in (('port', native.hostops()), ('jax', jax_lib())):
        path = str(tmp_path / name)
        fd = os.open(path, os.O_CREAT | os.O_WRONLY, 0o644)
        try:
            rc = lib.write_rows_contig(fd, rows.ctypes.data, 300,
                                       rows.shape[0], 200, pad.ctypes.data,
                                       56, 4096)
        finally:
            os.close(fd)
        assert rc == 0
        with open(path, 'rb') as f:
            files[name] = f.read()
    plain = bytes(4096) + b''.join(r.tobytes() + pad.tobytes() for r in rows)
    assert files['port'] == files['jax'] == plain


def test_port_build_is_loaded_with_the_jax_signatures():
    lib = native.hostops()
    assert native.hostops() is lib
    assert lib.feather_u16.argtypes[-1] is ctypes.c_float
    assert lib.write_rows_contig.restype is ctypes.c_longlong
    info = native.BUILDS['hostops']
    assert os.path.basename(os.path.dirname(os.path.dirname(
        info['path']))) == 'torch_kernels'


class _Job:
    def __init__(self, c, z, y, x, crops, tile):
        self.channel_idx, self.z_level, self.y, self.x = c, z, y, x
        self.crops, self.tile = crops, tile


@pytest.mark.parametrize("blend", ['overwrite', 'feather'])
@pytest.mark.parametrize("field", [False, True], ids=['plain', 'field'])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_host_canvas_equals_jax(dtype, field, blend):
    rng = np.random.default_rng(7)
    num_c, num_z, h, w, th, tw = 2, 2, 150, 170, 64, 72
    ff = ((1.0 / rng.uniform(0.5, 1.5, (num_c, th, tw))).astype(np.float32)
          if field else None)
    jobs = []
    for c in range(num_c):
        for z in range(num_z):
            for y in range(0, h, 44):
                for x in range(0, w, 50):
                    tile = rng.integers(0, np.iinfo(dtype).max, (th, tw),
                                        endpoint=True).astype(dtype)
                    crops = tuple(int(v) for v in rng.integers(0, 6, 4))
                    jobs.append(_Job(c, z, y, x, crops, tile))
    out = {}
    for name, mod in (('port', hf), ('jax', jhf)):
        canvas = mod.HostCanvas(num_c, num_z, h, w, dtype, num_threads=3,
                                ff_recip=ff, blend_method=blend, blend_px=9)
        canvas.fuse_streaming(jobs, lambda j: j.tile)
        out[name] = canvas.finalize()
    np.testing.assert_array_equal(out['port'], out['jax'])
    assert out['port'].dtype == dtype and out['port'].any()


def host_acquisition(folder):
    yy, xx = np.meshgrid(np.linspace(-1, 1, 96), np.linspace(-1, 1, 112),
                         indexing='ij')
    return write_synthetic_acquisition(
        folder, grid_cols=3, grid_rows=2, tile_w=112, tile_h=96, overlap=24,
        seed=8, channels=["Fluorescence 488 nm Ex", "Fluorescence 561 nm Ex",
                          "Fluorescence 638 nm Ex"],
        vignette=np.clip(1 - 0.35 * (xx ** 2 + yy ** 2), 0.3, 1)
        .astype(np.float32))


@pytest.mark.parametrize("blend", ['overwrite', 'feather'])
@pytest.mark.parametrize("streaming", ['off', 'on'], ids=['inram', 'band'])
def test_host_stitch_equals_jax_host_stitch(tmp_path, streaming, blend):
    """Raw OME-Zarr trees of the host fuser, fields and shifts of the
    JAX run carried in (the fits differ within 1e-4); for overwrite, the
    port's device path writes the same tree."""
    acq = str(tmp_path / 'acq')
    host_acquisition(acq)
    opts = dict(streaming=streaming, chunks=(1, 1, 1, 64, 64),
                compressor_cname=None, blend_method=blend,
                host_fusion_threads=3)
    kw = dict(apply_flatfield=True, use_registration=True)
    jpipe = jax_pkg.stitch(acq, options=jax_pkg.EngineOptions(
        fusion_device='host', output_folder=str(tmp_path / 'jax'), **opts),
        **kw)
    state = port.state_from_reference(flatfields=jpipe.flatfields,
                                      shifts=jpipe.shifts)
    pipe = port.stitch(acq, device=CPU, state=state,
                       options=port.EngineOptions(
                           fusion_device='host',
                           output_folder=str(tmp_path / 'host'), **opts),
                       **kw)
    if streaming == 'on':
        assert pipe.fuse_stats['A1_t0']['bands'] > 0
    assert_outputs_equal(str(tmp_path / 'jax'), str(tmp_path / 'host'))
    if blend == 'overwrite':
        port.stitch(acq, device=CPU, state=state, options=port.EngineOptions(
            fusion_device='device', output_folder=str(tmp_path / 'device'),
            **opts), **kw)
        assert_outputs_equal(str(tmp_path / 'jax'), str(tmp_path / 'device'))


@pytest.mark.parametrize("fmt", [2, 3], ids=['v2', 'v3'])
def test_host_bands_default_codec_equal_jax_host_stitch(tmp_path, fmt):
    """The default blosc-lz4 chunks (zarr v2, and v3 shards) from host
    bands on 4 threads, 32-row bands over two levels: the JAX package's
    host tree."""
    acq = str(tmp_path / 'acq')
    host_acquisition(acq)
    opts = dict(streaming='on', fusion_device='host', zarr_format=fmt,
                chunks=(1, 1, 1, 32, 32), host_fusion_threads=4)
    kw = dict(apply_flatfield=True, use_registration=True)
    jpipe = jax_pkg.stitch(acq, options=jax_pkg.EngineOptions(
        output_folder=str(tmp_path / 'jax'), **opts), **kw)
    state = port.state_from_reference(flatfields=jpipe.flatfields,
                                      shifts=jpipe.shifts)
    pipe = port.stitch(acq, device=CPU, state=state,
                       options=port.EngineOptions(
                           output_folder=str(tmp_path / 'port'), **opts),
                       **kw)
    assert pipe.options.compressor_cname == 'lz4'
    assert pipe.fuse_stats['A1_t0']['bands'] > 8
    assert_outputs_equal(str(tmp_path / 'jax'), str(tmp_path / 'port'))


@pytest.mark.parametrize("fmt", [2, 3], ids=['v2', 'v3'])
def test_host_bands_reach_the_writer_in_plane_order(tmp_path, fmt):
    """Band 0 of every plane fuses slowly, so later bands finish first on
    the fuser's 4 threads: they park until band 0 is written, and the
    lz4 tree (each chunk row encoded once, when a later chunk row of its
    plane starts) equals the one-thread run's."""
    from image_stitcher_tpu_torch.io.omezarr import MultiscaleWriter
    from image_stitcher_tpu_torch.models.streaming import StreamingFuser
    rng = np.random.default_rng(9)
    num_c, h, w, th, tw = 3, 150, 170, 64, 72
    jobs = [_Job(c, 0, y, x, tuple(int(v) for v in rng.integers(0, 6, 4)),
                 rng.integers(1, 65535, (th, tw)).astype(np.uint16))
            for c in range(num_c) for y in range(0, h, 44)
            for x in range(0, w, 50)]
    trees, parked = {}, []
    for threads in (1, 4):
        path = str(tmp_path / f'{threads}.ome.zarr')
        writer = MultiscaleWriter(path, (1, num_c, 1, h, w), 2, np.uint16,
                                  (1, 1, 1, 16, 16), 'A1_t0', 1.0, 1.0,
                                  ['c0', 'c1', 'c2'], [0xFFFFFF] * num_c,
                                  cname='lz4', zarr_format=fmt)
        fuser = StreamingFuser(writer, h, w, th, tw, np.uint16, 2,
                               chunk_rows=16, num_threads=threads)
        place, write = fuser._place_in_band, fuser._write_in_order

        def slow_band0(buf, band0, *a, place=place):
            if band0 == 0:
                time.sleep(0.02)
            place(buf, band0, *a)

        def spy(*a, write=write, fuser=fuser):
            released = write(*a)
            parked.append(len(fuser._parked))
            return released

        fuser._place_in_band, fuser._write_in_order = slow_band0, spy
        fuser.run(jobs, lambda j: j.tile)
        trees[threads] = path
    assert max(parked) > 0
    assert_trees_equal(trees[1], trees[4])


@pytest.mark.parametrize("blend", ['overwrite', 'feather'])
def test_host_stitch_ome_tiff_equals_jax(tmp_path, blend):
    """The host fuser's whole canvas written as OME-TIFF: the JAX host
    run's file, byte for byte."""
    acq = str(tmp_path / 'acq')
    host_acquisition(acq)
    opts = dict(streaming='off', fusion_device='host', blend_method=blend,
                host_fusion_threads=2)
    kw = dict(output_format='.ome.tiff', use_registration=True)
    jax_pkg.stitch(acq, options=jax_pkg.EngineOptions(
        output_folder=str(tmp_path / 'jax'), **opts), **kw)
    port.stitch(acq, device=CPU, options=port.EngineOptions(
        output_folder=str(tmp_path / 'port'), **opts), **kw)
    assert_tiff_outputs_equal(str(tmp_path / 'jax'), str(tmp_path / 'port'))


@pytest.mark.parametrize("gate_cls", [FlatfieldGate, JaxGate],
                         ids=['port', 'jax'])
def test_flatfield_gate_semantics(gate_cls):
    """Per-channel publish and wait, identity rows after finish, and the
    fit's error raised in every waiter with its own type (the port's gate
    and the JAX gate alike)."""
    g = gate_cls(3, (4, 4))
    g.publish(0, np.full((4, 4), 2.0, np.float32))
    np.testing.assert_array_equal(g.wait(0)[0], np.full((4, 4), 0.5))
    assert not g._events[1].is_set()
    g.finish()
    np.testing.assert_array_equal(g.wait(1)[1], np.ones((4, 4), np.float32))
    g2 = gate_cls(2, (4, 4))
    errors = []

    def waits():
        try:
            g2.wait(1)
        except BaseException as e:
            errors.append(e)

    t = threading.Thread(target=waits)
    t.start()
    g2.fail(StitchCancelled("stop"))
    t.join(5)
    assert not t.is_alive() and isinstance(errors[0], StitchCancelled)


def test_gated_fit_equals_ungated_and_bands_start_before_it_ends(tmp_path):
    """With the fit overlapped (the gate), host bands start while later
    channels still fit; the tree equals the serial fit's. Registration is
    off, so the gate is the only overlap."""
    acq = str(tmp_path / 'acq')
    host_acquisition(acq)
    trees = {}
    for overlap in (True, False):
        out = str(tmp_path / f'out_{overlap}')
        pipe = port.stitch(acq, apply_flatfield=True, device=CPU,
                           options=port.EngineOptions(
                               streaming='on', fusion_device='host',
                               chunks=(1, 1, 1, 32, 32),
                               compressor_cname=None, overlap_prep=overlap,
                               output_folder=out))
        trees[overlap] = out
        first = pipe.fuse_stats['A1_t0']['first_band_at']
        assert (first < pipe.fit_done_at) == overlap
        assert sorted(pipe.flatfields) == [0, 1, 2]
        assert os.path.exists(os.path.join(out, 'flatfields.npz'))
    assert_outputs_equal(trees[False], trees[True])


def test_gated_fit_failure_surfaces(tmp_path, monkeypatch):
    """A fit that dies mid-run unblocks the gated bands and fails the
    run with its error; no fit or band thread is left behind."""
    import image_stitcher_tpu_torch.ops.flatfield as ffmod

    def boom(*a, **k):
        raise RuntimeError("fit exploded")

    monkeypatch.setattr(ffmod, "fit_flatfield_stack_np", boom)
    acq = str(tmp_path / 'acq')
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=2, tile_w=64,
                                tile_h=64, overlap=16)
    with pytest.raises(RuntimeError, match="fit exploded"):
        port.stitch(acq, apply_flatfield=True, device=CPU,
                    options=port.EngineOptions(
                        streaming='on', chunks=(1, 1, 1, 32, 32),
                        fusion_device='host',
                        output_folder=str(tmp_path / 'out')))
    assert not [t for t in threading.enumerate()
                if t.name.startswith(('flatfield-fit', 'host-band'))]


def test_failed_build_raises_no_plain_fallback(tmp_path, monkeypatch):
    """Without a C compiler the host fuser and the band writer's fold
    raise; nothing steps aside to the plain versions."""
    monkeypatch.setattr(native, '_LIBS', {})
    monkeypatch.setattr(native, 'BUILD_ROOT', str(tmp_path / 'build'))

    def no_cc():
        raise RuntimeError("no C compiler found")

    monkeypatch.setattr(native, 'find_cc', no_cc)
    x = np.zeros((8, 8), np.uint16)
    with pytest.raises(RuntimeError, match="no C compiler"):
        host_downsample(x, 'nearest')
    with pytest.raises(RuntimeError, match="no C compiler"):
        hf.place_window(np.zeros((8, 8), np.uint16), x, None, 0, 8, 0, 8,
                        0, 0)
    # float data is a layout the C code does not take: the plain version
    np.testing.assert_array_equal(
        host_downsample(x.astype(np.float32), 'mean'), np.zeros((4, 4)))


def test_auto_fuses_on_the_device(tmp_path):
    """'auto' never turns into the host fuser (no link probe): the band
    path launches device batches, the host fuser runs no band."""
    acq = str(tmp_path / 'acq')
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=2, tile_w=64,
                                tile_h=64, overlap=16)
    pipe = port.stitch(acq, device=CPU, options=port.EngineOptions(
        streaming='on', chunks=(1, 1, 1, 32, 32),
        output_folder=str(tmp_path / 'out')))
    assert pipe.options.fusion_device == 'auto'
    stats = pipe.fuse_stats['A1_t0']
    assert stats['batches'] > 0 and 'bands' not in stats
    assert port.EngineOptions(host_fusion_threads=None) \
        .resolved_fusion_threads() >= 4
    assert port.EngineOptions(host_fusion_threads=3) \
        .resolved_fusion_threads() == 3


# ------------------------------------------ block writes and the fill skip

def _chunk_bytes(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            if not n.startswith('.') and n != 'zarr.json':
                p = os.path.join(d, n)
                with open(p, 'rb') as f:
                    out[os.path.relpath(p, root)] = f.read()
    return out


def _random_jobs(rng, height, width, th, tw):
    """A grid of tiles with random pitch, jitter and crops, some outside
    the canvas's top-left and some past its bottom-right, and sometimes a
    tile left out."""
    step_y = int(rng.integers(th // 2, th + 8))
    step_x = int(rng.integers(tw // 2, tw + 8))
    jobs = []
    for y in range(-int(rng.integers(0, 6)), height, step_y):
        for x in range(-int(rng.integers(0, 6)), width, step_x):
            if rng.random() < 0.05:
                continue
            crops = tuple(int(v) for v in rng.integers(0, 5, 4))
            jobs.append((_Job(0, 0, y + int(rng.integers(-2, 3)),
                              x + int(rng.integers(-2, 3)), crops, None),
                         True))
    return jobs


@pytest.mark.parametrize("seed", range(4))
def test_band_covered_equals_jax(seed):
    """``_band_covered`` gives the JAX fuser's answer for every band of
    seeded random job sets (crops, gaps, tiles over the canvas's edges)."""
    from image_stitcher_tpu.models.streaming import StreamingFuser as JaxSF
    from image_stitcher_tpu_torch.models.streaming import StreamingFuser
    rng = np.random.default_rng(seed)
    seen = set()
    for _ in range(40):
        h, w = int(rng.integers(40, 200)), int(rng.integers(40, 200))
        th, tw = int(rng.integers(16, 60)), int(rng.integers(16, 60))
        band = int(rng.choice([8, 16, 32]))
        port_sf = StreamingFuser(object(), h, w, th, tw, np.uint16, 1,
                                 chunk_rows=band)
        jax_sf = JaxSF(object(), 1, 1, h, w, th, tw, np.uint16, 1,
                       chunk_rows=band)
        jobs = _random_jobs(rng, h, w, th, tw)
        for band0 in range(0, h, band):
            rows = min(band, h - band0)
            got = port_sf._band_covered(jobs, band0, rows)
            assert got == jax_sf._band_covered(jobs, band0, rows)
            seen.add(got)
    assert seen == {True, False}


def _covering_jobs(rng, h, w, th, tw, overlap, dtype=np.uint16):
    """Tiles of a grid whose crop windows tile the canvas, in plan
    order, each with a seeded tile."""
    jobs = []
    step_y, step_x = th - overlap, tw - overlap
    for y in range(0, h - overlap, step_y):
        for x in range(0, w - overlap, step_x):
            top = overlap // 2 if y else 0
            left = overlap // 2 if x else 0
            tile = rng.integers(1, np.iinfo(dtype).max, (th, tw),
                                endpoint=True).astype(dtype)
            jobs.append(_Job(0, 0, y, x, (top, 0, left, 0), tile))
    return jobs


def _fuse_both(tmp_path, jobs, h, w, th, tw, cname, chunks, num_levels=3):
    """The port's and the JAX host band fusers over the same jobs into
    their own writers; returns (port fuser, JAX fuser, progress calls)."""
    from image_stitcher_tpu.io.omezarr import MultiscaleWriter as JaxMW
    from image_stitcher_tpu.models.streaming import StreamingFuser as JaxSF
    from image_stitcher_tpu_torch.io.omezarr import MultiscaleWriter
    from image_stitcher_tpu_torch.models.streaming import StreamingFuser
    common = ((1, 1, 1, h, w), num_levels, np.uint16,
              (1, 1, 1, chunks, chunks), 'A1_t0', 1.0, 1.0, ['c0'],
              [0xFFFFFF])
    pw = MultiscaleWriter(str(tmp_path / 'port.ome.zarr'), *common,
                          cname=cname, direct_io='off')
    jw = JaxMW(str(tmp_path / 'jax.ome.zarr'), *common, cname=cname,
               clevel=5, direct_io='off')
    port_sf = StreamingFuser(pw, h, w, th, tw, np.uint16, num_levels,
                             chunk_rows=chunks, num_threads=3)
    jax_sf = JaxSF(jw, 1, 1, h, w, th, tw, np.uint16, num_levels,
                   chunk_rows=chunks, num_threads=3)
    calls = []
    port_sf.run(jobs, lambda j: j.load(),
                progress_cb=lambda n, total: calls.append((n, total)))
    jax_sf.run(jobs, lambda j: j.load())
    return port_sf, jax_sf, calls


@pytest.mark.parametrize("undersized", [False, True],
                         ids=['covered', 'undersized'])
@pytest.mark.parametrize("cname", [None, 'lz4'], ids=['raw', 'lz4'])
def test_fill_skip_and_replay_equal_jax(tmp_path, cname, undersized):
    """Bands the tiles cover skip their fill (counted); with one tile
    loaded smaller than the nominal size the band is zeroed and replayed,
    every later band fills up front, and progress fires once a tile. The
    tree equals the JAX fuser's (raw: block mode, chunk files byte-equal;
    lz4: the row-major band)."""
    rng = np.random.default_rng(11)
    th, tw, overlap, h, w = 40, 48, 8, 136, 200
    jobs = _covering_jobs(rng, h, w, th, tw, overlap)
    for j in jobs:
        j.load = (lambda j=j: j.tile)
    if undersized:
        short = jobs[len(jobs) // 2]
        short.load = lambda j=short: j.tile[:th - 6, :tw - 5]
    port_sf, jax_sf, calls = _fuse_both(tmp_path, jobs, h, w, th, tw, cname,
                                        16)
    assert [n for n, _ in calls] == list(range(1, len(jobs) + 1))
    assert port_sf.block_cols == (0 if cname else -(-w // 16))
    assert port_sf.blocks == port_sf.bands * port_sf.block_cols
    assert port_sf.block_refusals == 0
    assert bool(port_sf._block_cx) == (cname is None) \
        == bool(jax_sf._block_cx)
    assert port_sf._nominal_dims_ok == jax_sf._nominal_dims_ok \
        == (not undersized)
    if undersized:   # the bands before the short tile's skipped
        assert 0 < port_sf.fill_skips < port_sf.bands
    else:
        assert port_sf.fill_skips == port_sf.bands
    assert_trees_equal(str(tmp_path / 'jax.ome.zarr'),
                       str(tmp_path / 'port.ome.zarr'))
    if cname is None:
        assert _chunk_bytes(str(tmp_path / 'jax.ome.zarr')) \
            == _chunk_bytes(str(tmp_path / 'port.ome.zarr'))


def test_refused_blocks_are_counted_apart(tmp_path, monkeypatch):
    """A level-0 block the raw writer refuses goes out as rows and is
    counted as a refusal, not as a block; the tree still equals the JAX
    fuser's, chunk files byte for byte."""
    from image_stitcher_tpu_torch.io.zarr_store import RawZarrArray
    monkeypatch.setattr(RawZarrArray, 'try_write_block',
                        lambda self, *a: False)
    rng = np.random.default_rng(13)
    th, tw, overlap, h, w = 40, 48, 8, 136, 200
    jobs = _covering_jobs(rng, h, w, th, tw, overlap)
    for j in jobs:
        j.load = (lambda j=j: j.tile)
    port_sf, _, _ = _fuse_both(tmp_path, jobs, h, w, th, tw, None, 16)
    assert port_sf.block_cols == -(-w // 16)
    assert port_sf.blocks == 0
    assert port_sf.block_refusals == port_sf.bands * port_sf.block_cols
    assert _chunk_bytes(str(tmp_path / 'jax.ome.zarr')) \
        == _chunk_bytes(str(tmp_path / 'port.ome.zarr'))


def test_fuser_cpu_has_the_jax_keys(tmp_path):
    """The on-core sums carry the JAX fuser's stage keys, plus the
    port's 'gate'; every wall stage has its on-core twin."""
    rng = np.random.default_rng(12)
    jobs = _covering_jobs(rng, 100, 120, 40, 48, 8)
    for j in jobs:
        j.load = (lambda j=j: j.tile)
    port_sf, jax_sf, _ = _fuse_both(tmp_path, jobs, 100, 120, 40, 48, None,
                                    16)
    assert set(port_sf.cpu) == set(jax_sf.cpu) | {'gate'}
    assert set(port_sf.cpu) == set(port_sf.stats)
    assert all(v >= 0 for v in port_sf.cpu.values())


@pytest.mark.parametrize("fmt,cname", [(2, None), (3, None), (2, 'lz4')],
                         ids=['raw_v2', 'raw_v3', 'lz4'])
def test_host_blocks_and_fill_skip_equal_jax_host_stitch(tmp_path, fmt,
                                                         cname):
    """Whole host stitches in bands: raw v2 and v3 take block mode (the
    level-0 chunk files written as blocks from the band threads), lz4 the
    rows; covered bands skip their fill. The trees equal the JAX host
    stitch's, raw chunk files byte for byte."""
    acq = str(tmp_path / 'acq')
    host_acquisition(acq)
    opts = dict(streaming='on', fusion_device='host', zarr_format=fmt,
                chunks=(1, 1, 1, 16, 16), compressor_cname=cname,
                host_fusion_threads=4)
    kw = dict(apply_flatfield=True, use_registration=True)
    jpipe = jax_pkg.stitch(acq, options=jax_pkg.EngineOptions(
        output_folder=str(tmp_path / 'jax'), **opts), **kw)
    state = port.state_from_reference(flatfields=jpipe.flatfields,
                                      shifts=jpipe.shifts)
    pipe = port.stitch(acq, device=CPU, state=state,
                       options=port.EngineOptions(
                           output_folder=str(tmp_path / 'port'), **opts),
                       **kw)
    stats = pipe.fuse_stats['A1_t0']
    assert (stats['block_cols'] > 0) == (cname is None)
    assert stats['blocks'] == stats['bands'] * stats['block_cols']
    assert stats['block_refusals'] == 0
    assert 0 < stats['fill_skips'] < stats['bands']
    assert set(stats['cpu']) >= {'fill', 'decode', 'place', 'write'}
    assert_outputs_equal(str(tmp_path / 'jax'), str(tmp_path / 'port'))
    if cname is None:
        assert _chunk_bytes(str(tmp_path / 'jax')) \
            == _chunk_bytes(str(tmp_path / 'port'))
