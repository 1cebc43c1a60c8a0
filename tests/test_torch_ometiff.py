"""The port's OME-TIFF output against the JAX package's.

``image_stitcher_tpu_torch/io/tiffwriter.py`` is a copy of the JAX
writer, so both packages write the same bytes: ``write_ome_tiff_pyramid``
and ``BigTiffWriter`` (uint8 and uint16, monochrome and RGB, deflate and
raw, with and without the thumbnail and the stage position, on sizes that
are not multiples of 256), ``ome_xml`` (names with ``&``, ``<`` and
quotes), ``StreamingTiffWriter`` fed bands out of order (the same file,
the same peak of buffered bytes, the same error for missing rows), and
whole ``stitch(..., output_format='.ome.tiff')`` runs: in RAM and in
bands, monochrome and RGB, deflate and raw, with flatfield and
registration, overwrite byte-equal and feather within 1 LSB. JPEG tiles
raise the JAX package's ``ValueError`` on uint16 and are byte-identical
to the JAX package's (``cv2.imencode``) on uint8, grey and RGB, from the
writers and from whole runs in RAM and in bands; a resumed run skips
its completed units and leaves their files untouched. Where a band of a
band path holds no tile, the JAX run raises and the port writes the
band as zeros (the JAX in-RAM file, decoded). Both packages run in one interpreter, so their deflate bytes
come from one zlib.
"""

import glob
import os
import threading

import numpy as np
import pytest
import torch

from fixtures import write_synthetic_acquisition
from test_torch_rgb_e2e import write_rgb_acquisition
from torch_helpers import (assert_tiff_outputs_equal,  # noqa: F401
                           small_disk_probe, tiff_outputs)
import image_stitcher_tpu as jax_pkg
from image_stitcher_tpu.io import tiffwriter as jtw
import image_stitcher_tpu_torch as port
from image_stitcher_tpu_torch.io import tiffwriter as ptw
from image_stitcher_tpu_torch.io.tiff import read_pages
from image_stitcher_tpu_torch.ops.pyramid import host_downsample_plain
from image_stitcher_tpu_torch.utils.manifest import RunManifest

CPU = torch.device('cpu')
NAMES = ['BF LED & "full"_R', "a<b>'c'_G", 'plain_B']
COLORS = [0xFF0000, 0x00FF00, 0x0000FF]


def pyramid(rng, shape, dtype, num_levels=3):
    top = np.iinfo(dtype).max
    levels = [rng.integers(0, top, shape, endpoint=True).astype(dtype)]
    for _ in range(num_levels - 1):
        levels.append(host_downsample_plain(levels[-1], 'nearest'))
    return levels


def read(path):
    with open(path, 'rb') as f:
        return f.read()


@pytest.mark.parametrize("extras", ['thumbnail+position', 'bare'])
@pytest.mark.parametrize("compression", ['deflate', 'raw'])
@pytest.mark.parametrize("rgb", [False, True], ids=['mono', 'rgb'])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=['u8', 'u16'])
@pytest.mark.parametrize("hw", [(300, 400), (513, 257), (17, 700)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_pyramid_file_equals_jax(tmp_path, hw, dtype, rgb, compression,
                                 extras):
    rng = np.random.default_rng(hw[0] * 7 + hw[1])
    levels = pyramid(rng, (3, 2) + hw, dtype)
    kw = dict(image_name='A1 & <B2>', channel_names=NAMES,
              channel_colors=COLORS, pixel_size_um=0.325, dz_um=1.5,
              compression=compression, rgb=rgb,
              thumbnail=extras != 'bare', thumbnail_max=64,
              position_um=(12.5, -3.25) if extras != 'bare' else None)
    want, got = str(tmp_path / 'jax.ome.tiff'), str(tmp_path / 'port.ome.tiff')
    assert jtw.write_ome_tiff_pyramid(want, levels, **kw) == want
    assert ptw.write_ome_tiff_pyramid(got, levels, **kw) == got
    assert read(got) == read(want)
    pages = read_pages(read(got))
    n_pages = 2 if rgb else 6
    assert len(pages) == n_pages + (extras != 'bare')
    for page, (_, page_levels) in enumerate(pages[:n_pages]):
        for lv, array in zip(levels, page_levels):
            plane = (np.moveaxis(lv[:, page], 0, -1) if rgb
                     else lv[page // 2, page % 2])
            np.testing.assert_array_equal(array, plane)


def test_bigtiff_writer_equals_jax(tmp_path):
    """Planes added one by one, with their own SubIFD levels, subfile
    types and descriptions."""
    rng = np.random.default_rng(3)
    planes = [pyramid(rng, (300, 700), np.uint16, 2),
              pyramid(rng, (260, 260, 3), np.uint8, 1)]
    files = {}
    for name, mod in (('jax', jtw), ('port', ptw)):
        path = str(tmp_path / f'{name}.tif')
        w = mod.BigTiffWriter(path, compression='none')
        w.add_plane(planes[0], description='first & <only>')
        w.add_plane(planes[1], subfile_type=1)
        w.close()
        files[name] = read(path)
    assert files['port'] == files['jax']


@pytest.mark.parametrize("rgb", [False, True], ids=['mono', 'rgb'])
@pytest.mark.parametrize("planes", [None, 'positions'])
def test_ome_xml_equals_jax(rgb, planes):
    plane_list = None
    if planes:
        plane_list = [{'the_c': 0, 'the_z': z, 'the_t': 0, 'z_um': 1.5 * z,
                       'x_um': 10.0, 'y_um': -2.5} for z in range(2)]
    for dtype in (np.uint8, np.uint16, np.float32):
        args = ('well "A1" & <B>', 700, 300, 2, 3, 1, dtype, NAMES, COLORS,
                0.325, 1.5)
        assert (ptw.ome_xml(*args, rgb=rgb, planes=plane_list)
                == jtw.ome_xml(*args, rgb=rgb, planes=plane_list))


def feed_bands(writer, data, band, order, num_levels, rgb=False):
    """Feed (C, Z, H, W) ``data`` to a streaming writer band by band in
    ``order`` of (c, z, band index), each band's levels folded from it as
    the band fusers fold them."""
    for c, z, b in order:
        band0 = b * band
        level = data[c, z, band0:band0 + band]
        for lv in range(num_levels):
            if lv:
                level = host_downsample_plain(level, 'nearest')
            b_lv = band0 >> lv
            writer.write_level(lv, level[None, None, None], sel=(
                slice(0, 1), slice(c, c + 1), slice(z, z + 1),
                slice(b_lv, b_lv + level.shape[0]),
                slice(0, level.shape[1])))


def band_order(rng, num_c, num_z, n_bands):
    order = [(c, z, b) for z in range(num_z) for b in range(n_bands)
             for c in range(num_c)]
    return [order[i] for i in rng.permutation(len(order))]


@pytest.mark.parametrize("rgb", [False, True], ids=['mono', 'rgb'])
def test_streaming_writer_out_of_order_equals_jax(tmp_path, rgb):
    rng = np.random.default_rng(11)
    dtype = np.uint8 if rgb else np.uint16
    num_c, num_z, h, w, band, levels = 3, 2, 1000, 700, 320, 3
    data = rng.integers(0, 200, (num_c, num_z, h, w)).astype(dtype)
    order = band_order(rng, num_c, num_z, -(-h // band))
    files, peaks = {}, {}
    for name, mod in (('jax', jtw), ('port', ptw)):
        path = str(tmp_path / f'{name}.ome.tiff')
        writer = mod.StreamingTiffWriter(
            path, (1, num_c, num_z, h, w), levels, dtype, 'A1_t0', 1.5,
            0.325, NAMES, COLORS, thumbnail_max=64,
            position_um=(1.0, 2.0), rgb=rgb)
        feed_bands(writer, data, band, order, levels)
        peaks[name] = writer.peak_buffer_bytes
        writer.close()
        files[name] = read(path)
    assert files['port'] == files['jax']
    assert peaks['port'] == peaks['jax'] > 0
    pages = read_pages(files['port'])
    assert len(pages) == (num_z if rgb else num_c * num_z) + 1
    np.testing.assert_array_equal(
        pages[0][1][0], np.moveaxis(data[:, 0], 0, -1) if rgb
        else data[0, 0])


def test_streaming_writer_missing_rows_raise_as_jax(tmp_path):
    rng = np.random.default_rng(12)
    data = rng.integers(0, 999, (2, 1, 600, 300)).astype(np.uint16)
    order = [(c, 0, b) for b in range(3) for c in range(2)][:-1]
    errors = {}
    before = set(threading.enumerate())
    for name, mod in (('port', ptw), ('jax', jtw)):
        if name == 'jax':   # the port's writer left no encode thread
            assert not [t for t in set(threading.enumerate()) - before
                        if t.name.startswith('tiff-encode')]
        writer = mod.StreamingTiffWriter(
            str(tmp_path / f'{name}.ome.tiff'), (1, 2, 1, 600, 300), 2,
            np.uint16, 'x', 1.0, 1.0, NAMES[:2], COLORS[:2])
        feed_bands(writer, data, 256, order, 2)
        with pytest.raises(ValueError) as e:
            writer.close()
        errors[name] = str(e.value)
    assert errors['port'] == errors['jax']
    assert 'missing rows' in errors['port']


def test_streaming_writer_abort_then_a_second_run_overwrites(tmp_path):
    """abort() stops the encode pool and leaves a file without IFDs; a
    second writer on the same path writes the JAX writer's file."""
    rng = np.random.default_rng(13)
    data = rng.integers(0, 999, (1, 1, 900, 1300)).astype(np.uint16)
    order = [(0, 0, b) for b in range(3)]
    path = str(tmp_path / 'port.ome.tiff')
    args = ((1, 1, 1, 900, 1300), 2, np.uint16, 'x', 1.0, 1.0, NAMES[:1],
            COLORS[:1])
    before = set(threading.enumerate())
    writer = ptw.StreamingTiffWriter(path, *args)
    feed_bands(writer, data, 320, order[:2], 2)
    writer.abort()
    assert not [t for t in set(threading.enumerate()) - before
                if t.name.startswith('tiff-encode')]
    aborted = read(path)
    assert aborted[:8] == b'II+\x00\x08\x00\x00\x00'
    assert aborted[8:16] == bytes(8)        # no first IFD: not a TIFF yet
    writer = ptw.StreamingTiffWriter(path, *args)
    feed_bands(writer, data, 320, order, 2)
    writer.close()
    want = str(tmp_path / 'jax.ome.tiff')
    writer = jtw.StreamingTiffWriter(want, *args)
    feed_bands(writer, data, 320, order, 2)
    writer.close()
    assert read(path) == read(want)


def mono_acquisition(folder, dtype=np.uint16):
    """Two channels, a 2x2 grid of 160x144 tiles with a vignette (the
    fit has something to find): a canvas of ~300x270, so level 0 holds
    2x2 TIFF tiles and its edges are partial."""
    yy, xx = np.meshgrid(np.linspace(-1, 1, 160), np.linspace(-1, 1, 144),
                         indexing='ij')
    write_synthetic_acquisition(
        folder, grid_cols=2, grid_rows=2, tile_w=144, tile_h=160,
        overlap=24, seed=4, dtype=dtype,
        channels=["Fluorescence 488 nm Ex", "Fluorescence 561 nm Ex"],
        vignette=np.clip(1 - 0.3 * (xx ** 2 + yy ** 2), 0.4, 1)
        .astype(np.float32))
    return folder


def run_both(acq, tmp_path, **opts):
    """The JAX package's run, then the port's with the JAX run's fields
    and shifts carried in; returns (JAX output, port output)."""
    jax_out, port_out = str(tmp_path / 'jax'), str(tmp_path / 'port')
    kw = dict(output_format='.ome.tiff', apply_flatfield=True,
              use_registration=True)
    jpipe = jax_pkg.stitch(acq, options=jax_pkg.EngineOptions(
        fusion_device='device', output_folder=jax_out, **opts), **kw)
    port.stitch(acq, device=CPU, state=port.state_from_reference(
        flatfields=jpipe.flatfields, shifts=jpipe.shifts),
        options=port.EngineOptions(output_folder=port_out, **opts), **kw)
    return jax_out, port_out


@pytest.mark.parametrize("blend", ['overwrite', 'feather'])
@pytest.mark.parametrize("compression", ['deflate', 'raw'])
@pytest.mark.parametrize("rgb", [False, True], ids=['mono', 'rgb'])
@pytest.mark.parametrize("streaming", ['off', 'on'], ids=['inram', 'band'])
def test_stitch_equals_jax(tmp_path, streaming, rgb, compression, blend):
    acq = str(tmp_path / 'acq')
    if rgb:
        write_rgb_acquisition(acq)
    else:
        mono_acquisition(acq)
    jax_out, port_out = run_both(
        acq, tmp_path, streaming=streaming, chunks=(1, 1, 1, 64, 64),
        tiff_compression=compression, blend_method=blend)
    assert tiff_outputs(port_out) == ['0_stitched/A1_stitched.ome.tiff']
    assert_tiff_outputs_equal(jax_out, port_out,
                              lsb=1 if blend == 'feather' else 0)
    pages = read_pages(read(os.path.join(port_out, tiff_outputs(port_out)[0])))
    assert pages[0][1][0].ndim == (3 if rgb else 2)
    assert 'OME' in pages[0][0] and pages[-1][0] == \
        'reduced-resolution overview'


def test_jpeg_raises_as_jax_on_u16_and_names_item_19_on_u8(tmp_path):
    """JPEG tiles: uint16 raises the JAX package's ``ValueError`` in both
    writers; uint8 (the part that named item 19 before the port had a
    JPEG codec) writes the JAX package's bytes, grey and RGB (4:2:0,
    Photometric 6), and reads back through ``read_pages``."""
    rng = np.random.default_rng(5)
    u16 = pyramid(rng, (1, 1, 300, 300), np.uint16, 2)
    u8 = pyramid(rng, (3, 1, 300, 300), np.uint8, 2)
    kw = dict(image_name='x', channel_names=NAMES, channel_colors=COLORS,
              pixel_size_um=1.0, dz_um=1.0, compression='jpeg')
    with pytest.raises(ValueError) as want:
        jtw.write_ome_tiff_pyramid(str(tmp_path / 'j.tif'), u16, **kw)
    with pytest.raises(ValueError) as got:
        ptw.write_ome_tiff_pyramid(str(tmp_path / 'p.tif'), u16, **kw)
    assert str(got.value) == str(want.value)
    args = ((1, 1, 1, 300, 300), 2, np.uint16, 'x', 1.0, 1.0, NAMES[:1],
            COLORS[:1])
    with pytest.raises(ValueError) as want:
        jtw.StreamingTiffWriter(str(tmp_path / 'j2.tif'), *args,
                                compression='jpeg')
    with pytest.raises(ValueError) as got:
        ptw.StreamingTiffWriter(str(tmp_path / 'p2.tif'), *args,
                                compression='jpeg')
    assert str(got.value) == str(want.value)
    before = set(threading.enumerate())
    for rgb in (False, True):
        for quality in (40, 85):
            jpath = str(tmp_path / f'j3_{rgb}_{quality}.tif')
            ppath = str(tmp_path / f'p3_{rgb}_{quality}.tif')
            jtw.write_ome_tiff_pyramid(jpath, u8, rgb=rgb,
                                       jpeg_quality=quality, **kw)
            ptw.write_ome_tiff_pyramid(ppath, u8, rgb=rgb,
                                       jpeg_quality=quality, **kw)
            assert read(ppath) == read(jpath)
            pages = read_pages(read(ppath))
            top = pages[0][1][0]
            assert top.shape == ((300, 300, 3) if rgb else (300, 300))
            want_top = (np.moveaxis(u8[0][:, 0], 0, -1) if rgb
                        else u8[0][0, 0]).astype(np.float64)
            mse = np.mean((top.astype(np.float64) - want_top) ** 2)
            assert mse > 0      # lossy, but a picture of the input
    assert not [t for t in set(threading.enumerate()) - before
                if t.name.startswith('tiff-encode')]


@pytest.mark.parametrize("streaming", ['off', 'on'], ids=['inram', 'band'])
def test_jpeg_runs_fail_as_jax_on_u16_and_name_item_19_on_u8(tmp_path,
                                                            streaming):
    """Whole ``tiff_compression='jpeg'`` runs, in RAM and in bands: a
    uint16 acquisition fails with the JAX package's ``ValueError``; uint8
    grey and RGB acquisitions (which named item 19 before the port had a
    JPEG codec) write the JAX package's ``.ome.tiff`` files, byte for
    byte."""
    mono = mono_acquisition(str(tmp_path / 'mono'))
    opts = dict(streaming=streaming, chunks=(1, 1, 1, 64, 64),
                tiff_compression='jpeg')
    with pytest.raises(ValueError) as want:
        jax_pkg.stitch(mono, output_format='.ome.tiff',
                       options=jax_pkg.EngineOptions(
                           fusion_device='device',
                           output_folder=str(tmp_path / 'jax'), **opts))
    with pytest.raises(ValueError) as got:
        port.stitch(mono, output_format='.ome.tiff', device=CPU,
                    options=port.EngineOptions(
                        output_folder=str(tmp_path / 'port'), **opts))
    assert str(got.value) == str(want.value)
    for name, acq in (
            ('u8', mono_acquisition(str(tmp_path / 'mono8'), np.uint8)),
            ('rgb', write_rgb_acquisition(str(tmp_path / 'rgb')))):
        jax_out, port_out = run_both(acq, tmp_path / name, **opts)
        assert tiff_outputs(port_out) == ['0_stitched/A1_stitched.ome.tiff']
        assert_tiff_outputs_equal(jax_out, port_out)
        pages = read_pages(read(os.path.join(port_out,
                                             tiff_outputs(port_out)[0])))
        assert pages[0][1][0].ndim == (3 if name == 'rgb' else 2)


def test_resume_skips_completed_tiff(tmp_path):
    """The twin of the JAX package's test: completed (t, region) units
    are skipped and their .ome.tiff files stay untouched; the finished
    tree equals an uninterrupted run's."""
    acq = str(tmp_path / 'acq')
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=2, tile_w=64,
                                tile_h=64, overlap=16, regions=["A1", "A2"],
                                timepoints=2)
    stop = threading.Event()
    count = [0]

    def on_status(msg, is_saving=False):
        if msg.startswith("Completed region"):
            count[0] += 1
            if count[0] == 2:
                stop.set()

    out = str(tmp_path / 'out')
    kw = dict(output_format='.ome.tiff', use_registration=True, device=CPU)
    with pytest.raises(port.StitchCancelled):
        port.stitch(acq, reporter=port.ProgressReporter(status=on_status),
                    stop_event=stop, options=port.EngineOptions(
                        output_folder=out), **kw)
    # the manifest is the source of truth: the pipelined save may land a
    # third file before the stop is seen
    completed = RunManifest.load(out).data["completed"]
    assert 2 <= len(completed) < 4
    done = [os.path.join(out, f"{k.split('/')[0]}_stitched",
                         f"{k.split('/')[1]}_stitched.ome.tiff")
            for k in completed]
    mtimes = {f: os.stat(f).st_mtime_ns for f in done}
    skipped = []
    pipe = port.stitch(acq, resume=True, reporter=port.ProgressReporter(
        status=lambda m, s=False: skipped.append(m)
        if m.startswith("Skipping") else None),
        options=port.EngineOptions(output_folder=out), **kw)
    assert pipe.resumed and len(skipped) == len(done)
    assert len(glob.glob(os.path.join(out, "*_stitched", "*.ome.tiff"))) == 4
    for f, t in mtimes.items():
        assert os.stat(f).st_mtime_ns == t
    whole = str(tmp_path / 'whole')
    port.stitch(acq, options=port.EngineOptions(output_folder=whole), **kw)
    assert_tiff_outputs_equal(whole, out)


#: the band paths: (the port's options, the JAX run whose file the
#: port's decodes equal to)
TILE_LESS = {
    'bands': (dict(streaming='on'), dict(streaming='off')),
    'host_bands': (dict(streaming='on', fusion_device='host'),
                   dict(streaming='off', fusion_device='host')),
    'feather_bands': (dict(streaming='on', blend_method='feather'),
                      dict(streaming='off', blend_method='feather')),
    'mesh': (dict(mesh_shape=(1, 2)), dict(mesh_shape=(1, 2))),
}


@pytest.mark.parametrize("dtype", ['uint16', 'float16'])
@pytest.mark.parametrize("path", list(TILE_LESS))
def test_band_paths_write_tile_less_bands_as_zeros(tmp_path, path, dtype):
    """A fault of the reference the port does not copy: the JAX band
    paths hand the OME-TIFF writer only the bands some tile reaches, and
    the writer refuses to close with a page's rows missing
    (``ValueError``), so a run whose canvas has a band no tile reaches
    (here the registered canvas's empty foot, in bands of 64 rows) fails
    at its end. The port writes such bands as zeros: its file decodes
    equal to the JAX package's in-RAM file, or on a mesh to the JAX
    mesh's (which saves the assembled canvas); feathered within 1 LSB
    (float16: 1 ulp)."""
    from torch_tile_files import tiff_bytes
    from image_stitcher_tpu_torch.io.acquisition import read_image
    acq = str(tmp_path / 'acq')
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=4, tile_w=128,
                                tile_h=128, overlap=40, seed=3)
    if dtype == 'float16':
        for tile in glob.glob(acq + '/0/*.tiff'):
            img = read_image(tile)
            with open(tile, 'wb') as f:
                f.write(tiff_bytes((img / np.float32(16)).astype(np.float16),
                                   8, 3))
    opts, jax_opts = TILE_LESS[path]
    common = dict(chunks=(1, 1, 1, 64, 64), device_band_multiple=1)
    kw = dict(output_format='.ome.tiff', apply_flatfield=True,
              use_registration=True)
    if path != 'mesh':
        with pytest.raises(ValueError, match='missing rows'):
            jax_pkg.stitch(acq, options=jax_pkg.EngineOptions(
                output_folder=str(tmp_path / 'jax_bands'), **common,
                **opts), **kw)
    jpipe = jax_pkg.stitch(acq, options=jax_pkg.EngineOptions(
        output_folder=str(tmp_path / 'jax'), **common, **jax_opts), **kw)
    port.stitch(acq, device=[CPU] * 2 if path == 'mesh' else CPU,
                state=port.state_from_reference(flatfields=jpipe.flatfields,
                                                shifts=jpipe.shifts),
                options=port.EngineOptions(output_folder=str(tmp_path / 'port'),
                                           **common, **opts), **kw)
    assert_tiff_outputs_equal(str(tmp_path / 'jax'), str(tmp_path / 'port'),
                              lsb=1 if path == 'feather_bands' else 0,
                              decoded=True)
    page = read_pages(read(os.path.join(str(tmp_path / 'port'),
                                        tiff_outputs(str(tmp_path / 'port'))[0]
                                        )))[0][1][0]
    assert page.dtype == np.dtype(dtype) and not page[-64:].any()
