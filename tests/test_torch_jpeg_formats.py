"""The rest of JPEG tile input against the JAX package: lossless (SOF3),
arithmetic-coded (SOF9, SOF10) and block-smoothed progressive frames
and JPEG-in-TIFF, each read by the port (its C codec and the plain
version) to the array the JAX ``read_image`` gives for the same file
(OpenCV's pixels), the streams neither OpenCV nor the JAX package's
imageio fallback reads refused with ``DecodeError``, and 3x3
acquisitions of each new format stitched to the JAX package's trees.

The streams come from ``torch_jpeg_coders.py`` (lossless and arithmetic
encoders, JPEG-in-TIFF files) and OpenCV; each encoder is held to
libjpeg-turbo on its own: OpenCV decodes an arithmetic stream to the
pixels of the Huffman stream of the same coefficients, and a lossless
stream to its samples.
"""

import io
import os
import struct

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import torch_jpeg_coders as coders
import torch_jpeg_formats
from fixtures import write_synthetic_acquisition
from test_torch_jpeg import cv2_decode, cv2_encode, image
from torch_helpers import assert_outputs_equal, small_disk_probe  # noqa: F401
from torch_jpeg_streams import pixel_digest
from image_stitcher_tpu import EngineOptions as JaxOptions
from image_stitcher_tpu import stitch as jax_stitch
from image_stitcher_tpu.io.acquisition import read_image as jax_read_image
import image_stitcher_tpu_torch as port
from image_stitcher_tpu_torch.io import jpeg, jpeg_plain, tiff
from image_stitcher_tpu_torch.io import tiffwriter
from image_stitcher_tpu_torch.io.acquisition import read_image
from image_stitcher_tpu_torch.io.tile_decode import DecodeError

CPU = torch.device('cpu')


def _write(tmp_path, data, suffix):
    path = str(tmp_path / f"A1_0_0_ch.{suffix}")
    with open(path, 'wb') as f:
        f.write(data)
    return path


def assert_reads_as_jax(tmp_path, data, suffix='jpg'):
    """The JAX ``read_image`` of the file equals the port's, its C
    decoder's and its plain version's pixels; for a JPEG stream also
    ``cv2.imdecode``'s."""
    path = _write(tmp_path, data, suffix)
    want = jax_read_image(path)
    got = read_image(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if suffix == 'jpg':
        np.testing.assert_array_equal(cv2_decode(data), want)
        codecs = [jpeg.decode(data), jpeg_plain.decode(data)]
    else:
        codecs = [tiff.decode_tiff(data), tiff.decode_tiff(data, True)]
    for px in codecs:
        np.testing.assert_array_equal(px, want)
    return want


def _samples(seed, shape, bits):
    return np.random.default_rng(seed).integers(0, 1 << bits, shape)


# ------------------------------------------------------------- 1. lossless

@pytest.mark.parametrize("restart", [0, 2], ids=['norst', 'rst'])
@pytest.mark.parametrize("pt", [0, 1])
@pytest.mark.parametrize("psv", range(1, 8))
@pytest.mark.parametrize("precision", [2, 5, 8])
def test_lossless_grey(tmp_path, precision, psv, pt, restart):
    """Predictors 1-7, the point transform, a restart every ``restart``
    rows: the samples, shifted left by Pt and not scaled to 8 bits."""
    x = _samples(precision * 10 + psv, (13, 17), precision)
    data = coders.lossless([x], precision, psv, pt, restart * 17)
    got = assert_reads_as_jax(tmp_path, data)
    np.testing.assert_array_equal(got, (x >> pt) << pt)


#: name: (components, predictor, sampling, interleaved, restart every so
#: many MCU rows, marker, component ids)
LOSSLESS_COLOUR = {
    'rgb-interleaved-rst': (3, 4, None, True, 2, b'', None),
    'rgb-scans': (3, 6, None, False, 0, b'', None),
    'rgb-sub-interleaved-rst': (3, 7, [(2, 2), (1, 1), (1, 2)], True, 1,
                                b'', None),
    'rgb-sub-scans': (3, 1, [(2, 2), (1, 1), (1, 2)], False, 0, b'', None),
    'rgb-ids-adobe0': (3, 5, None, True, 0, coders.adobe(0), b'RGB'),
    'cmyk': (4, 2, None, True, 0, b'', None),
    'cmyk-adobe0-rst': (4, 3, None, True, 3, coders.adobe(0), None),
    'grey-v2-rst': (1, 4, [(1, 2)], True, 1, b'', None),
    'grey-h2v2-rst': (1, 4, [(2, 2)], True, 2, b'', None),
    'grey-v3-rst': (1, 7, [(1, 3)], True, 1, b'', None),
}


@pytest.mark.parametrize("case", sorted(LOSSLESS_COLOUR))
def test_lossless_components(tmp_path, case):
    """3 and 4 components, interleaved or a scan each, subsampled (box
    upsampling), with restarts (a single component's iMCU rows of v rows
    restart whole); no marker or Adobe transform 0: RGB, 4: CMYK."""
    nc, psv, samp, inter, rows, marker, ids = LOSSLESS_COLOUR[case]
    samp = samp or [(1, 1)] * nc
    hmax = max(h for h, _ in samp)
    vmax = max(v for _, v in samp)
    H, W = 26, 36
    planes = [_samples(k + 40, (H * v // vmax, W * h // hmax), 8)
              for k, (h, v) in enumerate(samp)]
    per_row = -(-W // hmax) if inter and nc > 1 else planes[0].shape[1]
    data = coders.lossless(planes, 8, psv, 0, rows * per_row, samp, inter,
                           ids, marker)
    assert_reads_as_jax(tmp_path, data)


# ----------------------------------------------------------- 2. arithmetic

ARITH_KINDS = ['grey', '420', '444', '422', '440', '411']
DAC = bytes([0, 0x21, 1, 0x53, 16, 2, 17, 9])


@pytest.mark.parametrize("dac", [b'', DAC], ids=['default', 'dac'])
@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("progressive", [0, 1], ids=['seq', 'prog'])
@pytest.mark.parametrize("kind", ARITH_KINDS)
def test_arithmetic_equals_huffman(tmp_path, kind, progressive, restart,
                                   dac):
    """The coefficients of an OpenCV stream re-coded arithmetically
    (SOF9 / SOF10, the same scan script, DAC conditioning, restarts):
    OpenCV decodes both to the same pixels, and so does the port."""
    img = image(len(kind) + progressive, 33, 41, kind != 'grey')
    huff = cv2_encode(img, 80, None if kind == 'grey' else kind,
                      restart=restart, progressive=progressive)
    data = coders.arithmetic(huff, dac=dac)
    assert (b'\xff\xca' if progressive else b'\xff\xc9') in data
    np.testing.assert_array_equal(cv2_decode(data), cv2_decode(huff))
    assert_reads_as_jax(tmp_path, data)


# ------------------------------------------------------------ 3. smoothing

@pytest.mark.parametrize("scans", [1, 2, 3, 5])
@pytest.mark.parametrize("size", [(40, 48), (57, 83)], ids=str)
@pytest.mark.parametrize("kind", ['grey', '420', '444', '422', '440'])
def test_smoothed_progressive(tmp_path, kind, size, scans):
    """A progressive stream stopped after ``scans`` scans, Huffman and
    arithmetic-coded: libjpeg-turbo smooths its blocks
    (``decompress_smooth_data``: DC-only estimates when no AC was sent,
    the 5x5 Section K.8 estimates otherwise, 4:2:0 luma's neighbour rows
    as it numbers them) and so does the port."""
    img = image(scans, *size, kind != 'grey')
    data = cv2_encode(img, 85, None if kind == 'grey' else kind,
                      progressive=1)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b'\xff\xda']
    cut = data[:sos[scans]] + b'\xff\xd9'
    assert jpeg_plain._smoothed(jpeg_plain.read(cut))
    assert_reads_as_jax(tmp_path, cut)
    assert_reads_as_jax(tmp_path, coders.arithmetic(cut))


@pytest.mark.parametrize("sampling", [0x12, 0x22, 0x13, 0x14])
@pytest.mark.parametrize("size", [(40, 48), (17, 9)], ids=str)
def test_smoothed_single_component_of_tall_imcu_rows(tmp_path, sampling,
                                                     size):
    """One component whose iMCU rows are 2 to 4 block rows: the padding
    rows below the image take part in the smoothing as libjpeg-turbo's
    numbering reaches them."""
    data = cv2_encode(image(3, *size, False), 85, progressive=1)
    pos = data.index(b'\xff\xc2')
    data = data[:pos + 11] + bytes([sampling]) + data[pos + 12:]
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b'\xff\xda']
    assert_reads_as_jax(tmp_path, data[:sos[1]] + b'\xff\xd9')


# --------------------------------------------------------- 4. JPEG-in-TIFF

TIFF_LAYOUTS = [(1, (1, 1)), (2, (1, 1)), (6, (1, 1)), (6, (2, 1)),
                (6, (2, 2)), (6, (1, 2))]


@pytest.mark.parametrize("tables", [True, False], ids=['tables', 'whole'])
@pytest.mark.parametrize("layout", ['tiles', 'strips'])
@pytest.mark.parametrize("photo_sub", TIFF_LAYOUTS, ids=str)
def test_jpeg_in_tiff(tmp_path, photo_sub, layout, tables):
    """Compression 7, grey (1), RGB in the JPEG (2) and YCbCr (6) of
    every subsampling the port's encoder writes, in tiles (edge tiles
    cropped) or strips (a short last one), with JPEGTables spliced into
    abbreviated segments or whole streams."""
    photo, sub = photo_sub
    img = image(photo + sub[0], 45, 70, photo != 1)
    data = coders.jpeg_tiff(img, photo, 80, sub,
                            tile=(32, 16) if layout == 'tiles' else None,
                            rows_per_strip=16 if layout == 'strips' else None,
                            tables=tables, encode=jpeg.encode)
    assert_reads_as_jax(tmp_path, data, 'tiff')


@pytest.mark.parametrize("mode", ['L', 'RGB'])
def test_jpeg_in_tiff_from_pillow(tmp_path, mode):
    """Pillow's ``compression='jpeg'`` TIFFs: grey, and RGB (Photometric
    2) with JPEGTables."""
    buf = io.BytesIO()
    Image.fromarray(image(4, 45, 70, mode == 'RGB'), mode).save(
        buf, 'TIFF', compression='jpeg', quality=80)
    assert_reads_as_jax(tmp_path, buf.getvalue(), 'tiff')


@pytest.mark.parametrize("what", ['cmyk', 'miniswhite'])
def test_jpeg_in_tiff_through_libtiffs_rgba_reader(tmp_path, what):
    """Pillow's CMYK JPEG as a CMYK strip (its components as they are,
    then libtiff's CMYK conversion) and a MinIsWhite strip (inverted)."""
    if what == 'cmyk':
        buf = io.BytesIO()
        Image.fromarray(image(4, 32, 40, True)).convert('CMYK').save(
            buf, 'JPEG')
        data = coders.jpeg_tiff_file(32, 40, 4, 5, [buf.getvalue()])
    else:
        data = coders.jpeg_tiff_file(
            32, 40, 1, 0, [jpeg.encode(image(6, 32, 40, False), 85)])
    assert_reads_as_jax(tmp_path, data, 'tiff')


@pytest.mark.parametrize("rgb", [False, True], ids=['grey', 'rgb'])
def test_own_jpeg_ome_tiff_pages_read_as_tiles(tmp_path, rgb):
    """The port's JPEG OME-TIFF (whole JFIF streams in 256^2 tiles, grey
    or 4:2:0 YCbCr) read as a tile by the general reader: OpenCV's page
    0, and ``read_pages`` still reads it back."""
    rng = np.random.default_rng(3)
    level = rng.integers(0, 255, (3 if rgb else 1, 1, 300, 280), np.uint8)
    path = str(tmp_path / 'p.tiff')
    tiffwriter.write_ome_tiff_pyramid(
        path, [level], 'x', ['a', 'b', 'c'][:level.shape[0]],
        [0xFF0000, 0xFF00, 0xFF][:level.shape[0]], 1.0, 1.0,
        compression='jpeg', thumbnail=False, rgb=rgb)
    with open(path, 'rb') as f:
        data = f.read()
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    want = want[:, :, ::-1] if want.ndim == 3 else want
    for plain in (False, True):
        np.testing.assert_array_equal(tiff.decode_tiff(data, plain), want)
    np.testing.assert_array_equal(tiff.read_pages(data)[0][1][0], want)


# ----------------------------------------------------- 5. no pixels anywhere

def _two_components(data):
    """A 3-component baseline stream declaring 2 components."""
    sof = data.index(b'\xff\xc0')
    out = bytearray(data)
    out[sof + 9] = 2
    return bytes(out)


def _precision(data, marker, bits):
    pos = data.index(bytes([0xFF, marker]))
    out = bytearray(data)
    out[pos + 4] = bits
    return bytes(out)


def _no_pixels():
    grey = cv2_encode(image(1, 16, 16, False), 85)
    rgb = cv2_encode(image(2, 16, 16, True), 85, '444')
    x = _samples(1, (9, 11), 8)
    ycc = coders.jpeg_tiff(image(3, 32, 32, True), 6, 85, (2, 2))
    cases = {
        'lossless-9-bit': coders.lossless([_samples(2, (9, 11), 9)], 9),
        'lossless-12-bit': coders.lossless([_samples(3, (9, 11), 12)], 12),
        'lossless-16-bit': coders.lossless([_samples(4, (9, 11), 16)], 16),
        'lossless-2-component': coders.lossless([x, x], 8),
        'lossless-ycbcr-jfif': coders.lossless([x, x, x], 8,
                                               marker=coders.JFIF),
        'lossless-ycbcr-adobe1': coders.lossless([x, x, x], 8,
                                                 marker=coders.adobe(1)),
        'lossless-ycck': coders.lossless([x] * 4, 8, marker=coders.adobe(2)),
        'lossless-arithmetic': coders.lossless([x]).replace(
            b'\xff\xc3', b'\xff\xcb', 1),
        '12-bit-sequential': _precision(grey, 0xC0, 12),
        '12-bit-progressive': _precision(cv2_encode(
            image(1, 16, 16, False), 85, progressive=1), 0xC2, 12),
        '12-bit-arithmetic': _precision(coders.arithmetic(grey), 0xC9, 12),
        '2-component': _two_components(rgb),
    }
    for marker in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF):
        cases[f'hierarchical-{marker:02x}'] = grey.replace(
            b'\xff\xc0', bytes([0xFF, marker]), 1)
    tiffs = {
        'tiff-old-style': coders.ojpeg_tiff(grey, 16, 16, 1),
        'tiff-old-style-ycbcr': coders.ojpeg_tiff(rgb, 16, 16),
        'tiff-12-bit': coders.jpeg_tiff_file(16, 16, 1, 1, [
            _precision(grey, 0xC0, 12)]).replace(
                struct.pack('<HHII', 258, 3, 1, 8),
                struct.pack('<HHII', 258, 3, 1, 12)),
        'tiff-sampling-mismatch': ycc.replace(
            struct.pack('<HHIHH', 530, 3, 2, 2, 2),
            struct.pack('<HHIHH', 530, 3, 2, 1, 1)),
    }
    return cases, tiffs


@pytest.mark.parametrize("what", sorted(_no_pixels()[0])
                         + sorted(_no_pixels()[1]))
def test_streams_without_pixels_raise_decode_error(tmp_path, what):
    """Streams OpenCV does not decode and Pillow (through the JAX
    package's imageio fallback) refuses too: the JAX ``read_image``
    raises, and the port raises ``DecodeError``."""
    streams, tiffs = _no_pixels()
    suffix = 'tiff' if what in tiffs else 'jpg'
    data = tiffs[what] if what in tiffs else streams[what]
    path = _write(tmp_path, data, suffix)
    with pytest.raises(Exception):
        jax_read_image(path)
    with pytest.raises(DecodeError):
        read_image(path)
    if suffix == 'jpg':
        for codec in (jpeg, jpeg_plain):
            with pytest.raises(DecodeError, match="no pixels"):
                codec.decode(data)
    else:
        for plain in (False, True):
            with pytest.raises(DecodeError):
                tiff.decode_tiff(data, plain)


# -------------------------------------------------------- the kept files

def test_kept_files_are_what_the_script_writes():
    """``torch_jpeg_formats.npz``, which ``chip_smoke.py`` phase 19 reads
    on the card's host, holds what ``torch_jpeg_formats.make`` writes."""
    made = torch_jpeg_formats.make()
    with np.load(torch_jpeg_formats.PATH) as f:
        assert sorted(f.files) == sorted(made)
        for name in f.files:
            np.testing.assert_array_equal(f[name], made[name], name)


@pytest.mark.parametrize("name", sorted(torch_jpeg_formats.CASES))
def test_kept_files_decode_to_their_digests(name):
    """Each kept file decodes, through the C codec and (but the 2048^2
    tile) the plain version, to the digest of the JAX array."""
    data, digest = torch_jpeg_formats.load()[name]
    assert pixel_digest(torch_jpeg_formats.decode(name, data)) == digest
    if not name.startswith('tile'):
        assert pixel_digest(torch_jpeg_formats.decode(
            name, data, plain=True)) == digest


# ------------------------------------------------------------- the slice

def _rewrite(acq, fmt):
    """The acquisition's uint8 grey TIFF tiles rewritten in ``fmt``:
    lossless JPEG (.jpg), arithmetic-coded progressive JPEG with a
    restart interval (.jpg) or JPEG-in-TIFF (Photometric 1, 32^2 tiles
    with JPEGTables, .tiff)."""
    tdir = os.path.join(acq, '0')
    for name in sorted(os.listdir(tdir)):
        if not name.endswith('.tiff'):
            continue
        path = os.path.join(tdir, name)
        px = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if fmt == 'jpeg_tiff':
            data = coders.jpeg_tiff(px, 1, 90, tile=(32, 32))
            with open(path, 'wb') as f:
                f.write(data)
            continue
        if fmt == 'lossless':
            data = coders.lossless([px], 8, 4, restart=2 * px.shape[1])
        else:
            data = coders.arithmetic(cv2_encode(px, 90, progressive=1),
                                     restart=4)
        os.remove(path)
        with open(path[:-5] + '.jpg', 'wb') as f:
            f.write(data)


@pytest.mark.parametrize("fmt", ['lossless', 'arithmetic', 'jpeg_tiff'])
def test_acquisition_stitches_as_jax(tmp_path, fmt):
    """A 3x3 acquisition of each new format, registered and stitched by
    the JAX package and by the port with the JAX run's shifts carried
    across: byte-equal trees."""
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(
        acq, grid_cols=3, grid_rows=3, tile_w=96, tile_h=80, overlap=20,
        dtype=np.uint8, gt_quantize_bits=5, seed=23)
    _rewrite(acq, fmt)
    opts = dict(compressor_cname=None, chunks=(1, 1, 1, 64, 64))
    jpipe = jax_stitch(acq, use_registration=True, apply_flatfield=True,
                       options=JaxOptions(fusion_device='device',
                                          output_folder=str(tmp_path / "jax"),
                                          **opts))
    port.stitch(acq, use_registration=True, apply_flatfield=True, device=CPU,
                state=port.state_from_reference(
                    flatfields=jpipe.flatfields, shifts=jpipe.shifts),
                options=port.EngineOptions(
                    output_folder=str(tmp_path / "port"), **opts))
    assert_outputs_equal(str(tmp_path / "jax"), str(tmp_path / "port"))
