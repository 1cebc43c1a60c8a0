"""The port's JPEG codec (``io/jpeg.py``, C, and its plain version
``io/jpeg_plain.py``) against OpenCV's libjpeg-turbo, which the JAX
package reads and writes JPEG through.

Decoding: files written by OpenCV (grey; RGB 4:4:4, 4:2:2, 4:2:0, 4:4:0,
4:1:1; baseline and progressive, with and without optimised Huffman
tables) and by PIL (grey; RGB 4:4:4, 4:2:2, 4:2:0; optimised tables;
progressive; CMYK, and YCCK made from it by its Adobe transform flag) at
quality 1 to 100, sizes 1x1, 7x13, 17x33 and 256x256 and a 2048^2 tile,
with restart intervals, and 3-component streams with an Adobe APP14
marker (RGB or YCbCr) or 'R', 'G', 'B' component ids, decode to the
pixels of ``cv2.imread(IMREAD_UNCHANGED)`` (BGR flipped to RGB), EXIF
orientation ignored as OpenCV ignores it there. Encoding: the bytes of
``cv2.imencode('.jpg')`` with the JAX TIFF writer's parameters (quality,
4:2:0 for RGB), and with the other samplings and restart intervals. The
C codec equals the plain version on every case. Streams OpenCV does not
read (fractional sampling, MCUs of more than 10 blocks) raise
``DecodeError``; arithmetic-coded, lossless, hierarchical and 12-bit
frames, and progressive streams that libjpeg-turbo would smooth, raise
naming ROADMAP item 19 (remainder).
"""

import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

import torch_jpeg_streams
from image_stitcher_tpu_torch.io import jpeg, jpeg_plain
from image_stitcher_tpu_torch.io.tile_decode import DecodeError

QUALITIES = (1, 50, 75, 85, 95, 100)
SIZES = ((1, 1), (7, 13), (17, 33), (256, 256))
CV2_SAMPLING = {'444': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                '422': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                '420': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                '440': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                '411': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
#: luma (h, v) sampling of each layout the encoder writes
LUMA = {'444': (1, 1), '422': (2, 1), '420': (2, 2), '440': (1, 2)}
PIL_SUBSAMPLING = {'444': 0, '422': 1, '420': 2}


def image(seed, h, w, rgb):
    """Smooth waves, noise and colour casts: every coefficient range."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = 128 + 60 * np.sin(x / 5.0) + 50 * np.cos(y / 7.0)
    if rgb:
        img = base[..., None] + rng.normal(0, 20, (h, w, 3)) + [0, 30, -30]
    else:
        img = base + rng.normal(0, 20, (h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


def cv2_encode(img, quality, sampling=None, restart=0, progressive=0,
               optimize=0):
    """OpenCV's JPEG of ``img`` (RGB flipped to BGR, as the JAX writer
    hands it over)."""
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
              cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
              cv2.IMWRITE_JPEG_OPTIMIZE, optimize]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, CV2_SAMPLING[sampling]]
        img = np.ascontiguousarray(img[:, :, ::-1])
    ok, data = cv2.imencode('.jpg', img, params)
    assert ok
    return data.tobytes()


def cv2_decode(data):
    """The JAX ``read_image`` of a JPEG file: IMREAD_UNCHANGED, then BGR
    -> RGB."""
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    return img[:, :, ::-1] if img.ndim == 3 else img


def pil_encode(img, quality, sampling=None, optimize=False,
               progressive=False, mode=None):
    out = io.BytesIO()
    kw = dict(quality=quality, optimize=optimize, progressive=progressive)
    if img.ndim == 3 and mode is None:
        kw['subsampling'] = PIL_SUBSAMPLING[sampling]
    im = Image.fromarray(img)
    im.convert(mode).save(out, 'JPEG', **kw) if mode else im.save(
        out, 'JPEG', **kw)
    return out.getvalue()


def ycck(cmyk):
    """A CMYK stream with its Adobe APP14 transform flag set to 2: the
    same components read as YCCK."""
    pos = cmyk.index(b'\xff\xee') + 4 + 11
    assert cmyk[pos - 11:pos - 6] == b'Adobe' and cmyk[pos] == 0
    return cmyk[:pos] + b'\x02' + cmyk[pos + 1:]


def assert_decodes_as_cv2(data):
    want = cv2_decode(data)
    got = jpeg.decode(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jpeg_plain.decode(data), got)


# ---------------------------------------------------------------- decoder

@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("kind", ['grey'] + sorted(CV2_SAMPLING))
def test_decode_cv2_files(kind, quality):
    for k, (h, w) in enumerate(SIZES):
        img = image(k + quality, h, w, kind != 'grey')
        assert_decodes_as_cv2(cv2_encode(img, quality, kind))


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("kind", ['grey'] + sorted(PIL_SUBSAMPLING))
def test_decode_pil_files(kind, quality):
    for k, (h, w) in enumerate(SIZES):
        img = image(k + 2 * quality, h, w, kind != 'grey')
        # PIL's optimising writer fails on some quality-100 images
        # ("Suspension not allowed here")
        for optimize in (False, True) if quality < 100 else (False,):
            assert_decodes_as_cv2(pil_encode(img, quality, kind, optimize))


@pytest.mark.parametrize("restart", [1, 3, 17])
@pytest.mark.parametrize("kind", ['grey', '420', '444'])
def test_decode_restart_intervals(kind, restart):
    img = image(restart, 61, 97, kind != 'grey')
    data = cv2_encode(img, 85, kind, restart=restart)
    assert b'\xff\xdd' in data and b'\xff\xd0' in data
    assert_decodes_as_cv2(data)


@pytest.mark.parametrize("quality", (5, 50, 85, 100))
@pytest.mark.parametrize("kind", ['grey'] + sorted(CV2_SAMPLING))
def test_decode_cv2_progressive_files(kind, quality):
    """Progressive streams (SOF2, jpeg_simple_progression's scans: DC
    first and refinement, spectral bands with EOB runs, successive
    approximation), each also with optimised tables (one DHT a scan)
    and a restart interval."""
    for k, (h, w) in enumerate(SIZES):
        img = image(k + 3 * quality, h, w, kind != 'grey')
        for optimize, restart in ((0, 0), (1, 0), (0, 2), (1, 5)):
            data = cv2_encode(img, quality, kind, restart, 1, optimize)
            assert b'\xff\xc2' in data
            assert_decodes_as_cv2(data)


@pytest.mark.parametrize("quality", (1, 50, 95))
def test_decode_cv2_411_files(quality):
    """4:1:1 (luma 4x1): chroma box-replicated four times across, as
    libjpeg-turbo's int_upsample does; optimised tables and restart
    intervals (SOF1-style extended tables are baseline-decodable)."""
    for k, (h, w) in enumerate(SIZES + ((9, 70),)):
        img = image(k + quality, h, w, True)
        for optimize, restart in ((0, 0), (1, 3)):
            assert_decodes_as_cv2(cv2_encode(img, quality, '411', restart,
                                             0, optimize))


@pytest.mark.parametrize("progressive", [False, True],
                         ids=['baseline', 'progressive'])
@pytest.mark.parametrize("kind", ['grey', '444', '422', '420', 'cmyk',
                                  'ycck'])
def test_decode_pil_progressive_and_cmyk_files(kind, progressive):
    """PIL's progressive streams, and its CMYK streams (Adobe APP14,
    transform 0), read through OpenCV's CMYK -> BGR; the same streams
    flagged YCCK (transform 2) go through libjpeg-turbo's YCCK -> CMYK
    first."""
    for k, (h, w) in enumerate(SIZES):
        img = image(k + 7, h, w, kind != 'grey')
        if kind in ('cmyk', 'ycck'):
            data = pil_encode(img, 80, progressive=progressive, mode='CMYK')
            if kind == 'ycck':
                data = ycck(data)
        else:
            data = pil_encode(img, 80, kind, progressive=progressive)
        assert_decodes_as_cv2(data)


def adobe(data, transform, jfif=True):
    """A cv2 stream with an Adobe APP14 marker of ``transform`` after its
    SOI, its JFIF APP0 kept or dropped."""
    body = b'Adobe' + bytes([0, 100, 0, 0, 0, 0, transform])
    app14 = b'\xff\xee' + struct.pack('>H', len(body) + 2) + body
    rest = data[2:] if jfif else data[20:]
    return data[:2] + app14 + rest


@pytest.mark.parametrize("jfif", [True, False], ids=['jfif', 'no_jfif'])
@pytest.mark.parametrize("transform", [0, 1, 2])
def test_decode_adobe_transforms(transform, jfif):
    """Three components: a JFIF APP0 means YCbCr; without one, an Adobe
    transform 0 means RGB (no conversion), 1 or any other YCbCr."""
    for kind in ('420', '444'):
        data = adobe(cv2_encode(image(transform, 24, 40, True), 85, kind),
                     transform, jfif)
        assert_decodes_as_cv2(data)


def rgb_ids(data):
    """A cv2 stream without its JFIF APP0 and its components named 'R',
    'G', 'B'."""
    no_jfif = bytearray(data[:2] + data[20:])
    sof, sos = no_jfif.index(b'\xff\xc0'), no_jfif.index(b'\xff\xda')
    for k, cid in enumerate(b'RGB'):
        no_jfif[sof + 10 + 3 * k] = cid
        no_jfif[sos + 5 + 2 * k] = cid
    return bytes(no_jfif)


@pytest.mark.parametrize("kind", ['444', '420'])
def test_decode_rgb_component_ids(kind):
    """'R', 'G', 'B' ids without JFIF: RGB samples, no conversion; with
    ids 1, 2, 3 and no JFIF: YCbCr."""
    data = cv2_encode(image(8, 33, 21, True), 90, kind)
    assert_decodes_as_cv2(rgb_ids(data))
    assert_decodes_as_cv2(data[:2] + data[20:])


@pytest.mark.parametrize("what", ['fractional', 'mcu_of_18_blocks',
                                  'factor_5'])
def test_streams_opencv_does_not_read_raise_decode_error(what):
    """libjpeg-turbo refuses fractional sampling ratios, interleaved MCUs
    of more than 10 blocks and sampling factors over 4: ``cv2.imread``
    gives None (and the JAX package's imageio fallback fails too); the
    port raises ``DecodeError``."""
    data = cv2_encode(image(2, 16, 24, True), 85, '422')
    patch = {'fractional': ((10, 0x31), (13, 0x21)),
             'mcu_of_18_blocks': ((10, 0x44),),
             'factor_5': ((10, 0x51),)}[what]
    for offset, value in patch:
        data = _patched(data, 0xC0, offset, value)
    assert cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_UNCHANGED) is None
    for codec in (jpeg, jpeg_plain):
        with pytest.raises(DecodeError):
            codec.decode(data)


@pytest.mark.parametrize("scans", [1, 6, 9])
def test_progressive_streams_libjpeg_would_smooth_name_item_19(scans):
    """A progressive stream cut after ``scans`` of its 10 scans leaves
    low coefficients unrefined: libjpeg-turbo then smooths the blocks
    (``jdcoefct.c::decompress_smooth_data``), which the port does not
    reproduce, so it raises naming ROADMAP item 19 (remainder)."""
    data = cv2_encode(image(3, 40, 48, True), 85, '420', progressive=1)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b'\xff\xda']
    assert len(sos) == 10
    cut = data[:sos[scans]] + b'\xff\xd9'
    assert cv2.imdecode(np.frombuffer(cut, np.uint8),
                        cv2.IMREAD_UNCHANGED).shape == (40, 48, 3)
    for codec in (jpeg, jpeg_plain):
        with pytest.raises(NotImplementedError,
                           match=r"item 19 \(remainder\)"):
            codec.decode(cut)


def exif_orientation(data, orientation):
    """``data`` with an EXIF APP1 segment (IFD0 holding only Orientation)
    after its JFIF APP0."""
    tiff = (b'II*\x00' + struct.pack('<I', 8) + struct.pack('<H', 1)
            + struct.pack('<HHIHH', 0x0112, 3, 1, orientation, 0)
            + struct.pack('<I', 0))
    body = b'Exif\x00\x00' + tiff
    app1 = b'\xff\xe1' + struct.pack('>H', len(body) + 2) + body
    end = 4 + struct.unpack('>H', data[4:6])[0]
    return data[:end] + app1 + data[end:]


@pytest.mark.parametrize("rgb", [False, True], ids=['grey', 'rgb'])
def test_exif_orientation_is_ignored(tmp_path, rgb):
    img = image(3, 24, 40, rgb)
    data = exif_orientation(cv2_encode(img, 90, '420'), 6)
    path = str(tmp_path / 'A1_0_0_ch.jpg')
    with open(path, 'wb') as f:
        f.write(data)
    # the orientation takes effect where OpenCV applies it ...
    assert cv2.imread(path, cv2.IMREAD_COLOR).shape[:2] == (40, 24)
    # ... and IMREAD_UNCHANGED (the JAX read_image) ignores it
    assert cv2.imread(path, cv2.IMREAD_UNCHANGED).shape[:2] == (24, 40)
    assert_decodes_as_cv2(data)


def test_decode_a_whole_tile():
    img = image(9, 2048, 2048, False)
    data = cv2_encode(img, 95)
    np.testing.assert_array_equal(jpeg.decode(data), cv2_decode(data))


@pytest.mark.parametrize("kind", ['grey', '420'])
def test_decode_a_whole_progressive_tile(kind):
    img = image(10, 2048, 2048, kind != 'grey')
    data = cv2_encode(img, 90, kind, progressive=1)
    np.testing.assert_array_equal(jpeg.decode(data), cv2_decode(data))


# ---------------------------------------------------------------- encoder

@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("kind", ['grey', '420'])
def test_encode_equals_cv2(kind, quality):
    """The JAX TIFF writer's parameters: quality, 4:2:0 for RGB."""
    for k, (h, w) in enumerate(SIZES):
        img = image(3 * k + quality, h, w, kind == '420')
        want = cv2_encode(img, quality, kind)
        got = jpeg.encode(img, quality, LUMA.get(kind, (1, 1)))
        assert got == want, (h, w)
        assert jpeg_plain.encode(img, quality,
                                 LUMA.get(kind, (1, 1))) == got, (h, w)


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("kind", ['444', '422', '440'])
def test_encode_other_samplings_equal_cv2(kind, restart):
    for quality in (30, 85):
        for k, (h, w) in enumerate(SIZES):
            img = image(k + quality, h, w, True)
            want = cv2_encode(img, quality, kind, restart=restart)
            got = jpeg.encode(img, quality, LUMA[kind], restart)
            assert got == want, (quality, h, w)
            assert jpeg_plain.encode(img, quality, LUMA[kind],
                                     restart) == got


@pytest.mark.parametrize("kind", ['grey', '420'])
def test_encode_restart_intervals_equal_cv2(kind):
    for restart in (1, 5, 64):
        img = image(restart, 77, 131, kind == '420')
        want = cv2_encode(img, 75, kind, restart=restart)
        got = jpeg.encode(img, 75, LUMA.get(kind, (1, 1)), restart)
        assert got == want
        assert jpeg_plain.encode(img, 75, LUMA.get(kind, (1, 1)),
                                 restart) == got


def test_encode_a_whole_tile():
    img = image(11, 2048, 2048, False)
    assert jpeg.encode(img, 95) == cv2_encode(img, 95)


def test_encode_refuses_what_it_cannot_write():
    for bad in (np.zeros((8, 8), np.uint16), np.zeros((8, 8, 4), np.uint8),
                np.zeros((0, 8), np.uint8)):
        for codec in (jpeg, jpeg_plain):
            with pytest.raises(ValueError):
                codec.encode(bad, 85)


# ---------------------------------------------------------- out of scope

def _patched(data, marker, offset, value):
    """``data`` with the byte ``offset`` into the segment of ``marker``
    (0 is the marker's second byte) set to ``value``."""
    pos = data.index(bytes([0xFF, marker]))
    out = bytearray(data)
    out[pos + 1 + offset] = value
    return bytes(out)


def _refused():
    """The streams the port refused before it read progressive frames,
    every sampling, 4 components and the colour transforms, and those it
    still refuses."""
    grey = cv2_encode(image(1, 16, 16, False), 85)
    rgb = cv2_encode(image(2, 16, 16, True), 85, '420')
    cmyk = io.BytesIO()
    Image.fromarray(image(4, 16, 16, True)).convert('CMYK').save(cmyk, 'JPEG')
    return {
        'progressive': cv2_encode(image(3, 16, 16, True), 85, '420',
                                  progressive=1),
        'arithmetic': _patched(grey, 0xC0, 0, 0xC9),
        'lossless': _patched(grey, 0xC0, 0, 0xC3),
        'hierarchical': _patched(grey, 0xC0, 0, 0xC5),
        '12-bit': _patched(grey, 0xC0, 3, 12),
        'sampling': cv2_encode(image(5, 16, 16, True), 85, '411'),
        '4-component': cmyk.getvalue(),
        'Adobe': adobe(rgb, 1),
        "'R', 'G', 'B'": rgb_ids(rgb),
    }


#: the cases of :func:`_refused` the port now reads
NOW_READ = {'progressive', 'sampling', '4-component', 'Adobe',
            "'R', 'G', 'B'"}


@pytest.mark.parametrize("what", sorted(_refused()))
def test_out_of_scope_streams_name_item_19(what):
    """Arithmetic-coded, lossless, hierarchical and 12-bit frames raise
    naming ROADMAP item 19 (remainder); the streams of the other cases,
    refused until the port read them, decode to OpenCV's pixels."""
    data = _refused()[what]
    if what in NOW_READ:
        assert_decodes_as_cv2(data)
        return
    for codec in (jpeg, jpeg_plain):
        with pytest.raises(NotImplementedError,
                           match=r"item 19 \(remainder\)"):
            codec.decode(data)


@pytest.mark.parametrize("cut", ['truncated', 'no_eoi', 'garbage', 'soi'])
def test_corrupt_streams_raise(cut):
    data = cv2_encode(image(5, 40, 40, True), 85, '420')
    bad = {'truncated': data[:len(data) // 2],
           'no_eoi': data[:-2],
           'garbage': data[:-40] + bytes([0xFF, 0x99]) + data[-38:],
           'soi': b'\xff\xd8'}[cut]
    for codec in (jpeg, jpeg_plain):
        with pytest.raises(DecodeError):
            codec.decode(bad)


@pytest.mark.parametrize("why", ['no_compiler', 'failed_build'])
def test_codec_that_cannot_build_raises(tmp_path, monkeypatch, why):
    """No C compiler, or one that fails: reading a JPEG tile and writing a
    JPEG tile raise; nothing runs the plain version instead."""
    from image_stitcher_tpu_torch import native
    from image_stitcher_tpu_torch.io import acquisition, tiffwriter
    monkeypatch.setattr(native, 'BUILD_ROOT', str(tmp_path / "build"))
    monkeypatch.setattr(native, '_LIBS', {})
    monkeypatch.setattr(jpeg, '_LIB', None)
    if why == 'no_compiler':
        monkeypatch.delenv('CC', raising=False)
        monkeypatch.setenv('PATH', str(tmp_path / "empty"))
        match = "no C compiler"
    else:
        monkeypatch.setenv('CC', 'false')
        match = "failed to build"
    data = cv2_encode(image(6, 16, 16, False), 85)
    path = str(tmp_path / 'A1_0_0_ch.jpg')
    with open(path, 'wb') as f:
        f.write(data)
    with pytest.raises(RuntimeError, match=match):
        acquisition.read_image(path)
    with pytest.raises(RuntimeError, match=match):
        tiffwriter._encode_jpeg(np.zeros((256, 256), np.uint8), 85)


# ------------------------------------------------- the card's stream file

def test_kept_streams_are_what_the_script_writes():
    """``torch_jpeg_streams.npz``, which ``chip_smoke.py`` decodes on the
    card's host (no OpenCV there), holds what ``torch_jpeg_streams.make``
    writes with this host's OpenCV."""
    made = torch_jpeg_streams.make()
    with np.load(torch_jpeg_streams.PATH) as f:
        assert sorted(f.files) == sorted(made)
        for name in f.files:
            np.testing.assert_array_equal(f[name], made[name], name)


@pytest.mark.parametrize("name", [c[0] for c in torch_jpeg_streams.CASES])
def test_kept_streams_decode_to_their_digests(name):
    """Each kept stream decodes, through the C codec and (but the 2048^2
    tiles) the plain version, to the pixels whose SHA-256 it carries:
    OpenCV's."""
    data, digest = torch_jpeg_streams.load()[name]
    got = jpeg.decode(data)
    assert torch_jpeg_streams.pixel_digest(got) == digest
    np.testing.assert_array_equal(got, cv2_decode(data))
    if not name.startswith('tile'):
        np.testing.assert_array_equal(jpeg_plain.decode(data), got)
