"""The port's baseline JPEG codec (``io/jpeg.py``, C, and its plain
version ``io/jpeg_plain.py``) against OpenCV's libjpeg-turbo, which the
JAX package reads and writes JPEG through.

Decoding: files written by OpenCV (grey; RGB 4:4:4, 4:2:2, 4:2:0, 4:4:0)
and by PIL (grey; RGB 4:4:4, 4:2:2, 4:2:0; optimised Huffman tables) at
quality 1, 50, 75, 85, 95 and 100, sizes 1x1, 7x13, 17x33 and 256x256,
and with restart intervals, decode to the pixels of
``cv2.imread(IMREAD_UNCHANGED)`` (BGR flipped to RGB), EXIF orientation
ignored as OpenCV ignores it there. Encoding: the bytes of
``cv2.imencode('.jpg')`` with the JAX TIFF writer's parameters (quality,
4:2:0 for RGB), and with the other samplings and restart intervals. The
C codec equals the plain version on every case, and refused streams
raise naming ROADMAP item 19 (remainder).
"""

import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from image_stitcher_tpu_torch.io import jpeg, jpeg_plain
from image_stitcher_tpu_torch.io.tile_decode import DecodeError

QUALITIES = (1, 50, 75, 85, 95, 100)
SIZES = ((1, 1), (7, 13), (17, 33), (256, 256))
CV2_SAMPLING = {'444': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                '422': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                '420': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                '440': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
#: luma (h, v) sampling of each layout
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


def cv2_encode(img, quality, sampling=None, restart=0, progressive=0):
    """OpenCV's JPEG of ``img`` (RGB flipped to BGR, as the JAX writer
    hands it over)."""
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
              cv2.IMWRITE_JPEG_PROGRESSIVE, progressive]
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


def pil_encode(img, quality, sampling=None, optimize=False):
    out = io.BytesIO()
    kw = dict(quality=quality, optimize=optimize)
    if img.ndim == 3:
        kw['subsampling'] = PIL_SUBSAMPLING[sampling]
    Image.fromarray(img).save(out, 'JPEG', **kw)
    return out.getvalue()


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
    grey = cv2_encode(image(1, 16, 16, False), 85)
    rgb = cv2_encode(image(2, 16, 16, True), 85, '420')
    adobe_body = b'Adobe' + bytes([0, 100, 0, 0, 0, 0, 1])
    app14 = b'\xff\xee' + struct.pack('>H', len(adobe_body) + 2) + adobe_body
    no_jfif = rgb[:2] + rgb[20:]
    sof, sos = no_jfif.index(b'\xff\xc0'), no_jfif.index(b'\xff\xda')
    rgb_ids = bytearray(no_jfif)
    for k, cid in enumerate(b'RGB'):
        rgb_ids[sof + 10 + 3 * k] = cid
        rgb_ids[sos + 5 + 2 * k] = cid
    cmyk = io.BytesIO()
    Image.fromarray(image(4, 16, 16, True)).convert('CMYK').save(cmyk, 'JPEG')
    return {
        'progressive': cv2_encode(image(3, 16, 16, True), 85, '420',
                                  progressive=1),
        'arithmetic': _patched(grey, 0xC0, 0, 0xC9),
        'lossless': _patched(grey, 0xC0, 0, 0xC3),
        '12-bit': _patched(grey, 0xC0, 3, 12),
        'sampling': _patched(rgb, 0xC0, 10, 0x41),
        '4-component': cmyk.getvalue(),
        'Adobe': rgb[:20] + app14 + rgb[20:],
        "'R', 'G', 'B'": bytes(rgb_ids),
    }


@pytest.mark.parametrize("what", sorted(_refused()))
def test_out_of_scope_streams_name_item_19(what):
    data = _refused()[what]
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
