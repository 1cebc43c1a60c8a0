"""The port's ``read_image`` against the JAX package's (OpenCV, with its
BGR(A) -> RGB conversion) on PNG and BMP tiles: equal shape, dtype and
every sample. Files come from OpenCV, PIL and ``torch_tile_files`` (for
what those do not write: every filter type forced per row, gray + alpha,
palettes, low bit depths, Adam7, split IDAT, BMP header variants)."""

import io

import cv2
import numpy as np
import pytest
from PIL import Image

from torch_tile_files import bmp_bytes, png_bytes
from image_stitcher_tpu.io.acquisition import read_image as jax_read_image
from image_stitcher_tpu_torch.io.acquisition import read_image

CTYPES = {0: 1, 2: 3, 4: 2, 6: 4}
GRAY_PALETTE = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)


def _write(tmp_path, data, name):
    path = str(tmp_path / name)
    with open(path, 'wb') as f:
        f.write(data)
    return path


def _assert_same(path):
    want = jax_read_image(path)
    got = read_image(path)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    return got


def _samples(seed, shape, depth):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << depth, shape).astype(
        np.uint16 if depth == 16 else np.uint8)


# ----------------------------------------------------------------- PNG

@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("ctype", sorted(CTYPES))
@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4],
                         ids=['none', 'sub', 'up', 'average', 'paeth'])
def test_png_every_filter(tmp_path, depth, ctype, filt):
    img = _samples(depth + ctype + filt, (21, 33, CTYPES[ctype]), depth)
    img[7:10] = img[6]                      # repeated rows
    path = _write(tmp_path, png_bytes(img, ctype, depth, filters=(filt,)),
                  "A1_0_0_ch.png")
    got = _assert_same(path)
    if ctype == 0:
        np.testing.assert_array_equal(got, img[..., 0])
    elif ctype == 4:                        # gray + alpha -> 3 equal planes
        np.testing.assert_array_equal(got, np.repeat(img[..., :1], 3, 2))
    else:
        np.testing.assert_array_equal(got, img[..., :3])


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("ctype", sorted(CTYPES))
def test_png_adam7_split_idat_cycling_filters(tmp_path, depth, ctype):
    img = _samples(ctype, (19, 27, CTYPES[ctype]), depth)
    path = _write(tmp_path, png_bytes(img, ctype, depth, filters=range(5),
                                      interlace=True, idat_chunks=4),
                  "t.png")
    _assert_same(path)


@pytest.mark.parametrize("kind,depth", [
    ('gray', 1), ('gray', 2), ('gray', 4),
    ('palette', 1), ('palette', 2), ('palette', 4), ('palette', 8)])
@pytest.mark.parametrize("interlace", [False, True], ids=['flat', 'adam7'])
def test_png_low_depths_and_palettes(tmp_path, kind, depth, interlace):
    idx = _samples(depth, (23, 37), depth)
    rng = np.random.default_rng(depth)
    # a short palette: the indices past it read black
    palette = (rng.integers(0, 256, (max(1, (1 << depth) - 3), 3),
                            dtype=np.uint8) if kind == 'palette' else None)
    path = _write(tmp_path, png_bytes(
        idx, 3 if palette is not None else 0, depth, filters=range(5),
        palette=palette, interlace=interlace), "t.png")
    _assert_same(path)


@pytest.mark.parametrize("ctype", [0, 2, 3])
def test_png_transparency_chunk(tmp_path, ctype):
    """tRNS gives OpenCV an alpha plane, which read_image drops, or
    (gray) nothing: the port ignores it."""
    ch = 3 if ctype == 2 else 1
    img = _samples(11, (17, 19, ch), 8)
    trns = {0: b'\0\x05', 2: b'\0\x05\0\x06\0\x07', 3: bytes(range(40))}
    path = _write(tmp_path, png_bytes(
        img, ctype, 8, palette=GRAY_PALETTE[::-1] if ctype == 3 else None,
        extra_chunks=[(b'tRNS', trns[ctype])]), "t.png")
    _assert_same(path)


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_written_by_opencv(tmp_path, depth, channels):
    img = _samples(channels, (25, 31) + ((channels,) if channels > 1
                                         else ()), depth)
    path = str(tmp_path / "t.png")
    assert cv2.imwrite(path, img)
    _assert_same(path)


def test_png_crc(tmp_path):
    img = _samples(3, (9, 10, 1), 8)
    data = bytearray(png_bytes(img, 0, 8, extra_chunks=[(b'tEXt', b'k\0v')]))
    text = data.index(b'tEXt')
    data[text + 4] ^= 1         # an ancillary chunk's body: libpng skips it
    _assert_same(_write(tmp_path, bytes(data), "anc.png"))
    data = bytearray(png_bytes(img, 0, 8))
    data[data.index(b'IDAT') + 5] ^= 1    # a critical chunk's body: error
    with pytest.raises(ValueError, match="crit.png.*CRC"):
        read_image(_write(tmp_path, bytes(data), "crit.png"))


# ----------------------------------------------------------------- BMP

def _cv2_bmp(tmp_path, img):
    path = str(tmp_path / "cv.bmp")
    assert cv2.imwrite(path, img)
    return path


def _pil_bmp(tmp_path, img, mode):
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, 'BMP')
    return _write(tmp_path, buf.getvalue(), "pil.bmp")


@pytest.mark.parametrize("width", [61, 62, 63, 64])
@pytest.mark.parametrize("top_down", [False, True], ids=['bottom_up',
                                                          'top_down'])
@pytest.mark.parametrize("kind", ['gray8', 'color8', 'rgb24', 'rgb32',
                                  'bitfields32', 'v5_32', 'color4', 'gray1'])
def test_bmp_layouts(tmp_path, width, top_down, kind):
    rng = np.random.default_rng(width)
    if kind in ('gray8', 'color8'):
        img = rng.integers(0, 256, (17, width), dtype=np.uint8)
        pal = GRAY_PALETTE if kind == 'gray8' else rng.integers(
            0, 256, (256, 3), dtype=np.uint8)
        data = bmp_bytes(img, 8, pal, top_down=top_down)
    elif kind in ('color4', 'gray1'):
        bits = 4 if kind == 'color4' else 1
        img = rng.integers(0, 1 << bits, (17, width), dtype=np.uint8)
        pal = (rng.integers(0, 256, (16, 3), dtype=np.uint8)
               if bits == 4 else np.array([[0] * 3, [255] * 3], np.uint8))
        data = bmp_bytes(img, bits, pal, top_down=top_down)
    elif kind == 'rgb24':
        img = rng.integers(0, 256, (17, width, 3), dtype=np.uint8)
        data = bmp_bytes(img, 24, top_down=top_down)
    else:
        img = rng.integers(0, 256, (17, width, 4), dtype=np.uint8)
        data = bmp_bytes(img, 32, top_down=top_down,
                         compression=0 if kind == 'rgb32' else 3,
                         header=124 if kind == 'v5_32' else 40)
    got = _assert_same(_write(tmp_path, data, "t.bmp"))
    if kind == 'gray8':
        np.testing.assert_array_equal(got, img)
    elif kind in ('rgb24', 'rgb32', 'bitfields32', 'v5_32'):
        np.testing.assert_array_equal(got, img[..., :3])


@pytest.mark.parametrize("width", [61, 62, 63, 64])
@pytest.mark.parametrize("source", ['opencv', 'pil'])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_bmp_written_by_opencv_and_pil(tmp_path, width, source, channels):
    """A 32-bit BMP from OpenCV (BI_BITFIELDS) reads back (H, W, 4) in
    OpenCV, one from PIL (BI_RGB) (H, W, 3): both end as RGB."""
    rng = np.random.default_rng(channels * width)
    shape = (15, width) + ((channels,) if channels > 1 else ())
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    if source == 'opencv':
        path = _cv2_bmp(tmp_path, img)
        rgb = img[..., 2::-1] if channels > 1 else img
    else:
        path = _pil_bmp(tmp_path, img, {1: 'L', 3: 'RGB', 4: 'RGBA'}[channels])
        rgb = img[..., :3] if channels > 1 else img
    np.testing.assert_array_equal(_assert_same(path), rgb)


def test_bmp_short_palettes(tmp_path):
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 16, (9, 13), dtype=np.uint8)
    for pal in (GRAY_PALETTE[:16], rng.integers(0, 256, (16, 3),
                                                dtype=np.uint8)):
        _assert_same(_write(tmp_path, bmp_bytes(idx, 8, pal), "t.bmp"))


@pytest.mark.parametrize("what", ['rle8', 'bits16', 'os2'])
def test_bmp_out_of_scope_raises_naming_item_6(tmp_path, what):
    img = np.zeros((4, 4), np.uint8)
    data = bytearray(bmp_bytes(img, 8, GRAY_PALETTE,
                               header=12 if what == 'os2' else 40))
    if what == 'rle8':
        data[30] = 1
    elif what == 'bits16':
        data[28] = 16
    with pytest.raises(NotImplementedError, match="item 6"):
        read_image(_write(tmp_path, bytes(data), "t.bmp"))


# ------------------------------------------------------------ dispatch

def test_dispatch_by_signature_not_suffix(tmp_path):
    img = _samples(5, (12, 14, 3), 16)
    png = _write(tmp_path, png_bytes(img, 2, 16), "A1_0_0_ch.tiff")
    np.testing.assert_array_equal(_assert_same(png), img)
    gray = _samples(6, (12, 14), 8)
    bmp = _write(tmp_path, bmp_bytes(gray, 8, GRAY_PALETTE), "A1_0_0_chtif")
    np.testing.assert_array_equal(_assert_same(bmp), gray)


def test_jpeg_raises_naming_item_19(tmp_path):
    """JPEG tiles, which named item 19 before the port had a JPEG codec,
    read as the JAX package reads them, by signature (the ``.tiff`` file
    holds a JPEG), progressive ones too (item 19 (remainder) until the
    port read them); an arithmetic-coded one still names item 19
    (remainder)."""
    path = str(tmp_path / "A1_0_0_ch.jpg")
    assert cv2.imwrite(path, _samples(7, (16, 16), 8))
    _assert_same(path)
    rgb = str(tmp_path / "A1_0_0_rgb.tiff")
    with open(rgb, 'wb') as f:
        f.write(cv2.imencode('.jpg', _samples(8, (16, 24, 3), 8))[1])
    assert _assert_same(rgb).shape == (16, 24, 3)
    prog = str(tmp_path / "A1_0_0_prog.jpg")
    assert cv2.imwrite(prog, _samples(9, (16, 16), 8),
                       [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    _assert_same(prog)
    arith = bytearray(cv2.imencode('.jpg', _samples(10, (16, 16), 8))[1])
    arith[arith.index(b'\xff\xc0') + 1] = 0xC9
    with pytest.raises(NotImplementedError, match=r"item 19 \(remainder\)"):
        read_image(_write(tmp_path, bytes(arith), "A1_0_0_arith.jpg"))


def test_unknown_file_raises_value_error_naming_it(tmp_path):
    path = _write(tmp_path, b'not an image at all', "A1_0_0_ch.png")
    with pytest.raises(ValueError, match="A1_0_0_ch.png"):
        read_image(path)
