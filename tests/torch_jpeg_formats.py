"""Lossless, arithmetic-coded, block-smoothed and JPEG-in-TIFF tiles
kept in the repo, with the digests of the pixels the JAX package reads
from them.

The card's host has no OpenCV, Pillow or imageio, and the test-side
arithmetic encoder (``torch_jpeg_coders.py``) is too slow there for
2048^2 tiles. So ``chip_smoke.py`` (phase 19) takes these files from
``torch_jpeg_formats.npz``, written by :func:`make` on the CPU test host
(OpenCV 5.0 with libjpeg-turbo 3.1.2, imageio with Pillow's libtiff):

- small files of every group: lossless frames (predictors, the point
  transform, restarts, 2 bits, 3 subsampled components in separate
  scans, CMYK), arithmetic-coded sequential and progressive frames (DAC
  conditioning, restarts, a stream cut before its refinements, which
  libjpeg-turbo smooths), a Huffman progressive stream cut likewise, and
  JPEG-in-TIFF files (grey tiles, RGB strips, YCbCr 2x2 tiles with
  JPEGTables, YCbCr 2x1 strips, Pillow's CMYK JPEG as a CMYK strip, a
  MinIsWhite strip);
- one 2048^2 arithmetic-coded progressive RGB 4:2:0 tile with a restart
  interval, for decode rates and phase 19's grid.

Each file comes with the SHA-256 of the array the JAX ``read_image``
gives for it (OpenCV's pixels, libtiff's RGBA ones for CMYK and
MinIsWhite TIFFs), so the
card can hold the port's decoders to the JAX package without either.
Regenerate with::

    python tests/torch_jpeg_formats.py

``tests/test_torch_jpeg_formats.py`` checks that the file is what
:func:`make` writes and that every file decodes to those pixels.
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch_jpeg_coders as coders  # noqa: E402
from torch_jpeg_streams import content, pixel_digest  # noqa: E402

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    'torch_jpeg_formats.npz')


def _huffman(img, quality, sampling, progressive=0, restart=0):
    import cv2
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, {
            '444': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            '422': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            '420': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}[sampling]]
        img = np.ascontiguousarray(img[:, :, ::-1])
    ok, data = cv2.imencode('.jpg', img, params)
    assert ok
    return data.tobytes()


def _pil_cmyk(img):
    """Pillow's CMYK JPEG of an RGB image (Adobe-inverted samples)."""
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).convert('CMYK').save(buf, 'JPEG', quality=85)
    return buf.getvalue()


def _cut(data, scans):
    """A progressive stream stopped after ``scans`` scans."""
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b'\xff\xda']
    return data[:sos[scans]] + b'\xff\xd9'


def _samples(seed, shape, bits):
    return np.random.default_rng(seed).integers(0, 1 << bits, shape)


#: name -> (file suffix, builder)
CASES = {
    'll-grey-p1': ('jpg', lambda: coders.lossless(
        [content(1, 37, 61, False, 12.0)])),
    'll-grey-p7-pt1-rst': ('jpg', lambda: coders.lossless(
        [content(2, 40, 30, False, 12.0)], 8, 7, 1, restart=60)),
    'll-2bit-p4': ('jpg', lambda: coders.lossless(
        [_samples(3, (19, 23), 2)], 2, 4)),
    'll-rgb-sub-scans': ('jpg', lambda: coders.lossless(
        [_samples(4, (32, 40), 8), _samples(5, (16, 20), 8),
         _samples(6, (32, 20), 8)], 8, 6,
        sampling=[(2, 2), (1, 1), (1, 2)], interleaved=False)),
    'll-cmyk-p5-rst': ('jpg', lambda: coders.lossless(
        [_samples(7 + k, (20, 26), 8) for k in range(4)], 8, 5,
        restart=52)),
    'ar-seq-grey': ('jpg', lambda: coders.arithmetic(
        _huffman(content(8, 45, 70, False, 12.0), 85, None))),
    'ar-seq-420-rst-dac': ('jpg', lambda: coders.arithmetic(
        _huffman(content(9, 61, 97, True, 12.0), 90, '420', restart=2),
        dac=bytes([0, 0x21, 1, 0x53, 16, 2, 17, 9]))),
    'ar-prog-422': ('jpg', lambda: coders.arithmetic(
        _huffman(content(10, 33, 50, True, 12.0), 75, '422', 1))),
    'ar-prog-444-cut3': ('jpg', lambda: coders.arithmetic(
        _cut(_huffman(content(11, 40, 48, True, 12.0), 85, '444', 1), 3))),
    'hf-prog-420-cut2': ('jpg', lambda: _cut(
        _huffman(content(12, 57, 83, True, 12.0), 85, '420', 1), 2)),
    'tiff-grey-tiles': ('tiff', lambda: coders.jpeg_tiff(
        content(13, 45, 70, False, 12.0), 1, 80, tile=(32, 16))),
    'tiff-rgb-strips': ('tiff', lambda: coders.jpeg_tiff(
        content(14, 45, 70, True, 12.0), 2, 80, rows_per_strip=16,
        tables=False)),
    'tiff-ycc22-tiles': ('tiff', lambda: coders.jpeg_tiff(
        content(15, 50, 70, True, 12.0), 6, 85, (2, 2), tile=(32, 32))),
    'tiff-ycc21-strips': ('tiff', lambda: coders.jpeg_tiff(
        content(16, 45, 70, True, 12.0), 6, 85, (2, 1),
        rows_per_strip=16)),
    'tiff-cmyk-strip': ('tiff', lambda: coders.jpeg_tiff_file(
        32, 40, 4, 5, [_pil_cmyk(content(17, 32, 40, True, 12.0))])),
    'tiff-miniswhite-strip': ('tiff', lambda: coders.jpeg_tiff_file(
        32, 40, 1, 0, [coders.jp.encode(content(19, 32, 40, False, 12.0),
                                        80)])),
    'tile-ar-prog-420-rst': ('jpg', lambda: coders.arithmetic(
        _huffman(content(18, 2048, 2048, True, 1.0), 85, '420', 1),
        restart=128)),
}


def make() -> dict:
    """{name: file bytes, name + ':sha256': the digest of the JAX
    ``read_image``'s array for it} for every case (needs the JAX package
    and its readers)."""
    from image_stitcher_tpu.io.acquisition import read_image
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (suffix, build) in CASES.items():
            data = build()
            path = os.path.join(tmp, f'A1_0_0_{name}.{suffix}')
            with open(path, 'wb') as f:
                f.write(data)
            out[name] = np.frombuffer(data, np.uint8)
            out[name + ':sha256'] = np.frombuffer(
                pixel_digest(np.asarray(read_image(path))).encode(),
                np.uint8)
    return out


def load() -> dict:
    """{name: (file bytes, the JAX array's SHA-256)} from the file."""
    with np.load(PATH) as f:
        return {name: (f[name].tobytes(), f[name + ':sha256'].tobytes()
                       .decode())
                for name in f.files if not name.endswith(':sha256')}


def decode(name: str, data: bytes, plain: bool = False) -> np.ndarray:
    """The port's pixels of a kept file: JPEG streams through
    ``io/jpeg.py``, TIFFs through ``io/tiff.py`` (``plain``: the plain
    versions)."""
    from image_stitcher_tpu_torch.io import jpeg, jpeg_plain, tiff
    if CASES[name][0] == 'tiff':
        return tiff.decode_tiff(data, plain)
    return (jpeg_plain if plain else jpeg).decode(data)


if __name__ == '__main__':
    np.savez(PATH, **make())
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")
