"""Tiles in the layouts the rest of ROADMAP item 6 ported, kept in the repo
with the pixels the JAX package's ``read_image`` gives for them.

The layouts: TIFFs that OpenCV reads through libtiff's RGBA interface
(MinIsWhite, palettes of 1, 4 and 8 bits, CMYK, YCbCr with and without
subsampling, grey + alpha, bilevel in every codec: none, LZW, PackBits,
CCITT Modified Huffman, T.4 1-D / 2-D / with fill bits, T.6), 10- to
14-bit samples (which OpenCV scales to 16 bits), FillOrder 2, old-style
LZW, the TIFFs OpenCV cannot read and imageio can (2- and 4-bit grey,
16-bit palette and CMYK, 3-sample CMYK, CMYK of InkSet 2, 5 samples,
LZMA), and RLE8, RLE4 and 16-bit BMPs. Each is a small seeded image
(:data:`H` x :data:`W`) built with ``torch_tile_files`` (and PIL's
libtiff for three CCITT files).

The card's host has no OpenCV, imageio or PIL, so ``chip_smoke.py``
phase 18 takes one file of each layout (strips, little-endian) from
``torch_tiff_layouts.npz``, written by :func:`make` on the CPU test
host, each with :func:`digest` of the array the JAX package's
``read_image`` gives for it. Regenerate with::

    python tests/torch_tiff_layouts.py

``tests/test_torch_tiff_layouts.py`` checks that the file is what
:func:`make` writes, that every kept file decodes to its digest, and
that every layout, in strips and tiles and both byte orders, reads as
the JAX package reads it.
"""

import io
import os
import tempfile
import zlib

import numpy as np

from torch_jpeg_streams import pixel_digest
from torch_tile_files import bmp_bytes, lzw_encode_old, tiff_bytes

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    'torch_tiff_layouts.npz')
H, W = 23, 37
#: the layout variants: (name suffix, tiff_bytes keywords)
VARIANTS = (('strips-II', dict(rows_per_strip=5)),
            ('strips-MM', dict(rows_per_strip=5, byteorder='>')),
            ('tiles-II', dict(tile=(16, 16))),
            ('tiles-MM', dict(tile=(16, 16), byteorder='>')))


def _u(rng, bits, shape=(H, W)):
    dtype = np.uint8 if bits <= 8 else np.uint16
    return rng.integers(0, 1 << bits, shape).astype(dtype)


def _bilevel(rng):
    img = (rng.random((H, W)) < 0.3).astype(np.uint8)
    img[H // 2:, W // 4:] = 1
    img[3] = 0
    return img


def _cmap(rng, bits, narrow=False):
    """A (3, 2**bits) ColorMap; 16-bit indices' repeats 256 entries (the
    file stays small; imageio gives the indices, not their colours)."""
    n = min(1 << bits, 256)
    cmap = rng.integers(0, 256 if narrow else 65536, (3, n))
    return np.tile(cmap, (1, (1 << bits) // n))


#: name -> (rng -> (image, tiff_bytes keywords)); compression first
TIFF_LAYOUTS = {
    'miniswhite-u8-lzw': lambda r: (_u(r, 8), dict(compression=5,
                                                   photometric=0)),
    'miniswhite-u16-lzw': lambda r: (_u(r, 16), dict(compression=5,
                                                     photometric=0)),
    'miniswhite-u8-deflate-p2': lambda r: (_u(r, 8), dict(
        compression=8, predictor=2, photometric=0)),
    'palette-u8-lzw': lambda r: (_u(r, 8), dict(
        compression=5, photometric=3, colormap=_cmap(r, 8))),
    'palette-u8-cmap8-lzw': lambda r: (_u(r, 8), dict(
        compression=5, photometric=3, colormap=_cmap(r, 8, narrow=True))),
    'palette-u4-lzw': lambda r: (_u(r, 4), dict(
        compression=5, bits=4, photometric=3, colormap=_cmap(r, 4))),
    'palette-u1-lzw': lambda r: (_u(r, 1), dict(
        compression=5, bits=1, photometric=3, colormap=_cmap(r, 1))),
    'palette-u16-lzw': lambda r: (_u(r, 16), dict(
        compression=5, photometric=3, colormap=_cmap(r, 16))),
    'bilevel-raw': lambda r: (_bilevel(r), dict(compression=1, bits=1)),
    'bilevel-lzw': lambda r: (_bilevel(r), dict(compression=5, bits=1)),
    'bilevel-packbits': lambda r: (_bilevel(r), dict(compression=32773,
                                                     bits=1)),
    'bilevel-mh': lambda r: (_bilevel(r), dict(compression=2, bits=1,
                                               photometric=0)),
    'bilevel-g3': lambda r: (_bilevel(r), dict(compression=3, bits=1,
                                               photometric=0)),
    'bilevel-g3-2d': lambda r: (_bilevel(r), dict(
        compression=3, bits=1, photometric=0, t4_options=1)),
    'bilevel-g3-2d-fill': lambda r: (_bilevel(r), dict(
        compression=3, bits=1, photometric=1, t4_options=5)),
    'bilevel-g4': lambda r: (_bilevel(r), dict(compression=4, bits=1,
                                               photometric=0)),
    'bilevel-g4-minisblack': lambda r: (_bilevel(r), dict(compression=4,
                                                          bits=1)),
    'grey-u4-lzw': lambda r: (_u(r, 4), dict(compression=5, bits=4)),
    'grey-u2-lzw': lambda r: (_u(r, 2), dict(compression=5, bits=2)),
    'grey-u12-lzw': lambda r: (_u(r, 12), dict(compression=5, bits=12)),
    'grey-u10-deflate': lambda r: (_u(r, 10), dict(compression=8, bits=10)),
    'grey-u14-packbits': lambda r: (_u(r, 14), dict(compression=32773,
                                                    bits=14)),
    'miniswhite-u12-lzw': lambda r: (_u(r, 12), dict(
        compression=5, bits=12, photometric=0)),
    'rgb-u12-lzw': lambda r: (_u(r, 12, (H, W, 3)), dict(compression=5,
                                                         bits=12)),
    'fillorder2-u16-lzw': lambda r: (_u(r, 16), dict(
        compression=5, predictor=2, fill_order=2)),
    'fillorder2-rgb-deflate': lambda r: (_u(r, 8, (H, W, 3)), dict(
        compression=8, fill_order=2)),
    'fillorder2-u8-packbits': lambda r: (_u(r, 8), dict(compression=32773,
                                                        fill_order=2)),
    'fillorder2-bilevel-g4': lambda r: (_bilevel(r), dict(
        compression=4, bits=1, photometric=0, fill_order=2)),
    'old-lzw-u8': lambda r: (_u(r, 8), dict(compression=5, lzw=lzw_encode_old)),
    'old-lzw-rgb16-p2': lambda r: (_u(r, 16, (H, W, 3)), dict(
        compression=5, predictor=2, lzw=lzw_encode_old)),
    'cmyk-u8-lzw': lambda r: (_u(r, 8, (H, W, 4)), dict(compression=5,
                                                        photometric=5)),
    'cmyk-u16-lzw': lambda r: (_u(r, 16, (H, W, 4)), dict(compression=5,
                                                          photometric=5)),
    'separated3-u8-lzw': lambda r: (_u(r, 8, (H, W, 3)), dict(
        compression=5, photometric=5)),
    'cmyk-inkset2-u8-lzw': lambda r: (_u(r, 8, (H, W, 4)), dict(
        compression=5, photometric=5, ink_set=2)),
    'ycbcr-11-lzw': lambda r: (_u(r, 8, (H, W, 3)), dict(
        compression=5, photometric=6, ycbcr_subsampling=(1, 1))),
    'ycbcr-22-lzw': lambda r: (_u(r, 8, (H, W, 3)), dict(
        compression=5, photometric=6, ycbcr_subsampling=(2, 2))),
    'ycbcr-42-deflate': lambda r: (_u(r, 8, (H, W, 3)), dict(
        compression=8, photometric=6, ycbcr_subsampling=(4, 2))),
    'ycbcr-11-rec709-studio': lambda r: (_u(r, 8, (H, W, 3)), dict(
        compression=5, photometric=6, ycbcr_subsampling=(1, 1),
        ycbcr_coefficients=((2126, 10000), (7152, 10000), (722, 10000)),
        reference_black_white=((16, 1), (235, 1), (128, 1), (240, 1),
                               (128, 1), (240, 1)))),
    'grey-alpha-u8-lzw': lambda r: (_u(r, 8, (H, W, 2)), dict(
        compression=5, photometric=1, extra_samples=[2])),
    'grey-alpha-u16-lzw': lambda r: (_u(r, 16, (H, W, 2)), dict(
        compression=5, photometric=1, extra_samples=[2])),
    'miniswhite-alpha-u16-lzw': lambda r: (_u(r, 16, (H, W, 2)), dict(
        compression=5, photometric=0, extra_samples=[1])),
    'samples5-u8-lzw': lambda r: (_u(r, 8, (H, W, 5)), dict(
        compression=5, extra_samples=[0, 0])),
    'samples5-u16-deflate-p2': lambda r: (_u(r, 16, (H, W, 5)), dict(
        compression=8, predictor=2, extra_samples=[0, 0])),
    'lzma-u16': lambda r: (_u(r, 16), dict(compression=34925)),
    'lzma-rgb-u8-p2': lambda r: (_u(r, 8, (H, W, 3)), dict(
        compression=34925, predictor=2)),
    'lzma-rgba-u8': lambda r: (_u(r, 8, (H, W, 4)), dict(
        compression=34925, extra_samples=[2])),
    'lzma-miniswhite-u8': lambda r: (_u(r, 8), dict(compression=34925,
                                                    photometric=0)),
}

#: (layout, variant) whose JAX array is not the pixels, which the port
#: refuses: libtiff misplaces the rows of grey + alpha tiles overhanging
#: the right edge (W is not a multiple of the 16-pixel tiles)
REFUSED = {(n, v) for n in ('grey-alpha-u8-lzw', 'grey-alpha-u16-lzw',
                            'miniswhite-alpha-u16-lzw')
           for v in ('tiles-II', 'tiles-MM')}

#: PIL's libtiff writes these (strips, little-endian)
PIL_LAYOUTS = {'pil-group3': 'group3', 'pil-group4': 'group4',
               'pil-ccitt-rle': 'tiff_ccitt'}


def _bmp_palette(rng, bits, grey):
    if grey:
        return np.repeat(np.arange(0, 256, 256 >> bits, dtype=np.uint8
                                   )[:, None], 3, 1)
    return rng.integers(0, 256, (1 << bits, 3)).astype(np.uint8)


def _runs(rng, bits):
    """Palette indices with runs, literal stretches and solid rows."""
    idx = _u(rng, bits)
    idx[4] = 1
    idx[7:12, 5:30] = 2
    idx[15] = np.repeat(_u(rng, bits, (W // 3 + 1,)), 3)[:W]
    return idx


#: name -> (rng -> (image, bmp_bytes keywords))
BMP_LAYOUTS = {
    'bmp-rle8-grey': lambda r: (_runs(r, 8), dict(
        bpp=8, palette=_bmp_palette(r, 8, True), compression=1)),
    'bmp-rle8-colour': lambda r: (_runs(r, 8), dict(
        bpp=8, palette=_bmp_palette(r, 8, False), compression=1)),
    'bmp-rle4-grey': lambda r: (_runs(r, 4), dict(
        bpp=4, palette=_bmp_palette(r, 4, True), compression=2)),
    'bmp-rle4-colour': lambda r: (_runs(r, 4), dict(
        bpp=4, palette=_bmp_palette(r, 4, False), compression=2)),
    'bmp-16-555': lambda r: (_u(r, 8, (H, W, 3)), dict(bpp=16)),
    'bmp-16-565': lambda r: (_u(r, 8, (H, W, 3)), dict(bpp=16,
                                                       compression=3)),
}


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(name.encode()))


def build(name: str, variant: dict = None) -> bytes:
    """The file of a layout (TIFF ones in ``variant``'s strip or tile
    layout and byte order; strips of 5 rows, little-endian, when it is
    None)."""
    rng = _rng(name)
    if name in BMP_LAYOUTS:
        img, kw = BMP_LAYOUTS[name](rng)
        return bmp_bytes(img, **kw)
    if name in PIL_LAYOUTS:
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(_bilevel(rng).astype(bool)).save(
            buf, 'TIFF', compression=PIL_LAYOUTS[name])
        return buf.getvalue()
    img, kw = TIFF_LAYOUTS[name](rng)
    return tiff_bytes(img, **kw, **(variant or VARIANTS[0][1]))


def names():
    """Every layout's name."""
    return list(TIFF_LAYOUTS) + list(PIL_LAYOUTS) + list(BMP_LAYOUTS)


def suffix(name: str) -> str:
    return '.bmp' if name in BMP_LAYOUTS else '.tiff'


def digest(pixels: np.ndarray) -> str:
    """SHA-256 of the pixels' dtype, shape and bytes."""
    return pixel_digest(pixels) + ':' + np.dtype(pixels.dtype).str


def jax_pixels(data: bytes, name: str) -> np.ndarray:
    """The array the JAX package's ``read_image`` gives for the file
    (OpenCV, then imageio where OpenCV returns None)."""
    import warnings
    from image_stitcher_tpu.io.acquisition import read_image
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, 'A1_0_0_ch' + suffix(name))
        with open(path, 'wb') as f:
            f.write(data)
        with warnings.catch_warnings():   # imageio's vendored tifffile
            warnings.simplefilter('ignore')
            return read_image(path)


def make() -> dict:
    """{name: file bytes, name + ':sha256': digest of the JAX package's
    array} for one file of every layout (needs OpenCV, imageio, PIL)."""
    out = {}
    for name in names():
        data = build(name)
        out[name] = np.frombuffer(data, np.uint8)
        out[name + ':sha256'] = np.array(digest(jax_pixels(data, name)))
    return out


def load() -> dict:
    """The kept files and digests, as :func:`make` returned them."""
    with np.load(PATH) as z:
        return {k: z[k] for k in z.files}


if __name__ == '__main__':
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(PATH)))  # the JAX
    np.savez_compressed(PATH, **make())
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")
