"""TIFF tiles of every sample type the port stitches, kept in the repo with
the pixels the JAX package's reader gives for them.

The card's host has no OpenCV and no imageio, so ``chip_smoke.py`` takes
these files from ``torch_tiff_samples.npz``, written by :func:`make` on
the CPU test host: with its OpenCV 5.0 (libtiff) for uint8, int8,
uint16, int16, int32, uint32, float32 and float64, one and three samples,
LZW with Predictor 2 (OpenCV's default for integers), deflate with
Predictor 2, and for the floats LZW and deflate with Predictor 3 (the
floating-point predictor), in strips of 5 rows; and for float16, which
OpenCV neither writes nor reads (the JAX package reads it through
imageio's tifffile), with ``torch_tile_files.tiff_bytes`` in every
layout the JAX package reads: uncompressed, LZW, deflate and PackBits,
Predictor 3 after the three codecs, in strips of 5 rows, and deflate in
16 x 16 tiles, one and three samples. Each file comes with the SHA-256
of the pixels ``cv2.imdecode(IMREAD_UNCHANGED)`` gives for it (BGR
flipped to RGB), or for float16 ``imageio.v2.imread``, so the card holds
its C decoders, and their plain versions, to those readers without
them. Regenerate with::

    python tests/torch_tiff_samples.py

``tests/test_torch_tiff_input.py`` checks that the file is what
:func:`make` writes and that every file decodes to those pixels.
"""

import os

import numpy as np

from torch_jpeg_streams import pixel_digest

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    'torch_tiff_samples.npz')
SAMPLE_TYPES = ('uint8', 'int8', 'uint16', 'int16', 'int32', 'uint32',
                'float32', 'float64')
#: (name, TIFF compression, Predictor)
CODECS = (('lzw-p2', 5, 2), ('deflate-p2', 8, 2), ('lzw-p3', 5, 3),
          ('deflate-p3', 8, 3))
#: float16's (name, TIFF compression, Predictor): the layouts the JAX
#: package reads (imageio's tifffile); '-tiles' in 16 x 16 tiles
HALF_LAYOUTS = (('raw', 1, 1), ('lzw', 5, 1), ('deflate', 8, 1),
                ('packbits', 32773, 1), ('lzw-p3', 5, 3), ('deflate-p3', 8, 3),
                ('packbits-p3', 32773, 3), ('deflate-tiles', 8, 1))


def content(seed: int, dtype: str, spp: int) -> np.ndarray:
    """A (23, 31[, 3]) seeded image: an integer type over its whole range,
    a float type with fractions, signs and zeros."""
    rng = np.random.default_rng(seed)
    shape = (23, 31) if spp == 1 else (23, 31, 3)
    dt = np.dtype(dtype)
    if dt.kind == 'f':
        return (rng.standard_normal(shape) * 1e4).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, shape, dtype=dt, endpoint=True)


def cases():
    """(name, dtype, spp, compression, predictor) of every kept file."""
    for dtype in SAMPLE_TYPES:
        for spp in (1, 3):
            for codec, comp, pred in CODECS:
                if pred == 3 and not dtype.startswith('float'):
                    continue
                yield f"{dtype}-x{spp}-{codec}", dtype, spp, comp, pred
    for spp in (1, 3):
        for layout, comp, pred in HALF_LAYOUTS:
            yield f"float16-x{spp}-{layout}", 'float16', spp, comp, pred


def _half_file(name: str, seed: int, spp: int, comp: int,
               pred: int) -> bytes:
    from torch_tile_files import tiff_bytes
    kw = (dict(tile=(16, 16)) if name.endswith('-tiles')
          else dict(rows_per_strip=5))
    return tiff_bytes(content(seed, 'float16', spp), comp, pred, **kw)


def make() -> dict:
    """{name: file bytes, name + ':sha256': the pixels' digest} for every
    case (needs OpenCV, and imageio for float16)."""
    import cv2
    out = {}
    for seed, (name, dtype, spp, comp, pred) in enumerate(cases()):
        if dtype == 'float16':
            import io
            import warnings
            import imageio.v2 as iio
            data = _half_file(name, seed, spp, comp, pred)
            with warnings.catch_warnings():   # its vendored tifffile
                warnings.simplefilter('ignore')
                pixels = np.asarray(iio.imread(io.BytesIO(data),
                                               format='tiff'))
            out[name] = np.frombuffer(data, np.uint8)
            out[name + ':sha256'] = np.array(pixel_digest(pixels))
            continue
        ok, buf = cv2.imencode('.tiff', content(seed, dtype, spp), [
            int(cv2.IMWRITE_TIFF_COMPRESSION), comp,
            int(cv2.IMWRITE_TIFF_PREDICTOR), pred,
            int(cv2.IMWRITE_TIFF_ROWSPERSTRIP), 5])
        if not ok:
            raise RuntimeError(f"OpenCV did not encode {name}")
        pixels = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
        if pixels.ndim == 3:
            pixels = pixels[:, :, ::-1]
        out[name] = np.frombuffer(buf.tobytes(), np.uint8)
        out[name + ':sha256'] = np.array(pixel_digest(pixels))
    return out


def load() -> dict:
    """The kept files and digests, as :func:`make` returned them."""
    with np.load(PATH) as z:
        return {k: z[k] for k in z.files}


if __name__ == '__main__':
    np.savez_compressed(PATH, **make())
    print(f"wrote {PATH}")
