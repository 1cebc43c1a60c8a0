"""Progressive and 4:1:1 JPEG streams written by OpenCV, kept in the repo.

The port decodes progressive frames and every integral sampling, but its
encoder writes baseline 4:4:4 / 4:2:2 / 4:2:0 / 4:4:0 only (what the JAX
package's JPEG OME-TIFF writer needs), and the card's host has no
OpenCV or PIL. So ``chip_smoke.py`` (phase 13) takes these streams from
``torch_jpeg_streams.npz``, written by :func:`make` with the CPU test
host's OpenCV 5.0 (libjpeg-turbo 3.1.2):

- small cases: grey, 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1 at odd sizes,
  progressive with and without optimised tables and a restart interval,
  and baseline 4:1:1;
- two 2048^2 progressive tiles, grey and RGB 4:2:0 at quality 85, of
  smooth content (waves and a little noise, so the file stays small),
  for decode rates.

Each stream comes with the SHA-256 of the pixels ``cv2.imread
(IMREAD_UNCHANGED)`` gives for it (BGR flipped to RGB), so the card can
hold its decoders to OpenCV without OpenCV. Regenerate with::

    python tests/torch_jpeg_streams.py

``tests/test_torch_jpeg.py`` checks that the file is what :func:`make`
writes and that every stream decodes to those pixels.
"""

import hashlib
import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    'torch_jpeg_streams.npz')


def content(seed: int, h: int, w: int, rgb: bool, noise: float):
    """Waves and seeded noise, uint8 (H, W) or (H, W, 3)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = (128 + 60 * np.sin(x / 37.0) * np.cos(y / 53.0)
            + 40 * np.sin((x + y) / 91.0))
    if rgb:
        img = (base[..., None] + rng.normal(0, noise, (h, w, 3))
               + [0, 20, -20])
    else:
        img = base + rng.normal(0, noise, (h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


def pixel_digest(pixels: np.ndarray) -> str:
    """SHA-256 of the pixels' shape and bytes."""
    h = hashlib.sha256(repr(pixels.shape).encode())
    h.update(np.ascontiguousarray(pixels).tobytes())
    return h.hexdigest()


#: (name, h, w, sampling or None for grey, quality, progressive,
#: optimize, restart, noise)
CASES = [
    ('prog-grey-37x61', 37, 61, None, 85, 1, 0, 0, 12.0),
    ('prog-grey-opt-rst', 100, 77, None, 50, 1, 1, 3, 12.0),
    ('prog-444-37x61', 37, 61, '444', 85, 1, 0, 0, 12.0),
    ('prog-422-opt', 45, 70, '422', 75, 1, 1, 0, 12.0),
    ('prog-420-rst', 61, 97, '420', 90, 1, 0, 2, 12.0),
    ('prog-440-opt-rst', 33, 50, '440', 60, 1, 1, 5, 12.0),
    ('prog-411', 40, 90, '411', 85, 1, 0, 0, 12.0),
    ('prog-411-opt-rst', 23, 67, '411', 95, 1, 1, 4, 12.0),
    ('base-411', 40, 90, '411', 85, 0, 0, 0, 12.0),
    ('base-411-opt-rst', 100, 77, '411', 50, 0, 1, 2, 12.0),
    ('tile-prog-grey', 2048, 2048, None, 85, 1, 0, 0, 1.0),
    ('tile-prog-420', 2048, 2048, '420', 85, 1, 0, 0, 1.0),
]


def make() -> dict:
    """{name: stream bytes, name + ':sha256': the OpenCV pixels' digest}
    for every case (needs OpenCV)."""
    import cv2
    sampling = {'444': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                '422': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                '420': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                '440': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                '411': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
    out = {}
    for k, (name, h, w, samp, quality, prog, opt, restart,
            noise) in enumerate(CASES):
        img = content(k, h, w, samp is not None, noise)
        params = [cv2.IMWRITE_JPEG_QUALITY, quality,
                  cv2.IMWRITE_JPEG_PROGRESSIVE, prog,
                  cv2.IMWRITE_JPEG_OPTIMIZE, opt,
                  cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
        if samp is not None:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling[samp]]
            img = np.ascontiguousarray(img[:, :, ::-1])
        ok, data = cv2.imencode('.jpg', img, params)
        assert ok
        pixels = cv2.imdecode(data, cv2.IMREAD_UNCHANGED)
        if pixels.ndim == 3:
            pixels = pixels[:, :, ::-1]
        out[name] = data.reshape(-1)
        out[name + ':sha256'] = np.frombuffer(
            pixel_digest(pixels).encode(), np.uint8)
    return out


def load() -> dict:
    """{name: (stream bytes, the OpenCV pixels' SHA-256)} from the file."""
    with np.load(PATH) as f:
        return {name: (f[name].tobytes(), f[name + ':sha256'].tobytes()
                       .decode())
                for name in f.files if not name.endswith(':sha256')}


if __name__ == '__main__':
    np.savez(PATH, **make())
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")
