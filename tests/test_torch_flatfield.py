"""The port's host flatfield path against the JAX package's.

The ADMM fit is a copy and must agree bit for bit. The two resamples
replace cv2.resize (INTER_AREA for the decimation to the working size,
INTER_LINEAR for the field back to tile size); they reproduce OpenCV's
coefficients and f32 operation order, so they are held to equality
with cv2 here, on the shapes the main path and the test fixtures use.
"""

import cv2
import numpy as np
import pytest

from image_stitcher_tpu.ops import flatfield as jff
from image_stitcher_tpu_torch.ops import flatfield as tff


def test_fit_flatfield_stack_identical():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:96, 0:96] / 95.0
    vignette = 1.0 - 0.3 * ((yy - 0.5) ** 2 + (xx - 0.5) ** 2)
    stack = (rng.uniform(500, 4000, (12, 96, 96)) * vignette).astype(np.float32)
    np.testing.assert_array_equal(tff.fit_flatfield_stack_np(stack),
                                  jff.fit_flatfield_stack_np(stack))


AREA_CASES = [
    ((205, 205), (96, 96)),     # main path: 2048^2 decimated by 10
    ((200, 192), (96, 96)),     # 1920x1200 camera decimated
    ((128, 128), (96, 96)),     # fixture tiles, fractional area
    ((192, 192), (96, 96)),     # integer factor (fast path)
    ((64, 64), (96, 96)),       # upscale: OpenCV's area emulation
    ((64, 128), (96, 96)),      # mixed scales
    ((96, 96), (96, 96)),       # equal size
]


@pytest.mark.parametrize("src,dst", AREA_CASES, ids=str)
@pytest.mark.parametrize("channels", [0, 3])
def test_resize_area_matches_cv2(src, dst, channels):
    rng = np.random.default_rng(1)
    shape = src + ((channels,) if channels else ())
    img = (rng.random(shape) * 60000).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(tff.resize_area(img, dst), want)


@pytest.mark.parametrize("dst", [(2048, 2048), (1200, 1920), (128, 128),
                                 (80, 96), (64, 128), (96, 96)], ids=str)
def test_resize_linear_matches_cv2(dst):
    rng = np.random.default_rng(2)
    img = (rng.random((96, 96)) + 0.5).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(tff.resize_linear(img, dst), want)


@pytest.mark.parametrize("shape", [(2048, 2048), (1200, 1920), (128, 64),
                                   (80, 96)], ids=str)
def test_sampling_and_finalize_match_jax(shape):
    """The whole fit recipe around the solver: decimate a uint16 tile to
    the working size, and stretch a working field back to tile size."""
    rng = np.random.default_rng(3)
    tile = rng.integers(0, 65536, shape).astype(np.uint16)
    np.testing.assert_array_equal(
        tff.decimate_to_working(tile, tff.WORKING_SIZE),
        jff.decimate_to_working(tile, jff.WORKING_SIZE))
    field = (rng.random((96, 96)) * 0.4 + 0.8).astype(np.float32)
    np.testing.assert_array_equal(tff.finalize_flatfield(field, shape),
                                  jff.finalize_flatfield(field, shape))
