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


def _vignetted_stack(seed, n, size=96):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / (size - 1.0)
    vignette = 1.0 - 0.3 * ((yy - 0.5) ** 2 + (xx - 0.5) ** 2)
    stack = rng.uniform(500, 4000, (n, size, size)) * vignette
    # foreground objects: the sparse residual E the model absorbs
    stack[:, 30:40, 50:70] += rng.uniform(0, 20000, (n, 1, 1))
    return stack.astype(np.float32)


@pytest.mark.parametrize("n", [5, 32, 80])
def test_device_solver_matches_jax(n):
    """The torch solver (here on the CPU) against the JAX package's
    jitted solver on the same padded stack, within the JAX package's own
    bar between its solvers (1e-4); and against the NumPy twin."""
    import jax.numpy as jnp
    import torch
    stack = tff.pad_stack_cycled(_vignetted_stack(n, n), 80)
    got = tff.fit_flatfield_stack(torch.from_numpy(stack))
    assert got.dtype == torch.float32 and tuple(got.shape) == (96, 96)
    want = np.asarray(jff.fit_flatfield_stack(jnp.asarray(stack)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), tff.fit_flatfield_stack_np(stack),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("n, target", [(5, 80), (32, 80), (33, 80), (80, 80),
                                       (90, 80), (1, 7)])
def test_pad_stack_cycled_identical(n, target):
    stack = _vignetted_stack(n + target, n, size=8)
    got = tff.pad_stack_cycled(stack, target)
    assert got.shape == (target, 8, 8)
    np.testing.assert_array_equal(got, jff.pad_stack_cycled(stack, target))
    rgb = np.stack([stack] * 3, axis=-1)   # RGB samples pad along axis 0
    np.testing.assert_array_equal(tff.pad_stack_cycled(rgb, target),
                                  jff.pad_stack_cycled(rgb, target))


@pytest.mark.parametrize("size", [8, 96, 128])
def test_dct_matrix_identical(size):
    np.testing.assert_array_equal(tff.dct_matrix(size), jff.dct_matrix(size))
