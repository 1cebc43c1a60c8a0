"""The port's registration against the JAX package's, on the same inputs.

- the batched phase correlation (``phase_cross_correlation_conf_batch``,
  torch on the CPU here) against the JAX vmapped version on strip pairs
  with known shifts: shifts within 1/upsample_factor of each other (two
  float32 FFT libraries may pick a neighbouring upsampled peak),
  confidences within rtol 1e-4;
- the f64 host twin and the global solve: the same NumPy/SciPy code as
  the JAX package's, so exactly equal;
- the subpixel warp at load time, in NumPy, against ``cv2.warpAffine``,
  which only the test imports: byte-equal.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from fractions import Fraction

from fixtures import make_ground_truth
from image_stitcher_tpu.io.readers import TileJob as JaxTileJob
from image_stitcher_tpu.io.readers import load_tile_plane as jax_load_plane
from image_stitcher_tpu.ops import globalopt as jopt
from image_stitcher_tpu.ops import phasecorr as jpcc
from image_stitcher_tpu_torch.io.readers import (TileJob, load_tile_plane,
                                                 subpixel_shift)
from image_stitcher_tpu_torch.ops import globalopt as topt
from image_stitcher_tpu_torch.ops import phasecorr as tpcc
from image_stitcher_tpu_torch.ops.flatfield import fma32

UF = 10


def _strip_pairs(seed, n, sh, sw, max_shift=6):
    """(n, sh, sw) u16 strip pairs cut from one texture at known integer
    offsets, as the all-pairs scope cuts overlap strips: b is a's window
    moved by (dy, dx), which is the shift that registers b onto a."""
    rng = np.random.default_rng(seed)
    pad = max_shift + 2
    tex = make_ground_truth(sh + 2 * pad, sw + 2 * pad, seed=seed)
    a = np.empty((n, sh, sw), np.uint16)
    b = np.empty((n, sh, sw), np.uint16)
    truth = np.empty((n, 2))
    for i in range(n):
        dy, dx = rng.integers(-max_shift, max_shift + 1, 2)
        a[i] = tex[pad:pad + sh, pad:pad + sw]
        b[i] = tex[pad + dy:pad + dy + sh, pad + dx:pad + dx + sw]
        truth[i] = (dy, dx)
    return a, b, truth


def _fourier_pairs(seed, n, shape):
    """float32 pairs with exact subpixel circular shifts."""
    rng = np.random.default_rng(seed)
    base = np.asarray(make_ground_truth(*shape, seed=seed), np.float64)
    f = np.fft.fft2(base)
    fy = np.fft.fftfreq(shape[0])[:, None]
    fx = np.fft.fftfreq(shape[1])[None, :]
    a, b, truth = [], [], []
    for _ in range(n):
        dy, dx = rng.uniform(-8, 8, 2)
        a.append(base)
        b.append(np.real(np.fft.ifft2(
            f * np.exp(2j * np.pi * (fy * dy + fx * dx)))))
        truth.append((dy, dx))
    return (np.stack(a).astype(np.float32), np.stack(b).astype(np.float32),
            np.array(truth))


@pytest.mark.parametrize("kind", ["h_strips", "v_strips", "subpixel"])
def test_device_batch_matches_jax(kind):
    if kind == "h_strips":
        a, b, truth = _strip_pairs(1, 12, 96, 40)
    elif kind == "v_strips":
        a, b, truth = _strip_pairs(2, 12, 36, 120)
    else:
        a, b, truth = _fourier_pairs(3, 8, (64, 80))
    js, jc = jpcc.phase_cross_correlation_conf_batch(
        jnp.asarray(a), jnp.asarray(b), UF)
    ts, tc = tpcc.phase_cross_correlation_conf_batch(
        torch.from_numpy(a), torch.from_numpy(b), UF)
    assert ts.dtype == torch.float32 and tuple(ts.shape) == (len(a), 2)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1.0 / UF)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4)
    np.testing.assert_allclose(ts.numpy(), truth, atol=0.15)


def test_device_batch_without_upsampling():
    a, b, truth = _strip_pairs(4, 5, 50, 30)
    ts, tc = tpcc.phase_cross_correlation_conf_batch(
        torch.from_numpy(a), torch.from_numpy(b), 1)
    np.testing.assert_array_equal(ts.numpy(), truth)
    assert (tc.numpy() > 0.5).all()


@pytest.mark.parametrize("uf", [1, 10])
def test_host_twin_equals_jax(uf):
    a, b, _ = _strip_pairs(5, 3, 70, 33)
    for i in range(len(a)):
        js, jc = jpcc.phase_cross_correlation_conf_np(a[i], b[i], uf)
        ts, tc = tpcc.phase_cross_correlation_conf_np(a[i], b[i], uf)
        np.testing.assert_array_equal(ts, js)
        assert tc == jc


def test_global_solve_equals_jax():
    rng = np.random.default_rng(7)
    n_rows, n_cols, th, tw, ox, oy = 4, 5, 100, 120, 22, 18
    h = {(r, c): tuple(rng.normal(0, 2, 2) + (0, ox))
         for r in range(n_rows) for c in range(n_cols - 1)}
    v = {(r, c): tuple(rng.normal(0, 2, 2) + (oy, 0))
         for r in range(n_rows - 1) for c in range(n_cols)}
    hw = {k: float(rng.uniform(0.05, 1)) for k in h}
    vw = {k: float(rng.uniform(0.05, 1)) for k in v}
    h[(1, 2)] = (40.0, -30.0)           # an outlier for the IRLS to damp
    args = (h, v, n_rows, n_cols, tw, th, ox, oy)
    jp = jopt.grid_pairs_from_shifts(*args, h_weights=hw, v_weights=vw)
    tp = topt.grid_pairs_from_shifts(*args, h_weights=hw, v_weights=vw)
    assert tp == jp
    want = jopt.solve_positions(jp, n_rows * n_cols)
    got = topt.solve_positions(tp, n_rows * n_cols)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(topt.positions_to_int(got),
                                  jopt.positions_to_int(want))
    np.testing.assert_array_equal(topt.solve_positions([], 3),
                                  jopt.solve_positions([], 3))


def _cv2_shift(img, fy, fx):
    m = np.array([[1.0, 0.0, fx], [0.0, 1.0, fy]], np.float64)
    return cv2.warpAffine(img, m, (img.shape[1], img.shape[0]),
                          flags=cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_REPLICATE)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("fy,fx", [(0.0, 0.5), (0.5, 0.0), (-0.3, 0.97),
                                   (0.97, -0.3), (0.9999999999997655, 0.0),
                                   (-0.012, 0.731)])
@pytest.mark.parametrize("shape", [(5, 3), (37, 53), (120, 257)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_subpixel_shift_matches_cv2(dtype, fy, fx, shape):
    rng = np.random.default_rng(8)
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    got = subpixel_shift(img, fy, fx)
    assert got.dtype == dtype and got.shape == img.shape
    np.testing.assert_array_equal(got, _cv2_shift(img, fy, fx))


def test_subpixel_shift_edges_replicate():
    """Edge pixels: a shift past the border repeats the edge row/column."""
    img = np.arange(12, dtype=np.uint16).reshape(3, 4) * 1000
    got = subpixel_shift(img, 0.0, 0.5)
    np.testing.assert_array_equal(got[:, 0], img[:, 0])
    np.testing.assert_array_equal(got, _cv2_shift(img, 0.0, 0.5))
    got = subpixel_shift(img, -0.5, 0.0)
    np.testing.assert_array_equal(got[-1], img[-1])
    np.testing.assert_array_equal(got, _cv2_shift(img, -0.5, 0.0))


def test_load_tile_plane_applies_the_residual_like_jax(tmp_path):
    rng = np.random.default_rng(9)
    path = str(tmp_path / "t.tiff")
    cv2.imwrite(path, rng.integers(0, 65536, (48, 64)).astype(np.uint16),
                [int(cv2.IMWRITE_TIFF_COMPRESSION), 1])
    for fy, fx in ((0.0, 0.0), (0.25, -0.6), (0.999, 0.001)):
        want = jax_load_plane(JaxTileJob(path, -1, 0, 0, 0, 0, (0, 0, 0, 0),
                                         fy=fy, fx=fx))
        got = load_tile_plane(TileJob(path, -1, 0, 0, 0, 0, (0, 0, 0, 0),
                                      fy=fy, fx=fx))
        np.testing.assert_array_equal(got, want)


def test_fma32_rounds_once():
    """Cases built to land the f64 sum on an f32 midpoint: the emulated
    fused multiply-add still rounds as the exact sum would."""
    rng = np.random.default_rng(10)
    c = rng.integers(1 << 14, 1 << 16, 4000).astype(np.float32)
    a = (1.0 + rng.integers(-3, 4, 4000) * 2.0 ** -23).astype(np.float32)
    b = np.full(4000, 2.0 ** -9 - 2.0 ** -40, np.float32)
    b[::2] = np.float32(2.0 ** -9)
    got = fma32(a, b, c)
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.nextafter(g, np.float32(-np.inf))
        hi = np.nextafter(g, np.float32(np.inf))
        err = abs(Fraction(float(g)) - exact)
        assert err <= abs(Fraction(float(lo)) - exact)
        assert err <= abs(Fraction(float(hi)) - exact)
