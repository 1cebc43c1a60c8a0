"""BaSiC-style flatfield estimation (NumPy + SciPy on the host, torch on
a device).

The counterpart of the JAX package's ``ops/flatfield.py``:
- :func:`fit_flatfield_stack_np` is a copy of the NumPy ADMM twin, so on
  the same stack the fields agree bit for bit;
- :func:`fit_flatfield_stack` is the device solver (the JAX package's
  jitted one): the same iteration in torch on a tensor on any device,
  for ``flatfield_device='device'``, with :func:`pad_stack_cycled`
  giving it the JAX package's fixed stack size;
- the two OpenCV resamples the JAX package uses around the fit are
  written out in NumPy: :func:`resize_area` (``cv2.INTER_AREA``, for the
  decimation to the 96^2 working size) and :func:`resize_linear`
  (``cv2.INTER_LINEAR``, for the field back to tile size). They follow
  OpenCV's coefficient tables and its order of f32 operations, including
  the fused multiply-adds of its IPP-backed bilinear path, and agree bit
  for bit with OpenCV 5.0 on the shapes the tests cover (a different
  OpenCV build may differ in the last f32 bit).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

WORKING_SIZE = 96
# ADMM penalty schedule (see the JAX package for its derivation)
MU0 = 0.02
MU_RHO = 1.3
DEFAULT_MAX_ITERS = 35


def fit_flatfield_stack_np(images: np.ndarray, smoothness: float = 1.0,
                           max_iters: int = DEFAULT_MAX_ITERS) -> np.ndarray:
    """Fit the flatfield S (mean 1) of a (N, h, w) float32 stack by ADMM on
    min ||E||_1 + lam*||DCT(S)||_1  s.t.  D_i = B_i*S + E_i.

    A copy of ``image_stitcher_tpu.ops.flatfield.fit_flatfield_stack_np``:
    scaled multipliers z = y/mu, the E soft threshold through the identity
    soft(x, t) = x - clip(x, -t, t), every stack op into a preallocated
    buffer."""
    from scipy.fft import dctn, idctn
    n, h, w_ = images.shape
    d = images.astype(np.float32)
    d = d / np.maximum(d.mean(axis=(1, 2), keepdims=True), 1e-6)
    lam = smoothness

    def soft_small(x, t):
        return np.sign(x) * np.maximum(np.abs(x) - t, 0.0)

    s = d.mean(axis=0)
    e = np.zeros_like(d)
    z = np.zeros_like(d)
    b = np.ones(n, np.float32)
    w = np.empty_like(d)
    x = np.empty_like(d)
    cl = np.empty_like(d)
    bs = np.empty_like(d)
    mu = np.float32(MU0)
    for _ in range(max_iters):
        np.add(d, z, out=w)
        np.subtract(w, e, out=x)                     # u = w - e
        bsq = float(b @ b) + 1e-6
        s_ls = (b @ x.reshape(n, -1)).reshape(h, w_) / bsq
        s = idctn(soft_small(dctn(s_ls, norm='ortho'), lam / (mu * bsq)),
                  norm='ortho').astype(np.float32)
        np.multiply(b[:, None, None], s, out=bs)
        np.subtract(w, bs, out=x)                    # x = w - b*s
        thr = np.float32(1.0 / mu)
        np.clip(x, -thr, thr, out=cl)
        np.subtract(x, cl, out=e)                    # e = soft(x, 1/mu)
        np.add(bs, cl, out=x)                        # v = w - e = b*s + cl
        ssq = float(s.ravel() @ s.ravel()) + 1e-6
        b = np.maximum(x.reshape(n, -1) @ s.ravel() / ssq,
                       0.0).astype(np.float32)
        mu_new = np.float32(min(mu * MU_RHO, 1e6))
        np.multiply(b[:, None, None], s, out=bs)     # b'*s (refit b)
        np.subtract(x, bs, out=z)                    # v - b'*s
        z *= np.float32(mu / mu_new)
        mu = mu_new
    s = np.maximum(s, 1e-3)
    return (s / s.mean()).astype(np.float32)


def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (C @ x == dct(x, norm='ortho'))."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    c = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    c[0] /= np.sqrt(2.0)
    return c.astype(np.float32)


def _soft(x: torch.Tensor, thresh) -> torch.Tensor:
    return torch.sign(x) * torch.relu(torch.abs(x) - thresh)


def fit_flatfield_stack(images: torch.Tensor, smoothness: float = 1.0,
                        max_iters: int = DEFAULT_MAX_ITERS) -> torch.Tensor:
    """Fit the flatfield S (mean 1) of a (N, h, w) stack on its device:
    the JAX package's jitted ADMM, step for step, in float32.

    Same model and iteration as :func:`fit_flatfield_stack_np` (scaled
    multipliers z = y/mu, the shared term w = d + z), with the DCT prox
    as two products with the orthonormal DCT-II matrix,
    ``C_h @ s @ C_w.T``. Those products run in float64 and are rounded
    back to float32, so no TF32 setting of the process can reach them;
    on a 96^2 field they cost nothing. Returns an (h, w) float32 tensor
    on the stack's device. Each iteration is a few dozen small launches
    and no host synchronization."""
    n, h, w = images.shape
    dev = images.device
    d = images.to(torch.float32)
    d = d / torch.clamp(d.mean(dim=(1, 2), keepdim=True), min=1e-6)
    c_h = torch.from_numpy(dct_matrix(h)).to(dev, torch.float64)
    c_w = torch.from_numpy(dct_matrix(w)).to(dev, torch.float64)

    def dct2(x):
        return (c_h @ x.to(torch.float64) @ c_w.T).to(torch.float32)

    def idct2(x):
        return (c_h.T @ x.to(torch.float64) @ c_w).to(torch.float32)

    lam = smoothness
    s = d.mean(dim=0)
    e = torch.zeros_like(d)
    b = torch.ones((n, 1, 1), dtype=torch.float32, device=dev)
    z = torch.zeros_like(d)
    mu = np.float32(MU0)
    for _ in range(max_iters):
        w_ = d + z
        # S: least squares, then the DCT-L1 prox (exact: orthonormal DCT)
        bsq = (b * b).sum() + 1e-6
        s_ls = (b * (w_ - e)).sum(dim=0) / bsq
        s = idct2(_soft(dct2(s_ls), lam / (float(mu) * bsq)))
        # E: elementwise soft threshold
        e = _soft(w_ - b * s, float(np.float32(1.0) / mu))
        # B: per-image projection onto S, non-negative
        v = w_ - e
        ssq = (s * s).sum() + 1e-6
        b = torch.relu((v * s).sum(dim=(1, 2), keepdim=True) / ssq)
        # multiplier and penalty
        mu_new = np.float32(min(mu * np.float32(MU_RHO), np.float32(1e6)))
        z = float(mu / mu_new) * (v - b * s)
        mu = mu_new
    s = torch.clamp(s, min=1e-3)
    return s / s.mean()


def pad_stack_cycled(stack: np.ndarray, target: int) -> np.ndarray:
    """Pad a sample stack to ``target`` by whole cycles plus an evenly
    strided remainder, so no sample is over-weighted by more than one
    extra copy (the JAX package's device solver wants one static shape;
    the port keeps its stacks so the two fit the same samples)."""
    n = len(stack)
    if n >= target:
        return stack[:target]
    reps = target // n
    rem = target - reps * n
    parts = [stack] * reps
    if rem:
        idx = np.linspace(0, n - 1, rem).round().astype(int)
        parts.append(stack[idx])
    return np.concatenate(parts)


# ---------------------------------------------------------------- resampling

def _scales(ssize: int, dsize: int) -> Tuple[float, float]:
    """(scale, inv_scale) as OpenCV derives them: inv = dsize/ssize in
    double, scale = 1/inv (not ssize/dsize, which can differ in the last
    bit)."""
    inv = dsize / ssize
    return 1.0 / inv, inv


def _area_taps(ssize: int, dsize: int, scale: float):
    """OpenCV's computeResizeAreaTab: per destination index, the source
    indices and f32 weights of its cell, in OpenCV's order. Returned as
    (idx, alpha), each (taps, dsize), zero-weight padded."""
    per = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1 = math.ceil(fsx1)
        sx2 = min(math.floor(fsx2), ssize - 1)
        sx1 = min(sx1, sx2)
        taps = []
        if sx1 - fsx1 > 1e-3:
            taps.append((sx1 - 1, (sx1 - fsx1) / cell))
        taps.extend((sx, 1.0 / cell) for sx in range(sx1, sx2))
        if fsx2 - sx2 > 1e-3:
            taps.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        per.append(taps)
    n = max(len(t) for t in per)
    idx = np.zeros((n, dsize), np.intp)
    alpha = np.zeros((n, dsize), np.float32)
    for dx, taps in enumerate(per):
        for m, (sx, a) in enumerate(taps):
            idx[m, dx] = sx
            alpha[m, dx] = np.float32(a)
    return idx, alpha


def _area_upscale_taps(ssize: int, dsize: int, clamp: bool):
    """OpenCV's area-mode bilinear taps (INTER_AREA where a scale is below
    one): per destination index, the source index and the f32 weight of
    the next source pixel. ``clamp`` applies the horizontal border rule
    (weight 0 past the edges); the vertical pass instead clips the row
    index and keeps the weight, as OpenCV does."""
    scale, inv = _scales(ssize, dsize)
    sx = np.empty(dsize, np.intp)
    fx = np.empty(dsize, np.float32)
    for d in range(dsize):
        s = math.floor(d * scale)
        f = np.float32((d + 1) - (s + 1) * inv)
        f = np.float32(0.0) if f <= 0 else np.float32(f - np.floor(f))
        if clamp and s >= ssize - 1:
            s, f = ssize - 1, np.float32(0.0)
        sx[d] = s
        fx[d] = f
    return sx, fx


def _resize_area_upscale_2d(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """OpenCV's emulation of INTER_AREA upscaling: a horizontal then a
    vertical two-tap pass, S0*(1-f) + S1*f in f32."""
    h, w = img.shape
    sx, fx = _area_upscale_taps(w, dw, clamp=True)
    sy, fy = _area_upscale_taps(h, dh, clamp=False)
    one = np.float32(1.0)
    x1 = np.minimum(sx + 1, w - 1)
    hor = img[:, sx] * (one - fx) + img[:, x1] * fx
    edge = sx + 1 >= w
    hor[:, edge] = img[:, sx[edge]] * (one - fx[edge])
    r0 = np.clip(sy, 0, h - 1)
    r1 = np.clip(sy + 1, 0, h - 1)
    return hor[r0] * (one - fy)[:, None] + hor[r1] * fy[:, None]


def fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """round_f32(a*b + c) with one rounding, as a fused multiply-add
    computes it, for float32 inputs. The f32 product is exact in f64; the
    f64 sum rounds once more, which can only mislead the final cast where
    it lands exactly on a midpoint between two f32 values: there the sum's
    own rounding error (TwoSum) nudges it one f64 ulp toward the exact
    value, so the cast rounds as the exact sum would."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    mid = (s.view(np.int64) & 0x1FFFFFFF) == 0x10000000
    if mid.any():
        pm, cm, sm = p[mid], c[mid], s[mid]
        t = sm - pm
        err = (pm - (sm - t)) + (cm - t)
        s[mid] = np.where(err == 0, sm,
                          np.nextafter(sm, np.copysign(np.inf, err)))
    return s.astype(np.float32)


def _linear_taps(ssize: int, dsize: int):
    """Bilinear source index and f32 fraction per destination index:
    pixel centres at (d + 0.5) * scale - 0.5 in f64, clamped to the
    edge pixel (fraction 0) past either border."""
    scale, _ = _scales(ssize, dsize)
    pos = (np.arange(dsize) + 0.5) * scale - 0.5
    s = np.floor(pos)
    frac = pos - s
    s = s.astype(np.intp)
    lo, hi = s < 0, s >= ssize - 1
    s[lo], frac[lo] = 0, 0.0
    s[hi], frac[hi] = ssize - 1, 0.0
    return s, frac.astype(np.float32)


def _resize_linear_2d(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """cv2.INTER_LINEAR as the OpenCV build with IPP computes it: each
    pass is S0 + (S1 - S0)*f with a fused multiply-add, horizontal
    first."""
    h, w = img.shape
    sx, fx = _linear_taps(w, dw)
    sy, fy = _linear_taps(h, dh)
    x1 = np.minimum(sx + 1, w - 1)
    y1 = np.minimum(sy + 1, h - 1)
    d = img[:, x1] - img[:, sx]
    hor = fma32(d, np.broadcast_to(fx, d.shape), img[:, sx])
    d = hor[y1] - hor[sy]
    return fma32(d, np.broadcast_to(fy[:, None], d.shape), hor[sy])


def _resize_area_2d(img: np.ndarray, dh: int, dw: int,
                    channels: int = 1) -> np.ndarray:
    h, w = img.shape
    if (h, w) == (dh, dw):
        return img.copy()
    scale_x, _ = _scales(w, dw)
    scale_y, _ = _scales(h, dh)
    if scale_x < 1 or scale_y < 1:
        # OpenCV emulates INTER_AREA upscaling with bilinear-like taps
        return _resize_area_upscale_2d(img, dh, dw)
    ix, iy = round(scale_x), round(scale_y)
    eps = np.finfo(np.float64).eps
    if abs(scale_x - ix) < eps and abs(scale_y - iy) < eps:
        # integer factors: block sums times 1/area; OpenCV's 2x2 SIMD
        # path (single-channel images) pairs them as (a + b) + (c + d),
        # its scalar path adds them in order
        cells = [img[ky:dh * iy:iy, kx:dw * ix:ix]
                 for ky in range(iy) for kx in range(ix)]
        if len(cells) == 4 and channels == 1:
            acc = (cells[0] + cells[1]) + (cells[2] + cells[3])
        else:
            acc = np.zeros((dh, dw), np.float32)
            for cell in cells:
                acc += cell
        return acc * np.float32(1.0 / (ix * iy))
    xi, xa = _area_taps(w, dw, scale_x)
    yi, ya = _area_taps(h, dh, scale_y)
    hor = np.zeros((h, dw), np.float32)
    for m in range(xi.shape[0]):
        hor += img[:, xi[m]] * xa[m]
    out = np.zeros((dh, dw), np.float32)
    for m in range(yi.shape[0]):
        out += hor[yi[m]] * ya[m][:, None]
    return out


def _per_channel(fn, img: np.ndarray, size: Tuple[int, int],
                 **kw) -> np.ndarray:
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim == 2:
        return fn(img, size[0], size[1], **kw)
    return np.stack([fn(img[..., k], size[0], size[1], **kw)
                     for k in range(img.shape[-1])], axis=-1)


def resize_area(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)`` on a
    float32 (H, W[, C]) image; ``size`` is (h, w)."""
    channels = img.shape[2] if img.ndim == 3 else 1
    return _per_channel(_resize_area_2d, img, size, channels=channels)


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` on a
    float32 (H, W[, C]) image; ``size`` is (h, w)."""
    return _per_channel(_resize_linear_2d, img, size)


# -------------------------------------------------------------- fit recipe

def decimate_to_working(img: np.ndarray, working_size: int) -> np.ndarray:
    """(H, W[, 3]) image -> (ws, ws[, 3]) float32: stride-decimate toward
    ~2x the working size (mmap-backed inputs fault only every sy-th row),
    then one area resample for the final step."""
    h, w = img.shape[:2]
    sy = max(1, h // (2 * working_size))
    sx = max(1, w // (2 * working_size))
    img = np.ascontiguousarray(img[::sy, ::sx]).astype(np.float32)
    return resize_area(img, (working_size, working_size))


def load_sample_small(path: str,
                      working_size: int = WORKING_SIZE) -> np.ndarray:
    """One sample tile decimated straight to working resolution."""
    from ..io.acquisition import read_image
    return decimate_to_working(read_image(path, prefer_mmap=True),
                               working_size)


def finalize_flatfield(s: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Resize a working-resolution field to tile size, unit mean."""
    full = resize_linear(np.asarray(s, dtype=np.float32), out_hw)
    full = np.maximum(full, 1e-3)
    return (full / full.mean()).astype(np.float32)
