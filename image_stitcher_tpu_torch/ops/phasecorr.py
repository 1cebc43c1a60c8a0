"""Phase cross-correlation with upsampled-DFT subpixel refinement, on
the host (SciPy FFT, float64).

A copy of the host twins in the JAX package's ``ops/phasecorr.py``
(Guizar-Sicairos et al. 2008, as scikit-image implements it): the
center-pair registration measures two or three strip pairs, which the
JAX package also measures on the host. The batched device version is a
later item of the port.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def phase_cross_correlation_np(reference: np.ndarray, moving: np.ndarray,
                               upsample_factor: int = 10) -> np.ndarray:
    """Subpixel shift (dy, dx) registering ``moving`` to ``reference``
    (scikit-image's sign convention)."""
    return _pcc_np(reference, moving, upsample_factor)[0]


def _pcc_np(reference: np.ndarray, moving: np.ndarray,
            upsample_factor: int) -> tuple:
    from scipy import fft as sfft
    a = np.asarray(reference, np.float64)
    b = np.asarray(moving, np.float64)
    h, w = a.shape
    product = sfft.fft2(a) * np.conj(sfft.fft2(b))
    eps = 100 * np.finfo(np.float64).eps
    product /= np.maximum(np.abs(product), eps)
    corr = sfft.ifft2(product)
    my, mx = np.unravel_index(np.argmax(np.abs(corr)), corr.shape)
    shifts = np.array([my, mx], np.float64)
    mids = np.array([np.fix(h / 2), np.fix(w / 2)])
    shifts[shifts > mids] -= np.array([h, w])[shifts > mids]
    peak = float(np.max(np.abs(corr)))
    if upsample_factor <= 1:
        return shifts, peak
    uf = float(upsample_factor)
    shifts = np.round(shifts * uf) / uf
    ups_size = int(math.ceil(uf * 1.5))
    dftshift = float(math.trunc(ups_size / 2.0))
    offsets = dftshift - shifts * uf
    # matrix-DFT patch, axis x then axis y
    data = np.conj(product)
    for off in (offsets[1], offsets[0]):
        n = data.shape[1]
        freqs = np.fft.fftfreq(n, uf)
        kernel = np.exp(-2j * np.pi * (np.arange(ups_size)[:, None] - off)
                        * freqs[None, :])
        data = np.tensordot(kernel, data, axes=((1,), (1,)))
    patch = np.conj(data)
    py, px = np.unravel_index(np.argmax(np.abs(patch)), patch.shape)
    return shifts + (np.array([py, px], np.float64) - dftshift) / uf, peak


def normalize_to_dtype_range_np(img: np.ndarray, dtype_max: float) -> np.ndarray:
    """Min-max normalize, then scale to [0, dtype_max] (float32)."""
    img = np.asarray(img, np.float32)
    lo, hi = float(img.min()), float(img.max())
    return (img - lo) / max(hi - lo, 1e-12) * dtype_max


def horizontal_shift_from_pcc(shift, strip_w: int) -> Tuple[int, int]:
    """h_shift = (round(sy), round(sx - strip_w))."""
    sy, sx = float(shift[0]), float(shift[1])
    return round(sy), round(sx - strip_w)


def vertical_shift_from_pcc(shift, strip_h: int) -> Tuple[int, int]:
    """v_shift = (round(sy - strip_h), round(sx))."""
    sy, sx = float(shift[0]), float(shift[1])
    return round(sy - strip_h), round(sx)
