"""Phase cross-correlation with upsampled-DFT subpixel refinement.

The counterpart of the JAX package's ``ops/phasecorr.py``
(Guizar-Sicairos et al. 2008, as scikit-image implements it):
- the host twins (SciPy FFT, float64), a copy of the JAX package's
  ``_pcc_np``: the center-pair scope measures two or three strip pairs
  with them, and the all-pairs scope measures small batches with them;
- :func:`phase_cross_correlation_conf_batch`, the batched device
  version of ``_pcc_core`` for the all-pairs and global scopes: the
  coarse peak from ``torch.fft`` (cuFFT on the card), the upsampled
  patch around it as two batched complex64 matrix products.

Float32 products run at full precision: the port sets no TF32 flag, and
a complex matmul does not use TF32 unless
``torch.backends.cuda.matmul.allow_tf32`` is set.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def phase_cross_correlation_np(reference: np.ndarray, moving: np.ndarray,
                               upsample_factor: int = 10) -> np.ndarray:
    """Subpixel shift (dy, dx) registering ``moving`` to ``reference``
    (scikit-image's sign convention)."""
    return _pcc_np(reference, moving, upsample_factor)[0]


def phase_cross_correlation_conf_np(reference: np.ndarray,
                                    moving: np.ndarray,
                                    upsample_factor: int = 10):
    """(shift, normalized correlation peak) from one set of FFTs: the
    peak is 1.0 for a perfect circular shift and about 1/sqrt(h*w) for
    unrelated content; it weights the pair in the global solve."""
    return _pcc_np(reference, moving, upsample_factor)


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


def _fftfreq(n: int, d: float, device) -> torch.Tensor:
    """np.fft.fftfreq in float32 on ``device``."""
    val = 1.0 / (n * d)
    m = (n - 1) // 2 + 1
    idx = torch.cat([torch.arange(0, m, dtype=torch.float32, device=device),
                     torch.arange(-(n // 2), 0, dtype=torch.float32,
                                  device=device)])
    return idx * val


def _dft_kernel(ups_size: int, offsets: torch.Tensor, n: int,
                upsample_factor: float) -> torch.Tensor:
    """(N, ups, n) complex64 rows exp(-2 pi i (k - offset) f_j)."""
    freqs = _fftfreq(n, upsample_factor, offsets.device)
    k = (torch.arange(ups_size, dtype=torch.float32,
                      device=offsets.device)[None, :, None]
         - offsets[:, None, None]) * freqs[None, None, :]
    return torch.exp((-2j * math.pi) * k.to(torch.complex64))


def _upsampled_patch(product: torch.Tensor, ups_size: int,
                     upsample_factor: float,
                     offsets: torch.Tensor) -> torch.Tensor:
    """(N, ups, ups) upsampled cross-correlation around the coarse peak:
    the inverse DFT evaluated on the patch, as conj(K0 @ (K1 @ conj(P)^T)^T),
    axis x first, then axis y."""
    data = torch.conj(product)
    k1 = _dft_kernel(ups_size, offsets[:, 1], data.shape[2], upsample_factor)
    data = torch.matmul(k1, data.transpose(1, 2))           # (N, ups, h)
    k0 = _dft_kernel(ups_size, offsets[:, 0], data.shape[2], upsample_factor)
    data = torch.matmul(k0, data.transpose(1, 2))           # (N, ups, ups)
    return torch.conj(data)


def phase_cross_correlation_conf_batch(reference: torch.Tensor,
                                       moving: torch.Tensor,
                                       upsample_factor: int = 10
                                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 2) float32 shifts (dy, dx) and (N,) normalized correlation
    peaks for (N, h, w) strip pairs, on the pairs' device; one set of
    FFTs per pair, as the JAX package's ``_pcc_core`` under vmap."""
    if reference.shape != moving.shape or reference.dim() != 3:
        raise ValueError(f"expected two (N, h, w) batches, got "
                         f"{tuple(reference.shape)} and {tuple(moving.shape)}")
    a = reference.to(torch.float32)
    b = moving.to(torch.float32)
    n, h, w = a.shape
    product = torch.fft.fft2(a) * torch.conj(torch.fft.fft2(b))
    # "phase" normalization: whiten to unit magnitude with an eps guard
    eps = 100.0 * torch.finfo(torch.float32).eps
    product = product / torch.clamp(product.abs(), min=eps)
    mag = torch.fft.ifft2(product).abs().reshape(n, h * w)
    peak, flat = mag.max(dim=1)
    my = torch.div(flat, w, rounding_mode='floor').to(torch.float32)
    mx = (flat % w).to(torch.float32)
    sy = torch.where(my > math.floor(h / 2), my - h, my)
    sx = torch.where(mx > math.floor(w / 2), mx - w, mx)
    shifts = torch.stack([sy, sx], dim=1)
    if upsample_factor <= 1:
        return shifts, peak
    uf = float(upsample_factor)
    shifts = torch.round(shifts * uf) / uf
    ups_size = int(math.ceil(uf * 1.5))
    dftshift = float(math.trunc(ups_size / 2.0))
    offsets = dftshift - shifts * uf
    pmag = _upsampled_patch(product, ups_size, uf, offsets).abs()
    pidx = pmag.reshape(n, -1).argmax(dim=1)
    py = torch.div(pidx, ups_size, rounding_mode='floor').to(torch.float32)
    px = (pidx % ups_size).to(torch.float32)
    return shifts + (torch.stack([py, px], dim=1) - dftshift) / uf, peak


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
