"""Multiscale pyramid downsampling, level from level.

The counterpart of the JAX package's ``ops/pyramid.py`` (its jitted
device steps) and of the host step it takes from ``ops/host_fuse.py``;
one module owns both twins:
- :func:`downsample_nearest` / :func:`downsample_mean` run on torch
  tensors on any device (the in-RAM path runs them on the card);
- :func:`host_downsample` is the NumPy step the band fuser's writer
  thread folds each finished band with.

Two modes, both flooring odd extents:
- 'nearest': the stride-2 pick (the JAX package's bitcast trick exists
  only for the TPU's lanes; a strided slice made contiguous is the same
  pixels);
- 'mean': the 2x2 mean in float32, summed in the JAX package's order
  (row 0's pair, then row 1's pixels one by one) and divided by 4,
  truncated back for integer dtypes.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch


def downsample_nearest(x: torch.Tensor) -> torch.Tensor:
    """Stride-2 pick over the last two axes; output dims floor(n/2)."""
    h2, w2 = (x.shape[-2] // 2) * 2, (x.shape[-1] // 2) * 2
    return x[..., :h2:2, :w2:2].contiguous()


def downsample_mean(x: torch.Tensor) -> torch.Tensor:
    """2x2 box mean over the last two axes, excess row/column trimmed:
    ((x00 + x01) + x10) + x11 in float32, divided by 4, truncated toward
    zero and cast back for integer dtypes (exact for uint8/uint16, whose
    sums f32 holds exactly; bit-equal to XLA's order for float32)."""
    h2, w2 = (x.shape[-2] // 2) * 2, (x.shape[-1] // 2) * 2
    t = x[..., :h2, :w2].to(torch.float32)
    m = (((t[..., 0::2, 0::2] + t[..., 0::2, 1::2]) + t[..., 1::2, 0::2])
         + t[..., 1::2, 1::2]) / 4.0
    if x.dtype.is_floating_point:
        return m.to(x.dtype)
    # torch casts no float to uint16: truncate through int32
    return torch.trunc(m).to(torch.int32).to(x.dtype)


def level_shapes(base_shape: Tuple[int, ...],
                 num_levels: int) -> List[Tuple[int, ...]]:
    """Shapes of all pyramid levels; only the last two axes shrink."""
    shapes = [tuple(base_shape)]
    for _ in range(1, num_levels):
        prev = shapes[-1]
        shapes.append(prev[:-2] + (prev[-2] // 2, prev[-1] // 2))
    return shapes


def downsample(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == 'nearest':
        return downsample_nearest(x)
    if mode == 'mean':
        return downsample_mean(x)
    raise ValueError(f"Unknown pyramid downsample mode: {mode}")


def iter_levels(canvas: torch.Tensor, num_levels: int,
                mode: str) -> Iterator[torch.Tensor]:
    """Yield pyramid levels level from level (level 0 = the input), on
    the canvas's device."""
    level = canvas
    for lv in range(num_levels):
        if lv > 0:
            level = downsample(level, mode)
        yield level


def host_downsample(x: np.ndarray, mode: str) -> np.ndarray:
    """One pyramid step over the last two axes of a NumPy array, odd
    extents floored: 'nearest' picks every other pixel, 'mean' is the
    2x2 mean in f32 truncated back to the integer dtype."""
    h2, w2 = (x.shape[-2] // 2) * 2, (x.shape[-1] // 2) * 2
    if mode == 'nearest':
        return np.ascontiguousarray(x[..., :h2:2, :w2:2])
    if mode != 'mean':
        raise ValueError(f"Unknown pyramid downsample mode: {mode}")
    t = x[..., :h2, :w2].astype(np.float32)
    lead = t.shape[:-2]
    m = t.reshape(lead + (h2 // 2, 2, w2 // 2, 2)).mean(axis=(-3, -1))
    if np.issubdtype(x.dtype, np.integer):
        m = np.trunc(m)
    return m.astype(x.dtype)
