"""Tile -> canvas fusion in plain PyTorch: the reference for the kernels.

The counterpart of ``image_stitcher_tpu/ops/fuse.py``. These functions
are the plain versions of the CUDA kernels in ``ops/cuda_fuse.py``: the
CPU runs of the port use them, and they run on CUDA tensors too, so each
kernel can be held against them on the card.

Semantics, as in the JAX package:
- tiles apply in batch order; a valid tile writes its crop window
  [top, th-bottom) x [left, tw-right) at canvas[c, z, y:, x:]; a later
  tile wins and pixels outside every window keep the canvas value;
- feathered blending accumulates ``acc += ramp * tile`` and
  ``wsum += ramp`` into float32 canvases, tile after tile, with the ramp
  rising from the crop window's edge (:func:`feather_ramp`); the
  finished canvas is ``round(acc / wsum)`` (:func:`finalize_feather`);
- the flatfield multiplies by a host-computed f32 RECIPROCAL, clips to
  the dtype range and truncates (never a divide: that is what keeps
  every backend byte-identical);
- the canvas carries a one-tile apron on the bottom/right
  (:func:`padded_canvas_shape`), so no window needs clamping.

torch has no comparisons, clamp or max on uint16, so the arithmetic runs
in float32/int32 and uint16 is only stored and sliced.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

#: storage dtypes the port fuses, with their value range
DTYPE_RANGE = {torch.uint8: (0, 255), torch.uint16: (0, 65535)}


def padded_canvas_shape(num_c: int, num_z: int, height: int, width: int,
                        tile_h: int, tile_w: int) -> Tuple[int, int, int, int]:
    """Canvas with a one-tile apron on bottom/right: every tile placed
    inside the real canvas keeps its whole (th, tw) extent in bounds."""
    return (num_c, num_z, height + tile_h, width + tile_w)


def crop_window(crops, th: int, tw: int) -> Tuple[int, int, int, int]:
    """(r0, r1, s0, s1): the crop window clamped to the tile."""
    top, bottom, left, right = (int(v) for v in crops)
    return (max(top, 0), min(th - bottom, th), max(left, 0),
            min(tw - right, tw))


def check_batch(canvas: torch.Tensor, tiles: torch.Tensor,
                info: torch.Tensor, crops: torch.Tensor, valid: torch.Tensor,
                ff_recip: Optional[torch.Tensor] = None) -> None:
    """Raise on anything the fusion does not take.

    canvas (C, Z, Hp, Wp) and tiles (N, th, tw) share a dtype (uint8 or
    uint16) and a device, and are contiguous; ff_recip, when given, is a
    contiguous float32 (C_ff, th, tw) on that device. info (N, 4) int32,
    crops (N, 4) int32 and valid (N,) bool are HOST tensors. Every valid
    tile's (th, tw) extent must lie inside the canvas (the JAX scan would
    clamp such a tile to the edge and place it elsewhere)."""
    if canvas.dtype not in DTYPE_RANGE:
        raise TypeError(f"fusion takes uint8 or uint16 canvases, "
                        f"not {canvas.dtype}")
    if tiles.dtype != canvas.dtype:
        raise TypeError(f"tiles are {tiles.dtype}, canvas is {canvas.dtype}")
    _check_placement(canvas, tiles, info, crops, valid, ff_recip)


def check_feather_batch(acc: torch.Tensor, wsum: torch.Tensor,
                        tiles: torch.Tensor, info: torch.Tensor,
                        crops: torch.Tensor, valid: torch.Tensor,
                        ff_recip: Optional[torch.Tensor] = None,
                        blend_px: int = 64) -> None:
    """:func:`check_batch` for a feather pair: ``acc`` and ``wsum`` are
    float32 (C, Z, Hp, Wp) of one shape and device; tiles are uint8 or
    uint16; ``blend_px`` is a positive int."""
    if acc.dtype != torch.float32 or wsum.dtype != torch.float32:
        raise TypeError(f"feather canvases are float32, got {acc.dtype} "
                        f"and {wsum.dtype}")
    if acc.shape != wsum.shape or acc.device != wsum.device:
        raise ValueError(f"acc {tuple(acc.shape)} on {acc.device} and wsum "
                         f"{tuple(wsum.shape)} on {wsum.device} differ")
    if not wsum.is_contiguous():
        raise ValueError("wsum must be contiguous")
    if tiles.dtype not in DTYPE_RANGE:
        raise TypeError(f"fusion takes uint8 or uint16 tiles, "
                        f"not {tiles.dtype}")
    if isinstance(blend_px, bool) or not isinstance(blend_px, int) \
            or blend_px < 1:
        raise ValueError(f"blend_px must be a positive int, got {blend_px!r}")
    _check_placement(acc, tiles, info, crops, valid, ff_recip)


def _check_placement(canvas: torch.Tensor, tiles: torch.Tensor,
                     info: torch.Tensor, crops: torch.Tensor,
                     valid: torch.Tensor,
                     ff_recip: Optional[torch.Tensor]) -> None:
    if canvas.dim() != 4 or tiles.dim() != 3:
        raise ValueError(f"canvas must be (C, Z, Hp, Wp) and tiles (N, th, "
                         f"tw); got {tuple(canvas.shape)}, "
                         f"{tuple(tiles.shape)}")
    if tiles.device != canvas.device:
        raise ValueError(f"tiles on {tiles.device}, canvas on {canvas.device}")
    if not (canvas.is_contiguous() and tiles.is_contiguous()):
        raise ValueError("canvas and tiles must be contiguous")
    n, th, tw = tiles.shape
    for name, t, shape, dtype in (('info', info, (n, 4), torch.int32),
                                  ('crops', crops, (n, 4), torch.int32),
                                  ('valid', valid, (n,), torch.bool)):
        if t.device.type != 'cpu':
            raise ValueError(f"{name} must be a host tensor, got {t.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if ff_recip is not None:
        if ff_recip.dtype != torch.float32 or ff_recip.dim() != 3 \
                or tuple(ff_recip.shape[1:]) != (th, tw):
            raise ValueError(f"ff_recip must be float32 (C, {th}, {tw}), got "
                             f"{tuple(ff_recip.shape)} {ff_recip.dtype}")
        if ff_recip.device != canvas.device or not ff_recip.is_contiguous():
            raise ValueError("ff_recip must be contiguous on the canvas device")
    C, Z, Hp, Wp = canvas.shape
    meta = info[valid]
    if meta.numel():
        c, z, y, x = meta.unbind(1)
        c_max = ff_recip.shape[0] if ff_recip is not None else C
        bad = ((c < 0) | (c >= min(C, c_max)) | (z < 0) | (z >= Z)
               | (y < 0) | (y + th > Hp) | (x < 0) | (x + tw > Wp))
        if bool(bad.any()):
            k = int(bad.nonzero()[0, 0])
            raise ValueError(f"tile (c, z, y, x) = {meta[k].tolist()} of "
                             f"{(th, tw)} does not lie inside the canvas "
                             f"{tuple(canvas.shape)}")


def apply_flatfield(tiles: torch.Tensor, ff_recip: torch.Tensor,
                    channel_idx: torch.Tensor,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """Per-tile flatfield correct-clip-cast: trunc(clip(tile * recip)).

    tiles (N, th, tw); ff_recip (C, th, tw) float32 reciprocal fields
    (ones where absent); channel_idx (N,) selects each tile's field."""
    lo, hi = DTYPE_RANGE[out_dtype]
    ff = ff_recip.index_select(0, channel_idx.to(ff_recip.device).long())
    corrected = tiles.to(torch.float32) * ff
    return corrected.clamp_(lo, hi).to(torch.int32).to(out_dtype)


def fuse_overwrite(canvas: torch.Tensor, tiles: torch.Tensor,
                   info: torch.Tensor, crops: torch.Tensor,
                   valid: torch.Tensor,
                   ff_recip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Place a batch into ``canvas`` in place, one tile after another.

    Each valid tile's crop window is a rectangular mask; writing it as a
    slice assignment in batch order gives later-tile-wins. With
    ``ff_recip`` the batch is corrected first (:func:`apply_flatfield`),
    with the field picked by each tile's channel (info[:, 0]).
    Returns ``canvas``."""
    check_batch(canvas, tiles, info, crops, valid, ff_recip)
    if ff_recip is not None:
        tiles = apply_flatfield(tiles, ff_recip, info[:, 0], canvas.dtype)
    _, th, tw = tiles.shape
    for i in valid.nonzero().flatten().tolist():
        c, z, y, x = info[i].tolist()
        r0, r1, s0, s1 = crop_window(crops[i], th, tw)
        if r1 > r0 and s1 > s0:
            canvas[c, z, y + r0:y + r1, x + s0:x + s1] = tiles[i, r0:r1, s0:s1]
    return canvas


def feather_ramp(crops, th: int, tw: int, blend_px: int,
                 device=None) -> torch.Tensor:
    """(th, tw) float32 weights: the 1-based distance to the nearest edge
    of the crop window, d = min(r - top + 1, th - bottom - r,
    s - left + 1, tw - right - s), as clip(d / blend_px, 0, 1) where
    d > 0 and 0 elsewhere. The crops are taken as they are (a negative
    crop moves the edge outside the tile)."""
    top, bottom, left, right = (int(v) for v in crops)
    rows = torch.arange(th, dtype=torch.int32, device=device)[:, None]
    cols = torch.arange(tw, dtype=torch.int32, device=device)[None, :]
    d = torch.minimum(torch.minimum(rows - top + 1, (th - bottom) - rows),
                      torch.minimum(cols - left + 1, (tw - right) - cols))
    w = torch.clamp(d.to(torch.float32) / float(blend_px), 0.0, 1.0)
    return torch.where(d > 0, w, torch.zeros((), dtype=torch.float32,
                                             device=device))


def fuse_feather(acc: torch.Tensor, wsum: torch.Tensor, tiles: torch.Tensor,
                 info: torch.Tensor, crops: torch.Tensor, valid: torch.Tensor,
                 ff_recip: Optional[torch.Tensor] = None,
                 blend_px: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accumulate a batch into ``acc``/``wsum`` in place, tile after tile:
    acc += ramp * v and wsum += ramp over each valid tile's crop window
    (where the ramp is > 0; it is 0 elsewhere, and adding 0 changes
    nothing). v is the tile as float32, or with ``ff_recip`` the tile
    corrected and quantized to its dtype first (:func:`apply_flatfield`).

    Each term is a product, then a sum, each rounded to float32 (never a
    fused multiply-add), so the CUDA kernel can give the same bits.
    Returns (acc, wsum)."""
    check_feather_batch(acc, wsum, tiles, info, crops, valid, ff_recip,
                        blend_px)
    if ff_recip is not None:
        tiles = apply_flatfield(tiles, ff_recip, info[:, 0], tiles.dtype)
    _, th, tw = tiles.shape
    for i in valid.nonzero().flatten().tolist():
        c, z, y, x = info[i].tolist()
        r0, r1, s0, s1 = crop_window(crops[i], th, tw)
        if r1 <= r0 or s1 <= s0:
            continue
        ramp = feather_ramp(crops[i], th, tw, blend_px,
                            acc.device)[r0:r1, s0:s1]
        v = tiles[i, r0:r1, s0:s1].to(torch.float32)
        win = (c, z, slice(y + r0, y + r1), slice(x + s0, x + s1))
        acc[win] += ramp * v
        wsum[win] += ramp
    return acc, wsum


def finalize_feather(acc: torch.Tensor, wsum: torch.Tensor,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """acc / max(wsum, 1e-6), 0 where wsum <= 0, rounded half to even,
    clipped to the dtype range and cast (a new tensor)."""
    lo, hi = DTYPE_RANGE[out_dtype]
    out = acc / torch.clamp(wsum, min=1e-6)
    out = torch.where(wsum > 0, out, torch.zeros((), dtype=out.dtype,
                                                 device=out.device))
    out = torch.round(out).clamp_(lo, hi)
    return out.to(torch.int32).to(out_dtype)
