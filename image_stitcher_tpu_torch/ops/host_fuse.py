"""The host fuser: tile placement on the CPU, through ``csrc/hostops.c``.

The counterpart of the JAX package's ``ops/host_fuse.py``, for
``fusion_device='host'``: a thread pool places flatfield-corrected tiles
into a NumPy canvas (:class:`HostCanvas`) or into the band fuser's bands
(``models/streaming.py::StreamingFuser``), by overwrite (later tile wins,
crop windows, edge clamp) or feathered accumulation, with the C loops of
``hostops.c`` (the JAX package's source, built with its flags). Their
plain NumPy versions are kept beside them (``*_plain``); the tests hold
the two byte-equal. A uint8/uint16 tile always takes the C loop, and a
failed build raises. Tiles of other dtypes take the JAX package's own
NumPy placement (:func:`place_window_numpy`), as its host fuser does
for every dtype its C loops lack.

Every path multiplies by the same host-computed RECIPROCAL flatfield,
so the host, the CUDA kernels and the JAX package agree byte for byte.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

#: tile dtypes the C loops take, with their functions' suffix
_NATIVE = {np.dtype(np.uint16): 'u16', np.dtype(np.uint8): 'u8'}


def correct_tile(tile: np.ndarray, ff_recip: Optional[np.ndarray],
                 c: int, dtype: np.dtype) -> np.ndarray:
    """Reference flatfield correction (stitcher.py:607-611) expressed as
    multiply-by-reciprocal, clip to dtype range, cast. An undersized edge
    tile is corrected by the matching top-left window of the field."""
    if ff_recip is None:
        return tile
    corrected = tile * ff_recip[c][:tile.shape[0], :tile.shape[1]]
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        np.clip(corrected, info.min, info.max, out=corrected)
    return corrected.astype(dtype)


def place_window_plain(dst, tile: np.ndarray, ff_c: Optional[np.ndarray],
                       y0: int, y1: int, x0: int, x1: int, cy: int, cx: int,
                       feather: Optional[Tuple] = None) -> None:
    """The plain version of :func:`place_window`: NumPy, byte-equal to
    the C loops. Feather ramps are min(1, d * inv_blend_px) per axis in
    f32 (d the 1-based distance to the nearer edge of the full crop
    window), the smaller of the two; the sum ``acc += w * v`` is one
    fused multiply-add, as the compiler contracts it in ``hostops.c``."""
    from .flatfield import fma32
    if ff_c is not None:
        t = correct_tile(tile, ff_c[None], 0, tile.dtype)
    else:
        t = tile
    t = t[y0:y1, x0:x1]
    ye, xe = cy + (y1 - y0), cx + (x1 - x0)
    if feather is None:
        dst[cy:ye, cx:xe] = t
        return
    acc, wsum = dst
    wy0, wy1, wx0, wx1, inv_px = feather
    inv = np.float32(inv_px)
    ys, xs = np.arange(y0, y1), np.arange(x0, x1)
    dy = np.minimum(ys - wy0 + 1, wy1 - ys).astype(np.float32)
    dx = np.minimum(xs - wx0 + 1, wx1 - xs).astype(np.float32)
    wgt = np.minimum(np.minimum(dy * inv, np.float32(1.0))[:, None],
                     np.minimum(dx * inv, np.float32(1.0))[None, :])
    acc[cy:ye, cx:xe] = fma32(wgt, t.astype(np.float32), acc[cy:ye, cx:xe])
    wsum[cy:ye, cx:xe] += wgt


def place_window_numpy(dst, tile: np.ndarray, ff_c: Optional[np.ndarray],
                       y0: int, y1: int, x0: int, x1: int, cy: int, cx: int,
                       feather: Optional[Tuple] = None) -> None:
    """:func:`place_window` for tiles other than uint8/uint16, as the JAX
    package's host fuser places them in NumPy: the tile corrected by
    :func:`correct_tile` in its dtype; feathered, the ramp is
    min(dy, dx) / blend_px in f32 clipped to 1 (d the 1-based distance to
    the nearer edge of the full crop window) and ``acc += w * v`` rounds
    the product before the sum (no fused multiply-add)."""
    t = correct_tile(tile, None if ff_c is None else ff_c[None], 0,
                     tile.dtype)[y0:y1, x0:x1]
    ye, xe = cy + (y1 - y0), cx + (x1 - x0)
    if feather is None:
        dst[cy:ye, cx:xe] = t
        return
    acc, wsum = dst
    wy0, wy1, wx0, wx1, inv_px = feather
    ys, xs = np.arange(y0, y1), np.arange(x0, x1)
    dy = np.minimum(ys - wy0 + 1, wy1 - ys)
    dx = np.minimum(xs - wx0 + 1, wx1 - xs)
    wgt = (np.minimum.outer(dy, dx).astype(np.float32)
           / round(1.0 / inv_px)).clip(0, 1)
    acc[cy:ye, cx:xe] += wgt * t.astype(np.float32)
    wsum[cy:ye, cx:xe] += wgt


def place_window(dst, tile: np.ndarray, ff_c: Optional[np.ndarray],
                 y0: int, y1: int, x0: int, x1: int, cy: int, cx: int,
                 feather: Optional[Tuple] = None) -> None:
    """Flatfield-correct tile[y0:y1, x0:x1] (``ff_c``: the channel's
    (th, tw) f32 RECIPROCAL field, or None) and place it at dst[cy, cx]:
    ``dst`` is a 2-D plane of the tile's dtype (overwrite), or an
    (acc, wsum) float32 pair (``feather`` = (wy0, wy1, wx0, wx1,
    inv_blend_px), the FULL crop window in tile coordinates the ramps
    measure from). uint8/uint16 tiles run the fused C loop of
    ``hostops.c``; other dtypes :func:`place_window_numpy`. A window
    outside the tile, the field or ``dst``, and a layout the C loop does
    not take (a destination of another dtype, or with strided columns),
    raise."""
    suffix = _NATIVE.get(tile.dtype)
    plane = dst[0] if feather is not None else dst
    if not (0 <= y0 <= y1 <= tile.shape[0] and 0 <= x0 <= x1 <= tile.shape[1]
            and 0 <= cy and cy + (y1 - y0) <= plane.shape[0]
            and 0 <= cx and cx + (x1 - x0) <= plane.shape[1]
            and (ff_c is None or (ff_c.shape[0] >= y1
                                  and ff_c.shape[1] >= x1))
            and (feather is None or dst[1].shape == plane.shape)):
        raise ValueError(f"window [{y0}:{y1}, {x0}:{x1}] of a {tile.shape} "
                         f"tile at ({cy}, {cx}) does not fit a "
                         f"{plane.shape} destination")
    if suffix is None:
        place_window_numpy(dst, tile, ff_c, y0, y1, x0, x1, cy, cx, feather)
        return
    if (feather is None and dst.dtype != tile.dtype) \
            or plane.strides[-1] != plane.itemsize:
        raise ValueError(f"a {tile.dtype} tile does not place into a "
                         f"{plane.dtype} plane with strides {plane.strides}: "
                         "the C loop takes unit-stride columns of the "
                         "tile's dtype (float32 pairs when feathered)")
    from ..native import hostops
    lib = hostops()
    tile = np.ascontiguousarray(tile)
    es = tile.itemsize
    if ff_c is not None:
        ff_c = np.ascontiguousarray(ff_c, np.float32)
    ffp = ff_c.ctypes.data if ff_c is not None else None
    ffs = ff_c.strides[0] // 4 if ff_c is not None else 0
    if feather is not None:
        acc, wsum = dst
        if acc.strides != wsum.strides or acc.dtype != np.float32 \
                or wsum.dtype != np.float32:
            raise ValueError("feather accumulators must be float32 planes "
                             "of one layout")
        wy0, wy1, wx0, wx1, inv_px = feather
        getattr(lib, f'feather_{suffix}')(
            acc.ctypes.data, wsum.ctypes.data, acc.strides[0] // 4,
            tile.ctypes.data, tile.strides[0] // es,
            ffp, ffs, y0, y1, x0, x1, wy0, wy1, wx0, wx1, cy, cx, inv_px)
        return
    getattr(lib, f'place_{suffix}')(
        dst.ctypes.data, dst.strides[0] // es,
        tile.ctypes.data, tile.strides[0] // es,
        ffp, ffs, y0, y1, x0, x1, cy, cx)


def finalize_feather_plain(acc: np.ndarray, wsum: np.ndarray,
                           dtype) -> np.ndarray:
    """``clip(round(acc / maximum(wsum, 1e-6)))``, 0 where wsum is 0,
    cast to ``dtype`` (round half to even, as ``rintf``)."""
    dtype = np.dtype(dtype)
    out_f = acc / np.maximum(wsum, np.float32(1e-6))
    out_f[wsum == 0] = 0
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        out_f = np.clip(np.round(out_f), info.min, info.max)
    return out_f.astype(dtype)


def finalize_feather_host(acc: np.ndarray, wsum: np.ndarray,
                          dtype) -> np.ndarray:
    """(acc, wsum) f32 -> storage dtype in one C pass
    (``finalize_feather_u16/u8``) for uint8/uint16 output; any leading
    shape over rows of one layout. Other dtypes: the plain version."""
    dtype = np.dtype(dtype)
    suffix = _NATIVE.get(dtype)
    if (suffix is None or acc.ndim < 2 or acc.shape != wsum.shape
            or acc.dtype != np.float32 or wsum.dtype != np.float32):
        return finalize_feather_plain(acc, wsum, dtype)
    from ..native import hostops
    fn = getattr(hostops(), f'finalize_feather_{suffix}')
    acc = np.ascontiguousarray(acc)
    wsum = np.ascontiguousarray(wsum)
    out = np.empty(acc.shape, dtype)
    a3 = acc.reshape((-1,) + acc.shape[-2:])
    w3 = wsum.reshape((-1,) + wsum.shape[-2:])
    o3 = out.reshape((-1,) + out.shape[-2:])
    for i in range(a3.shape[0]):
        fn(a3[i].ctypes.data, w3[i].ctypes.data, a3.shape[-1],
           o3[i].ctypes.data, o3.shape[-1], a3.shape[-2], a3.shape[-1])
    return out


def downsample2x_native(x: np.ndarray, mode: str,
                        out: np.ndarray) -> None:
    """C 2x fold of a uint8/uint16 plane ``x`` (unit-stride rows) into
    ``out`` (rows may be strided): 'nearest' copies x[::2, ::2], 'mean'
    is floor of each 2x2 window's mean, as ``sum >> 2``."""
    from ..native import hostops
    suffix = _NATIVE[x.dtype]
    fn = getattr(hostops(), (f'downsample2x_{suffix}' if mode == 'nearest'
                             else f'downsample2x2_mean_{suffix}'))
    es = x.itemsize
    fn(x.ctypes.data, x.strides[0] // es, out.ctypes.data,
       out.strides[0] // es, out.shape[0], out.shape[1])


class HostCanvas:
    """A (C, Z, H, W) canvas fused by a host thread pool."""

    def __init__(self, num_c: int, num_z: int, height: int, width: int,
                 dtype, num_threads: int = 4,
                 ff_recip: Optional[np.ndarray] = None,
                 blend_method: str = 'overwrite', blend_px: int = 64):
        if blend_method not in ('overwrite', 'feather'):
            raise ValueError(f"unknown blend_method {blend_method!r}")
        self.height, self.width = height, width
        self.dtype = np.dtype(dtype)
        self.ff_recip = ff_recip  # (C, th, tw) f32 reciprocal or None
        self.blend = blend_method
        self.blend_px = blend_px
        if blend_method == 'feather':
            # the storage-dtype canvas materializes at finalize() only
            self.canvas = None
            self.acc = np.zeros((num_c, num_z, height, width), np.float32)
            self.wsum = np.zeros((num_c, num_z, height, width), np.float32)
        else:
            self.canvas = np.zeros((num_c, num_z, height, width), dtype)
        self.pool = ThreadPoolExecutor(max_workers=num_threads,
                                       thread_name_prefix='host-fuse')

    def _place(self, job) -> None:
        tile, c, z, y, x, crops = job
        top, bottom, left, right = crops
        th, tw = tile.shape
        # the full crop window within the tile (feather ramps measure
        # from its edges, as the device kernel's do), then the canvas clamp
        wy1 = th - bottom if bottom else th
        wx1 = tw - right if right else tw
        y0, y1 = top, wy1
        x0, x1 = left, wx1
        yy, xx = y + top, x + left
        y1 = min(y1, y0 + (self.height - yy))
        x1 = min(x1, x0 + (self.width - xx))
        if y1 <= y0 or x1 <= x0:
            return
        ff_c = self.ff_recip[c] if self.ff_recip is not None else None
        if self.blend == 'feather':
            place_window((self.acc[c, z], self.wsum[c, z]), tile, ff_c,
                         y0, y1, x0, x1, yy, xx,
                         feather=(y0, wy1, x0, wx1,
                                  1.0 / float(self.blend_px)))
        else:
            place_window(self.canvas[c, z], tile, ff_c, y0, y1, x0, x1,
                         yy, xx)

    def fuse_streaming(self, jobs, load_fn, progress_cb=None,
                       stop_check=None) -> None:
        """Read and place directly, no batch buffers. ``jobs`` are
        TileJob-likes; ``load_fn(job)`` returns the (th, tw) plane. Jobs
        are grouped by (c, z) plane: each plane streams sequentially in
        plan order (exact later-tile-wins semantics), planes in
        parallel (they never overlap)."""
        planes = {}
        for job in jobs:
            planes.setdefault((job.channel_idx, job.z_level), []).append(job)
        done = [0]
        done_lock = threading.Lock()
        cancelled = [False]

        def run_plane(plane_jobs):
            for job in plane_jobs:
                if cancelled[0]:
                    return
                if stop_check is not None:
                    stop_check()
                tile = load_fn(job)
                self._place((tile, job.channel_idx, job.z_level,
                             job.y, job.x, job.crops))
                with done_lock:
                    done[0] += 1
                    n = done[0]
                if progress_cb is not None:
                    progress_cb(n)

        try:
            list(self.pool.map(run_plane, planes.values()))
        except BaseException:
            cancelled[0] = True  # running planes stop at their next job
            self.pool.shutdown(wait=False, cancel_futures=True)
            raise

    def finalize(self) -> np.ndarray:
        if self.blend == 'feather':
            self.canvas = finalize_feather_host(self.acc, self.wsum,
                                                self.dtype)
            self.acc = self.wsum = None
        self.pool.shutdown(wait=True)
        return self.canvas
