"""Sharded canvas fusion: Y bands over the mesh's canvas axis.

The counterpart of the JAX package's ``parallel/sharded_fuse.py``. Each
device of the canvas axis holds one horizontal band of the output
canvas as a one-band canvas of the port's layout: ``(C, Z, tile_h +
band + tile_h, ceil8(W + tile_w))`` (``models/streaming.py::
band_canvas_shape`` for every plane), or the float32 ``(acc, wsum)``
pair for feathered blending. Every batch goes to every band: a band
fuses, through ``ops/cuda_fuse``'s kernels on its device, the tiles
that intersect its rows at band-local origins, with the others masked
off; a straddling tile lands partly in the aprons, which are never read
back. No halo exchange and no collective in the hot loop: each output
row has one owner.

Feathered blending shards the same way: the ramps come from each tile's
whole crop window (the aprons keep the tile whole), so a straddler gives
both of its bands the same weights, and each band's divide and cast
(``finalize_feather``) is local. Overwrite is byte-equal and feather
bit-equal to one unbanded canvas (tested against the JAX
``ShardedCanvas``).

The JAX package assembles the whole (C, Z, H, W) canvas on one device at
the end (:meth:`ShardedCanvas.finalize` keeps that contract); the
pipeline instead streams the bands to the writer piece by piece
(:meth:`ShardedCanvas.iter_bands`: a (c, z) plane's rows of one band at
a time), so no device and no host buffer ever holds the whole canvas. A mesh with several data rows fuses each
band once, on the row this process owns; the JAX package keeps a copy
on every row, with the same output.
"""

from __future__ import annotations

import itertools

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..io.readers import device_dtype
from ..ops import cuda_fuse
from .mesh import AXIS_CANVAS, Mesh


def band_local_origin(y, band: int, tile_h: int, band_start):
    """Band-local y origin and intersection flag (scalar or array ``y``).

    Origins clamp to [0, band + tile_h], the placement envelope of a band
    with one-tile aprons; the clamp only moves tiles that do not
    intersect the band, which are masked off. An intersecting tile's
    origin lies in (0, band + tile_h), so its whole extent fits the
    band's tile_h + band + tile_h rows."""
    y = np.asarray(y)
    y_local = np.clip(y - band_start + tile_h, 0, band + tile_h)
    intersects = (y + tile_h > band_start) & (y < band_start + band)
    return y_local, intersects


class _Band:
    """One band: its device, first canvas row, real rows and tensors."""

    def __init__(self, index: int, device: torch.device, start: int,
                 rows: int):
        self.index = index
        self.device = device
        self.start = start
        self.rows = rows
        self.canvas: Optional[torch.Tensor] = None
        self.acc: Optional[torch.Tensor] = None
        self.wsum: Optional[torch.Tensor] = None
        #: kernel launches on this band
        self.launches = 0


class ShardedCanvas:
    """A (C, Z, H, W) canvas banded over the mesh's canvas axis.

    ``band`` is the rows a band owns; the default ``ceil(H / n_canvas)``
    is the JAX package's. The pipeline passes a taller band (a multiple
    of the writer's band rows, so no pyramid window crosses two bands);
    a device whose band would start at or past H then holds nothing.
    ``ff_recip`` ((C, tile_h, tile_w) float32 reciprocal fields) is fused
    into every launch: tiles arrive raw."""

    def __init__(self, mesh: Mesh, num_c: int, num_z: int, height: int,
                 width: int, tile_h: int, tile_w: int, dtype,
                 blend_method: str = 'overwrite', blend_px: int = 64,
                 ff_recip=None, band: Optional[int] = None):
        if blend_method not in ('overwrite', 'feather'):
            raise ValueError(f"unknown blend_method {blend_method!r}")
        self.mesh = mesh
        self.n_bands = mesh.shape[AXIS_CANVAS]
        self.num_c, self.num_z = num_c, num_z
        self.height, self.width = height, width
        self.tile_h, self.tile_w = tile_h, tile_w
        self.dtype = device_dtype(dtype) if not isinstance(
            dtype, torch.dtype) else dtype
        self.blend = blend_method
        self.blend_px = blend_px
        least = -(-height // self.n_bands)
        self.band = least if band is None else int(band)
        if self.band < least:
            raise ValueError(f"{self.n_bands} bands of {self.band} rows do "
                             f"not cover {height} rows")
        self.band_shape = (num_c, num_z, tile_h + self.band + tile_h,
                           -(-(width + tile_w) // 8) * 8)
        feather = blend_method == 'feather'
        cuda_fuse.check_extents(
            self.band_shape,
            max_rows=cuda_fuse.FEATHER_MAX_ROWS if feather
            else cuda_fuse.INT_MAX,
            max_planes=cuda_fuse.MAX_PLANES if feather else cuda_fuse.INT_MAX)
        devices = mesh.row(mesh.local_row())
        self.bands: List[_Band] = []
        for b, dev in enumerate(devices):
            start = b * self.band
            if start >= height:
                break          # a trailing device with no rows: skipped
            band_ = _Band(b, dev, start, min(self.band, height - start))
            if feather:
                band_.acc = torch.zeros(self.band_shape, dtype=torch.float32,
                                        device=dev)
                band_.wsum = torch.zeros(self.band_shape,
                                         dtype=torch.float32, device=dev)
            else:
                band_.canvas = torch.zeros(self.band_shape, dtype=self.dtype,
                                           device=dev)
            self.bands.append(band_)
        self._ff_host = (None if ff_recip is None else torch.from_numpy(
            np.ascontiguousarray(np.asarray(ff_recip), np.float32)))
        self._ff: Dict[torch.device, torch.Tensor] = {}
        #: distinct devices that hold a band, in band order
        self.devices = list(dict.fromkeys(b.device for b in self.bands))

    def _field(self, device: torch.device) -> Optional[torch.Tensor]:
        """The reciprocal field on ``device``, copied there once."""
        if self._ff_host is None:
            return None
        if device not in self._ff:
            self._ff[device] = self._ff_host.to(device)
        return self._ff[device]

    def fuse_batch(self, tiles, info, crops, valid) -> None:
        """Fuse one batch: tiles (N, th, tw) of the canvas dtype on the host
        (pinned for CUDA bands: each distinct device gets one
        ``non_blocking`` upload on its current stream), info (N, 4)
        [c, z, y, x], crops (N, 4) and valid (N,) on the host (NumPy or
        tensors). Each band launches its kernel, on its device's current
        stream, with info's y rewritten to band-local origins and valid
        masked to the tiles that intersect it; a band no tile reaches
        launches nothing."""
        tiles = torch.as_tensor(tiles)
        info = np.asarray(info, np.int32)
        crops_t = torch.from_numpy(np.ascontiguousarray(crops, np.int32))
        valid = np.asarray(valid, bool)
        uploads: Dict[torch.device, torch.Tensor] = {}
        for band in self.bands:
            y_local, hit = band_local_origin(info[:, 2], self.band,
                                             self.tile_h, band.start)
            mask = valid & hit
            if not mask.any():
                continue
            dev = band.device
            if dev not in uploads:
                uploads[dev] = tiles.to(dev, non_blocking=True)
            dinfo = info.copy()
            dinfo[:, 2] = y_local
            meta = (torch.from_numpy(dinfo), crops_t, torch.from_numpy(mask))
            if self.blend == 'feather':
                cuda_fuse.fuse_feather(band.acc, band.wsum, uploads[dev],
                                       *meta, ff_recip=self._field(dev),
                                       blend_px=self.blend_px)
            else:
                cuda_fuse.fuse_overwrite(band.canvas, uploads[dev], *meta,
                                         ff_recip=self._field(dev))
            band.launches += 1

    def _core(self, band: _Band) -> torch.Tensor:
        """The band's real (C, Z, rows, W) pixels on its device (a new
        tensor for feather, finalized there; a view for overwrite)."""
        th = self.tile_h
        if self.blend == 'feather':
            return cuda_fuse.finalize_feather(band.acc, band.wsum,
                                              self.dtype, (th, th + band.rows),
                                              (0, self.width))
        return band.canvas[:, :, th:th + band.rows, :self.width]

    def finalize(self) -> torch.Tensor:
        """The assembled (C, Z, H, W) canvas on the first band's device
        (the JAX contract; the pipeline streams :meth:`iter_bands`
        instead)."""
        first = self.bands[0].device
        return torch.cat([self._core(b).to(first) for b in self.bands],
                         dim=2)

    def iter_bands(self, piece_rows: Optional[int] = None, keep=None,
                   z_group: int = 1
                   ) -> Iterator[Tuple[int, int, int, torch.Tensor,
                                       Optional[torch.cuda.Event]]]:
        """Yield (c, z, first row, (rows, W) host copy, event or None) for
        the canvas's core rows, band by band in row order and within a
        band by z // ``z_group``, row, z and c (for ``z_group`` 1: z, row
        and c), the band writers' order for chunks ``z_group`` planes deep
        (``models/streaming.py::band_order``): one piece a (c, z) plane,
        cut again at every multiple of ``piece_rows`` when it is given. ``keep(c, z, row)``
        (default: every piece) picks the pieces to copy. A CUDA piece's
        copy goes to pinned memory on a side stream of the band's device,
        after the band's fusion on its current stream; wait on the event
        before reading it. Each copy starts only when the caller asks for
        its piece, so the caller bounds the host copies alive at once,
        and a device holds at most one piece-sized staging copy beyond
        its bands. The canvas is consumed: a band's device memory goes
        back to the allocator once its last piece is queued (the side
        stream is recorded on it)."""
        for band in self.bands:
            core = self._core(band)
            b0, b1 = band.start, band.start + band.rows
            cuts = {b0, b1}
            if piece_rows:
                cuts |= set(range(-(-b0 // piece_rows) * piece_rows, b1,
                                  piece_rows))
            cuts = sorted(cuts)
            side = None
            if band.device.type == 'cuda':
                side = torch.cuda.Stream(band.device)
                side.wait_stream(torch.cuda.current_stream(band.device))
            for zg in range(0, self.num_z, z_group):
                zs = range(zg, min(zg + z_group, self.num_z))
                for (r0, r1), z, c in itertools.product(
                        zip(cuts, cuts[1:]), zs, range(self.num_c)):
                    if keep is not None and not keep(c, z, r0):
                        continue
                    piece = core[c, z, r0 - b0:r1 - b0]
                    if side is None:
                        host, done = piece.clone(), None
                    else:
                        host = torch.empty(tuple(piece.shape),
                                           dtype=piece.dtype,
                                           pin_memory=True)
                        with torch.cuda.stream(side):
                            host.copy_(piece, non_blocking=True)
                            done = torch.cuda.Event()
                            done.record(side)
                    del piece
                    yield c, z, r0, host, done
                    host = done = None   # the caller holds the copy
            if side is not None:
                core.record_stream(side)
            band.canvas = band.acc = band.wsum = None
            del core

    def band_stats(self) -> List[Dict]:
        """Per band: its device, rows and launches."""
        return [{'band': band.index, 'device': str(band.device),
                 'start': band.start, 'rows': band.rows,
                 'launches': band.launches} for band in self.bands]
