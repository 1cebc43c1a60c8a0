"""Streaming fusion: tiles -> OME-Zarr with bounded memory, on a device.

The counterpart of the JAX package's ``models/streaming.py`` (its
``DeviceStreamingFuser`` and the helpers it shares with the host fuser).
Each (channel, z) plane is fused in horizontal bands sized to the chunk
grid. A band canvas lives on the device; tile batches are uploaded from
pinned host memory and placed by a CUDA kernel, with the flatfield fused
in: ``ops/cuda_fuse.fuse_overwrite`` into one storage-dtype canvas, or
for feathered blending ``ops/cuda_fuse.fuse_feather`` into a float32
(acc, wsum) pair that ``finalize_feather`` turns into the band's pixels
on the device. A finished band is copied back to pinned host memory on a
side stream and handed to one writer thread, which folds it into every
pyramid level and writes the chunk files, while the next band fuses.

Placement parity: each band canvas carries a one-tile apron above
(tiles straddling the band's top edge keep their whole pre-crop extent
in bounds, and so their ramps from the whole crop window) and one tile
below and to the right, as the JAX package's non-Pallas band canvas
does, so band output is identical to an unbanded canvas. Its rows are
padded to a multiple of 8 elements (:func:`band_canvas_shape`), so the
kernels' canvas rows start 16-byte aligned; the padding is never read
back.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..io.omezarr import MultiscaleWriter
from ..io.readers import TileBatchLoader, torch_dtype
from ..ops import cuda_fuse
from ..ops.pyramid import host_downsample


def band_rows_for(chunk_rows: int, num_levels: int) -> int:
    """Band height: >= one chunk row, multiple of 2^(num_levels-1)."""
    align = 1 << max(0, num_levels - 1)
    return max(chunk_rows, ((chunk_rows + align - 1) // align) * align)


def write_band_levels(writer: MultiscaleWriter, c: int, z: int, band0: int,
                      buf: np.ndarray, num_levels: int, mode: str) -> None:
    """Write one finished (c, z) band to level 0 and fold it into every
    deeper level (band rows are a multiple of 2^(levels-1), so pooling
    windows never cross bands). ``band0`` is in level-0 rows."""
    level = buf
    for lv in range(num_levels):
        if lv > 0:
            level = host_downsample(level, mode)
        h_lv, w_lv = level.shape
        if h_lv == 0 or w_lv == 0:
            break
        b_lv = band0 >> lv
        sel = (slice(0, 1), slice(c, c + 1), slice(z, z + 1),
               slice(b_lv, b_lv + h_lv), slice(0, w_lv))
        writer.write_level(lv, level[None, None, None], sel=sel)


def band_canvas_shape(tile_h: int, tile_w: int, band: int,
                      width: int) -> Tuple[int, int, int, int]:
    """(1, 1, rows, cols) of a band canvas: a one-tile apron above and
    below the band and one tile to the right of the width, the row length
    rounded up to a multiple of 8 elements, so every canvas row starts
    16-byte aligned in uint16 (32 in float32) and the kernels store whole
    16-byte vectors. The padding columns are never read back."""
    return (1, 1, tile_h + band + tile_h, -(-(width + tile_w) // 8) * 8)


def partition_jobs_by_band(jobs: Sequence, tile_h: int, height: int,
                           band: int):
    """Group jobs by (channel, z, band_start), preserving plan order
    within each band. A job appears in every band its cropped window
    intersects; ``is_primary`` is True only for its first band.

    Returns (tasks dict, n_jobs)."""
    tasks: Dict[Tuple[int, int, int], List] = {}
    n_jobs = 0
    for job in jobs:
        top, bottom = job.crops[0], job.crops[1]
        y0e = job.y + top
        y1e = min(job.y + tile_h - bottom, height)
        if y1e <= y0e:
            continue
        n_jobs += 1
        first = True
        for b in range(y0e // band, (y1e - 1) // band + 1):
            tasks.setdefault((job.channel_idx, job.z_level,
                              b * band), []).append((job, first))
            first = False
    return tasks, n_jobs


class DeviceStreamingFuser:
    """Device-resident Y-band fusion feeding a MultiscaleWriter."""

    def __init__(self, writer: MultiscaleWriter,
                 height: int, width: int, tile_h: int, tile_w: int, dtype,
                 num_levels: int, downsample_mode: str = 'nearest',
                 chunk_rows: int = 2048, batch_size: int = 8,
                 reader_threads: int = 4,
                 ff_recip: Optional[np.ndarray] = None,
                 blend_method: str = 'overwrite', blend_px: int = 64,
                 device: torch.device = torch.device('cuda')):
        if blend_method not in ('overwrite', 'feather'):
            raise ValueError(f"unknown blend_method {blend_method!r}")
        self.writer = writer
        self.height, self.width = height, width
        self.tile_h, self.tile_w = tile_h, tile_w
        self.dtype = np.dtype(dtype)
        self.tdtype = torch_dtype(dtype)
        self.num_levels = num_levels
        self.mode = downsample_mode
        self.band = band_rows_for(chunk_rows, num_levels)
        self.batch_size = batch_size
        self.reader_threads = reader_threads
        self.ff_recip = ff_recip
        self.blend = blend_method
        self.blend_px = blend_px
        self.device = torch.device(device)
        self._ff_device: Optional[torch.Tensor] = None  # one upload per run
        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == 'cuda' else None)
        #: batches placed (one placement kernel launch each on CUDA)
        self.batches = 0
        #: wall seconds: 'fuse' (main thread, loads + uploads + launches),
        #: 'readback_wait' and 'write' (writer thread), 'close' (the
        #: writer's last chunks encoded and written after the last band)
        self.stats = {'fuse': 0.0, 'readback_wait': 0.0, 'write': 0.0,
                      'close': 0.0}

    def _fuse_band(self, band_c: int, band0: int, band_jobs: Sequence,
                   progress_cb=None, stop_check=None):
        th, tw = self.tile_h, self.tile_w
        rows = min(self.band, self.height - band0)
        shape = band_canvas_shape(th, tw, self.band, self.width)
        if self.blend == 'feather':
            acc = torch.zeros(shape, dtype=torch.float32, device=self.device)
            wsum = torch.zeros(shape, dtype=torch.float32, device=self.device)
        else:
            canvas = torch.zeros(shape, dtype=self.tdtype, device=self.device)
        if self._ff_device is None and self.ff_recip is not None:
            self._ff_device = torch.from_numpy(
                np.ascontiguousarray(self.ff_recip, np.float32)
            ).to(self.device)
        # the band canvas is one (c, z) plane: the batch's c is zeroed,
        # so the kernel gets this band's single-channel field
        ff_band = (self._ff_device[band_c:band_c + 1]
                   if self._ff_device is not None else None)
        jobs = [j for j, _ in band_jobs]
        primaries = [p for _, p in band_jobs]
        loader = TileBatchLoader(jobs, self.batch_size, th, tw, self.dtype,
                                 num_threads=self.reader_threads,
                                 pin_memory=self.device.type == 'cuda')
        consumed = 0
        for batch in loader:
            if stop_check is not None:
                stop_check()
            tiles = batch.tiles.to(self.device, non_blocking=True)
            # band-local coordinates: the +th apron keeps origins >= 0 for
            # every real job; padding entries pin to 0
            dinfo = np.zeros_like(batch.info)
            dinfo[:, 2] = np.where(batch.valid, batch.info[:, 2] - band0 + th, 0)
            dinfo[:, 3] = np.where(batch.valid, batch.info[:, 3], 0)
            meta = (torch.from_numpy(dinfo), torch.from_numpy(batch.crops),
                    torch.from_numpy(batch.valid))
            if self.blend == 'feather':
                cuda_fuse.fuse_feather(acc, wsum, tiles, *meta,
                                       ff_recip=ff_band,
                                       blend_px=self.blend_px)
            else:
                cuda_fuse.fuse_overwrite(canvas, tiles, *meta,
                                         ff_recip=ff_band)
            self.batches += 1
            if progress_cb is not None:
                for p in primaries[consumed:consumed + batch.count]:
                    if p:
                        progress_cb()
            consumed += batch.count
        if self.blend == 'feather':
            # finalize the real rows on the device; only they come back
            out = cuda_fuse.finalize_feather(acc, wsum, self.tdtype,
                                             (th, th + rows),
                                             (0, self.width))[0, 0]
            return self._readback(out, out)
        return self._readback(canvas, canvas[0, 0, th:th + rows, :self.width])

    def _readback(self, canvas: torch.Tensor, out: torch.Tensor):
        """Start the band's copy to host; returns (host tensor, event to
        wait on before reading it, or None when it is ready)."""
        if self._side is None:
            return out.clone(), None
        host = torch.empty(tuple(out.shape), dtype=out.dtype, pin_memory=True)
        self._side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._side):
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._side)
        # the caching allocator must not hand the canvas to the next band
        # before the side stream has read it
        canvas.record_stream(self._side)
        return host, done

    def run(self, jobs: Sequence,
            progress_cb: Optional[Callable[[int, int], None]] = None,
            stop_check: Optional[Callable] = None) -> None:
        """Fuse all jobs band by band; one writer thread behind a bounded
        hand-off (one band in flight) writes while the next band fuses.
        Bands target disjoint rows, so write order across bands does not
        change the output."""
        tasks, n_jobs = partition_jobs_by_band(jobs, self.tile_h,
                                               self.height, self.band)
        done = [0]

        def progress():
            done[0] += 1
            if progress_cb is not None:
                progress_cb(done[0], n_jobs)

        handoff: "queue.Queue" = queue.Queue(maxsize=1)
        write_err: List[BaseException] = []

        def writer_loop():
            while True:
                item = handoff.get()
                if item is None:
                    return
                c, z, band0, host, event = item
                try:
                    t0 = time.perf_counter()
                    if event is not None:
                        event.synchronize()
                    t1 = time.perf_counter()
                    write_band_levels(self.writer, c, z, band0, host.numpy(),
                                      self.num_levels, self.mode)
                    self.stats['readback_wait'] += t1 - t0
                    self.stats['write'] += time.perf_counter() - t1
                except BaseException as e:  # surfaced on the main thread
                    write_err.append(e)
                    return

        wt = threading.Thread(target=writer_loop, name='band-writer',
                              daemon=True)
        wt.start()
        fuse_exc = None
        try:
            # (z, band0, c) order: all channels of one band row finish
            # close together
            for key in sorted(tasks.keys(), key=lambda k: (k[1], k[2], k[0])):
                if stop_check is not None:
                    stop_check()
                if write_err:
                    break
                c, z, band0 = key
                t0 = time.perf_counter()
                host, event = self._fuse_band(c, band0, tasks[key], progress,
                                              stop_check=stop_check)
                self.stats['fuse'] += time.perf_counter() - t0
                while not write_err:
                    try:
                        handoff.put((c, z, band0, host, event), timeout=0.5)
                        break
                    except queue.Full:
                        continue
                host = event = None
        except BaseException as e:
            fuse_exc = e
        # stop the writer; on an error, drop a band still waiting in the
        # hand-off rather than write it for a run being abandoned
        while wt.is_alive():
            if fuse_exc is not None:
                try:
                    handoff.get_nowait()
                except queue.Empty:
                    pass
            try:
                handoff.put(None, timeout=0.5)
                break
            except queue.Full:
                continue
        wt.join()
        if fuse_exc is not None or write_err:
            # chunks still queued for encoding would land in the tree
            # after the error is reported
            self.writer.abort()
            raise fuse_exc if fuse_exc is not None else write_err[0]
        t0 = time.perf_counter()
        self.writer.close()
        self.stats['close'] = time.perf_counter() - t0
