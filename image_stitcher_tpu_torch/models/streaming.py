"""Streaming fusion: tiles -> OME-Zarr or OME-TIFF with bounded memory.

The counterpart of the JAX package's ``models/streaming.py``: its
``DeviceStreamingFuser``, its host ``StreamingFuser`` (for
``fusion_device='host'``, bands fused by a thread pool through
``csrc/hostops.c``; see :class:`StreamingFuser`), the ``FlatfieldGate``
that lets host bands start as each channel's field lands, and the
helpers they share. On the device path:
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

import itertools
import mmap
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..io.omezarr import MultiscaleWriter
from ..io.readers import TileBatchLoader, device_dtype
from ..ops import cuda_fuse
from ..ops.host_fuse import (downsample2x_native, finalize_feather_host,
                             place_window)
from ..ops.pyramid import host_downsample


def band_rows_for(chunk_rows: int, num_levels: int) -> int:
    """Band height: >= one chunk row, multiple of 2^(num_levels-1)."""
    align = 1 << max(0, num_levels - 1)
    return max(chunk_rows, ((chunk_rows + align - 1) // align) * align)


def band_levels(buf: np.ndarray, num_levels: int, mode: str):
    """Yield a finished band and its pyramid folds, level from level, up
    to ``num_levels`` levels or the first empty one (band rows are a
    multiple of 2^(levels-1), so pooling windows never cross bands)."""
    level = buf
    for lv in range(num_levels):
        if lv > 0:
            level = host_downsample(level, mode)
        if level.shape[0] == 0 or level.shape[1] == 0:
            return
        yield level


def write_band_levels(writer, c: int, z: int, band0: int, levels,
                      first_level: int = 0) -> bool:
    """Write one finished (c, z) band's levels (:func:`band_levels`),
    the first of them at level ``first_level`` (1 when level 0 went out
    as chunk-column blocks). ``band0`` is in level-0 rows. The writer is
    a :class:`MultiscaleWriter` or an OME-TIFF ``StreamingTiffWriter``.
    Returns True when the writer is done with the first level (the
    caller may reuse it); the OME-TIFF writer keeps views of the rows
    until their 256-row strips complete."""
    released = None
    for i, level in enumerate(levels):
        lv = first_level + i
        h_lv, w_lv = level.shape
        b_lv = band0 >> lv
        sel = (slice(0, 1), slice(c, c + 1), slice(z, z + 1),
               slice(b_lv, b_lv + h_lv), slice(0, w_lv))
        r = writer.write_level(lv, level[None, None, None], sel=sel)
        if i == 0:
            released = r
    return released is True


def write_behind(items: Iterable, write: Callable, writer) -> None:
    """Call ``write(item)`` for each item of ``items`` on one writer
    thread, behind a hand-off that holds one item, while the caller's
    thread produces the next. An error on either side stops both: a band
    still waiting in the hand-off is dropped, ``writer`` is aborted (its
    queued chunks must not land after the error is reported) and the
    error is raised here. On success the caller closes the writer."""
    handoff: "queue.Queue" = queue.Queue(maxsize=1)
    write_err: List[BaseException] = []

    def writer_loop():
        while True:
            item = handoff.get()
            if item is None:
                return
            try:
                write(item)
            except BaseException as e:  # surfaced on the caller's thread
                write_err.append(e)
                return
            del item       # written: not kept alive while the next waits

    wt = threading.Thread(target=writer_loop, name='band-writer',
                          daemon=True)
    wt.start()
    failure = None
    try:
        for item in items:
            while not write_err:
                try:
                    handoff.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            item = None
            if write_err:
                break
    except BaseException as e:
        failure = e
    while wt.is_alive():
        if failure is not None:
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
    if failure is not None or write_err:
        writer.abort()
        raise failure if failure is not None else write_err[0]


def band_canvas_shape(tile_h: int, tile_w: int, band: int,
                      width: int) -> Tuple[int, int, int, int]:
    """(1, 1, rows, cols) of a band canvas: a one-tile apron above and
    below the band and one tile to the right of the width, the row length
    rounded up to a multiple of 8 elements, so every canvas row starts
    16-byte aligned in uint16 (32 in float32) and the kernels store whole
    16-byte vectors. The padding columns are never read back."""
    return (1, 1, tile_h + band + tile_h, -(-(width + tile_w) // 8) * 8)


def partition_jobs_by_band(jobs: Sequence, tile_h: int, height: int,
                           band: int,
                           planes: Optional[Tuple[int, int]] = None):
    """Group jobs by (channel, z, band_start), preserving plan order
    within each band. A job appears in every band its cropped window
    intersects; ``is_primary`` is True only for its first band. With
    ``planes`` (C, Z), every band of every (c, z) plane is a task, those
    no tile reaches with no jobs (:func:`writer_planes`).

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
    if planes is not None:
        for key in itertools.product(range(planes[0]), range(planes[1]),
                                     range(0, height, band)):
            tasks.setdefault(key, [])
    return tasks, n_jobs


def writer_planes(writer) -> Optional[Tuple[int, int]]:
    """(C, Z) of a writer that must be handed every row of every plane,
    else None. The OME-TIFF writer refuses to close a page with rows
    missing, so the band fusers write the bands no tile reaches as
    zeros for it (the JAX package's band paths raise there; its in-RAM
    path and its mesh, which save whole canvases, write those zeros).
    The zarr writers leave such rows unwritten, as the JAX package's
    band paths do."""
    if getattr(writer, 'needs_every_row', False):
        return writer.num_c, writer.num_z
    return None


def band_order(keys, chunk_z: int = 1) -> List[Tuple[int, int, int]]:
    """(c, z, band0) band keys in write order: (z // chunk_z, band0, z, c).
    With one-plane chunks that is (z, band0, c), the JAX package's order,
    in which all channels of a band row finish close together; with
    chunks ``chunk_z`` planes deep, every plane of a chunk's z group
    finishes a band row before any plane starts the next, so a chunk row
    is complete once its last plane's band is written and the writer's
    buffer holds at most one band row of one z group."""
    return sorted(keys, key=lambda k: (k[1] // chunk_z, k[2], k[1], k[0]))


class FlatfieldGate:
    """Per-channel flatfield readiness gate.

    The fit runs channel by channel; fusing channel c needs only channel
    c's field. The overlapped fit publishes each field as it lands, so
    the host band fuser starts a channel's bands while later channels are
    still solving. ``recip`` is the shared (C, th, tw) reciprocal stack;
    row c is immutable once its event is set, so readers gated on
    ``wait(c)`` never see a partial row."""

    def __init__(self, num_c: int, tile_hw: Tuple[int, int]):
        self.recip = np.ones((num_c,) + tuple(tile_hw), np.float32)
        self._events = [threading.Event() for _ in range(num_c)]
        self._error: Optional[BaseException] = None

    def publish(self, c: int, field: Optional[np.ndarray]) -> None:
        """Record channel ``c``'s fitted field (None keeps identity)."""
        if field is not None:
            np.divide(1.0, field, out=self.recip[c])
        self._events[c].set()

    def finish(self) -> None:
        """All fits done: release channels that never got a field."""
        for e in self._events:
            e.set()

    def fail(self, exc: BaseException) -> None:
        """Unblock every waiter with the fit's error (raised there with
        its own type, so a cancellation stays a cancellation)."""
        self._error = exc
        for e in self._events:
            e.set()

    def wait(self, c: int) -> np.ndarray:
        self._events[c].wait()
        if self._error is not None:
            raise self._error
        return self.recip


class StreamingFuser:
    """Host band fusion (``fusion_device='host'``): the twin of
    :class:`DeviceStreamingFuser` on a thread pool, feeding a
    MultiscaleWriter or an OME-TIFF ``StreamingTiffWriter``.

    Each (c, z, band) task fills a band buffer with
    ``ops/host_fuse.place_window`` (the C loops of ``csrc/hostops.c``)
    in plan order, finalizes a feathered band in C, and writes it with
    its pyramid folded in C, on the task's own thread. Tasks run in
    :func:`band_order` ((z, band0, c) for one-plane chunks), so all
    channels of one band row finish close together: the RGB OME-TIFF
    writer, which interleaves the three channel bands of a page strip,
    parks at most a few bands. ``chunk_planes`` is (channels, z planes)
    a chunk spans. With ``ff_gate`` a band first waits for its channel's
    field.

    Chunk-column block mode (the JAX package's): for overwrite blending
    into a writer whose level 0 takes block writes (raw chunks, v2 or
    v3; ``writer.block_spec``), with a band a whole number of chunk rows,
    an even chunk width and a uint8/uint16 canvas (the C fold's), the
    band lives as (ncx, band, cx)
    chunk-shaped blocks in a page-aligned pool, and each level-0 chunk
    file is one contiguous write straight from it, made from the band's
    own thread: a band's level-0 chunk files belong to it alone. Level 1
    is folded block by block into one strided array.

    The fill skip: an overwrite band whose tiles' nominal windows cover
    it whole (:meth:`_band_covered`) is not zeroed first. A loaded tile
    smaller than the nominal one breaks that proof: the band is zeroed
    and its placements replayed, and every later band is zeroed up
    front.

    Every other level, and every write of a writer without blocks (blosc
    chunks, chunks over several planes, OME-TIFF), goes through one
    hand-off: those writers take one chunk group's rows in order, from
    one thread at a time (the zarr writers encode a chunk row once every
    plane of its group has written or passed it, and their buffers hold
    no lock).
    So a band's levels reach the writer under one lock, in the task order
    within its chunk group (:meth:`_write_in_order`; a group is the planes
    that share chunk files, one plane for one-plane chunks): a band done
    before an earlier band of its group parks its levels, and the thread
    that writes the earlier band writes it too.

    A thread's overwrite band buffer is reused for its next band only
    when the writer released it (``write_band_levels``); a parked band,
    or one the OME-TIFF writer keeps views of, leaves the thread a fresh
    buffer. A block-mode band parks only its freshly folded levels."""

    def __init__(self, writer, height: int, width: int, tile_h: int,
                 tile_w: int, dtype, num_levels: int,
                 downsample_mode: str = 'nearest', chunk_rows: int = 2048,
                 num_threads: int = 2, ff_recip: Optional[np.ndarray] = None,
                 blend_method: str = 'overwrite', blend_px: int = 64,
                 ff_gate: Optional[FlatfieldGate] = None,
                 chunk_planes: Tuple[int, int] = (1, 1)):
        if blend_method not in ('overwrite', 'feather'):
            raise ValueError(f"unknown blend_method {blend_method!r}")
        self.writer = writer
        self.height, self.width = height, width
        self.tile_h, self.tile_w = tile_h, tile_w
        self.dtype = np.dtype(dtype)
        self.num_levels = num_levels
        self.mode = downsample_mode
        self.band = band_rows_for(chunk_rows, num_levels)
        self.num_threads = num_threads
        self.ff_recip = ff_recip
        self.ff_gate = ff_gate
        self.blend = blend_method
        self.blend_px = blend_px
        self.chunk_c, self.chunk_z = chunk_planes
        #: wall seconds summed over the band threads: 'gate' (waiting for
        #: a channel's field), 'fill' (the band buffer zeroed), 'decode',
        #: 'place', 'finalize', 'pyramid' (the folds), 'write' (the
        #: writer, the hand-off's waits included), and 'close' (the
        #: writer's close)
        self.stats = {'gate': 0.0, 'fill': 0.0, 'decode': 0.0, 'place': 0.0,
                      'finalize': 0.0, 'pyramid': 0.0, 'write': 0.0,
                      'close': 0.0}
        #: the same stages in on-core seconds (``time.thread_time``): on a
        #: busy host the wall sums bill waits to whatever stage held the
        #: thread; these bound a run with every core to itself
        self.cpu: Dict[str, float] = {}
        #: band tasks run; time.perf_counter() when the first one passed
        #: its gate; level-0 chunk-column blocks the raw writer took
        #: whole, and those it refused (written as rows instead); bands
        #: whose fill was skipped (covered, and not replayed)
        self.bands = 0
        self.first_band_at: Optional[float] = None
        self.blocks = 0
        self.block_refusals = 0
        self.fill_skips = 0
        self._lock = threading.Lock()
        self._tl = threading.local()
        # the fill skip's coverage proofs rest on the nominal tile dims;
        # False once a loaded tile contradicted them
        self._nominal_dims_ok = True
        self._block_cx = 0
        spec = getattr(writer, 'block_spec', None)
        bs = spec(0) if spec is not None and blend_method == 'overwrite' \
            else None
        # an EVEN chunk width: level 1 is folded block by block, and no
        # 2-column window may straddle two blocks; the fold is the C one
        if (bs and bs[0] > 0 and self.band % bs[0] == 0 and bs[1] % 2 == 0
                and self.dtype in (np.dtype(np.uint8), np.dtype(np.uint16))
                and downsample_mode in ('nearest', 'mean')):
            self._block_cx = int(bs[1])
        #: chunk-column blocks a band writes at level 0 (0: no block mode)
        self.block_cols = -(-width // self._block_cx) if self._block_cx else 0
        # group-order hand-off (set up by run()): each chunk group's next
        # band to write, each band's successor in its group, the parked
        # bands; a band is its (c, z, band0) key
        self._write_lock = threading.Lock()
        self._next: Dict[Tuple[int, int], Optional[Tuple]] = {}
        self._succ: Dict[Tuple[int, int, int], Optional[Tuple]] = {}
        self._parked: Dict[Tuple[int, int, int], Tuple[List, int]] = {}
        self._left: Dict[int, int] = {}   # bands of a z group not written

    def _tick(self, key: str, t0: float) -> float:
        """Add the wall time since ``t0`` and this thread's on-core time
        since its last tick (or :meth:`_cpu_mark`) to stage ``key``."""
        t1 = time.perf_counter()
        c1 = time.thread_time()
        c0 = getattr(self._tl, 'cpu0', c1)
        with self._lock:
            self.stats[key] += t1 - t0
            self.cpu[key] = self.cpu.get(key, 0.0) + (c1 - c0)
        self._tl.cpu0 = c1
        return t1

    def _cpu_mark(self) -> None:
        """Start an on-core segment on this thread, so the first tick
        after a gap that no stage owns (the pool's scheduling) does not
        absorb it."""
        self._tl.cpu0 = time.thread_time()

    @staticmethod
    def _pool(shape: Tuple[int, ...], dtype: np.dtype) -> np.ndarray:
        """A zeroed buffer on an anonymous mmap: page-aligned, as
        O_DIRECT block writes need."""
        n = int(np.prod(shape))
        mm = mmap.mmap(-1, max(n * dtype.itemsize, mmap.PAGESIZE))
        return np.frombuffer(mm, dtype, count=n).reshape(shape)

    def _place_in_band(self, buf, band0: int, rows: int, job,
                       tile: np.ndarray) -> None:
        top, bottom, left, right = job.crops
        th, tw = tile.shape
        # the full crop window in tile coordinates, from the loaded shape
        # (feather ramps measure from its edges), then the canvas and
        # band clamps of the visible part
        wy1 = th - bottom if bottom else th
        wx1 = tw - right if right else tw
        y0, y1 = top, wy1
        x0, x1 = left, wx1
        yy, xx = job.y + top, job.x + left
        y1 = min(y1, y0 + (self.height - yy))
        x1 = min(x1, x0 + (self.width - xx))
        if yy < band0:
            y0 += band0 - yy
            yy = band0
        y1 = min(y1, y0 + (band0 + rows - yy))
        if y1 <= y0 or x1 <= x0:
            return
        c = job.channel_idx
        ff_c = self.ff_recip[c] if self.ff_recip is not None else None
        if self._block_cx:
            # chunk-column blocks: the window split at chunk columns, each
            # segment placed into its block
            cx = self._block_cx
            for cxi in range(xx // cx, (xx + (x1 - x0) - 1) // cx + 1):
                gx0 = max(xx, cxi * cx)
                gx1 = min(xx + (x1 - x0), (cxi + 1) * cx)
                tx0 = x0 + (gx0 - xx)
                place_window(buf[cxi], tile, ff_c, y0, y1, tx0,
                             tx0 + (gx1 - gx0), yy - band0, gx0 - cxi * cx)
            return
        feather = ((top, wy1, left, wx1, 1.0 / float(self.blend_px))
                   if self.blend == 'feather' else None)
        place_window(buf, tile, ff_c, y0, y1, x0, x1, yy - band0, xx,
                     feather=feather)

    def _band_covered(self, jobs: Sequence, band0: int, rows: int) -> bool:
        """True iff the jobs' nominal visible rects tile the whole band
        (the JAX package's test, as it is): an overwrite band then skips
        its zero fill, every pixel being written anyway. The rects use
        the NOMINAL tile dims; :meth:`_process_band` checks each loaded
        tile against them and replays a zeroed band on a mismatch, so
        the output never rests on this estimate. A y-sweep over the
        rects' row boundaries: each slab's x intervals must span
        [0, width)."""
        if not self._nominal_dims_ok:
            return False
        th, tw = self.tile_h, self.tile_w
        b_lo, b_hi = band0, band0 + rows
        rects = []
        for job, _ in jobs:
            top, bottom, left, right = job.crops
            y0 = max(job.y + top, b_lo)
            y1 = min(job.y + (th - bottom if bottom else th),
                     self.height, b_hi)
            x0 = job.x + left
            x1 = min(job.x + (tw - right if right else tw), self.width)
            if y1 > y0 and x1 > x0 and y0 >= 0 and x0 >= 0:
                rects.append((y0, y1, x0, x1))
        if not rects:
            return rows <= 0
        rects.sort(key=lambda r: r[2])
        ys = sorted({v for r in rects for v in r[:2]} | {b_lo, b_hi})
        for ya, yb in zip(ys, ys[1:]):
            if yb <= b_lo or ya >= b_hi:
                continue
            reach = 0
            for y0, y1, x0, x1 in rects:
                if y0 <= ya and y1 >= yb:
                    if x0 > reach:
                        return False
                    reach = max(reach, x1)
            if reach < self.width:
                return False
        return True

    def _band_buffer(self, jobs: Sequence, band0: int, rows: int):
        """(buffer, filled) for a band: the thread's pooled feather pair,
        chunk-column blocks or row-major band, zeroed unless the band is
        covered (the blocks' pad columns past the width are zeroed even
        then: they land in the level-0 chunk files)."""
        if self.blend == 'feather':
            # acc/wsum never reach the writer: always reusable
            pair = getattr(self._tl, 'feather', None)
            if pair is None:
                pair = (np.empty((self.band, self.width), np.float32),
                        np.empty((self.band, self.width), np.float32))
                self._tl.feather = pair
            buf = (pair[0][:rows], pair[1][:rows])
            buf[0].fill(0.0)
            buf[1].fill(0.0)
            return buf, True
        if self._block_cx:
            cx = self._block_cx
            pooled = getattr(self._tl, 'blocks', None)
            if pooled is None:
                pooled = self._tl.blocks = self._pool(
                    (self.block_cols, self.band, cx), self.dtype)
            buf = pooled[:, :rows]
        else:
            pooled = getattr(self._tl, 'band', None)
            if pooled is None:
                pooled = self._tl.band = self._pool((self.band, self.width),
                                                    self.dtype)
            buf = pooled[:rows]
        if not self._band_covered(jobs, band0, rows):
            buf.fill(0)
            return buf, True
        if self._block_cx:
            tail0 = self.width - (buf.shape[0] - 1) * self._block_cx
            if tail0 < self._block_cx:
                buf[-1][:, tail0:] = 0
        return buf, False

    def _process_band(self, c: int, z: int, band0: int, jobs: Sequence,
                      load_fn: Callable, progress_cb=None,
                      stop_check=None) -> None:
        t0 = time.perf_counter()
        self._cpu_mark()
        if self.ff_gate is not None:
            # parks until channel c's field lands; the fit publishes the
            # channels in order, so only later channels' first bands wait
            self.ff_recip = self.ff_gate.wait(c)
        t0 = self._tick('gate', t0)
        with self._lock:
            self.bands += 1
            if self.first_band_at is None:
                self.first_band_at = t0
        rows = min(self.band, self.height - band0)
        buf, filled = self._band_buffer(jobs, band0, rows)
        self._tick('fill', t0)
        nominal = (self.tile_h, self.tile_w)
        reported = -1   # the last job whose progress fired
        i = 0
        while i < len(jobs):
            job, is_primary = jobs[i]
            if stop_check is not None:
                stop_check()
            t0 = time.perf_counter()
            tile = load_fn(job)
            t0 = self._tick('decode', t0)
            if not filled and tile.shape[-2:] != nominal:
                # a tile unlike its nominal rect breaks the coverage proof
                # the skipped fill rested on: zero the band and replay its
                # placements (progress does not fire twice); later bands
                # fill up front rather than each paying a replay
                self._nominal_dims_ok = False
                buf.fill(0)
                filled = True
                i = 0
                continue
            self._place_in_band(buf, band0, rows, job, tile)
            self._tick('place', t0)
            if progress_cb is not None and is_primary and i > reported:
                reported = i
                progress_cb()
            i += 1
        if not filled:
            with self._lock:
                self.fill_skips += 1
        t0 = time.perf_counter()
        if self._block_cx:
            self._tick('finalize', t0)
            self._write_blocks(c, z, band0, buf)
            return
        if self.blend == 'feather':
            buf = finalize_feather_host(buf[0], buf[1], self.dtype)
        t0 = self._tick('finalize', t0)
        # the folds run on this thread, outside the write lock
        levels = list(band_levels(buf, self.num_levels, self.mode))
        t0 = self._tick('pyramid', t0)
        released = self._write_in_order(c, z, band0, levels)
        self._tick('write', t0)
        if not released and self.blend != 'feather':
            # the band is parked, or the writer keeps views of it: the
            # thread's next band gets a fresh buffer
            self._tl.band = None

    def _write_blocks(self, c: int, z: int, band0: int,
                      blocks: np.ndarray) -> None:
        """Block-mode output: level 0 chunk by chunk straight from the
        pool (one contiguous write a chunk file, no lock: these chunk
        files are the band's alone), level 1 folded block by block into
        one strided array (chunk widths are even, so no 2x2 window
        straddles two blocks: the row-major band's fold, byte for byte),
        the deeper levels folded from it; levels >= 1 through the plane
        -order hand-off. The writer releases every block (raw writes are
        synchronous), so the pool is reused."""
        ncx, rows, cx = blocks.shape
        t0 = time.perf_counter()
        taken = sum(self.writer.write_level_block(0, c, z, band0, cxi,
                                                  blocks[cxi])
                    for cxi in range(ncx))
        with self._lock:
            self.blocks += taken
            self.block_refusals += ncx - taken
        t0 = self._tick('write', t0)
        w1, h1, cw1 = self.width // 2, rows // 2, cx // 2
        levels: List[np.ndarray] = []
        if self.num_levels > 1 and h1 and w1:
            level1 = np.empty((h1, ncx * cw1), self.dtype)
            for i in range(ncx):
                downsample2x_native(blocks[i], self.mode,
                                    level1[:, i * cw1:(i + 1) * cw1])
            levels = list(band_levels(level1[:, :w1], self.num_levels - 1,
                                      self.mode))
        t0 = self._tick('pyramid', t0)
        # every band of a plane takes its turn, with or without levels
        self._write_in_order(c, z, band0, levels, 1)
        self._tick('write', t0)

    def _write_in_order(self, c: int, z: int, band0: int,
                        levels: List[np.ndarray],
                        first_level: int = 0) -> bool:
        """Write a band's levels (the first at ``first_level``) once every
        band before it in its chunk group's order is written, then the
        parked later bands that this unblocks; a band whose predecessor is
        still fusing parks. Returns True when this band was written and
        the writer released its first level."""
        key = (c, z, band0)
        group = (c // self.chunk_c, z // self.chunk_z)
        with self._write_lock:
            if self._next[group] != key:
                self._parked[key] = (levels, first_level)
                return False
            released = write_band_levels(self.writer, c, z, band0, levels,
                                         first_level)
            self._written(key)
            nxt = self._succ[key]
            while nxt is not None and nxt in self._parked:
                write_band_levels(self.writer, *nxt,
                                  *self._parked.pop(nxt))
                self._written(nxt)
                nxt = self._succ[nxt]
            self._next[group] = nxt
            return released

    def _written(self, key: Tuple[int, int, int]) -> None:
        """Count a band written (under the write lock); after the last
        band of a z group, the writer encodes that group's chunk rows."""
        zg = key[1] // self.chunk_z
        self._left[zg] -= 1
        finish = getattr(self.writer, 'finish_group', None)
        if not self._left[zg] and finish is not None:
            finish(0, key[1])

    def run(self, jobs: Sequence, load_fn: Callable,
            progress_cb: Optional[Callable[[int, int], None]] = None,
            stop_check: Optional[Callable] = None) -> None:
        """Fuse all jobs through band tasks on ``num_threads`` threads,
        then close the writer; a failed or cancelled run stops the pool,
        aborts the writer and raises."""
        tasks, n_jobs = partition_jobs_by_band(jobs, self.tile_h,
                                               self.height, self.band,
                                               writer_planes(self.writer))
        done = [0]

        def progress():
            with self._lock:
                done[0] += 1
                n = done[0]
            if progress_cb is not None:
                progress_cb(n, n_jobs)

        cancelled = [False]

        def run_task(key):
            if cancelled[0]:
                return
            if stop_check is not None:
                stop_check()
            c, z, band0 = key
            self._process_band(c, z, band0, tasks[key], load_fn, progress,
                               stop_check=stop_check)

        self._parked.clear()
        self._next.clear()
        self._succ.clear()
        self._left.clear()
        order = band_order(tasks, self.chunk_z)
        for key in reversed(order):
            group = (key[0] // self.chunk_c, key[1] // self.chunk_z)
            self._succ[key] = self._next.get(group)
            self._next[group] = key
            self._left[group[1]] = self._left.get(group[1], 0) + 1
        pool = ThreadPoolExecutor(self.num_threads,
                                  thread_name_prefix='host-band')
        try:
            list(pool.map(run_task, order))
        except BaseException:
            cancelled[0] = True
            pool.shutdown(wait=True, cancel_futures=True)
            # chunks or strips still queued must not land after the error
            self.writer.abort()
            raise
        finally:
            pool.shutdown(wait=True)
        t0 = time.perf_counter()
        self._cpu_mark()
        self.writer.close()
        self._tick('close', t0)


class DeviceStreamingFuser:
    """Device-resident Y-band fusion feeding a MultiscaleWriter or an
    OME-TIFF ``StreamingTiffWriter``, band by band in :func:`band_order`
    (``chunk_z``: the z planes a chunk spans). The band contents do not
    depend on the order, only when each reaches the writer."""

    def __init__(self, writer: MultiscaleWriter,
                 height: int, width: int, tile_h: int, tile_w: int, dtype,
                 num_levels: int, downsample_mode: str = 'nearest',
                 chunk_rows: int = 2048, batch_size: int = 8,
                 reader_threads: int = 4,
                 ff_recip: Optional[np.ndarray] = None,
                 blend_method: str = 'overwrite', blend_px: int = 64,
                 device: torch.device = torch.device('cuda'),
                 chunk_z: int = 1):
        if blend_method not in ('overwrite', 'feather'):
            raise ValueError(f"unknown blend_method {blend_method!r}")
        self.writer = writer
        self.height, self.width = height, width
        self.tile_h, self.tile_w = tile_h, tile_w
        self.dtype = np.dtype(dtype)
        self.tdtype = device_dtype(dtype)
        self.num_levels = num_levels
        self.mode = downsample_mode
        self.band = band_rows_for(chunk_rows, num_levels)
        self.batch_size = batch_size
        self.reader_threads = reader_threads
        self.ff_recip = ff_recip
        self.blend = blend_method
        self.blend_px = blend_px
        self.device = torch.device(device)
        self.chunk_z = chunk_z
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
                                               self.height, self.band,
                                               writer_planes(self.writer))
        done = [0]

        def progress():
            done[0] += 1
            if progress_cb is not None:
                progress_cb(done[0], n_jobs)

        order = band_order(tasks, self.chunk_z)
        finish = getattr(self.writer, 'finish_group', None)

        def fused():
            for i, key in enumerate(order):
                if stop_check is not None:
                    stop_check()
                c, z, band0 = key
                t0 = time.perf_counter()
                host, event = self._fuse_band(c, band0, tasks[key], progress,
                                              stop_check=stop_check)
                self.stats['fuse'] += time.perf_counter() - t0
                # the z group's last band: its chunk rows can be encoded
                last = (i + 1 == len(order) or order[i + 1][1] // self.chunk_z
                        != z // self.chunk_z)
                yield c, z, band0, host, event, last
                host = event = None     # the writer holds the band now

        def write(item):
            c, z, band0, host, event, last = item
            t0 = time.perf_counter()
            if event is not None:
                event.synchronize()
            t1 = time.perf_counter()
            write_band_levels(self.writer, c, z, band0,
                              band_levels(host.numpy(), self.num_levels,
                                          self.mode))
            if last and finish is not None:
                finish(0, z)
            self.stats['readback_wait'] += t1 - t0
            self.stats['write'] += time.perf_counter() - t1

        write_behind(fused(), write, self.writer)
        t0 = time.perf_counter()
        self.writer.close()
        self.stats['close'] = time.perf_counter() - t0
