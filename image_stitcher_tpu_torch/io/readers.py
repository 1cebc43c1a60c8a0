"""Threaded host-side tile loading: disk -> (pinned) batches for the device.

The counterpart of the JAX package's ``io/readers.py``: the same
``TileJob`` records and the same batch layout, with the tiles of a batch
filled into a torch tensor, pinned when the batches feed a CUDA device,
so their upload can run asynchronously.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from .acquisition import read_image


def load_tile_plane(job: "TileJob") -> np.ndarray:
    """Read the (th, tw) plane a TileJob refers to (RGB plane select,
    leading-singleton squeeze), mmap-backed with readahead started.

    When the job carries a fractional placement residual (subpixel
    global positions), the plane is bilinearly shifted by it here
    (:func:`subpixel_shift`), so fusion places subpixel-corrected
    content."""
    img = read_image(job.filepath, prefer_mmap=True, prefetch=True)
    if job.plane >= 0:
        img = img[:, :, job.plane]
    elif img.ndim == 3 and img.shape[0] == 1:
        img = img[0]
    if job.fy or job.fx:
        img = subpixel_shift(img, job.fy, job.fx)
    return img


def subpixel_shift(img: np.ndarray, fy: float, fx: float) -> np.ndarray:
    """Shift a (h, w) integer plane by (fy, fx) px with bilinear
    interpolation and replicated borders: out(y, x) = img(y - fy, x - fx).

    The JAX package calls ``cv2.warpAffine(img, [[1, 0, fx], [0, 1, fy]],
    INTER_LINEAR, BORDER_REPLICATE)``; this is that call as OpenCV 5.0
    computes it (its float warp kernels, not the older 1/32-px fixed-point
    tables): the source coordinate x + f32(-fx) in f32, its floor and
    fraction a, taps clamped to the plane, each pass p0 + a*(p1 - p0) as
    one fused multiply-add in f32 (horizontal, then vertical), rounded
    half to even and saturated to the dtype. Equal to cv2 byte for byte on
    the tested shapes."""
    from ..ops.flatfield import fma32
    h, w = img.shape
    info = np.iinfo(img.dtype)

    def taps(n: int, shift: float):
        pos = np.arange(n, dtype=np.float32) + np.float32(-shift)
        base = np.floor(pos)
        frac = pos - base
        i0 = base.astype(np.intp)
        return (np.clip(i0, 0, n - 1), np.clip(i0 + 1, 0, n - 1), frac)

    x0, x1, ax = taps(w, fx)
    y0, y1, ay = taps(h, fy)
    src = img.astype(np.float32)
    left = src[:, x0]
    hor = fma32(np.broadcast_to(ax, left.shape), src[:, x1] - left, left)
    top = hor[y0]
    out = fma32(np.broadcast_to(ay[:, None], top.shape), hor[y1] - top, top)
    return np.clip(np.rint(out), info.min, info.max).astype(img.dtype)


@dataclass(frozen=True)
class TileJob:
    """One monochrome plane destined for the canvas."""
    filepath: str
    plane: int            # -1 = grayscale file, 0/1/2 = RGB plane index
    channel_idx: int      # index into monochrome channels
    z_level: int
    y: int                # pre-crop top-left in canvas coords
    x: int
    crops: Tuple[int, int, int, int]  # top, bottom, left, right
    fy: float = 0.0       # fractional placement residual (subpixel mode)
    fx: float = 0.0


@dataclass
class TileBatch:
    tiles: torch.Tensor   # (N, th, tw) native dtype, host (pinned for CUDA)
    info: np.ndarray      # (N, 4) int32 [c, z, y, x]
    crops: np.ndarray     # (N, 4) int32
    valid: np.ndarray     # (N,) bool
    count: int            # number of real (non-padding) entries


class TileBatchLoader:
    """Iterates fixed-size TileBatches with background prefetch.

    Batches have a static shape (batch_size, tile_h, tile_w); the
    trailing batch is padded with valid=False entries."""

    def __init__(self, jobs: Sequence[TileJob], batch_size: int,
                 tile_h: int, tile_w: int, dtype,
                 num_threads: int = 8, prefetch: int = 2,
                 pin_memory: bool = False):
        self.jobs = list(jobs)
        self.batch_size = batch_size
        self.tile_h, self.tile_w = tile_h, tile_w
        self.dtype = np.dtype(dtype)
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.pin_memory = pin_memory

    def __len__(self) -> int:
        return (len(self.jobs) + self.batch_size - 1) // self.batch_size

    def _load_plane(self, args) -> Tuple[int, int]:
        job, dst = args
        img = load_tile_plane(job)
        h = min(img.shape[0], self.tile_h)
        w = min(img.shape[1], self.tile_w)
        dst[:h, :w] = img[:h, :w]
        if h < self.tile_h or w < self.tile_w:
            dst[h:, :] = 0
            dst[:h, w:] = 0
        return h, w

    def _build_batch(self, chunk: List[TileJob],
                     pool: ThreadPoolExecutor) -> TileBatch:
        n = self.batch_size
        tiles = torch.empty((n, self.tile_h, self.tile_w),
                            dtype=torch_dtype(self.dtype),
                            pin_memory=self.pin_memory)
        view = tiles.numpy()
        info = np.zeros((n, 4), np.int32)
        crops = np.zeros((n, 4), np.int32)
        valid = np.zeros((n,), bool)
        view[len(chunk):] = 0
        sizes = list(pool.map(self._load_plane,
                              [(job, view[i]) for i, job in enumerate(chunk)]))
        for i, (job, (h, w)) in enumerate(zip(chunk, sizes)):
            info[i] = (job.channel_idx, job.z_level, job.y, job.x)
            # undersized tiles fold the zero-pad deficit into the
            # bottom/right crops so padding never overwrites canvas
            # content
            top, bottom, left, right = job.crops
            crops[i] = (top, bottom + (self.tile_h - h),
                        left, right + (self.tile_w - w))
            valid[i] = True
        return TileBatch(tiles, info, crops, valid, len(chunk))

    def __iter__(self) -> Iterator[TileBatch]:
        chunks = [self.jobs[i:i + self.batch_size]
                  for i in range(0, len(self.jobs), self.batch_size)]
        if not chunks:
            return
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        abandoned = threading.Event()

        def put(item) -> bool:
            # never block forever: the consumer may abandon iteration
            while not abandoned.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
                try:
                    for chunk in chunks:
                        if not put(self._build_batch(chunk, pool)):
                            return
                except Exception as e:  # surfaced in the consumer
                    put(e)
                finally:
                    put(sentinel)

        t = threading.Thread(target=producer, name='tile-loader', daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
            t.join()
        finally:
            abandoned.set()


_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.uint16): torch.uint16}


def torch_dtype(dtype) -> torch.dtype:
    """The torch storage dtype of a tile dtype (uint8/uint16 only)."""
    try:
        return _TORCH_DTYPES[np.dtype(dtype)]
    except KeyError:
        raise TypeError(f"image_stitcher_tpu_torch fuses uint8 and uint16 "
                        f"tiles, not {np.dtype(dtype)}") from None


def expand_tile_jobs(monochrome_channels: Sequence[str],
                     rgb_channels: Sequence[str],
                     positions_and_crops) -> List[TileJob]:
    """Expand (TileRecord, (x, y) or (x, y, fx, fy), crops) triples into
    per-plane TileJobs; RGB tiles become three jobs (R/G/B planes into
    consecutive channels)."""
    jobs: List[TileJob] = []
    for rec, pos, crops in positions_and_crops:
        x, y = pos[0], pos[1]
        # (x, y, fx, fy): a subpixel position's fractional residual
        fy, fx = (pos[3], pos[2]) if len(pos) > 2 else (0.0, 0.0)
        if rec.channel in rgb_channels:
            base = rec.channel.split('_')[0]
            for plane, suffix in enumerate('RGB'):
                cidx = monochrome_channels.index(f"{base}_{suffix}")
                jobs.append(TileJob(rec.filepath, plane, cidx, rec.z_level,
                                    y, x, tuple(crops), fy, fx))
        else:
            cidx = monochrome_channels.index(rec.channel)
            jobs.append(TileJob(rec.filepath, -1, cidx, rec.z_level,
                                y, x, tuple(crops), fy, fx))
    return jobs
