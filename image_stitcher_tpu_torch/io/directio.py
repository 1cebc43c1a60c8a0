"""O_DIRECT writes for the raw chunk and shard writers.

The counterpart of the JAX package's ``io/directio.py``. Buffered writes
run at page-cache speed until the dirty window fills, then at the
device's writeback speed while the writing thread also pays the copy
into the cache; O_DIRECT writes go to the device with one DMA and leave
the input tiles cached. Output bytes are the same either way.

The decision is measured, not configured: :func:`probe_direct_io`
writes an interleaved A/B (buffered + fdatasync, then O_DIRECT; twice)
once per (device, CPU count), and keeps the rates in
``~/.cache/image_stitcher_tpu_torch/directio.json`` for 24 hours. A
filesystem that refuses O_DIRECT (tmpfs, FUSE) is recorded as
unsupported. ``direct_io='auto'`` writes direct when the direct arm
reaches 70 % of the buffered arm: a bounded probe sees the buffered
burst, not the collapse at the dirty-window knee, so direct wins
whenever it comes close.

O_DIRECT needs buffers, lengths and offsets aligned to the logical block
size (4096 covers every common device). Rows are packed into a
page-aligned per-thread staging buffer and written with one ``pwrite``.
"""

from __future__ import annotations

import json
import mmap
import os
import threading
import time
from typing import Dict, Optional

import numpy as np

ALIGN = 4096
_PROBE_TTL_S = 24 * 3600
_PROBE_MB = 256          # per arm, in two halves; sees the burst, not the knee
_WIN_RATIO = 0.7         # direct must reach 70 % of the buffered burst

_cache_lock = threading.Lock()
_mem_cache: Dict[str, Optional[dict]] = {}


def _cache_path() -> str:
    return os.path.expanduser(
        "~/.cache/image_stitcher_tpu_torch/directio.json")


def _cache_key(dir_path: str) -> str:
    try:
        dev = os.stat(dir_path).st_dev
    except OSError:
        dev = -1
    return f"dev{dev}-cpu{os.cpu_count()}"


def _write_arm(dir_path: str, direct: bool, payload, n_mb: int) -> float:
    """MB/s of one arm. Buffered is charged an fdatasync (the steady
    state of a multi-GB output); direct is synchronous by nature."""
    path = os.path.join(dir_path, f".directio_probe_{os.getpid()}")
    flags = os.O_WRONLY | os.O_CREAT | os.O_TRUNC
    if direct:
        flags |= os.O_DIRECT
    t0 = time.perf_counter()
    fd = os.open(path, flags, 0o644)
    try:
        for _ in range(n_mb // 16):
            os.write(fd, payload)
        if not direct:
            os.fdatasync(fd)
    finally:
        os.close(fd)
        try:
            os.unlink(path)
        except OSError:
            pass
    return n_mb / (time.perf_counter() - t0)


def probe_direct_io(dir_path: str, force: bool = False) -> Optional[dict]:
    """Measured buffered and direct write rates (MB/s) of ``dir_path``'s
    device, cached in memory and on disk; ``unsupported`` set (and both
    rates 0) where O_DIRECT is refused."""
    key = _cache_key(dir_path)
    with _cache_lock:
        if not force and key in _mem_cache:
            return _mem_cache[key]
        cache_file = _cache_path()
        if not force:
            try:
                with open(cache_file) as f:
                    entry = json.load(f).get(key)
                if entry and time.time() - entry["ts"] < _PROBE_TTL_S:
                    _mem_cache[key] = entry
                    return entry
            except (OSError, ValueError, KeyError):
                pass
        mm = mmap.mmap(-1, 16 << 20)  # page-aligned: legal for O_DIRECT
        mm.write(os.urandom(1 << 20) * 16)
        payload = memoryview(mm)
        try:
            buffered = direct = 0.0
            for _ in range(2):  # interleaved: both arms see both weathers
                buffered = max(buffered, _write_arm(dir_path, False, payload,
                                                    _PROBE_MB // 2))
                direct = max(direct, _write_arm(dir_path, True, payload,
                                                _PROBE_MB // 2))
            entry = {"ts": time.time(), "buffered_mbps": round(buffered, 1),
                     "direct_mbps": round(direct, 1)}
        except OSError:
            # O_DIRECT open or write refused on this filesystem
            entry = {"ts": time.time(), "buffered_mbps": 0.0,
                     "direct_mbps": 0.0, "unsupported": True}
        finally:
            payload.release()
            mm.close()
        try:
            os.makedirs(os.path.dirname(cache_file), exist_ok=True)
            try:
                with open(cache_file) as f:
                    all_entries = json.load(f)
            except (OSError, ValueError):
                all_entries = {}
            all_entries[key] = entry
            tmp = f"{cache_file}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(all_entries, f)
            os.replace(tmp, cache_file)
        except OSError:
            pass
        _mem_cache[key] = entry
        return entry


def use_direct_io(dir_path: str, mode: str = 'auto') -> bool:
    """Resolve an EngineOptions ``direct_io`` ('auto', 'on', 'off') into
    a decision for writes under ``dir_path``."""
    if mode == 'off':
        return False
    if mode == 'on':
        return True
    entry = probe_direct_io(dir_path)
    if not entry or entry.get("unsupported"):
        return False
    return entry["direct_mbps"] >= _WIN_RATIO * entry["buffered_mbps"]


class AlignedStaging:
    """Per-thread page-aligned staging buffers for O_DIRECT packing."""

    def __init__(self, nbytes: int):
        self.nbytes = -(-nbytes // ALIGN) * ALIGN
        self._tls = threading.local()

    def get(self) -> np.ndarray:
        buf = getattr(self._tls, 'buf', None)
        if buf is None or buf.nbytes < self.nbytes:
            mm = mmap.mmap(-1, self.nbytes)
            buf = np.frombuffer(mm, np.uint8)
            self._tls.buf = buf
            self._tls.mm = mm  # keep the mapping alive
        return buf


def pwrite_direct(fd: int, staging: AlignedStaging, plane: np.ndarray,
                  dtype, src_row0: int, src_col0: int, nrows: int,
                  row_bytes: int, pitch: int, off0: int) -> None:
    """Pack ``nrows`` strided plane rows (zero-padded to ``pitch``) into
    the aligned staging buffer and pwrite them at ``off0``.

    The caller guarantees: fd opened with O_DIRECT, off0 % ALIGN == 0,
    (nrows * pitch) % ALIGN == 0."""
    dtype = np.dtype(dtype)
    total = nrows * pitch
    buf = staging.get()
    rec_elems = pitch // dtype.itemsize
    w = row_bytes // dtype.itemsize
    view = buf[:total].view(dtype).reshape(nrows, rec_elems)
    view[:, :w] = plane[src_row0:src_row0 + nrows, src_col0:src_col0 + w]
    if w < rec_elems:
        view[:, w:] = 0
    done = 0
    mv = memoryview(buf)[:total]
    while done < total:
        done += os.pwrite(fd, mv[done:], off0 + done)
