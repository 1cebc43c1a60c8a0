"""The traced run's readings: the profiler's device timeline, the
program's stage spans, and the geometry of each fusion kernel call.

Only ``--trace 1`` runs install these. ``Recorder.install`` wraps, in the
run's process, the three fusion entry points of
``image_stitcher_tpu_torch.ops.cuda_fuse`` (recording each call's tile
geometry for ``roofline.py``, then calling through unchanged) and the
program's ``StageTimers.time`` (recording each stage's span beside the
totals it keeps); ``uninstall`` puts them back. The profiler records CPU
and CUDA activity and is read from its exported chrome trace; the harness
marks each pass with a ``stitchbench.pass`` range, whose timestamps tie
the profiler's clock to ``time.perf_counter``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

from . import roofline

KERNELS = ('fuse_overwrite', 'fuse_feather', 'finalize_feather')
MARK = 'stitchbench.pass'


class Recorder:
    """Kernel call geometry and stage spans of the traced window."""

    def __init__(self):
        self.calls: Dict[str, List] = {k: [] for k in KERNELS}
        self.spans: List[Tuple[str, float, float]] = []
        self._saved = []

    def install(self) -> None:
        from image_stitcher_tpu_torch.ops import cuda_fuse
        from image_stitcher_tpu_torch.utils.profiling import StageTimers
        rec = self

        def geometry(tiles, info, crops, valid, ff):
            return (info.numpy().copy(), crops.numpy().copy(),
                    valid.numpy().copy(), tuple(tiles.shape[1:]),
                    tiles.element_size(), ff is not None)

        orig_ow = cuda_fuse.fuse_overwrite
        orig_ff = cuda_fuse.fuse_feather
        orig_fin = cuda_fuse.finalize_feather

        def fuse_overwrite(canvas, tiles, info, crops, valid, ff_recip=None):
            if canvas.device.type == 'cuda':
                rec.calls['fuse_overwrite'].append(
                    geometry(tiles, info, crops, valid, ff_recip))
            return orig_ow(canvas, tiles, info, crops, valid, ff_recip)

        def fuse_feather(acc, wsum, tiles, info, crops, valid, ff_recip=None,
                         blend_px=64):
            if acc.device.type == 'cuda':
                rec.calls['fuse_feather'].append(
                    geometry(tiles, info, crops, valid, ff_recip))
            return orig_ff(acc, wsum, tiles, info, crops, valid, ff_recip,
                           blend_px)

        def finalize_feather(acc, wsum, out_dtype, rows=None, cols=None):
            out = orig_fin(acc, wsum, out_dtype, rows, cols)
            if acc.device.type == 'cuda':
                c, z, hp, wp = acc.shape
                rec.calls['finalize_feather'].append(
                    (c * z, rows or (0, hp), cols or (0, wp),
                     out.element_size()))
            return out

        for new, old in ((fuse_overwrite, orig_ow), (fuse_feather, orig_ff),
                         (finalize_feather, orig_fin)):
            new.launches = old.launches
            self._saved.append((cuda_fuse, old.__name__, old))
            setattr(cuda_fuse, old.__name__, new)

        orig_time = StageTimers.time

        @contextlib.contextmanager
        def timed(timers, name):
            t0 = time.perf_counter()
            try:
                with orig_time(timers, name):
                    yield
            finally:
                rec.spans.append((name, t0, time.perf_counter()))

        self._saved.append((StageTimers, 'time', orig_time))
        StageTimers.time = timed

    def uninstall(self) -> None:
        for owner, name, old in reversed(self._saved):
            setattr(owner, name, old)
        self._saved = []

    def kernel_bytes(self) -> Dict[str, Dict]:
        """{kernel: {'bytes', 'calls'}} by ``roofline.py``'s rule."""
        out = {}
        for name, calls in self.calls.items():
            total = 0
            for call in calls:
                if name == 'finalize_feather':
                    planes, rows, cols, item = call
                    total += roofline.finalize_bytes(planes, rows, cols, item)
                    continue
                info, crops, valid, (th, tw), item, ff = call
                fn = (roofline.overwrite_bytes if name == 'fuse_overwrite'
                      else roofline.feather_bytes)
                total += fn(info, crops, valid, th, tw, item, ff)
            if calls:
                out[name] = {'bytes': total, 'calls': len(calls)}
        return out


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def device_events(trace: Dict) -> Tuple[List, List]:
    """(device events [(name, start_s, end_s)], pass marks [(start_s,
    end_s)]) of a chrome trace the profiler exported, on its clock (the
    trace gives microseconds)."""
    dev, marks = [], []
    for e in trace.get('traceEvents', []):
        if e.get('ph') != 'X':
            continue
        start = float(e['ts']) * 1e-6
        end = start + float(e.get('dur', 0)) * 1e-6
        if e.get('cat') in DEVICE_CATS:
            dev.append((e.get('name', ''), start, end))
        elif e.get('name') == MARK and e.get('cat') == 'user_annotation':
            marks.append((start, end))
    return dev, marks


def read(trace: Dict, passes: List[Dict], rec: Recorder, top: int = 10) -> Dict:
    """The traced window's device readings: busy seconds inside the
    passes, the window's seconds, each kernel's device seconds, the top
    device operations, and the longest idle gaps named by the stage open
    at their middle."""
    dev, marks = device_events(trace)
    pass_iv = [(p['start'], p['end']) for p in passes]
    # the profiler's clock against perf_counter, from the pass marks
    offset: Optional[float] = None
    if marks and len(marks) == len(pass_iv):
        offset = sum(m[0] - p[0] for m, p in zip(sorted(marks), pass_iv)) \
            / len(marks)
    window_s = sum(b - a for a, b in pass_iv)
    if offset is None:
        return {'window_s': window_s, 'busy_s': None, 'kernels': {},
                'device_ops': [], 'idle_gaps': []}
    events = [(n, a - offset, b - offset) for n, a, b in dev]
    busy_iv = merge([(a, b) for _n, a, b in events])
    busy = 0.0
    gaps = []
    for lo, hi in pass_iv:
        inside = clip(busy_iv, lo, hi)
        busy += sum(b - a for a, b in inside)
        edges = [lo] + [v for iv in inside for v in iv] + [hi]
        gaps.extend((edges[k], edges[k + 1])
                    for k in range(0, len(edges), 2)
                    if edges[k + 1] > edges[k])
    by_name: Dict[str, float] = {}
    kernels: Dict[str, float] = {}
    for n, a, b in events:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
        for k in KERNELS:
            if k + '_kernel' in n:
                kernels[k] = kernels.get(k, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    def stage_at(t: float) -> str:
        open_ = [(e - s, name) for name, s, e in rec.spans if s <= t <= e]
        return min(open_)[1] if open_ else 'between stages'

    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[stage_at((a + b) / 2), b - a] for a, b in gaps[:top]]
    return {'window_s': window_s, 'busy_s': busy, 'kernels': kernels,
            'device_ops': [[n[:120], s] for n, s in ops], 'idle_gaps': idle}
