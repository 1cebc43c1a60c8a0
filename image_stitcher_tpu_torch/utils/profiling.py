"""Spans of the program's work, and per-stage wall-clock timers (the JAX
package's ``StageTimers``) kept from the same clock reads.

A span is one piece of work on one thread::

    with span('chunk.encode', nbytes=chunk.nbytes):
        frame = compress(chunk)

Tracing is off until :func:`enable`; while it is off :func:`span` returns
one shared null context (it yields None) after one flag read. While it is
on each span records, on ``time.perf_counter()``: its name, its thread's
name and native id, its start and end, the thread's on-core seconds over
it (``time.thread_time()``), ``nbytes``, its own id and its parent's id
(0 for none). The parent is the span open around it on the same thread;
for work handed to a pool through :func:`carry`, the span that handed it
over. Spans are kept per thread in memory until :func:`drain` hands them
out.

:func:`timed` is a span that reads the clocks whether tracing is on or
not, for the counters that are kept from it in every run:
``StageTimers`` and the band fusers' ``stats`` (and the host fuser's
on-core ``cpu``).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional

_on = False
_NULL = contextlib.nullcontext()
_ids = itertools.count(1)
_lock = threading.Lock()
_tl = threading.local()
#: (thread, its span list) of every thread that recorded a span
_threads: List = []


class SpanRecord(NamedTuple):
    name: str
    thread: str       # the thread's name
    tid: int          # its native id
    start: float      # time.perf_counter()
    end: float
    cpu_s: float      # the thread's on-core seconds over the span
    nbytes: int
    id: int
    parent: int       # 0: none


class _Thread:
    __slots__ = ('name', 'tid', 'stack', 'spans')

    def __init__(self):
        self.name = threading.current_thread().name
        self.tid = threading.get_native_id()
        self.stack: List[int] = []     # ids of the open spans
        self.spans: List[SpanRecord] = []


def _state() -> _Thread:
    st = getattr(_tl, 'st', None)
    if st is None:
        st = _tl.st = _Thread()
        with _lock:
            _threads.append((threading.current_thread(), st.spans))
    return st


def enable() -> None:
    """Start recording spans."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording spans; those recorded wait for :func:`drain`."""
    global _on
    _on = False


def drain() -> List[SpanRecord]:
    """Every span recorded since the last drain, by start time."""
    out: List[SpanRecord] = []
    with _lock:
        keep = []
        for thread, spans in _threads:
            # read before the spans: a thread seen dead appends no more
            alive = thread.is_alive()
            n = len(spans)
            out.extend(spans[:n])
            del spans[:n]
            if alive:
                keep.append((thread, spans))
        _threads[:] = keep
    out.sort(key=lambda s: s.start)
    return out


class Span:
    """A span that always reads the clocks (``seconds`` and ``cpu_s``
    after it closes) and records itself while tracing is on."""

    __slots__ = ('name', 'nbytes', 'seconds', 'cpu_s', '_st', '_id',
                 '_parent', '_t0', '_c0')

    def __init__(self, name: str, nbytes: int = 0):
        self.name = name
        self.nbytes = nbytes
        self.seconds = 0.0
        self.cpu_s = 0.0
        self._st: Optional[_Thread] = None

    def __enter__(self) -> 'Span':
        if _on:
            st = self._st = _state()
            self._parent = st.stack[-1] if st.stack else 0
            self._id = next(_ids)
            st.stack.append(self._id)
        self._c0 = time.thread_time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        self.cpu_s = time.thread_time() - self._c0
        self.seconds = t1 - self._t0
        st = self._st
        if st is not None:
            st.stack.pop()
            st.spans.append(SpanRecord(
                self.name, st.name, st.tid, self._t0, t1, self.cpu_s,
                int(self.nbytes), self._id, self._parent))
        return False


def span(name: str, nbytes: int = 0):
    """A :class:`Span` while tracing is on, else the shared null
    context."""
    if not _on:
        return _NULL
    return Span(name, nbytes)


def timed(name: str, nbytes: int = 0) -> Span:
    """A :class:`Span` whether tracing is on or not: its ``seconds`` feed
    a counter that every run keeps."""
    return Span(name, nbytes)


def carry(fn: Callable) -> Callable:
    """``fn`` as a pool runs it: while tracing is on, the spans it opens on
    the pool's thread take the caller's open span as their parent."""
    if not _on:
        return fn
    st = _state()
    parent = st.stack[-1] if st.stack else 0

    def run(*args, **kwargs):
        stack = _state().stack
        stack.append(parent)
        try:
            return fn(*args, **kwargs)
        finally:
            stack.pop()
    return run


class StageTimers:
    """Accumulating named wall-clock timers; each stage is a span of its
    own name."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str) -> Iterator[None]:
        s = timed(name)
        try:
            with s:
                yield
        finally:
            self.totals[name] += s.seconds
            self.counts[name] += 1

    def summary(self) -> List[str]:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name:<28} {t:8.3f}s  x{n}  ({t / max(n, 1):.3f}s avg)")
        return lines

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)
