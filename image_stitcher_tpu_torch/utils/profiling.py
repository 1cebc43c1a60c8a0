"""Per-stage wall-clock timers (the JAX package's ``StageTimers``)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List


class StageTimers:
    """Accumulating named wall-clock timers."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> List[str]:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name:<28} {t:8.3f}s  x{n}  ({t / max(n, 1):.3f}s avg)")
        return lines

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)
