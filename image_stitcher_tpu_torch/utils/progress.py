"""Progress/status reporting protocol: the JAX package's callback bundle
and its adapter to the reference's multiprocessing queue messages
('progress' | 'status' | 'error' | 'complete', payload), which the
child-process edition speaks (``models/editions.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


def _noop(*args, **kwargs):
    return None


@dataclass
class ProgressReporter:
    """Callback bundle; every hook is optional."""
    update_progress: Callable[[int, int], None] = _noop
    getting_flatfields: Callable[[], None] = _noop
    starting_stitching: Callable[[], None] = _noop
    starting_saving: Callable[[bool], None] = _noop
    finished_saving: Callable[[str, Any], None] = _noop
    status: Callable[..., None] = _noop          # status(message, is_saving=False)
    error: Callable[[str], None] = _noop

    @classmethod
    def from_queues(cls, progress_queue=None, status_queue=None,
                    complete_queue=None) -> 'ProgressReporter':
        """Adapter emitting the reference's queue message protocol."""

        def put(q, item):
            if q is not None:
                try:
                    q.put_nowait(item)
                except Exception:
                    pass

        return cls(
            update_progress=lambda cur, total: put(progress_queue, ('progress', (cur, total))),
            starting_saving=lambda final: put(status_queue, ('status', ('Saving...', True))),
            getting_flatfields=lambda: put(status_queue, ('status', ('Calculating flatfields...', False))),
            starting_stitching=lambda: put(status_queue, ('status', ('Stitching...', False))),
            status=lambda msg, is_saving=False: put(status_queue, ('status', (msg, is_saving))),
            error=lambda msg: put(status_queue, ('error', msg)),
            finished_saving=lambda path, dtype: put(complete_queue, ('complete', (path, str(dtype)))),
        )


class StitchCancelled(Exception):
    """Raised when the stop event fires (cooperative cancellation parity
    with reference check_stop, stitcher_process.py:203-209)."""
