"""Progress/status reporting protocol (the JAX package's callback
bundle; its queue adapter belongs to the editions, not ported yet)."""

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


class StitchCancelled(Exception):
    """Raised when the stop event fires (cooperative cancellation parity
    with reference check_stop, stitcher_process.py:203-209)."""
