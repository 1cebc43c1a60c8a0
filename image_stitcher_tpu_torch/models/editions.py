"""Execution editions: thread and child-process wrappers around the engine.

The counterpart of the JAX package's ``models/editions.py``; the same
``StitchPipeline`` runs under different executors:

- StitcherThread  — in-process background thread with callback progress
  (parity with Stitcher(QThread), stitcher.py:31-37, minus the Qt
  dependency; a GUI can hook the same callbacks to signals).
- StitcherProcess — child process + multiprocessing queues + stop event
  (parity with stitcher_process.py:61-229 and zarr_stitcher.py:20-73,
  including the message tuple protocol and the drain-and-exit-0 shutdown).

Both take a ``device`` (``'cuda'`` by default) that they pass to the
pipeline: a run fuses on the card unless the caller asks for the CPU.
Child processes use the 'spawn' start method, so CUDA is initialised
only in the child (a fork after CUDA is initialised is unsafe). A child
asked for CUDA on a host without it reports the pipeline's error and
exits 1; it never stitches on the CPU instead.
"""

from __future__ import annotations

import multiprocessing as mp
import sys
import threading
from typing import Optional

from ..params import EngineOptions, StitchingParameters


def _run_pipeline(params, options, reporter, stop_event, resume=False,
                  device='cuda'):
    from .pipeline import StitchPipeline
    pipeline = StitchPipeline(params, options, reporter, stop_event,
                              resume=resume, device=device)
    return pipeline.run()


class StitcherThread(threading.Thread):
    """Background-thread edition; progress via a ProgressReporter."""

    def __init__(self, params: StitchingParameters,
                 options: Optional[EngineOptions] = None,
                 reporter=None, stop_event: Optional[threading.Event] = None,
                 resume: bool = False, device='cuda'):
        super().__init__(daemon=True)
        self.params = params
        self.options = options
        self.reporter = reporter
        self.stop_event = stop_event or threading.Event()
        self.resume = resume
        self.device = device
        self.result_path: Optional[str] = None
        self.error: Optional[BaseException] = None

    def run(self):
        try:
            self.result_path = _run_pipeline(
                self.params, self.options, self.reporter, self.stop_event,
                resume=self.resume, device=self.device)
        except BaseException as e:  # surfaced via .error and reporter
            self.error = e

    def stop(self):
        self.stop_event.set()


def _child_main(params, options, progress_queue, status_queue,
                complete_queue, stop_event, resume=False, device='cuda'):
    """Child-process entry: queue-protocol reporter, drain-clean shutdown
    (parity with stitcher_process.py:203-229)."""
    from ..utils.progress import ProgressReporter, StitchCancelled
    reporter = ProgressReporter.from_queues(progress_queue, status_queue,
                                            complete_queue)
    # pipeline.run() reports its own failures before re-raising; only
    # report here what it could NOT have (constructor/validation errors,
    # a CUDA device the host lacks), or consumers see every failure twice
    reported = []
    inner_error = reporter.error
    reporter.error = lambda msg: (reported.append(msg), inner_error(msg))
    try:
        _run_pipeline(params, options, reporter, stop_event, resume=resume,
                      device=device)
    except StitchCancelled:
        sys.exit(0)
    except Exception as e:
        if str(e) not in reported:
            reporter.error(str(e))
        sys.exit(1)


class StitcherProcess:
    """Child-process edition with the reference queue protocol.

    Messages: ('progress', (current, total)) on progress_queue,
    ('status', (message, is_saving)) / ('error', msg) on status_queue,
    ('complete', (path, dtype)) on complete_queue.
    """

    def __init__(self, params: StitchingParameters,
                 progress_queue=None, status_queue=None, complete_queue=None,
                 stop_event=None, options: Optional[EngineOptions] = None,
                 resume: bool = False, device='cuda'):
        self._ctx = mp.get_context('spawn')
        self.progress_queue = progress_queue if progress_queue is not None \
            else self._ctx.Queue()
        self.status_queue = status_queue if status_queue is not None \
            else self._ctx.Queue()
        self.complete_queue = complete_queue if complete_queue is not None \
            else self._ctx.Queue()
        self.stop_event = stop_event if stop_event is not None \
            else self._ctx.Event()
        self.device = str(device)
        self._proc = self._ctx.Process(
            target=_child_main,
            args=(params, options, self.progress_queue, self.status_queue,
                  self.complete_queue, self.stop_event, resume, self.device),
            daemon=True)

    def start(self):
        self._proc.start()

    def is_alive(self) -> bool:
        return self._proc.is_alive()

    def join(self, timeout=None):
        self._proc.join(timeout)

    def terminate(self):
        self._proc.terminate()

    @property
    def exitcode(self):
        return self._proc.exitcode

    def request_stop(self):
        self.stop_event.set()
