"""The port's editions and their front ends against the JAX package's.

- ``StitcherThread`` and ``StitcherProcess`` with ``device='cpu'``
  against the JAX editions (the JAX children pinned to the CPU as the
  JAX tests pin them, ``IMAGE_STITCHER_JAX_PLATFORM``): the same
  progress messages, the same protocol statuses in the same order, the
  same 'complete' message, and trees equal
  (``torch_helpers.assert_outputs_equal``); exit code 0.
- A stop event set before the child starts gives exit code 0 and no
  'complete'.
- A child left on its default device ('cuda') on this host without
  CUDA sends one ('error', ...) naming it and exits 1, writing nothing:
  it never stitches on the CPU unasked. The CLIs on their default device
  exit 1 the same way.
- ``process_cli`` and ``zarr_cli`` take the JAX CLIs' flags plus
  ``--device`` (and the port CLI's ``--subpixel-placement``), and run a
  child on the CPU to the JAX CLI's tree.
- ``monitor_process`` prints what the JAX monitor prints, and returns
  the same codes, on fake children (a finished run with its tree dump,
  an error, Ctrl-C with the terminate escalation).
"""

import importlib
import io
import os
import queue
import sys

import pytest

from fixtures import write_synthetic_acquisition
from torch_helpers import assert_outputs_equal
import image_stitcher_tpu as jax_pkg
from image_stitcher_tpu.models import editions as jax_editions
import image_stitcher_tpu_torch as port
from image_stitcher_tpu_torch.models import editions
from image_stitcher_tpu_torch import process_cli, zarr_cli

#: the JAX front ends, imported inside each test and dropped after it:
#: ``monitor_process(out=sys.stdout)`` binds the stdout of the moment its
#: module is imported, and the JAX package's own CLI test imports it
#: fresh, under its capture
JAX_FRONTS = ('image_stitcher_tpu.process_cli', 'image_stitcher_tpu.zarr_cli')


@pytest.fixture
def jax_front():
    yield lambda name: importlib.import_module(f'image_stitcher_tpu.{name}')
    for name in JAX_FRONTS:
        sys.modules.pop(name, None)
        if hasattr(jax_pkg, name.rsplit('.', 1)[1]):
            delattr(jax_pkg, name.rsplit('.', 1)[1])

#: the statuses of the queue protocol (the rest carry timings)
PROTOCOL = ('Calculating flatfields...', 'Stitching...', 'Saving...',
            'Completed region')


@pytest.fixture(scope='module')
def acq(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp('editions') / 'acq')
    write_synthetic_acquisition(folder, grid_cols=3, grid_rows=3, tile_w=64,
                                tile_h=64, overlap=16, seed=3)
    return folder


def drain(proc, timeout=120.0):
    """Every message of a child's three queues, until it exits and its
    queues stay empty; returns ({queue: messages}, exit code)."""
    import time
    msgs = {'progress': [], 'status': [], 'complete': []}
    queues = {'progress': proc.progress_queue, 'status': proc.status_queue,
              'complete': proc.complete_queue}
    deadline = time.time() + timeout
    quiet = 0
    while quiet < 5:
        assert time.time() < deadline, "the child did not finish in time"
        got = False
        for name, q in queues.items():
            try:
                while True:
                    msgs[name].append(q.get(timeout=0.05))
                    got = True
            except queue.Empty:
                pass
        quiet = 0 if got or proc.is_alive() else quiet + 1
    proc.join()
    return msgs, proc.exitcode


def protocol(msgs, out):
    """What the protocol fixes: progress ticks, the protocol statuses in
    order, errors, 'complete' with the path relative to ``out``."""
    statuses = [m for m in msgs['status'] if m[0] == 'error'
                or m[1][0].startswith(PROTOCOL)]
    complete = [(kind, (os.path.relpath(path, out), dtype))
                for kind, (path, dtype) in msgs['complete']]
    return msgs['progress'], statuses, complete


def _params(pkg, folder, **kw):
    return pkg.StitchingParameters(input_folder=folder, use_registration=True,
                                   apply_flatfield=True, **kw)


def test_thread_edition_equals_jax(acq, tmp_path):
    seen = {}
    for name, pkg, mod, kw in (('jax', jax_pkg, jax_editions, {}),
                               ('port', port, editions, {'device': 'cpu'})):
        events = []
        reporter = pkg.ProgressReporter(
            update_progress=lambda c, t, e=events: e.append(('progress',
                                                             (c, t))),
            starting_stitching=lambda e=events: e.append('stitching'),
            starting_saving=lambda final, e=events: e.append('saving'),
            finished_saving=lambda p, d, e=events: e.append(('complete',
                                                             str(d))),
            error=lambda msg, e=events: e.append(('error', msg)))
        out = str(tmp_path / name)
        thread = mod.StitcherThread(_params(pkg, acq),
                                    pkg.EngineOptions(output_folder=out),
                                    reporter=reporter, **kw)
        thread.start()
        thread.join(120)
        assert not thread.is_alive() and thread.error is None
        assert thread.result_path == os.path.join(
            out, '0_stitched', 'A1_stitched.ome.zarr')
        seen[name] = events
    # per hook, as the queues carry them: the fit's progress tick and
    # 'Stitching...' come from two threads, in either order
    for name in seen:
        events = seen[name]
        seen[name] = ([e for e in events if e[0] == 'progress'],
                      [e for e in events if e[0] != 'progress'])
    assert seen['port'] == seen['jax']
    assert seen['port'][1] == ['stitching', 'saving', ('complete', 'uint16')]
    assert_outputs_equal(str(tmp_path / 'jax'), str(tmp_path / 'port'))


def test_process_edition_equals_jax(acq, tmp_path):
    seen = {}
    for name, pkg, mod, kw in (('jax', jax_pkg, jax_editions, {}),
                               ('port', port, editions, {'device': 'cpu'})):
        out = str(tmp_path / name)
        proc = mod.StitcherProcess(_params(pkg, acq),
                                   options=pkg.EngineOptions(
                                       output_folder=out), **kw)
        proc.start()
        msgs, code = drain(proc)
        assert code == 0, msgs['status']
        seen[name] = protocol(msgs, out)
    assert seen['port'] == seen['jax']
    progress, statuses, complete = seen['port']
    assert progress[-1] == ('progress', (9, 9))
    assert [s[1][0] for s in statuses][:3] == [
        'Calculating flatfields...', 'Stitching...', 'Saving...']
    assert complete == [('complete', (os.path.join(
        '0_stitched', 'A1_stitched.ome.zarr'), 'uint16'))]
    assert_outputs_equal(str(tmp_path / 'jax'), str(tmp_path / 'port'))


def test_stop_event_exits_zero(acq, tmp_path):
    proc = editions.StitcherProcess(_params(port, acq), device='cpu',
                                    options=port.EngineOptions(
                                        output_folder=str(tmp_path / 'o')))
    proc.request_stop()
    proc.start()
    msgs, code = drain(proc)
    assert code == 0
    assert msgs['complete'] == [] and msgs['progress'] == []
    assert not [m for m in msgs['status'] if m[0] == 'error']


def _no_cuda_error(msgs):
    errors = [m for m in msgs['status'] if m[0] == 'error']
    assert len(errors) == 1 and 'torch.cuda.is_available() is false' \
        in errors[0][1]
    assert msgs['progress'] == [] and msgs['complete'] == []


def test_default_device_child_without_cuda_reports_and_exits_1(acq,
                                                               tmp_path):
    """The default device is CUDA: on a host without it the child
    reports the error once and exits 1, writing no output."""
    import torch
    assert not torch.cuda.is_available()
    out = str(tmp_path / 'o')
    proc = editions.StitcherProcess(_params(port, acq),
                                    options=port.EngineOptions(
                                        output_folder=out))
    assert proc.device == 'cuda'
    proc.start()
    msgs, code = drain(proc)
    assert code == 1
    _no_cuda_error(msgs)
    assert not os.path.exists(out)
    thread = editions.StitcherThread(_params(port, acq),
                                     port.EngineOptions(output_folder=out))
    thread.start()
    thread.join(60)
    assert isinstance(thread.error, RuntimeError) and not os.path.exists(out)


def _help_flags(parse_args, capsys):
    import re
    with pytest.raises(SystemExit):
        parse_args(['-h'])
    text = capsys.readouterr().out
    return set(re.findall(r'(?<![\w-])(--?[a-z][a-z-]*)', text)), text


@pytest.mark.parametrize("front", ['process_cli', 'zarr_cli'])
def test_cli_flags_are_the_jax_flags_plus_device(front, capsys,
                                                  monkeypatch, jax_front):
    monkeypatch.setenv('COLUMNS', '1000')
    ported = (process_cli if front == 'process_cli' else zarr_cli).parse_args
    jax = jax_front(front).parse_args
    got, text = _help_flags(ported, capsys)
    want, _ = _help_flags(jax, capsys)
    extra = {'--device'} | ({'--subpixel-placement'}
                            if front == 'process_cli' else set())
    assert got == want | extra
    assert 'default: cuda' in text
    args = ported(['-i', 'x'])
    assert args.device == 'cuda'
    assert ported(['-i', 'x', '--device', 'cpu']).device == 'cpu'


@pytest.mark.parametrize("front", ['process_cli', 'zarr_cli'])
def test_cli_runs_the_child_on_the_cpu_to_the_jax_tree(front, acq,
                                                       tmp_path, jax_front):
    """The CLI's child stitches on the CPU when given ``--device cpu``,
    writing the JAX CLI's tree; on its default device it exits 1 and
    writes nothing. (The monitor prints to the stdout it was imported
    with; ``test_monitor_process_equals_jax`` checks what it prints.)"""
    import shutil
    outs = {}
    for name, mod in (('jax', jax_front(front)),
                      ('port', process_cli if front == 'process_cli'
                       else zarr_cli)):
        folder = str(tmp_path / name / 'acq')
        shutil.copytree(acq, folder)
        argv = ['-i', folder, '-r']
        if name == 'port':
            argv += ['--device', 'cpu']
        assert mod.main(argv) == 0
        [outs[name]] = [os.path.join(str(tmp_path / name), d)
                        for d in os.listdir(str(tmp_path / name))
                        if d.startswith('acq_stitched_')]
    assert_outputs_equal(outs['jax'], outs['port'])
    folder = str(tmp_path / 'port' / 'acq')
    mod = process_cli if front == 'process_cli' else zarr_cli
    before = sorted(os.listdir(str(tmp_path / 'port')))
    assert mod.main(['-i', folder]) == 1
    assert sorted(os.listdir(str(tmp_path / 'port'))) == before


class FakeChild:
    """A finished (or Ctrl-C'd) child whose queues hold a run's
    messages."""

    def __init__(self, messages, interrupt=False, stubborn=False):
        self.progress_queue, self.status_queue, self.complete_queue = (
            queue.Queue(), queue.Queue(), queue.Queue())
        for name, msg in messages:
            getattr(self, f'{name}_queue').put(msg)
        self.interrupt, self.stubborn = interrupt, stubborn
        self.calls = []
        self.exitcode = 0

    def is_alive(self):
        if self.interrupt:
            self.interrupt = False
            raise KeyboardInterrupt
        return self.stubborn and 'terminate' not in self.calls

    def join(self, timeout=None):
        self.calls.append(('join', timeout))

    def terminate(self):
        self.calls.append('terminate')


class Event:
    def __init__(self):
        self.set_calls = 0

    def set(self):
        self.set_calls += 1


def _zarr_group(tmp_path):
    out = str(tmp_path / 'z.ome.zarr')
    writer = port_writer(out)
    writer.close()
    return out


def port_writer(path):
    import numpy as np
    from image_stitcher_tpu_torch.io.omezarr import MultiscaleWriter
    w = MultiscaleWriter(path, (1, 1, 1, 64, 64), 2, np.uint16,
                         (1, 1, 1, 32, 32), 'z', 1.0, 1.0, ['c'],
                         [0xFFFFFF], cname='lz4')
    w.write_level(0, np.ones((1, 1, 1, 64, 64), np.uint16))
    w.write_level(1, np.ones((1, 1, 1, 32, 32), np.uint16))
    return w


@pytest.mark.parametrize("case", ['complete', 'error', 'ctrl_c',
                                  'ctrl_c_stubborn'])
def test_monitor_process_equals_jax(case, tmp_path, jax_front):
    zarr = _zarr_group(tmp_path)
    messages = [('progress', ('progress', (1, 4))),
                ('status', ('status', ('Stitching...', False))),
                ('progress', ('progress', (4, 4)))]
    if case == 'error':
        messages.append(('status', ('error', 'disk full')))
    else:
        messages.append(('complete', ('complete', (zarr, 'uint16'))))
    outputs = {}
    for name, fn in (('jax', jax_front('process_cli').monitor_process),
                     ('port', process_cli.monitor_process)):
        child = FakeChild(messages, interrupt=case.startswith('ctrl_c'),
                          stubborn=case == 'ctrl_c_stubborn')
        stop = Event()
        out = io.StringIO()
        code = fn(child, child.progress_queue, child.status_queue,
                  child.complete_queue, stop, out=out)
        outputs[name] = (code, out.getvalue(), child.calls, stop.set_calls)
    assert outputs['port'] == outputs['jax']
    code, text = outputs['port'][:2]
    if case.startswith('ctrl_c'):
        assert code == 130 and 'Stopping stitcher' in text
    else:
        assert code == 0 and 'Progress: 4/4' in text
        assert ('Complete:' in text) == (case == 'complete')
