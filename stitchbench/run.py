#!/usr/bin/env python3
"""One run of one cell of the benchmark of image_stitcher_tpu_torch.

    python3 stitchbench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout that holds the program. Set-up generates the
cell's acquisition from the seed on the card (``acquisition.py``, under
``TMPDIR``) and stitches it once to build and warm every kernel. The
window then starts passes of ``image_stitcher_tpu_torch.stitch`` back to
back, each from the scan to the last chunk written into a fresh folder,
until ``--seconds`` have elapsed; the pass running then finishes. Between
passes the previous pass's output is deleted, untimed; set-up ends with
``sync``, so its own writes are not flushed under the first passes.
After the window the last pass's tree is held against the plain reference
(``reference.py``, ``check.py``).

With ``--trace 0`` the result carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics (the window under
``torch.profiler``). Earlier lines on standard output say what the last
line cannot carry; standard error ends with each number the check
compared beside its limit; the last line of standard output is the
result, one JSON object.

The BLAS and OpenMP pools run one thread each (``POOL_ENV``).

Exit codes: 0 a result was printed; 2 the program is not in the
checkout; 3 no CUDA card, or fewer than the cell asks for; 4 a module of
JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path.pop(0)
sys.path.insert(0, ROOT)

#: top-level module names no run may load: JAX and the JAX package
BANNED = ('jax', 'jaxlib', 'flax', 'image_stitcher_tpu')
GIB = float(1 << 30)
#: one thread for each BLAS and OpenMP pool (NumPy's, SciPy's, PyTorch's
#: intra-op), set before any of them loads: their idle workers spin on
#: the host's cores, which the program's loaders and encode pool need,
#: and with eight of them on an 8-core host the runs of a cell spread by
#: 7-13 % instead of 2 %. The program's own thread pools keep the
#: configuration's sizes.
POOL_ENV = {'OMP_NUM_THREADS': '1', 'OPENBLAS_NUM_THREADS': '1',
            'MKL_NUM_THREADS': '1'}


def banned_modules():
    """Loaded modules whose top-level name (before the first dot) is
    banned, compared whole."""
    return sorted({name.split('.')[0] for name in list(sys.modules)}
                  & set(BANNED))


def process_age() -> float:
    """Seconds since this process started (from /proc), so set-up counts
    the interpreter's start too."""
    try:
        with open('/proc/self/stat') as f:
            start = float(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf('SC_CLK_TCK'))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_T0 = process_age() - (time.perf_counter() - T0)


def io_counters():
    """This process's /proc/self/io counters (bytes)."""
    out = {}
    try:
        with open('/proc/self/io') as f:
            for line in f:
                k, v = line.split(':')
                out[k.strip()] = int(v)
    except OSError:
        pass
    return out


class HostSampler:
    """The highest resident set of the process, and the highest dirty
    and writeback page-cache bytes of the host since :meth:`mark`,
    sampled every 20 ms."""

    def __init__(self, every: float = 0.02):
        self.every = every
        self.peak = 0
        self.dirty = self.writeback = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._page = os.sysconf('SC_PAGE_SIZE')

    def _sample(self):
        with open('/proc/self/statm') as f:
            self.peak = max(self.peak, int(f.read().split()[1]) * self._page)
        mem = meminfo()
        self.dirty = max(self.dirty, mem.get('Dirty', 0))
        self.writeback = max(self.writeback, mem.get('Writeback', 0))

    def mark(self):
        """Start a new span for the dirty and writeback peaks."""
        self.dirty = self.writeback = 0

    def _run(self):
        while not self._stop.wait(self.every):
            self._sample()

    def __enter__(self):
        self._sample()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._sample()


def meminfo():
    """/proc/meminfo in bytes."""
    out = {}
    try:
        with open('/proc/meminfo') as f:
            for line in f:
                k, v = line.split(':', 1)
                out[k] = int(v.split()[0]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return out


def host_counters():
    """What a pass's host readings are taken from: the clock and this
    process's CPU time (s, all its threads)."""
    out = {'t': time.perf_counter()}
    try:
        with open('/proc/self/stat') as f:
            w = f.read().rsplit(')', 1)[1].split()
        out['proc'] = (int(w[11]) + int(w[12])) / os.sysconf('SC_CLK_TCK')
    except (OSError, ValueError, IndexError):
        pass
    return out


def host_reading(c0, c1, sampler=None):
    """A pass's host readings from its counters at the start and end:
    seconds, the CPUs this process kept busy on average, and the highest
    dirty and writeback page-cache bytes of the host meanwhile."""
    dt = c1['t'] - c0['t']
    out = {'s': round(dt, 4)}
    if 'proc' in c0 and 'proc' in c1:
        out['proc_cpus'] = round((c1['proc'] - c0['proc']) / dt, 3)
    if sampler is not None:
        out['dirty_max_mb'] = round(sampler.dirty / 1e6, 1)
        out['writeback_max_mb'] = round(sampler.writeback / 1e6, 1)
    return out


def filesystem_of(path: str) -> str:
    """The type of the filesystem that holds ``path`` (from
    /proc/self/mountinfo)."""
    path = os.path.realpath(path)
    best, kind = '', 'unknown'
    try:
        with open('/proc/self/mountinfo') as f:
            for line in f:
                left, right = line.split(' - ', 1)
                mount = left.split()[4]
                if (path == mount or path.startswith(mount.rstrip('/') + '/')
                        ) and len(mount) >= len(best):
                    best, kind = mount, right.split()[0]
    except (OSError, ValueError, IndexError):
        pass
    return kind


def card_info():
    """(name, power limit) of card 0; the limit from nvidia-smi, which
    only reads."""
    import torch
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader', '-i', '0'], capture_output=True,
            text=True, timeout=20).stdout.strip() or 'unknown'
    except (OSError, subprocess.SubprocessError):
        limit = 'unknown'
    return name, limit


def engine_options(config, folder):
    from image_stitcher_tpu_torch import EngineOptions
    opts = dict(config['options'])
    opts['chunks'] = tuple(opts['chunks'])
    return EngineOptions(output_folder=folder, **opts)


def stitch_pass(acq, config, folder, device):
    """One pass: the program's stitch of ``acq`` into ``folder``; returns
    the pipeline and its wall seconds."""
    import image_stitcher_tpu_torch as port
    t0 = time.perf_counter()
    pipe = port.stitch(acq, device=device,
                       options=engine_options(config, folder),
                       **config['stitch'])
    if device.type == 'cuda':
        import torch
        torch.cuda.synchronize(device)
    return pipe, t0, time.perf_counter()


def window(acq, config, work, seconds, device, marker=None, sampler=None):
    """Passes back to back until ``seconds`` have elapsed; the output of
    all but the last is deleted between passes. Returns (passes, last
    output folder, overrun seconds); each pass holds the host's readings
    over it (:func:`host_reading`)."""
    passes = []
    prev = None
    start = time.perf_counter()
    k = 0
    while True:
        folder = os.path.join(work, f'pass{k}')
        c0 = host_counters()
        if sampler is not None:
            sampler.mark()
        if marker is not None:
            with marker():
                pipe, t0, t1 = stitch_pass(acq, config, folder, device)
        else:
            pipe, t0, t1 = stitch_pass(acq, config, folder, device)
        passes.append({'start': t0, 'end': t1, 'seconds': t1 - t0,
                       'timers': dict(pipe.timers.as_dict()),
                       'fuse_stats': json.loads(json.dumps(
                           pipe.fuse_stats, default=float)),
                       'device_pairs': int(pipe.device_pairs),
                       'host': host_reading(c0, host_counters(), sampler)})
        passes[-1]['host']['timers'] = {
            k: round(v, 4) for k, v in passes[-1]['timers'].items()}
        del pipe
        if prev is not None:
            shutil.rmtree(prev, ignore_errors=True)
        prev = folder
        k += 1
        if t1 - start >= seconds:
            return passes, folder, (t1 - start) - seconds


def run_check(acq, config, folder, limits, device, regions):
    """Hold the pass's tree in ``folder`` against the reference."""
    from stitchbench import check, reference, unblosc
    tree = check.read_tree(folder, unblosc.Decoder(ROOT), regions)
    ref = reference.run(acq, config, device=device, answers=tree['answers'])
    numbers, info, faults = check.compare(tree, ref, device=device)
    ok, checks = check.judge(numbers, limits)
    return ok, checks, info, faults


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from stitchbench import registry
    reg = registry.Registry(ROOT, HERE)
    cell = reg.workload(args.workload)
    config = reg.config(cell['config'])
    traffic = reg.traffic(cell['traffic'])
    limits = reg.limits(cell['name'])
    try:
        import image_stitcher_tpu_torch as port
    except ImportError as e:
        port = None
        why = str(e)
    if port is None or not os.path.abspath(port.__file__).startswith(
            os.path.join(ROOT, '')):
        print("stitchbench: the program is not in this checkout: "
              f"{why if port is None else port.__file__}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell['chips']):
        print(f"stitchbench: {cell['name']} needs {cell['chips']} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device('cuda', 0)
    name, power = card_info()

    work = tempfile.mkdtemp(prefix='stitchbench-')
    try:
        return measure(args, cell, config, traffic, limits, device, name,
                       power, work, reg)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def measure(args, cell, config, traffic, limits, device, card, power, work,
            reg) -> int:
    """Set-up, the window, the readings and the check of one run on
    ``device``, in the scratch folder ``work``; prints the result."""
    import torch
    from stitchbench import acquisition
    acq = os.path.join(work, 'acquisition')
    lay = acquisition.write_acquisition(acq, traffic, args.seed, device)
    tiles = sum(1 for n in os.listdir(os.path.join(acq, '0'))
                if n.endswith('.tiff'))
    from stitchbench import unblosc
    unblosc.Decoder(ROOT)                   # built once a checkout
    warm, _, _ = stitch_pass(acq, config, os.path.join(work, 'warm'), device)
    del warm
    shutil.rmtree(os.path.join(work, 'warm'), ignore_errors=True)
    gc.collect()
    # set-up's writes (the acquisition, the warm pass) reach the disk
    # here, not under the window's first passes
    os.sync()
    cuda = device.type == 'cuda'
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    io_setup = io_counters()
    setup_s = AGE_AT_T0 + (time.perf_counter() - T0)

    recorder = prof = None
    marker = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        from stitchbench import trace
        recorder = trace.Recorder()
        recorder.install()
        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if cuda else []))
        prof.__enter__()

        def marker():
            return record_function(trace.MARK)
    try:
        with HostSampler() as rss:
            passes, last, overrun = window(acq, config, work, args.seconds,
                                           device, marker, rss)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        if recorder is not None:
            recorder.uninstall()
    device_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    io_end = io_counters()
    pass_s = sum(p['seconds'] for p in passes)
    done = tiles * len(passes)

    metrics = {}
    device_out = {'platform': 'gpu', 'kind': card, 'count': int(cell['chips']),
                  'memory_peak_bytes': int(device_peak)}
    breakdown = None
    if args.trace:
        from stitchbench import roofline, trace
        path = os.path.join(work, 'trace.json')
        prof.export_chrome_trace(path)
        with open(path) as f:
            tr = trace.read(json.load(f), passes, recorder)
        os.unlink(path)
        kernels = {}
        for k, b in recorder.kernel_bytes().items():
            kernels[k] = dict(b, seconds=tr['kernels'].get(k))
        record = {'cell': cell['name'], 'window_s': pass_s, 'tiles': done,
                  'passes': passes,
                  'device': {'busy_s': tr['busy_s'],
                             'window_s': tr['window_s']},
                  'kernels': kernels,
                  'peak_bytes_per_s': roofline.peak_bytes_per_s(card)}
        for m in reg.per_layer(cell['name']):
            value = reg.reader(m['name'])(record)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
        device_out['busy_s'] = tr['busy_s'] or 0.0
        device_out['window_s'] = tr['window_s']
        breakdown = {'device_ops': tr['device_ops'],
                     'idle_gaps': tr['idle_gaps']}
        print(f"trace: kernels {json.dumps(kernels, default=float)}")
    else:
        values = {'host_peak_gib': rss.peak / GIB,
                  'device_peak_gib': device_peak / GIB,
                  'setup_s': setup_s}
        for m in reg.end_to_end(cell['name']):
            metrics[m['name']] = {'value': values[m['name']],
                                  'unit': m['unit']}
    del prof, recorder
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    ok, checks, info, faults = run_check(acq, config, last, limits, device,
                                         lay['regions'])
    check_s = time.perf_counter() - t_check

    found = banned_modules()
    if found:
        print(f"stitchbench: modules of JAX or the JAX package were loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        return 4
    print(f"card: {card}, power limit {power}")
    print(f"passes: {len(passes)}, tiles: {done} ({tiles} a pass), pass "
          f"seconds {[round(p['seconds'], 4) for p in passes]}, overrun "
          f"{overrun:.4f} s, setup {setup_s:.4f} s, check {check_s:.4f} s")
    print(f"bytes: write_bytes {io_end.get('write_bytes', 0)} (set-up "
          f"{io_setup.get('write_bytes', 0)}), cancelled_write_bytes "
          f"{io_end.get('cancelled_write_bytes', 0)}, wchar "
          f"{io_end.get('wchar', 0)}")
    print(f"rate: {done / pass_s:.4f} tiles/s over {pass_s:.4f} s of passes "
          f"(tiles_per_s.window in traced runs); device peak "
          f"{device_peak} B")
    print(f"device_pairs: {passes[-1]['device_pairs']}")
    print(f"host: {os.cpu_count()} cpus, output on {filesystem_of(work)}, "
          f"BLAS/OpenMP threads "
          f"{','.join(os.environ.get(k, '-') for k in POOL_ENV)}")
    for k, p in enumerate(passes):
        print(f"host pass {k}: {json.dumps(p['host'])}")
    print(f"registration: {json.dumps(info)}")
    print(f"timers (last pass): {json.dumps(passes[-1]['timers'])}")
    for f_ in faults[:20]:
        print(f"fault: {f_}")
    result = {'correct': bool(ok), 'attempted': done, 'failed': 0,
              'metrics': metrics, 'device': device_out}
    if breakdown is not None:
        result['breakdown'] = breakdown
    result['checks'] = checks
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == '__main__':
    os.environ.update(POOL_ENV)
    sys.exit(main())
