#!/usr/bin/env python3
"""Times of the fusion kernels, or of the main path, of one or more
checkouts, on one CUDA card.

    python3 kernel_times.py [--reps N] ROOT [ROOT ...]
    python3 kernel_times.py --main-path [--rounds N] ROOT [ROOT ...]

Each ROOT is a checkout of this repository: its image_stitcher_tpu_torch
package is built and imported from there, in a process of its own.

Kernels (the default): the roots run one after another, in the order
given, so that ``A B B A`` compares two versions on one card in turns.
For each root the script runs chip_smoke.py's phase-3 cases (from this
file's directory, whatever the root) for the headline batch (ten u16
2048^2 tiles with the flatfield into the main path's band canvas) at the
padded and at the odd pitch: fuse_overwrite, fuse_feather and
finalize_feather, each checked against its plain version and timed on
the card with the host's enqueue hidden. It prints the card's name and
power limit, then one JSON line per root.

``--main-path``: writes chip_smoke.py's phase 5 acquisition once (10x10
x 3 channels x 2048^2 uint16, seed 5, ~205 px overlap), then stitches it
with each checkout's package and its ``chip_smoke.smoke_options`` (the
main path's options), one process a run. Each round runs the roots
forward then backward (A B B A for two), so a drift of the host weighs on
both sides alike. Every run prints its e2e seconds, the fit's, and the
band fuser's main-thread and writer-thread seconds; the last lines give
each root's medians. Each process builds its checkout's kernels and host
C before its timer starts. With ``--fusion-device host`` the runs fuse
on the host (chip_smoke.py phase 11c's run) and print the host fuser's
summed fold + write seconds over its threads (and their on-core sum
where the checkout keeps one) instead of the band fuser's.

    python3 kernel_times.py --main-path [--fusion-device host] ROOT ...
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))


def _smoke(root: str = HERE):
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(root, 'chip_smoke.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _import_port(root: str):
    sys.path.insert(0, root)
    import image_stitcher_tpu_torch
    if not image_stitcher_tpu_torch.__file__.startswith(root + os.sep):
        raise SystemExit(f"imported {image_stitcher_tpu_torch.__file__}, "
                         f"not the package under {root}")
    return image_stitcher_tpu_torch


def one_root(root: str, reps: int) -> dict:
    import numpy as np
    _import_port(root)
    smoke = _smoke()
    smoke.phase_environment()
    cases = [c for c in smoke.kernel_cases()
             if c[1] == smoke.torch.uint16 and c[2] and c[4:] == (10, 2048,
                                                                   2048)]
    out = []
    for case in cases:
        label = f"{case[0]} {'x'.join(map(str, case[3]))}"
        k = smoke.overwrite_case(np.random.default_rng(1234), case, reps)
        out.append(dict(kernel='fuse_overwrite', case=label, **k))
        k = smoke.feather_case(np.random.default_rng(4321), case, reps)
        fin = k.pop('finalize', None)
        out.append(dict(kernel='fuse_feather', case=label, **k))
        if fin is not None:
            out.append(dict(kernel='finalize_feather', case=label, **fin))
    return {'root': root, 'cases': out}


def main_path_one(root: str, acq: str, out: str,
                  fusion_device: str = 'auto') -> dict:
    """One stitch of the main path with ``root``'s package and options."""
    import time
    import torch
    port = _import_port(root)
    from image_stitcher_tpu_torch import native
    smoke = _smoke(root)
    for name in sorted(os.listdir(native.CSRC)):
        stem, ext = os.path.splitext(name)
        if ext in ('.c', '.cu'):    # the headers build with their source
            native.load(stem)
    t0 = time.perf_counter()
    pipe = port.stitch(acq, use_registration=True, apply_flatfield=True,
                       device=torch.device('cuda'),
                       options=smoke.smoke_options(
                           out, fusion_device=fusion_device))
    e2e = time.perf_counter() - t0
    stats = pipe.fuse_stats['A1_t0']
    rec = {'e2e_s': e2e,
           'fit_s': pipe.timers.as_dict().get('flatfield_fit', 0.0)}
    if fusion_device != 'host':
        return dict(rec, fuse_s=stats['fuse'],
                    writer_s=stats['write'] + stats['close'])
    # the host fuser: fold + writes summed over its threads
    rec['fold_write_s'] = stats['write'] + stats.get('pyramid', 0.0)
    if 'cpu' in stats:
        rec['fold_write_cpu_s'] = (stats['cpu'].get('write', 0.0)
                                   + stats['cpu'].get('pyramid', 0.0))
    return rec


def main_path(roots, rounds: int, fusion_device: str = 'auto') -> int:
    smoke = _smoke()
    _import_port(HERE)
    smoke.phase_environment()
    work = tempfile.mkdtemp(prefix='main_path_times_')
    try:
        acq = os.path.join(work, 'acq')
        smoke.write_acquisition(acq, 10, smoke.TILE, 205, seed=5)
        from image_stitcher_tpu_torch.io.directio import probe_direct_io
        probe_direct_io(work)     # the disk probe's cache, shared by all
        runs = {root: [] for root in roots}
        for _ in range(rounds):
            for root in roots + roots[::-1]:
                out = os.path.join(work, 'out')
                proc = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), '--one',
                     '--main-path', '--acq', acq, '--out', out,
                     '--fusion-device', fusion_device, root],
                    capture_output=True, text=True, cwd=root, timeout=600)
                shutil.rmtree(out, ignore_errors=True)
                if proc.returncode != 0:
                    print(proc.stderr[-3000:], file=sys.stderr)
                    return 1
                rec = json.loads(proc.stdout.strip().splitlines()[-1])
                runs[root].append(rec)
                print(f"{root}: " + " ".join(
                    f"{k}={v:.3f}" for k, v in rec.items()), flush=True)
        for root, recs in runs.items():
            keys = [k for k in recs[0] if all(k in r for r in recs)]
            print(f"{root}: medians of {len(recs)} runs: " + " ".join(
                f"{k}={statistics.median(r[k] for r in recs):.3f}"
                for k in keys))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('roots', nargs='+')
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--main-path', action='store_true',
                    help='time the main path end to end instead')
    ap.add_argument('--rounds', type=int, default=2)
    ap.add_argument('--fusion-device', default='auto',
                    choices=['auto', 'device', 'host'],
                    help='with --main-path: where the runs fuse')
    ap.add_argument('--one', action='store_true', help=argparse.SUPPRESS)
    ap.add_argument('--acq', help=argparse.SUPPRESS)
    ap.add_argument('--out', help=argparse.SUPPRESS)
    args = ap.parse_args()
    roots = [os.path.abspath(r) for r in args.roots]
    if args.one:
        rec = (main_path_one(roots[0], args.acq, args.out,
                             args.fusion_device) if args.main_path
               else one_root(roots[0], args.reps))
        print(json.dumps(rec), flush=True)
        return 0
    if args.main_path:
        return main_path(roots, args.rounds, args.fusion_device)
    print(_smoke().card_line(), flush=True)
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               '--one', '--reps', str(args.reps), root],
                              cwd=HERE)
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == '__main__':
    sys.exit(main())
