#!/usr/bin/env python3
"""Times of the fusion kernels of one or more checkouts, on one CUDA card.

    python3 kernel_times.py [--reps N] ROOT [ROOT ...]

Each ROOT is a checkout of this repository: its image_stitcher_tpu_torch
package is built and imported from there. The roots run one after
another, each in a process of its own, in the order given, so that
``A B B A`` compares two versions on one card in turns. For each root
the script runs chip_smoke.py's phase-3 cases (from this file's
directory, whatever the root) for the headline batch (ten u16 2048^2
tiles with the flatfield into the main path's band canvas) at the padded
and at the odd pitch: fuse_overwrite, fuse_feather and finalize_feather,
each checked against its plain version and timed on the card with the
host's enqueue hidden. It prints the card's name and power limit, then
one JSON line per root.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(HERE, 'chip_smoke.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def one_root(root: str, reps: int) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import image_stitcher_tpu_torch
    if not image_stitcher_tpu_torch.__file__.startswith(root + os.sep):
        raise SystemExit(f"imported {image_stitcher_tpu_torch.__file__}, "
                         f"not the package under {root}")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('roots', nargs='+')
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--one', action='store_true', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one_root(os.path.abspath(args.roots[0]),
                                  args.reps)), flush=True)
        return 0
    print(_smoke().card_line(), flush=True)
    for root in args.roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               '--one', '--reps', str(args.reps), root],
                              cwd=HERE)
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == '__main__':
    sys.exit(main())
