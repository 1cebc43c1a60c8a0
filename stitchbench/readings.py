#!/usr/bin/env python3
"""Readings for the output check's limits, at a cell's own size.

    python3 stitchbench/readings.py --workload <cell> --seeds 1 2 3 ...

For each seed, in one process: the cell's acquisition is generated, the
program stitches it once, and its tree is compared with the reference
(the sound reading); then the control (the reference computed in
bfloat16, one precision below the program's float32) is put in the
program's place and compared with the reference in the same way. One JSON line a seed; the limits
in ``checks/<cell>.json`` sit between the largest sound reading and the
smallest control reading of each number (see PERF.md). The benchmark's
runs do not run this.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path.pop(0)
sys.path.insert(0, ROOT)


def readings(cell: str, seeds, device, traffic=None, config=None):
    """Yield {'seed', 'sound', 'control'} for each seed."""
    import torch
    from stitchbench import acquisition, check, reference, registry, run, \
        unblosc
    reg = registry.Registry(ROOT, HERE)
    w = reg.workload(cell)
    config = config or reg.config(w['config'])
    traffic = traffic or reg.traffic(w['traffic'])
    decoder = unblosc.Decoder(ROOT)
    device = torch.device(device)
    for seed in seeds:
        work = tempfile.mkdtemp(prefix='stitchbench-readings-')
        try:
            acq = os.path.join(work, 'acquisition')
            lay = acquisition.write_acquisition(acq, traffic, seed, device)
            out = os.path.join(work, 'out')
            pipe, t0, t1 = run.stitch_pass(acq, config, out, device)
            del pipe
            tree = check.read_tree(out, decoder, lay['regions'])
            ref = reference.run(acq, config, device=device,
                                answers=tree['answers'])
            sound, info, faults = check.compare(tree, ref, device=device)
            item = {'seed': seed, 'pass_s': t1 - t0, 'sound': sound,
                    'info': info, 'faults': faults[:5]}
            del ref
            ctrl = check.as_tree(reference.run(
                acq, config, device=device, precision='bfloat16'))
            # the reference over the control's own answers, as over the
            # program's
            ref = reference.run(acq, config, device=device,
                                answers=ctrl['answers'])
            item['control'], item['control_info'], _ = check.compare(
                ctrl, ref, device=device)
            yield item
        finally:
            shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    args = ap.parse_args(argv)
    for item in readings(args.workload, args.seeds, 'cuda'):
        print(json.dumps(item), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
