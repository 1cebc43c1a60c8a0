"""Phase 12b of ``chip_smoke.py`` on its own, for one checkout: every blosc
codec's C encoder and decoder MB/s (input bytes) on distinct compressible
2048^2 u16 chunks, on one thread and on a pool of one thread per CPU,
with its ratio (``chip_smoke.other_codec_rates``, seed 12 as phase 12).
The checkout is given by its root, so two trees compare in one run on
one host, e.g. the parent and this tree, in turns::

    python tools/torch_codec_rates.py [ROOT ...]

Each ROOT (default: this checkout) runs in a process of its own, which
builds that tree's codec library; one JSON line is printed per run:
``{"root", "card", "rates": {cname: {"1": [enc, dec], "<n>": [enc,
dec], "ratio": r}}}``. Needs no card and no tensorstore.
"""

import json
import os
import subprocess
import sys

_CHILD = r'''
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import chip_smoke
card = chip_smoke.card_line() if chip_smoke.torch.cuda.is_available() \
    else 'no card'
rates = chip_smoke.other_codec_rates(np.random.default_rng(12), card)
print('RATES ' + json.dumps({'root': sys.argv[1], 'card': card, 'rates': {
    c: {str(k): v for k, v in r.items()} for c, r in rates.items()}}))
'''


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for root in sys.argv[1:] or [here]:
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, '-c', _CHILD, root],
                              capture_output=True, text=True, cwd=root)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith('RATES ')]
        if proc.returncode or not lines:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise SystemExit(f"{root}: exit {proc.returncode}")
        print(lines[-1][len('RATES '):], flush=True)
        sys.stderr.write(proc.stdout)


if __name__ == '__main__':
    main()
