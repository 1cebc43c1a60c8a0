"""The benchmark's registry: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell lives in a file of its own that is found by its name:

- ``configs/<config>.json``: the configuration as it is run (the
  ``EngineOptions`` fields under ``options``, the ``stitch`` keywords);
- ``traffic/<traffic>.json``: the parameters the acquisition generator
  (``acquisition.py``) reads;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(record)``;
- ``checks/<cell>.json``: the limits of the numbers the output check
  compares in that cell.

A later change adds a cell, a configuration, a mix or a metric by adding
files and entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

NAME_RE = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT_RE = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def check_name(name: str) -> str:
    """``name`` if it keeps the benchmark's rule for names, else raise."""
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise ValueError(f"bad name {name!r}: 1 to 64 of A-Z a-z 0-9 _ . -,"
                         " not starting with . or -")
    return name


def check_unit(unit: str) -> str:
    """``unit`` if it keeps the benchmark's rule for units, else raise."""
    if not isinstance(unit, str) or not UNIT_RE.match(unit):
        raise ValueError(f"bad unit {unit!r}: 1 to 16 of A-Z a-z 0-9 _ / % . -")
    return unit


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


class Registry:
    """``BENCHMARK.json`` of a checkout and the lookups by name."""

    def __init__(self, root: str = ROOT, here: str = HERE):
        self.root = root
        self.here = here
        self.bench = _json(os.path.join(root, 'BENCHMARK.json'))

    def workload(self, name: str) -> Dict:
        for w in self.bench['workloads']:
            if w['name'] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.bench['configs']:
            if c['name'] == name:
                return _json(os.path.join(self.root, c['file']))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict:
        return _json(os.path.join(self.here, 'traffic',
                                  check_name(name) + '.json'))

    def limits(self, cell: str) -> Dict:
        return _json(os.path.join(self.here, 'checks',
                                  check_name(cell) + '.json'))

    def end_to_end(self, cell: str) -> List[Dict]:
        """The end-to-end metrics a cell reports."""
        return [m for m in self.bench['end_to_end']
                if cell in m.get('workloads', [cell])]

    def per_layer(self, cell: str) -> List[Dict]:
        """The per-layer metrics read in a cell: those that list it, or
        list no cells and move an end-to-end metric the cell reports."""
        moved = {m['name'] for m in self.end_to_end(cell)}
        return [m for m in self.bench['per_layer']
                if m['moves'] in moved
                and cell in m.get('workloads', [cell])]

    def reader(self, metric: str):
        """The ``read(record)`` function of ``metrics/<metric>.py``."""
        path = os.path.join(self.here, 'metrics', check_name(metric) + '.py')
        spec = importlib.util.spec_from_file_location(
            'stitchbench_metric_' + metric.replace('.', '_').replace('-', '_'),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
