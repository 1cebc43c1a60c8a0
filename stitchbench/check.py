"""The output check: the program's tree of one pass against the reference.

``read_tree`` reads what the pass wrote (the fields in ``flatfields.npz``,
the registration in ``.stitch_manifest.json``, every level of every
region decoded by ``unblosc.py``, and the metadata); ``compare`` works
out the numbers the check compares; ``judge`` holds each against its
limit from ``checks/<cell>.json``.

The numbers:

- ``field_rel_gap``: the largest |F / F_ref - 1| over the fields;
- ``level_max_lsb``: the largest |level - level_ref| over every pixel of
  every level of every region (65535 where a level's shape differs);
- ``level_off_ppm``: the pixels that differ at all, per million;
- ``meta_faults``: metadata fields and chunk frame headers that differ
  from what the configuration fixes, and levels or regions missing;
- with global registration, ``pair_corr_gap``: the widest gap by which
  the correlation at a pair's answer (the program's refined shift, from
  its ``registration_report.json``) lies below the reference's best, as
  a share of the best (1 where the program gave no answer); and
  ``position_gap_px``: the largest gap of the program's solved positions
  (its run manifest) to the reference's solve of those answers.

The reference takes the program's pair answers, judged by the first of
these, and places every tile where its own solve of them puts it; so the
levels judge the solve's use, the placement and all after it. With the
centre scope the reference's shifts are its own, and the levels judge
them: another shift is another canvas. The gap of the program's shifts
to the reference's (``shift_gap_px``) is printed beside them.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from .unblosc import Decoder, read_level

WORST_LSB = 65535.0


def read_tree(folder: str, decoder: Decoder, regions: List[str]) -> Dict:
    """What one pass wrote into ``folder``."""
    fields = {}
    path = os.path.join(folder, 'flatfields.npz')
    if os.path.exists(path):
        with np.load(path) as z:
            fields = {int(k): z[k] for k in z.files}
    with open(os.path.join(folder, '.stitch_manifest.json')) as f:
        manifest = json.load(f)
    out = {'fields': fields, 'manifest': manifest, 'regions': {},
           'positions': program_positions(manifest),
           'answers': None}
    path = os.path.join(folder, 'registration_report.json')
    if os.path.exists(path):
        with open(path) as f:
            out['answers'] = program_answers(json.load(f))
    for region in regions:
        root = os.path.join(folder, '0_stitched',
                            f'{region}_stitched.ome.zarr')
        if not os.path.isdir(root):
            continue
        with open(os.path.join(root, '.zattrs')) as f:
            attrs = json.load(f)
        levels, metas, faults = [], [], []
        k = 0
        while os.path.isdir(os.path.join(root, str(k))):
            arr, meta, bad = read_level(decoder, os.path.join(root, str(k)))
            levels.append(arr)
            metas.append(meta)
            faults.extend(bad)
            k += 1
        out['regions'][region] = {'attrs': attrs, 'levels': levels,
                                  'metas': metas, 'frame_faults': faults}
    return out


def meta_faults(tree_region: Dict, want: Dict) -> List[str]:
    """Fields of a region's metadata that differ from ``want``."""
    bad = list(tree_region.get('frame_faults', []))
    attrs = tree_region.get('attrs', {})
    ms = (attrs.get('multiscales') or [{}])[0]
    for key in ('axes', 'datasets', 'version'):
        if ms.get(key) != want[key]:
            bad.append(f"multiscales {key}: {ms.get(key)!r}")
    labels = [c.get('label') for c in attrs.get('omero', {}).get(
        'channels', [])]
    if labels != want['channels']:
        bad.append(f"omero channels {labels!r}")
    metas = tree_region.get('metas', [])
    if len(metas) != len(want['arrays']):
        bad.append(f"{len(metas)} levels, want {len(want['arrays'])}")
    for k, (got, exp) in enumerate(zip(metas, want['arrays'])):
        for key, val in exp.items():
            if got.get(key) != val:
                bad.append(f"level {k} .zarray {key}: {got.get(key)!r}, "
                           f"want {val!r}")
    return bad


def program_positions(manifest: Dict) -> Dict[str, np.ndarray]:
    """{region: (n, 2) float positions (y, x)} of a global solve, from
    the program's run manifest, in row-major tile order."""
    out = {}
    for region, entries in (manifest.get('global_positions_float')
                            or {}).items():
        cols = 1 + max(int(c) for _r, c, _y, _x in entries)
        rows = 1 + max(int(r) for r, _c, _y, _x in entries)
        pos = np.full((rows * cols, 2), np.nan)
        for r, c, y, x in entries:
            pos[int(r) * cols + int(c)] = (y, x)
        out[region] = pos
    return out


def program_answers(report: Dict) -> Dict[str, Dict]:
    """{region: {((r, c), (r2, c2)): (dy, dx)}}: each pair's refined
    shift, from the program's registration report."""
    return {region: {(tuple(p['a']), tuple(p['b'])): (p['dy'], p['dx'])
                     for p in rep.get('pairs', [])}
            for region, rep in report.get('regions', {}).items()}


def registration_numbers(tree: Dict, ref: Dict) -> Dict[str, float]:
    """``pair_corr_gap`` and ``position_gap_px`` of a global
    registration (see the module's docstring)."""
    if tree.get('answers') is None:
        return {'pair_corr_gap': 1.0, 'position_gap_px': WORST_LSB}
    gap, pos_gap = 0.0, 0.0
    for region, pos in ref['registration'].items():
        gaps = ref['gaps'].get(region) or [1.0]
        gap = max(gap, max(gaps))
        have = tree['positions'].get(region)
        if have is None or have.shape != pos.shape or np.isnan(have).any():
            pos_gap = WORST_LSB
        else:
            pos_gap = max(pos_gap, float(np.abs(have - pos).max()))
    return {'pair_corr_gap': gap, 'position_gap_px': pos_gap}


def shift_gap(manifest: Dict, ref: Dict) -> float:
    """Largest gap of the centre shifts the program recorded against the
    reference's, in px."""
    s = manifest.get('shifts') or {}
    return float(max(abs(a - b) for key in ('h_shift', 'v_shift')
                     for a, b in zip(s.get(key, [WORST_LSB] * 2),
                                     ref['registration'][key])))


def level_gaps(levels, ref_levels, device) -> Tuple[float, int, int]:
    """(largest |gap| in LSB, pixels that differ, pixels compared) over
    a region's levels; a level of another shape counts the worst gap and
    all its pixels."""
    worst, off, total = 0.0, 0, 0
    for got, want in zip(levels, ref_levels):
        got = np.asarray(got)
        total += want.numel()
        if got.ndim == 5:
            got = got[0, :, 0]
        if tuple(got.shape) != tuple(want.shape):
            worst = WORST_LSB
            off += want.numel()
            continue
        g = torch.from_numpy(got.astype(np.int32)).to(device)
        d = (g - want.to(device)).abs()
        worst = max(worst, float(d.max()))
        off += int((d != 0).sum())
        del g, d
    for want in ref_levels[len(levels):]:
        worst = WORST_LSB
        off += want.numel()
        total += want.numel()
    return worst, off, total


def compare(tree: Dict, ref: Dict, device='cpu'
            ) -> Tuple[Dict, Dict, List[str]]:
    """(the numbers the check judges, the numbers it only reports, the
    metadata faults found)."""
    faults: List[str] = []
    field_gap = 0.0
    for k, want in ref['fields'].items():
        got = tree['fields'].get(k)
        if got is None or got.shape != want.shape:
            field_gap = WORST_LSB
            faults.append(f"field {k} missing or misshapen")
            continue
        field_gap = max(field_gap, float(np.abs(got / want - 1.0).max()))
    worst, off, total = 0.0, 0, 0
    for region, want in ref['regions'].items():
        have = tree['regions'].get(region)
        if have is None:
            faults.append(f"region {region} missing")
            worst = WORST_LSB
            n = sum(lv.numel() for lv in want['levels'])
            off += n
            total += n
            continue
        if 'attrs' in have:
            faults.extend(f"{region}: {m}" for m in
                          meta_faults(have, want['meta']))
        w_, o_, t_ = level_gaps(have['levels'], want['levels'], device)
        worst, off, total = max(worst, w_), off + o_, total + t_
    numbers = {
        'field_rel_gap': field_gap if ref['fields'] else 0.0,
        'level_max_lsb': worst,
        'level_off_ppm': 1e6 * off / max(total, 1),
        'meta_faults': float(len(faults)),
    }
    info = {}
    if ref['scope'] == 'global':
        numbers.update(registration_numbers(tree, ref))
        info['pairs_off_best'] = sum(
            1 for region, own in ref['own'].items()
            for k, s in own.items()
            if np.abs(np.subtract(ref['answers'][region][k], s)).max() > 1e-3)
        info['pairs'] = sum(len(v) for v in ref['own'].values())
    elif 'manifest' in tree:
        info['shift_gap_px'] = shift_gap(tree['manifest'], ref)
    return numbers, info, faults


def as_tree(ref: Dict) -> Dict:
    """A reference output in the place of a program's tree (the control):
    its fields, levels, pair answers and positions, nothing of the
    metadata."""
    return {'fields': ref['fields'],
            'answers': ref['answers'] if ref['scope'] == 'global' else None,
            'positions': (ref['registration'] if ref['scope'] == 'global'
                          else {}),
            'regions': {r: {'levels': [lv.cpu().numpy() for lv in
                                       v['levels']]}
                        for r, v in ref['regions'].items()}}


def judge(numbers: Dict, limits: Dict) -> Tuple[bool, Dict]:
    """(every number within its limit, {name: {value, limit}})."""
    checks = {}
    ok = True
    for name, value in numbers.items():
        limit = limits[name]
        checks[name] = {'value': value, 'limit': limit}
        if not value <= limit:
            ok = False
    return ok, checks
