"""Bytes the fusion kernels' work needs, and the card's peaks.

The rule: each input byte read once and each output byte written once,
whatever a kernel reads again, counted from the shapes of each call (the
tiles, their windows in the canvas, the fields they use), so that any
implementation of the same work reads the same count:

- ``fuse_overwrite``: the canvas pixels inside some valid window are
  written once, and the tile pixels that land there read once (``item``
  bytes each), plus each distinct channel's float32 field once;
- ``fuse_feather``: the float32 ``acc`` and ``wsum`` pixels inside some
  valid window read and written once (16 bytes), each tile pixel inside
  its own window read once, plus the fields;
- ``finalize_feather``: ``acc`` and ``wsum`` read (8 bytes) and the
  output written (``item``) for each pixel of the window it finishes.

A share of the roofline is (bytes / peak bytes per second) over the
kernels' device seconds; the kernels do no arithmetic that would bound
them before memory does.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

#: published peak memory bandwidth (bytes/s) by the device name torch
#: reports; NVIDIA's H100 SXM data sheet: 3.35 TB/s of HBM3
PEAK_BYTES_PER_S = {'NVIDIA H100 80GB HBM3': 3.35e12}


def peak_bytes_per_s(kind: str) -> Optional[float]:
    return PEAK_BYTES_PER_S.get(kind)


def union_area(rects: Iterable[Tuple[int, int, int, int]]) -> int:
    """Pixels covered by the union of [y0, y1) x [x0, x1) rectangles."""
    rects = [r for r in rects if r[1] > r[0] and r[3] > r[2]]
    if not rects:
        return 0
    ys = sorted({v for r in rects for v in (r[0], r[1])})
    total = 0
    for a, b in zip(ys, ys[1:]):
        spans = sorted((r[2], r[3]) for r in rects if r[0] <= a and r[1] >= b)
        cover, end = 0, None
        for x0, x1 in spans:
            if end is None or x0 > end:
                cover += x1 - x0
                end = x1
            elif x1 > end:
                cover += x1 - end
                end = x1
        total += cover * (b - a)
    return total


def windows(info: Sequence, crops: Sequence, valid: Sequence, th: int,
            tw: int) -> Dict[Tuple[int, int], list]:
    """{(c, z): [(y0, y1, x0, x1)]}: each valid tile's crop window in the
    canvas, by plane."""
    out: Dict[Tuple[int, int], list] = {}
    for (c, z, y, x), (top, bottom, left, right), ok in zip(info, crops,
                                                           valid):
        if not ok:
            continue
        r0, r1 = max(int(top), 0), min(th - int(bottom), th)
        s0, s1 = max(int(left), 0), min(tw - int(right), tw)
        out.setdefault((int(c), int(z)), []).append(
            (int(y) + r0, int(y) + r1, int(x) + s0, int(x) + s1))
    return out


def overwrite_bytes(info, crops, valid, th: int, tw: int, item: int,
                    with_field: bool) -> int:
    win = windows(info, crops, valid, th, tw)
    written = sum(union_area(v) for v in win.values())
    fields = len({c for c, _z in win}) * th * tw * 4 if with_field else 0
    return 2 * item * written + fields


def feather_bytes(info, crops, valid, th: int, tw: int, item: int,
                  with_field: bool) -> int:
    win = windows(info, crops, valid, th, tw)
    weighted = sum(union_area(v) for v in win.values())
    area = sum((y1 - y0) * (x1 - x0) for v in win.values()
               for y0, y1, x0, x1 in v if y1 > y0 and x1 > x0)
    fields = len({c for c, _z in win}) * th * tw * 4 if with_field else 0
    return 16 * weighted + item * area + fields


def finalize_bytes(planes: int, rows: Tuple[int, int], cols: Tuple[int, int],
                   item: int) -> int:
    px = planes * (rows[1] - rows[0]) * (cols[1] - cols[0])
    return px * (8 + item)
