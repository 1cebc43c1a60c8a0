"""Write-plan overlap report (a copy of the JAX package's
``utils/plan_check.py``, with the same status line).

Overlapping post-crop tile extents are pixels whose final value depends
on the order of the writes (later tile wins). This validator reports
every overlapping post-crop pair per (c, z) plane, with the area, so
users can see exactly where overwrite order matters (and where
feathered blending would act). ``EngineOptions.validate_plan`` prints
the summary for every region fused whole on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple


@dataclass(frozen=True)
class Overlap:
    plane: Tuple[int, int]          # (channel, z)
    first: int                      # job indices in plan order
    second: int
    rect: Tuple[int, int, int, int]  # y0, y1, x0, x1 (canvas coords)

    @property
    def area(self) -> int:
        y0, y1, x0, x1 = self.rect
        return max(0, y1 - y0) * max(0, x1 - x0)


def _extent(job, tile_h: int, tile_w: int) -> Tuple[int, int, int, int]:
    top, bottom, left, right = job.crops
    y0 = job.y + top
    x0 = job.x + left
    y1 = job.y + tile_h - bottom
    x1 = job.x + tile_w - right
    return y0, y1, x0, x1


def find_overlaps(jobs: Sequence, tile_h: int, tile_w: int,
                  limit: int = 100) -> List[Overlap]:
    """All pairwise post-crop overlaps within each (c, z) plane.

    ``jobs`` are TileJob-likes (attrs channel_idx, z_level, y, x, crops).
    O(n^2) per plane with an interval sweep — planes hold at most a few
    thousand tiles.
    """
    planes: Dict[Tuple[int, int], List[Tuple[int, Tuple[int, int, int, int]]]] = {}
    for idx, job in enumerate(jobs):
        planes.setdefault((job.channel_idx, job.z_level), []).append(
            (idx, _extent(job, tile_h, tile_w)))

    overlaps: List[Overlap] = []
    for plane, entries in planes.items():
        entries.sort(key=lambda e: e[1][0])  # by y0
        for a in range(len(entries)):
            ia, (ay0, ay1, ax0, ax1) = entries[a]
            for b in range(a + 1, len(entries)):
                ib, (by0, by1, bx0, bx1) = entries[b]
                if by0 >= ay1:
                    break  # sweep: no later entry can overlap in y
                y0, y1 = max(ay0, by0), min(ay1, by1)
                x0, x1 = max(ax0, bx0), min(ax1, bx1)
                if y1 > y0 and x1 > x0:
                    overlaps.append(Overlap(plane, min(ia, ib), max(ia, ib),
                                            (y0, y1, x0, x1)))
                    if len(overlaps) >= limit:
                        return overlaps
    return overlaps


def summarize_plan(jobs: Sequence, tile_h: int, tile_w: int) -> str:
    """One-line plan summary for reporting."""
    overlaps = find_overlaps(jobs, tile_h, tile_w)
    if not overlaps:
        return (f"write plan: {len(jobs)} tile writes, disjoint "
                f"(order-independent)")
    total_area = sum(o.area for o in overlaps)
    return (f"write plan: {len(jobs)} tile writes, "
            f"{len(overlaps)} overlapping pair(s), {total_area} px "
            f"order-dependent (later tile wins; consider "
            f"blend_method='feather')")
