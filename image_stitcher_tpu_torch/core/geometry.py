"""Placement geometry: output dims, tile positions, crops, pyramid depth.

A copy of the JAX package's ``core/geometry.py``. Pure functions with exact arithmetic parity to the reference
(stitcher.py:298-354 output dims; :563-605 crops; :652-679 positions;
:345-352 pyramid depth; :451-452 overlap estimate). These run on host —
they are O(tiles) integer math; the heavy work is in ops/.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

Shift = Tuple[int, int]  # (dy, dx) in pixels


@dataclass
class RegistrationShifts:
    """Grid-level shift model measured by registration.

    ``h_shift``: displacement between horizontally-adjacent tiles,
    expressed like the reference: (dy, dx) with dx negative ~ -overlap.
    ``v_shift``: displacement between vertically-adjacent tiles.
    S-Pattern scans carry a second horizontal shift for reverse rows
    (reference stitcher.py:113-117,487-496).
    """
    h_shift: Shift = (0, 0)
    v_shift: Shift = (0, 0)
    h_shift_rev: Shift = (0, 0)
    h_shift_rev_odd: int = 0  # rows where row_index % 2 == this use h_shift_rev
    scan_pattern: str = 'Unidirectional'

    def h_shift_for_row(self, row_index: int) -> Shift:
        """Row-dependent horizontal shift (reference stitcher.py:660-663)."""
        if self.scan_pattern == 'S-Pattern' and row_index % 2 == self.h_shift_rev_odd:
            return self.h_shift_rev
        return self.h_shift

    def max_h_shift(self) -> Shift:
        """Magnitude envelope over forward/reverse shifts
        (reference stitcher.py:324-328)."""
        if self.scan_pattern == 'S-Pattern':
            return (max(abs(self.h_shift[0]), abs(self.h_shift_rev[0])),
                    max(abs(self.h_shift[1]), abs(self.h_shift_rev[1])))
        return (abs(self.h_shift[0]), abs(self.h_shift[1]))


def output_dimensions_coordinate(
    x_positions: Sequence[float], y_positions: Sequence[float],
    input_width: int, input_height: int, pixel_size_um: float,
) -> Tuple[int, int]:
    """Canvas (width, height) in px from stage-coordinate extents.

    Parity with reference stitcher.py:337-343.
    """
    import numpy as np
    width_mm = max(x_positions) - min(x_positions) + (input_width * pixel_size_um / 1000)
    height_mm = max(y_positions) - min(y_positions) + (input_height * pixel_size_um / 1000)
    width_pixels = int(np.ceil(width_mm * 1000 / pixel_size_um))
    height_pixels = int(np.ceil(height_mm * 1000 / pixel_size_um))
    return width_pixels, height_pixels


def output_dimensions_registered(
    num_cols: int, num_rows: int,
    input_width: int, input_height: int,
    shifts: RegistrationShifts,
) -> Tuple[int, int]:
    """Canvas (width, height) in px from measured shifts.

    Includes the cross-axis drift terms (vertical drift of horizontal
    steps widens the canvas vertically and vice versa).
    Parity with reference stitcher.py:318-335.
    """
    max_h = shifts.max_h_shift()
    width_pixels = int(input_width + ((num_cols - 1) * (input_width - max_h[1])))
    width_pixels += abs((num_rows - 1) * shifts.v_shift[1])
    height_pixels = int(input_height + ((num_rows - 1) * (input_height - shifts.v_shift[0])))
    height_pixels += abs((num_cols - 1) * max_h[0])
    return width_pixels, height_pixels


def num_pyramid_levels(width_pixels: int, height_pixels: int, max_grid_dimension: int) -> int:
    """Pyramid depth = max(1, ceil(log2(max(W,H)/1024 * grid_dim))).

    Parity with reference stitcher.py:345-352 (grid_dim is the larger of
    the HCS row/column counts when multiple regions exist, else 1).
    """
    return max(1, math.ceil(math.log2(max(width_pixels, height_pixels) / 1024 * max_grid_dimension)))


def overlap_estimate(frame_size: int, step_px: float, pixel_binning: int,
                     fudge: float = 1.05) -> int:
    """Half-width of the expected overlap strip between adjacent tiles.

    ``round(|frame - step|*fudge) // 2 * binning`` — parity with reference
    stitcher.py:451-452 (Python banker's rounding preserved).
    """
    return round(abs(frame_size - step_px) * fudge) // 2 * pixel_binning


def tile_position_registered(
    col_index: int, row_index: int,
    num_cols: int, num_rows: int,
    input_width: int, input_height: int,
    shifts: RegistrationShifts,
) -> Tuple[int, int]:
    """(x_pixel, y_pixel) of a tile's top-left corner in registered mode.

    Row/col step by (frame + shift), then sign-dependent accumulation of
    the cross-axis drift: negative h dy accumulates from the right edge,
    positive from the left (and symmetrically for v dx).
    Parity with reference stitcher.py:656-676.
    """
    h_shift = shifts.h_shift_for_row(row_index)
    x_pixel = int(col_index * (input_width + h_shift[1]))
    y_pixel = int(row_index * (input_height + shifts.v_shift[0]))

    if h_shift[0] < 0:
        y_pixel += int((num_cols - 1 - col_index) * abs(h_shift[0]))
    else:
        y_pixel += int(col_index * h_shift[0])

    if shifts.v_shift[1] < 0:
        x_pixel += int((num_rows - 1 - row_index) * abs(shifts.v_shift[1]))
    else:
        x_pixel += int(row_index * shifts.v_shift[1])
    return x_pixel, y_pixel


def tile_position_coordinate(
    x_mm: float, y_mm: float, x_min_mm: float, y_min_mm: float, pixel_size_um: float,
) -> Tuple[int, int]:
    """(x_pixel, y_pixel) from stage coordinates (reference stitcher.py:678-679)."""
    x_pixel = int((x_mm - x_min_mm) * 1000 / pixel_size_um)
    y_pixel = int((y_mm - y_min_mm) * 1000 / pixel_size_um)
    return x_pixel, y_pixel


def tile_crops(
    col_index: int, row_index: int,
    num_cols: int, num_rows: int,
    shifts: RegistrationShifts,
) -> Tuple[int, int, int, int]:
    """Symmetric interior-edge crops (top, bottom, left, right) in px.

    Tiles shed half the measured overlap on edges that face a neighbor;
    grid-boundary edges keep full extent.
    Parity with reference stitcher.py:576-580.
    """
    h_shift = shifts.h_shift_for_row(row_index)
    v_shift = shifts.v_shift
    y_trim = max(0, (-v_shift[0] // 2) - abs(h_shift[0]) // 2)
    x_trim = max(0, (-h_shift[1] // 2) - abs(v_shift[1]) // 2)
    top = y_trim if row_index > 0 else 0
    bottom = y_trim if row_index < num_rows - 1 else 0
    left = x_trim if col_index > 0 else 0
    right = x_trim if col_index < num_cols - 1 else 0
    return top, bottom, left, right


def grid_center_pair_indices(num_positions: int) -> int:
    """Index of the center position used for single-pair registration
    (reference stitcher.py:456-457)."""
    return (num_positions - 1) // 2


def clamp_tile_extent(x_pixel: int, y_pixel: int, tile_h: int, tile_w: int,
                      canvas_h: int, canvas_w: int) -> Tuple[int, int]:
    """Clamp the tile's write window to the canvas (reference stitcher.py:589-594).

    Returns (y_end, x_end); caller slices tile[:y_end-y, :x_end-x].
    """
    y_end = min(y_pixel + tile_h, canvas_h)
    x_end = min(x_pixel + tile_w, canvas_w)
    return y_end, x_end
