"""State carried into a run: fitted flatfields and registration.

A pipeline given a :class:`CarriedState` skips its own flatfield fit
and/or registration and uses the carried values, as the JAX package's
resume path reuses the fields, shifts and global positions a run saved.
The main use is holding fusion and writing against the JAX package with
the same inputs: :func:`state_from_reference` turns the JAX pipeline's
fitted state (plain numpy arrays, ints and dicts, read by attribute, so
nothing of the JAX package is imported) into the port's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from .core.geometry import RegistrationShifts


Positions = Dict[str, Dict[Tuple[int, int], tuple]]


@dataclass
class CarriedState:
    """``flatfields``: {monochrome channel index: (H, W) float32 field},
    or None to fit them; ``shifts``: the grid shift model, or None to
    measure it; ``global_positions`` / ``global_positions_float``: the
    'global' scope's solved tile positions {region: {(row, col): (y, x)}}
    as ints / floats, or None to solve them."""
    flatfields: Optional[Dict[int, np.ndarray]] = None
    shifts: Optional[RegistrationShifts] = None
    global_positions: Optional[Positions] = None
    global_positions_float: Optional[Positions] = None


def _shift(v) -> tuple:
    return (int(v[0]), int(v[1]))


def _positions(positions: Optional[Mapping], cast) -> Optional[Positions]:
    if positions is None:
        return None
    return {str(region): {(int(k[0]), int(k[1])): (cast(v[0]), cast(v[1]))
                          for k, v in cells.items()}
            for region, cells in positions.items()}


def state_from_reference(flatfields: Optional[Mapping] = None,
                         shifts=None, global_positions: Optional[Mapping] = None,
                         global_positions_float: Optional[Mapping] = None
                         ) -> CarriedState:
    """Build a :class:`CarriedState` from a JAX pipeline's
    ``flatfields`` ({channel index: field}), ``shifts`` (any object with
    the ``RegistrationShifts`` fields h_shift, v_shift, h_shift_rev,
    h_shift_rev_odd and scan_pattern) and ``global_positions`` /
    ``global_positions_float`` ({region: {(row, col): (y, x)}})."""
    fields = None
    if flatfields is not None:
        fields = {int(k): np.ascontiguousarray(np.asarray(v), np.float32)
                  for k, v in flatfields.items()}
    carried = None
    if shifts is not None:
        carried = RegistrationShifts(
            h_shift=_shift(shifts.h_shift), v_shift=_shift(shifts.v_shift),
            h_shift_rev=_shift(shifts.h_shift_rev),
            h_shift_rev_odd=int(shifts.h_shift_rev_odd),
            scan_pattern=str(shifts.scan_pattern))
    return CarriedState(
        flatfields=fields, shifts=carried,
        global_positions=_positions(global_positions, int),
        global_positions_float=_positions(global_positions_float, float))
