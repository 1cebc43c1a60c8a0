"""State carried into a run: fitted flatfields and registration shifts.

A pipeline given a :class:`CarriedState` skips its own flatfield fit
and/or shift measurement and uses the carried values, as the JAX
package's resume path reuses the fields and shifts a run saved. The
main use is holding fusion and writing against the JAX package with the
same inputs: :func:`state_from_reference` turns the JAX pipeline's
fitted state (plain numpy arrays and ints, read by attribute, so nothing
of the JAX package is imported) into the port's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import numpy as np

from .core.geometry import RegistrationShifts


@dataclass
class CarriedState:
    """``flatfields``: {monochrome channel index: (H, W) float32 field},
    or None to fit them; ``shifts``: the grid shift model, or None to
    measure it."""
    flatfields: Optional[Dict[int, np.ndarray]] = None
    shifts: Optional[RegistrationShifts] = None


def _shift(v) -> tuple:
    return (int(v[0]), int(v[1]))


def state_from_reference(flatfields: Optional[Mapping] = None,
                         shifts=None) -> CarriedState:
    """Build a :class:`CarriedState` from a JAX pipeline's
    ``flatfields`` ({channel index: field}) and ``shifts`` (any object
    with the ``RegistrationShifts`` fields h_shift, v_shift, h_shift_rev,
    h_shift_rev_odd and scan_pattern)."""
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
    return CarriedState(flatfields=fields, shifts=carried)
