"""Access to stitched outputs: open a multiscale image, list a run's.

The counterpart of the JAX package's ``api.py``. Levels open through
the port's windowed reader (``io/zarr_store.open_array``) instead of a
tensorstore handle: ``image.level(0)[0, 0, 0, :512, :512]`` decodes only
the chunks that window touches.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from .io.zarr_store import ZarrArray, open_array, read_attrs


@dataclass
class StitchedImage:
    """Handle on a stitched multiscale OME-Zarr image."""
    path: str
    attrs: Dict

    @property
    def num_levels(self) -> int:
        return len(self.attrs["multiscales"][0]["datasets"])

    @property
    def channel_names(self) -> List[str]:
        omero = self.attrs.get("omero", {})
        return [c["label"] for c in omero.get("channels", [])]

    @property
    def pixel_size_um(self) -> float:
        ds = self.attrs["multiscales"][0]["datasets"][0]
        return ds["coordinateTransformations"][0]["scale"][-1]

    def level(self, n: int = 0) -> ZarrArray:
        """Pyramid level ``n``, opened for windowed reads."""
        return open_array(os.path.join(self.path, str(n)))

    def read(self, n: int = 0) -> np.ndarray:
        """Pyramid level ``n``, whole."""
        return self.level(n)[...]


def open_stitched(path: str) -> StitchedImage:
    """Open a ``{region}_stitched.ome.zarr`` (or a merge output) by path:
    NGFF 0.4 (zarr v2, attributes at the group root) or NGFF 0.5 (zarr
    v3, attributes under 'ome')."""
    attrs = read_attrs(path)
    if "multiscales" not in attrs and "ome" in attrs:
        attrs = attrs["ome"]
    return StitchedImage(path=path, attrs=attrs)


def list_outputs(stitched_folder: str) -> Dict[str, List[str]]:
    """The outputs of a stitched run folder:
    ``{"regions": [paths...], "time_series": [...], "hcs": [...]}``."""
    out: Dict[str, List[str]] = {"regions": [], "time_series": [], "hcs": []}
    if not os.path.isdir(stitched_folder):
        return out
    for entry in sorted(os.listdir(stitched_folder)):
        full = os.path.join(stitched_folder, entry)
        if entry.endswith("_stitched") and os.path.isdir(full):
            out["regions"].extend(
                os.path.join(full, f) for f in sorted(os.listdir(full))
                if f.endswith((".ome.zarr", ".ome.tiff")))
        elif entry == "region_time_series":
            out["time_series"].extend(
                os.path.join(full, f) for f in sorted(os.listdir(full)))
        elif entry == "hcs_timepoints":
            out["hcs"].extend(
                os.path.join(full, f) for f in sorted(os.listdir(full)))
    return out
