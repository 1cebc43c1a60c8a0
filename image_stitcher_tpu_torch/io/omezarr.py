"""OME-Zarr v0.4 writer for raw zarr v2 multiscale images.

The counterpart of the JAX package's ``io/omezarr.py`` for the layout the
port writes (zarr v2, raw chunks): the same ``.zattrs`` multiscales and
OMERO trees, the same level shapes, and chunk files with the bytes the
JAX package's raw writer produces. Writes are synchronous ``pwrite``
calls from the caller's thread (the band fuser's one writer thread).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .zarr_store import RawZarrArray, write_group

OME_AXES = [
    {"name": "t", "type": "time", "unit": "second"},
    {"name": "c", "type": "channel"},
    {"name": "z", "type": "space", "unit": "micrometer"},
    {"name": "y", "type": "space", "unit": "micrometer"},
    {"name": "x", "type": "space", "unit": "micrometer"},
]


def level_shapes(base_shape: Tuple[int, ...],
                 num_levels: int) -> List[Tuple[int, ...]]:
    """Shapes of all pyramid levels; only the last two axes halve
    (floor), as ``image_stitcher_tpu/ops/pyramid.py::level_shapes``."""
    shapes = [tuple(base_shape)]
    for _ in range(1, num_levels):
        prev = shapes[-1]
        shapes.append(prev[:-2] + (prev[-2] // 2, prev[-1] // 2))
    return shapes


def dataset_transforms(num_levels: int, dz_um: float,
                       pixel_size_um: float) -> List[Dict]:
    """Per-level scale transforms [1, 1, dz, px*2^l, px*2^l]."""
    return [
        {
            "path": str(level),
            "coordinateTransformations": [{
                "type": "scale",
                "scale": [1, 1, float(dz_um),
                          float(pixel_size_um * (2 ** level)),
                          float(pixel_size_um * (2 ** level))],
            }],
        }
        for level in range(num_levels)
    ]


def multiscales_attrs(name: str, num_levels: int, dz_um: float,
                      pixel_size_um: float) -> Dict:
    return {
        "multiscales": [{
            "axes": OME_AXES,
            "datasets": dataset_transforms(num_levels, dz_um, pixel_size_um),
            "name": name,
            "version": "0.4",
        }]
    }


def omero_attrs(name: str, channel_names: Sequence[str],
                channel_colors: Sequence[int], dtype,
                full: bool = True) -> Dict:
    """OMERO display metadata (``full=False``: the merge paths' reduced
    window dict)."""
    if np.issubdtype(np.dtype(dtype), np.integer):
        ii = np.iinfo(np.dtype(dtype))
        lo, hi = int(ii.min), int(ii.max)
    else:
        lo, hi = 0, 1
    channels = []
    for cname, color in zip(channel_names, channel_colors):
        ch = {
            "label": cname,
            "color": f"{color:06X}",
            "window": ({"start": 0, "end": hi, "min": lo, "max": hi}
                       if full else {"start": 0, "end": hi}),
        }
        if full:
            ch.update({"active": True, "coefficient": 1, "family": "linear"})
        channels.append(ch)
    omero = {"name": name, "version": "0.4", "channels": channels}
    if full:
        omero["id"] = 1
    return omero


class MultiscaleWriter:
    """One multiscale OME-Zarr image group, written level by level.

    Construct (writes the group metadata and every level's ``.zarray``),
    then ``write_level(level, data, sel)`` per slab, then ``close()``.
    Slabs are (1, 1, 1, h, w) planes starting at column 0, as the band
    fusers produce them, or whole levels, as the in-RAM path saves
    them."""

    def __init__(self, path: str, base_shape: Sequence[int],
                 num_levels: int, dtype, chunks: Sequence[int],
                 name: str, dz_um: float, pixel_size_um: float,
                 channel_names: Sequence[str], channel_colors: Sequence[int],
                 omero_full: bool = True):
        self.path = path
        self.num_levels = num_levels
        self.shapes = level_shapes(tuple(base_shape), num_levels)
        attrs = multiscales_attrs(name, num_levels, dz_um, pixel_size_um)
        attrs["omero"] = omero_attrs(name, channel_names, channel_colors,
                                     dtype, full=omero_full)
        write_group(path, attrs)
        self.arrays = [RawZarrArray(os.path.join(path, str(level)),
                                    self.shapes[level], chunks, dtype)
                       for level in range(num_levels)]

    def write_level(self, level: int, data: np.ndarray,
                    sel: Optional[Tuple[slice, ...]] = None) -> None:
        """Write a (1, 1, 1, h, w) slab at ``sel`` (t, c, z, y, x slices),
        or with ``sel`` None the whole level, a (T, C, Z, H, W) array of
        the level's shape, plane by plane."""
        data = np.asarray(data)
        if sel is None:
            if data.shape != self.shapes[level]:
                raise ValueError(f"level {level} is {self.shapes[level]}, "
                                 f"got {data.shape}")
            for t, c, z in np.ndindex(*data.shape[:3]):
                self.arrays[level].write_plane_rows(t, c, z, 0, data[t, c, z])
            return
        if data.ndim != 5 or data.shape[:3] != (1, 1, 1):
            raise ValueError(f"slabs are (1, 1, 1, h, w), got {data.shape}")
        t, c, z, ys, xs = (s.start or 0 for s in sel)
        if xs != 0:
            raise ValueError("slabs start at column 0")
        self.arrays[level].write_plane_rows(t, c, z, ys, data[0, 0, 0])

    def close(self) -> None:
        """Writes are synchronous: nothing is pending."""
