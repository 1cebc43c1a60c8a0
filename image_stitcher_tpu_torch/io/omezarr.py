"""OME-Zarr writer: multiscale images on zarr v2 (NGFF 0.4) or v3 (0.5).

The counterpart of the JAX package's ``io/omezarr.py``: the same
``.zattrs`` (or ``zarr.json`` attributes) multiscales and OMERO trees,
the same level shapes, and level arrays with the same chunk grid, raw or
blosc-lz4 (``io/zarr_store.py``, ``io/zarr_shard.py``). Raw chunks are
written synchronously from the caller's thread, bytes equal to the JAX
package's raw writer's; compressed chunks are encoded and written on a
pool of threads while the caller goes on.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .zarr_shard import BloscShardArray, RawShardArray
from .zarr_store import (BloscZarrArray, EncodePool, RawZarrArray,
                         write_group)

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


def multiscales_attrs_v3(name: str, num_levels: int, dz_um: float,
                         pixel_size_um: float,
                         omero: Optional[Dict] = None) -> Dict:
    """OME-NGFF 0.5 group attributes (zarr v3): the 0.4 multiscales and
    OMERO trees under one 'ome' key with the group's version, without
    their own version keys."""
    members: Dict = {"multiscales": [{
        "axes": OME_AXES,
        "datasets": dataset_transforms(num_levels, dz_um, pixel_size_um),
        "name": name,
    }]}
    if omero is not None:
        members["omero"] = {k: v for k, v in omero.items() if k != 'version'}
    return {"ome": {"version": "0.5", **members}}


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

    Construct (writes the group metadata and every level's array
    metadata), then ``write_level(level, data, sel)`` per slab, then
    ``close()``. Slabs are (1, 1, 1, h, w) planes starting at column 0,
    as the band fusers produce them, or whole levels, as the in-RAM path
    saves them.

    ``cname`` None stores raw chunks (``direct_io`` 'auto', 'on' or
    'off' picks O_DIRECT writes, same bytes); 'lz4' stores blosc-lz4
    chunks (``clevel``; byte ``shuffle`` on v2, always on v3, as the JAX
    package writes them), encoded on a pool of one thread per CPU with
    at most 512 MiB of chunks in flight; ``close()`` waits for them and
    raises the first failure, and ``abort()`` ends a failed write without
    writing what is still queued. ``zarr_format`` 3 writes NGFF 0.5 groups
    with sharded levels (shards one chunk row tall and 16 chunks
    wide)."""

    def __init__(self, path: str, base_shape: Sequence[int],
                 num_levels: int, dtype, chunks: Sequence[int],
                 name: str, dz_um: float, pixel_size_um: float,
                 channel_names: Sequence[str], channel_colors: Sequence[int],
                 cname: Optional[str] = None, clevel: int = 5,
                 shuffle: int = 1, omero_full: bool = True,
                 zarr_format: int = 2, direct_io: str = 'auto'):
        if cname not in (None, 'lz4'):
            from ..params import _not_ported
            raise _not_ported(f"blosc {cname!r} chunks",
                              "item 15, 'other blosc codecs'")
        self.path = path
        self.num_levels = num_levels
        self.shapes = level_shapes(tuple(base_shape), num_levels)
        omero = omero_attrs(name, channel_names, channel_colors, dtype,
                            full=omero_full)
        if zarr_format == 3:
            write_group(path, multiscales_attrs_v3(
                name, num_levels, dz_um, pixel_size_um, omero=omero),
                zarr_format=3)
        else:
            attrs = multiscales_attrs(name, num_levels, dz_um, pixel_size_um)
            attrs["omero"] = omero
            write_group(path, attrs)
        self.pool = EncodePool() if cname is not None else None
        self.arrays = []
        for level, shape in enumerate(self.shapes):
            lpath = os.path.join(path, str(level))
            if cname is None and zarr_format == 3:
                arr = RawShardArray(lpath, shape, chunks, dtype,
                                    direct_io=direct_io)
            elif cname is None:
                arr = RawZarrArray(lpath, shape, chunks, dtype,
                                   direct_io=direct_io)
            elif zarr_format == 3:
                arr = BloscShardArray(lpath, shape, chunks, dtype, self.pool,
                                      clevel=clevel)
            else:
                arr = BloscZarrArray(lpath, shape, chunks, dtype, self.pool,
                                     clevel, shuffle)
            self.arrays.append(arr)

    def write_level(self, level: int, data: np.ndarray,
                    sel: Optional[Tuple[slice, ...]] = None) -> None:
        """Write a (1, 1, 1, h, w) slab at ``sel`` (t, c, z, y, x slices),
        or with ``sel`` None the whole level, a (T, C, Z, H, W) array of
        the level's shape, plane by plane. The caller may reuse ``data``
        when the call returns."""
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
        """Encode what is buffered and wait for every chunk write; raises
        the first failure. Raw writes are synchronous: nothing waits."""
        if self.pool is None:
            return
        try:
            for arr in self.arrays:
                arr.flush()
        except BaseException:
            self.pool.abort()
            raise
        self.pool.close()

    def abort(self) -> None:
        """End a failed write: chunks still queued are dropped and the
        encode threads are joined, so nothing more is written into this
        tree. Raw writes are synchronous: nothing to stop."""
        if self.pool is not None:
            self.pool.abort()
