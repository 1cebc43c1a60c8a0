"""OME-Zarr writer: multiscale images on zarr v2 (NGFF 0.4) or v3 (0.5).

The counterpart of the JAX package's ``io/omezarr.py``: the same
``.zattrs`` (or ``zarr.json`` attributes) multiscales and OMERO trees,
the same level shapes, and level arrays with the same chunk grid, raw or
blosc of any codec (``io/zarr_store.py``, ``io/zarr_shard.py``). Raw
chunks are written synchronously from the caller's thread, bytes equal
to the JAX package's raw writer's, by plane rows or, for a band fuser
laid out in chunk columns, by whole chunk-column blocks
(``block_spec``, ``write_level_block``); compressed chunks are encoded
and written on a pool of threads while the caller goes on.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .zarr_shard import BloscShardArray, RawShardArray
# DEFAULT_MAX_PENDING_BYTES is re-exported: the merges split it
from .zarr_store import (DEFAULT_MAX_PENDING_BYTES, BloscZarrArray,  # noqa: F401
                         BufferMeter, EncodePool, RawZarrArray, clamp_chunks,
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


def ngff05_wrap(**members) -> Dict:
    """OME-NGFF 0.5 group attributes (zarr v3): every member under one
    'ome' key with the group's version."""
    return {"ome": {"version": "0.5", **members}}


def multiscales_attrs_v3(name: str, num_levels: int, dz_um: float,
                         pixel_size_um: float,
                         omero: Optional[Dict] = None) -> Dict:
    """OME-NGFF 0.5 multiscales: the 0.4 multiscales and OMERO trees
    under :func:`ngff05_wrap`, without their own version keys."""
    members: Dict = {"multiscales": [{
        "axes": OME_AXES,
        "datasets": dataset_transforms(num_levels, dz_um, pixel_size_um),
        "name": name,
    }]}
    if omero is not None:
        members["omero"] = {k: v for k, v in omero.items() if k != 'version'}
    return ngff05_wrap(**members)


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


def plate_attrs(regions: Sequence[str], name: str,
                acquisition_name: str) -> Dict:
    """HCS plate metadata: rows are the regions' first letters, columns
    the rest of their names."""
    rows = sorted({r[0] for r in regions})
    columns = sorted({str(r[1:]) for r in regions})
    wells = [{"path": f"{well[0]}/{well[1:]}",
              "rowIndex": rows.index(well[0]),
              "columnIndex": columns.index(str(well[1:]))}
             for well in sorted(regions)]
    return {
        "plate": {
            "acquisitions": [{"id": 0, "maximumfieldcount": 1,
                              "name": acquisition_name}],
            "columns": [{"name": c} for c in columns],
            "field_count": 1,
            "name": name,
            "rows": [{"name": r} for r in rows],
            "version": "0.4",
            "wells": wells,
        }
    }


def well_attrs() -> Dict:
    """Well group metadata: one image, at path '0'."""
    return {"well": {"images": [{"path": "0", "acquisition": 0}],
                     "version": "0.4"}}


class MultiscaleWriter:
    """One multiscale OME-Zarr image group, written level by level.

    Construct (writes the group metadata and every level's array
    metadata), then ``write_level(level, data, sel)`` per slab, then
    ``close()``. Slabs are (t, c, z, h, w) blocks of planes starting at
    column 0: (1, 1, 1, h, w) planes of a band, as the band fusers
    produce them, (1, C, Z, h, w) bands of every plane, as the merges
    write them, or whole levels, as the in-RAM path saves them.

    ``cname`` None stores raw chunks (``direct_io`` 'auto', 'on' or
    'off' picks O_DIRECT writes, same bytes); chunks that span several
    planes (``chunks[:3]`` other than (1, 1, 1) once clamped to the
    level) are gathered whole before they are written, raw ones too
    (buffered writes, no block writes), and a chunk equal to the fill
    value is then not stored, as tensorstore stores none; a blosc cname ('lz4',
    'zstd', ... :data:`~image_stitcher_tpu_torch.io.blosc.CNAMES`) stores
    blosc chunks of that codec (``clevel``; ``shuffle`` on v2, always byte
    shuffle on v3, as the JAX package writes them), encoded on a pool of
    one thread per CPU with at most ``max_pending_bytes`` (512 MiB) of
    chunks in flight (writers that run at once split it); ``close()``
    waits for them and
    raises the first failure, and ``abort()`` ends a failed write without
    writing what is still queued. ``zarr_format`` 3 writes NGFF 0.5 groups
    with sharded levels (shards one chunk row tall and 16 chunks
    wide).

    ``slab_dtypes``, one per level, are the dtypes of the slabs the
    caller hands in (``dtype`` where None). A level whose slabs differ
    (the device paths' float32 slabs of float64 tiles) casts them, and
    is gathered: the JAX package hands such slabs to tensorstore, its
    raw writers refusing them, so no chunk equal to the fill value is
    stored."""

    def __init__(self, path: str, base_shape: Sequence[int],
                 num_levels: int, dtype, chunks: Sequence[int],
                 name: str, dz_um: float, pixel_size_um: float,
                 channel_names: Sequence[str], channel_colors: Sequence[int],
                 cname: Optional[str] = None, clevel: int = 5,
                 shuffle: int = 1, omero_full: bool = True,
                 zarr_format: int = 2, direct_io: str = 'auto',
                 max_pending_bytes: int = DEFAULT_MAX_PENDING_BYTES,
                 slab_dtypes: Optional[Sequence] = None):
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
        #: chunks over several planes are gathered whole, raw ones too
        self.gathers = tuple(clamp_chunks(chunks, base_shape)[:3]) != (1, 1, 1)
        self.dtype = np.dtype(dtype)
        casts = [np.dtype(d) != self.dtype
                 for d in (slab_dtypes or [dtype] * num_levels)]
        self.pool = (EncodePool(max_pending_bytes)
                     if cname is not None or self.gathers or any(casts)
                     else None)
        #: the host bytes the chunk-row buffers hold (``peak_buffer_bytes``)
        self.meter = BufferMeter()
        self.arrays = []
        for level, shape in enumerate(self.shapes):
            lpath = os.path.join(path, str(level))
            raw = cname is None and not (self.gathers or casts[level])
            if raw and zarr_format == 3:
                arr = RawShardArray(lpath, shape, chunks, dtype,
                                    direct_io=direct_io)
            elif raw:
                arr = RawZarrArray(lpath, shape, chunks, dtype,
                                   direct_io=direct_io)
            elif zarr_format == 3:
                arr = BloscShardArray(lpath, shape, chunks, dtype, self.pool,
                                      clevel=clevel, cname=cname,
                                      meter=self.meter)
            else:
                arr = BloscZarrArray(lpath, shape, chunks, dtype, self.pool,
                                     clevel, shuffle, cname, self.meter)
            self.arrays.append(arr)

    @property
    def peak_buffer_bytes(self) -> int:
        """The most host bytes the chunk-row buffers held at once."""
        return self.meter.peak

    def write_level(self, level: int, data: np.ndarray,
                    sel: Optional[Tuple[slice, ...]] = None) -> bool:
        """Write a (t, c, z, h, w) slab at ``sel`` (t, c, z, y, x slices;
        x from column 0), or with ``sel`` None the whole level, plane by
        plane; where chunks span several planes, chunk row by chunk row
        and within one every plane, so each chunk group's rows arrive in
        order (``ChunkRowBuffer``). Returns True: the caller may reuse
        ``data`` when the call returns (the OME-TIFF writer returns False,
        it keeps views)."""
        data = np.asarray(data)
        if data.ndim != 5:
            raise ValueError(f"slabs are (t, c, z, h, w), got {data.shape}")
        if data.dtype != self.dtype:
            data = data.astype(self.dtype)
        if sel is None:
            if data.shape != self.shapes[level]:
                raise ValueError(f"level {level} is {self.shapes[level]}, "
                                 f"got {data.shape}")
            t0 = c0 = z0 = y0 = 0
        else:
            t0, c0, z0, y0, x0 = (s.start or 0 for s in sel)
            if x0 != 0:
                raise ValueError("slabs start at column 0")
        arr = self.arrays[level]
        h = data.shape[3]
        cuts = [y0, y0 + h]
        if self.gathers:
            cy = arr.chunks[3]
            cuts[1:1] = range((y0 // cy + 1) * cy, y0 + h, cy)
        for r0, r1 in zip(cuts, cuts[1:]):
            for t, c, z in np.ndindex(*data.shape[:3]):
                arr.write_plane_rows(t0 + t, c0 + c, z0 + z, r0,
                                     data[t, c, z, r0 - y0:r1 - y0])
        return True

    def finish_group(self, t: int, z: Optional[int] = None) -> None:
        """Every row of the chunk groups holding T index ``t`` (and, when
        given, plane ``z``; every channel) is written: encode their
        buffered chunk rows now, not at :meth:`close`. Rows that nothing
        writes (a band without tiles) would otherwise hold a chunk row
        back; nothing to do for one-plane raw chunks."""
        for arr in self.arrays:
            rows = getattr(arr, 'rows', None)
            if rows is not None:
                rows.flush(t, z)

    def block_spec(self, level: int = 0) -> Optional[Tuple[int, int]]:
        """(chunk_rows, chunk_cols) when ``level`` takes chunk-column
        block writes (raw chunks, v2 or v3), else None: a band fuser that
        lays its band out as chunk-column blocks then writes each chunk
        file with one contiguous write (:meth:`write_level_block`)."""
        spec = getattr(self.arrays[level], 'block_spec', None)
        return spec() if spec is not None else None

    def write_level_block(self, level: int, c: int, z: int, y0: int,
                          cxi: int, block: np.ndarray) -> bool:
        """Write one chunk-column block of plane (0, c, z): ``block`` is
        (rows, chunk_cols), canvas rows [y0, y0+rows) of chunk column
        ``cxi``, its columns past the level's width zero (see
        ``RawZarrArray.try_write_block``). A block the raw writer refuses
        is written by its in-canvas columns through the level's
        ``write_plane_rows``. Returns True when the raw writer took the
        block whole, False when it went out as rows; either way the
        write is done and the caller may reuse ``block``. A level
        without block writes raises."""
        arr = self.arrays[level]
        if getattr(arr, 'try_write_block', None) is None:
            raise ValueError(f"level {level} of {self.path} "
                             f"({type(arr).__name__}) takes no block writes")
        if arr.try_write_block(0, c, z, y0, cxi, block):
            return True
        x0 = cxi * block.shape[1]
        x1 = min(x0 + block.shape[1], self.shapes[level][4])
        arr.write_plane_rows(0, c, z, y0, block[:, :x1 - x0], x0=x0)
        return False

    def close(self) -> None:
        """Encode what is buffered and wait for every chunk write; raises
        the first failure. Raw writes of one-plane chunks are synchronous:
        nothing waits."""
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
