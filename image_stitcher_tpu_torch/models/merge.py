"""Merge passes: the timepoint series and the HCS plates.

The counterpart of the JAX package's ``models/merge.py``, writing the
same trees:
- :func:`merge_timepoints_per_region`: each region's timepoints, padded
  to the largest shape and stacked along T, at
  ``region_time_series/{region}_time_series.ome.zarr``;
- :func:`create_hcs_ome_zarr_per_timepoint`: one HCS plate per timepoint
  (rows = region[0], columns = region[1:]) at
  ``hcs_timepoints/{t}_hcs.ome.zarr``;
- :func:`create_complete_hcs_ome_zarr`: one plate with the timepoints
  stacked, at ``hcs_timepoints/complete_hcs.ome.zarr``.

Each source's level 0 is copied band by band: a band is read through
the windowed reader (``io/zarr_store.open_array``) into pinned host
memory, written as level 0, uploaded, folded level by level with the 2x2
mean (:func:`~image_stitcher_tpu_torch.ops.pyramid.downsample_mean`, on
the pipeline's device: the card, or the CPU for a CPU pipeline), copied
back on the worker's own CUDA stream and written. Merges always fold
with the mean, whatever ``pyramid_downsample`` says. Peak memory is one
band a worker, whatever the volume, and the rows the writer gathers for
chunks over several planes: with ``chunks[0]`` timepoints a chunk, the
time series and the complete plate copy those timepoints band by band
together, so each chunk is encoded once and the writer holds one band
of each. A (timepoint, region) is merged only
when the run manifests list it as completed and its level 0 is on disk.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

import torch

from ..io.omezarr import (DEFAULT_MAX_PENDING_BYTES, MultiscaleWriter,
                          ngff05_wrap, plate_attrs, well_attrs)
from ..io.readers import device_dtype, device_np_dtype, torch_dtype
from ..io.zarr_store import open_array, write_group
from ..ops.pyramid import downsample_mean
from ..utils.manifest import MANIFEST_NAME
from .streaming import band_rows_for

MERGE_DOWNSAMPLE = 'mean'


class MergeStats:
    """Where the merges' time goes, summed over bands and workers:
    seconds reading bands (``read_s``) and writing chunks (``write_s``,
    with ``close_s`` for the writers' final drain), the card's
    milliseconds for the upload, the fold and the copies back (CUDA
    events; on a CPU pipeline the fold's wall milliseconds and no
    copies), and the level-0 bytes read."""

    FIELDS = ('read_s', 'write_s', 'close_s', 'h2d_ms', 'fold_ms', 'd2h_ms',
              'bytes_read', 'bands', 'units')

    def __init__(self):
        self._lock = threading.Lock()
        for name in self.FIELDS:
            setattr(self, name, 0)

    def add(self, **amounts) -> None:
        with self._lock:
            for name, v in amounts.items():
                setattr(self, name, getattr(self, name) + v)

    def as_dict(self) -> Dict[str, float]:
        return {name: getattr(self, name) for name in self.FIELDS}


def _group_attrs(zarr_format: int, **members):
    """Plate/well attributes: bare for NGFF 0.4 (zarr v2), under the
    versioned 'ome' key without their own version for NGFF 0.5 (v3)."""
    if zarr_format == 3:
        return ngff05_wrap(**{k: ({kk: vv for kk, vv in v.items()
                                   if kk != 'version'}
                                  if isinstance(v, dict) else v)
                              for k, v in members.items()})
    return dict(members)


def _region_level0_path(pipeline, t, region: str) -> str:
    return os.path.join(
        pipeline.output_folder, f"{t}_stitched",
        f"{region}_stitched{pipeline.output_format}", "0")


def _open_region_level0(pipeline, t, region: str):
    return open_array(_region_level0_path(pipeline, t, region))


def _unit_exists(pipeline, t, region: str) -> bool:
    """A (timepoint, region) store is present AND complete: the run
    manifests list it as completed (a region that failed mid-save under
    ``continue_on_error`` leaves a partial store on disk) and its level-0
    metadata is on disk (a bad store may have been deleted since). With
    no manifest in the folder (merges of an existing tree), the metadata
    on disk decides alone."""
    completed = _completed_units(pipeline)
    if completed is not None and f"{t}/{region}" not in completed:
        return False
    level0 = _region_level0_path(pipeline, t, region)
    return (os.path.exists(os.path.join(level0, '.zarray'))
            or os.path.exists(os.path.join(level0, 'zarr.json')))


def _completed_units(pipeline):
    """The union of the completed (t, region) keys of every manifest in
    the output folder, or None when there is none; read once per merge
    pass and kept on the pipeline."""
    _unset = object()
    cached = getattr(pipeline, '_merge_completed_units', _unset)
    if cached is not _unset:
        return cached
    paths = [p for p in glob.glob(os.path.join(pipeline.output_folder,
                                               MANIFEST_NAME + '*'))
             if not p.endswith('.tmp')]
    if not paths:
        pipeline._merge_completed_units = None
        return None
    keys = set()
    for p in paths:
        try:
            with open(p) as f:
                keys.update(json.load(f).get('completed', []))
        except Exception:
            continue
    pipeline._merge_completed_units = keys
    return keys


def _regions_with_all_timepoints(pipeline):
    out = []
    for region in pipeline.acq.regions:
        missing = [int(t) for t in pipeline.acq.timepoints
                   if not _unit_exists(pipeline, int(t), region)]
        if missing:
            pipeline.reporter.status(
                f"merge: skipping region {region} (missing stitched "
                f"output for timepoint(s) {missing})", False)
        else:
            out.append(region)
    return out


def _max_region_shape(pipeline, region: str) -> Tuple[int, ...]:
    shapes = [_open_region_level0(pipeline, int(t), region).shape
              for t in pipeline.acq.timepoints]
    return tuple(max(s) for s in zip(*shapes))


def _stream_volume_banded(pipeline, writer: MultiscaleWriter, sources,
                          num_levels: int) -> None:
    """Copy timepoint volumes, ``sources`` a list of (T index of
    ``writer``, level-0 array), band by band: each band of every source
    in turn, then the next band, each folded into every pyramid level on
    the pipeline's device (bands are a multiple of 2^(levels-1) rows, so
    pooling windows never cross them). The sources of one call are the
    timepoints that share chunk files (``chunks[0]`` of them), so each
    chunk row is complete, and encoded once, when its band has passed
    through every source; one band's staging serves them all."""
    stats: MergeStats = pipeline.merge_stats
    _, c, z = sources[0][1].shape[:3]
    h = max(src.shape[3] for _, src in sources)
    w = max(src.shape[4] for _, src in sources)
    band = band_rows_for(pipeline.options.write_band_rows(), num_levels)
    dev = pipeline.device
    on_cuda = dev.type == 'cuda'
    # pinned staging for a band's level 0 and its deeper levels, which
    # the device folds in the device dtype (float32 for float64)
    staging = torch.empty(c * z * min(band, h) * w,
                          dtype=torch_dtype(sources[0][1].dtype),
                          pin_memory=on_cuda)
    fold_dt = device_dtype(sources[0][1].dtype)
    lv_staging = [torch.empty(c * z * (band >> lv) * (w >> lv), dtype=fold_dt,
                              pin_memory=on_cuda)
                  for lv in range(1, num_levels)]
    stream = torch.cuda.Stream(dev) if on_cuda else None
    for band0 in range(0, h, band):
        for ti, src in sources:
            if band0 < src.shape[3]:
                _copy_band(writer, src, ti, band0, band, num_levels, staging,
                           lv_staging, stream, dev, stats)
    # rows past a smaller timepoint's edge are never written
    writer.finish_group(sources[0][0])


def _copy_band(writer: MultiscaleWriter, src, ti: int, band0: int,
               band: int, num_levels: int, staging, lv_staging, stream, dev,
               stats: MergeStats) -> None:
    """One band of ``src`` into T index ``ti``: read into the staging,
    written as level 0 while the device folds it, its levels written."""
    _, c, z, h, w = src.shape
    on_cuda = stream is not None
    rows = min(band, h - band0)
    host = staging[:c * z * rows * w].view(1, c, z, rows, w)
    t0 = time.perf_counter()
    src.read((0, slice(None), slice(None), slice(band0, band0 + rows)),
             out=host.numpy())
    t1 = time.perf_counter()
    with (torch.cuda.stream(stream) if on_cuda
          else contextlib.nullcontext()):
        if on_cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
        level = host[0].to(dev, non_blocking=True)
        if lv_staging:   # folded in the device dtype (float32 for float64)
            level = level.to(lv_staging[0].dtype)
        if on_cuda:
            ev[1].record()
        levels = []
        for _ in range(1, num_levels):
            level = downsample_mean(level)
            if level.shape[-2] == 0 or level.shape[-1] == 0:
                break
            levels.append(level)
        t2 = time.perf_counter()
        if on_cuda:
            ev[2].record()
        back = []
        for lv, level in enumerate(levels, 1):
            dst = lv_staging[lv - 1][:level.numel()].view(level.shape)
            dst.copy_(level, non_blocking=on_cuda)
            back.append(dst)
        if on_cuda:
            ev[3].record()
    # level 0 is written from the staging while the card folds
    t3 = time.perf_counter()
    writer.write_level(0, host.numpy(), sel=(
        slice(ti, ti + 1), slice(None), slice(None),
        slice(band0, band0 + rows), slice(0, w)))
    write_s = time.perf_counter() - t3
    if on_cuda:
        stream.synchronize()
        times = dict(h2d_ms=ev[0].elapsed_time(ev[1]),
                     fold_ms=ev[1].elapsed_time(ev[2]),
                     d2h_ms=ev[2].elapsed_time(ev[3]))
    else:
        times = dict(fold_ms=(t2 - t1) * 1e3)
    t4 = time.perf_counter()
    for lv, dst in enumerate(back, 1):
        b_lv = band0 >> lv
        writer.write_level(lv, dst.numpy()[None], sel=(
            slice(ti, ti + 1), slice(None), slice(None),
            slice(b_lv, b_lv + dst.shape[-2]), slice(0, dst.shape[-1])))
    stats.add(read_s=t1 - t0, write_s=write_s + time.perf_counter() - t4,
              bytes_read=host.numel() * host.element_size(), bands=1,
              **times)


def _stream_timepoints(pipeline, writer: MultiscaleWriter, region: str,
                       num_levels: int) -> None:
    """Write each timepoint's pyramid into a T-stacked store, the
    timepoints that share chunk files (``chunks[0]``) band by band
    together."""
    timepoints = list(enumerate(pipeline.acq.timepoints))
    per = max(1, int(pipeline.options.chunks[0]))
    for k in range(0, len(timepoints), per):
        _stream_volume_banded(
            pipeline, writer,
            [(ti, _open_region_level0(pipeline, int(t), region))
             for ti, t in timepoints[k:k + per]], num_levels)


def _make_image_writer(pipeline, path: str, base_shape, name: str,
                       n_concurrent: int = 1) -> MultiscaleWriter:
    acq = pipeline.acq
    opts = pipeline.options
    cname, clevel, shuffle = pipeline.resolved_compressor()
    return MultiscaleWriter(
        path, base_shape, pipeline.num_pyramid_levels, acq.dtype, opts.chunks,
        name, acq.dz_um, acq.pixel_size_um, acq.monochrome_channels,
        acq.monochrome_colors, cname=cname, clevel=clevel, shuffle=shuffle,
        omero_full=False, zarr_format=opts.zarr_format,
        direct_io=opts.direct_io,
        # level 0 is copied as stored, the deeper levels folded on the
        # device (float32 for float64 tiles)
        slab_dtypes=[acq.dtype] + [device_np_dtype(acq.dtype)] * (
            pipeline.num_pyramid_levels - 1),
        # writers that run at once split the backpressure window, so the
        # merges hold no more pending bytes than one writer would
        max_pending_bytes=DEFAULT_MAX_PENDING_BYTES // max(1, n_concurrent))


def _write_image(pipeline, path: str, base_shape, name: str, stream_fn,
                 n_concurrent: int) -> None:
    """One merged image: its writer, ``stream_fn(writer)`` to fill it,
    then the writer's close; a failure aborts the writer (nothing more
    lands in its tree) and re-raises."""
    writer = _make_image_writer(pipeline, path, base_shape, name,
                                n_concurrent)
    try:
        stream_fn(writer)
        t0 = time.perf_counter()
        writer.close()
    except BaseException:
        writer.abort()
        raise
    pipeline.merge_stats.add(close_s=time.perf_counter() - t0, units=1)


def _merge_worker_count(n_units: int) -> int:
    from ..params import _available_cpus
    return max(1, min(4, _available_cpus(), n_units))


def _map_merge_units(pipeline, units, fn) -> None:
    """Run the independent merge units (separate writers, separate
    trees) on a pool of min(4, CPUs, units) threads, sharing the
    pipeline's device (each worker folds on its own CUDA stream). On the
    first failure the queued units are cancelled and the error re-raises
    once the running ones finish. ``fn(unit, n_concurrent)`` gets the
    pool's size so its writer can split the backpressure window."""
    if not units:
        return
    workers = _merge_worker_count(len(units))
    if workers == 1:
        for u in units:
            fn(u, 1)
        return
    # decide the compressor here, not in a race between the workers
    pipeline.resolved_compressor()
    with ThreadPoolExecutor(workers, thread_name_prefix='merge') as pool:
        futures = [pool.submit(fn, u, workers) for u in units]
        try:
            for fut in futures:
                fut.result()
        except BaseException:
            for f in futures:
                f.cancel()
            raise


def merge_timepoints_per_region(pipeline) -> str:
    """{output}/region_time_series/{region}_time_series.ome.zarr for
    every region with all its timepoints."""
    out_dir = os.path.join(pipeline.output_folder, "region_time_series")
    os.makedirs(out_dir, exist_ok=True)
    num_t = len(pipeline.acq.timepoints)
    regions = _regions_with_all_timepoints(pipeline)

    def merge_one(region, n_concurrent):
        path = os.path.join(
            out_dir, f"{region}_time_series{pipeline.output_format}")
        base_shape = (num_t,) + _max_region_shape(pipeline, region)[1:]
        _write_image(pipeline, path, base_shape, f"Region_{region}",
                     lambda writer: _stream_timepoints(
                         pipeline, writer, region,
                         pipeline.num_pyramid_levels), n_concurrent)

    _map_merge_units(pipeline, regions, merge_one)
    if not regions:
        return ''
    return os.path.join(
        out_dir, f"{regions[-1]}_time_series{pipeline.output_format}")


def _write_well_tree(pipeline, plate_root: str, region: str, name: str,
                     base_shape, stream_fn, n_concurrent: int = 1) -> None:
    """The {row}/{col} groups with the well's metadata, and its image
    at {row}/{col}/0."""
    row, col = region[0], region[1:]
    zf = pipeline.options.zarr_format
    write_group(os.path.join(plate_root, row), zarr_format=zf)
    write_group(os.path.join(plate_root, row, col),
                _group_attrs(zf, well=well_attrs()["well"]), zarr_format=zf)
    _write_image(pipeline, os.path.join(plate_root, row, col, "0"),
                 base_shape, name, stream_fn, n_concurrent)


def create_hcs_ome_zarr_per_timepoint(pipeline) -> str:
    """One HCS plate per timepoint, of the regions that timepoint has."""
    out_dir = os.path.join(pipeline.output_folder, "hcs_timepoints")
    os.makedirs(out_dir, exist_ok=True)
    output_path = ''
    for t in pipeline.acq.timepoints:
        t = int(t)
        regions = [r for r in pipeline.acq.regions
                   if _unit_exists(pipeline, t, r)]
        skipped = [r for r in pipeline.acq.regions if r not in regions]
        if skipped:
            pipeline.reporter.status(
                f"merge: plate t={t} skips missing region(s) {skipped}",
                False)
        if not regions:
            continue
        output_path = os.path.join(out_dir, f"{t}_hcs{pipeline.output_format}")
        zf = pipeline.options.zarr_format
        write_group(output_path, _group_attrs(zf, **plate_attrs(
            regions, f"HCS Dataset - Timepoint {t}",
            f"Timepoint {t} Acquisition")), zarr_format=zf)

        def well_one(region, n_concurrent, t=t, output_path=output_path):
            src = _open_region_level0(pipeline, t, region)
            _write_well_tree(
                pipeline, output_path, region, f"Well_{region}_t{t}",
                src.shape, lambda writer: _stream_volume_banded(
                    pipeline, writer, [(0, src)], pipeline.num_pyramid_levels),
                n_concurrent)

        _map_merge_units(pipeline, regions, well_one)
    return output_path


def create_complete_hcs_ome_zarr(pipeline) -> str:
    """One plate with every timepoint stacked along T, of the regions
    that have all their timepoints."""
    out_dir = os.path.join(pipeline.output_folder, "hcs_timepoints")
    os.makedirs(out_dir, exist_ok=True)
    output_path = os.path.join(out_dir, f"complete_hcs{pipeline.output_format}")
    regions = _regions_with_all_timepoints(pipeline)
    if not regions:
        pipeline.reporter.status(
            "merge: no region has a complete set of stitched outputs; "
            "skipping the complete plate", False)
        return ''
    zf = pipeline.options.zarr_format
    write_group(output_path, _group_attrs(zf, **plate_attrs(
        regions, "Complete HCS Dataset", "Stitched Acquisition")),
        zarr_format=zf)
    num_t = len(pipeline.acq.timepoints)

    def well_one(region, n_concurrent):
        base_shape = (num_t,) + _max_region_shape(pipeline, region)[1:]
        _write_well_tree(
            pipeline, output_path, region, f"Well_{region}", base_shape,
            lambda writer: _stream_timepoints(pipeline, writer, region,
                                              pipeline.num_pyramid_levels),
            n_concurrent)

    _map_merge_units(pipeline, regions, well_one)
    return output_path


def run_merges(pipeline) -> str:
    """The merge pass the flags ask for: both flags, the complete plate;
    ``merge_timepoints``, the time series; ``merge_hcs_regions``, a plate
    per timepoint. Merges are zarr-only (the reference's GUIs offer them
    for zarr output only): with ``.ome.tiff`` output they are reported
    and skipped, as the JAX package does, and the last saved path is
    returned."""
    if not pipeline.output_format.endswith('.zarr'):
        pipeline.reporter.error(
            "merge passes require .ome.zarr output; skipping merges")
        return pipeline.saved_paths[-1] if pipeline.saved_paths else ''
    if pipeline.params.merge_timepoints and pipeline.params.merge_hcs_regions:
        return create_complete_hcs_ome_zarr(pipeline)
    if pipeline.params.merge_timepoints:
        return merge_timepoints_per_region(pipeline)
    return create_hcs_ome_zarr_per_timepoint(pipeline)
