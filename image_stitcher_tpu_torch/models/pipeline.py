"""StitchPipeline: the port's stitching engine.

The counterpart of the JAX package's ``models/pipeline.py``, for the
paths it runs on one device: scan the acquisition, fit flatfields (on
the host, or with ``flatfield_device='device'`` on the device), measure
registration (the center pair on the host; or every adjacent pair, in
batches on the device, aggregated by median ('all-pairs') or solved for
per-tile positions ('global', optionally subpixel)), then fuse every
(timepoint, region) by overwrite or feathered blending into OME-Zarr
(v2, or v3 with shards; blosc chunks of any codec, lz4 by default, or
raw, or 'auto'
(:meth:`StitchPipeline.resolved_compressor`)) or pyramidal OME-TIFF
(``output_format='.ome.tiff'``, ``io/tiffwriter.py``). A canvas over
``streaming_threshold_bytes`` (or any canvas with ``streaming='on'``)
streams through :class:`~image_stitcher_tpu_torch.models.streaming.
DeviceStreamingFuser` in bands; a smaller one (every well of an HCS
plate) is fused whole on the device (:meth:`StitchPipeline.stitch_region`)
and saved with its pyramid built on the device
(:meth:`StitchPipeline.save_region`), region N saving on a background
thread while region N+1 fuses. ``fusion_device='host'`` fuses on the CPU
instead (``ops/host_fuse.py``'s ``HostCanvas`` whole, ``models/
streaming.py``'s ``StreamingFuser`` in bands), its bands starting as
each channel's field is fitted; 'auto' stays on the device. With
``mesh_shape`` every canvas is cut into Y bands over a mesh of devices
(``parallel/sharded_fuse.py``) and written band by band
(:meth:`StitchPipeline._stitch_and_save_sharded`); with ``work_shard``
several processes share one output folder, each stitching its units,
the coordinator merging after a bounded barrier
(``parallel/distributed.py``). With
``registration_report``
the per-pair measurements and solve statistics land in
``registration_report.json``; ``debug_visuals`` writes the center
pairs' overlap strips as PNGs. Every run keeps a manifest
(``utils/manifest.py``) of its parameters, calibrations and completed
units, which ``resume=True`` goes on from; ``merge_timepoints`` and
``merge_hcs_regions`` then merge the region stores (``models/merge.py``).

Output tree: ``{out}/{t}_stitched/{region}_stitched.ome.zarr`` or
``.ome.tiff`` (and the merges' ``region_time_series/`` and
``hcs_timepoints/``, zarr only), with the
same sampling, geometry and metadata as the JAX package, so the two
packages write equal trees for the same input (tested).

The pipeline runs on an explicit ``device``, CUDA by default, or on a
sequence of devices, which a ``mesh_shape`` run bands its canvases over
(the first runs everything else). It never moves to another device by
itself: without CUDA, a CUDA pipeline raises.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core import geometry as geo
from ..io.acquisition import Acquisition, read_image, scan_acquisition
from ..io.omezarr import MultiscaleWriter
from ..io.readers import (TileBatchLoader, TileJob, expand_tile_jobs,
                          device_dtype, device_np_dtype, load_tile_plane)
from ..ops import cuda_fuse
from ..ops.fuse import padded_canvas_shape
from ..ops.phasecorr import (horizontal_shift_from_pcc,
                             normalize_to_dtype_range_np,
                             phase_cross_correlation_conf_batch,
                             phase_cross_correlation_conf_np,
                             phase_cross_correlation_np,
                             vertical_shift_from_pcc)
from ..params import EngineOptions, StitchingParameters
from ..state import CarriedState
from ..utils.manifest import RunManifest, find_resumable
from ..utils.profiling import StageTimers, carry, span, timed
from ..utils.progress import ProgressReporter, StitchCancelled
from .merge import MergeStats, run_merges


def resolve_device(device=None) -> torch.device:
    """The pipeline's device: CUDA unless told otherwise; a CUDA device
    without a CUDA runtime raises instead of running elsewhere."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                "image_stitcher_tpu_torch runs on CUDA by default and "
                "torch.cuda.is_available() is false; pass "
                "device=torch.device('cpu') to run the plain PyTorch "
                "versions on the CPU")
    elif device.type != 'cpu':
        raise ValueError(f"unsupported device {device}")
    return device


def check_output_dtype(dtype, output_format: str) -> None:
    """Raise ``TypeError`` naming a tile dtype that ``output_format``
    does not store. float16 tiles are written to OME-TIFF only: the JAX
    package's OME-Zarr writer has no float16 type (``KeyError`` from its
    ``zarr_dtype_str``, region and merge outputs alike); the port refuses
    such a run before it loads a tile."""
    if np.dtype(dtype) == np.float16 and not output_format.endswith('.tiff'):
        raise TypeError(f"float16 tiles are stitched to .ome.tiff only, not "
                        f"{output_format}: the JAX package's OME-Zarr "
                        f"writer has no float16 type")


class StitchPipeline:
    """Orchestrates a full stitching run for one acquisition."""

    def __init__(self, params: StitchingParameters,
                 options: Optional[EngineOptions] = None,
                 reporter: Optional[ProgressReporter] = None,
                 stop_event=None, resume: bool = False, device=None,
                 state: Optional[CarriedState] = None):
        params.validate()
        self.params = params
        self.options = options or EngineOptions()
        self.options.validate()
        #: the devices of a ``mesh_shape`` run: ``device`` as a sequence,
        #: or None (every CUDA card, ``parallel/mesh.py::make_mesh``)
        self.mesh_devices = None
        if isinstance(device, (list, tuple)):
            self.mesh_devices = [resolve_device(d) for d in device]
            if not self.mesh_devices:
                raise ValueError("device: an empty sequence of devices")
            device = self.mesh_devices[0]
        self.device = resolve_device(device)
        self.reporter = reporter or ProgressReporter()
        self.stop_event = stop_event
        self.state = state

        self.input_folder = params.input_folder
        #: True when this run goes on from an earlier run's manifest
        self.resumed = False
        if self.options.output_folder is not None:
            # an explicit folder pins the destination; resuming into it
            # needs a compatible manifest, or none at all
            self.output_folder = self.options.output_folder
            if resume:
                # a finished manifest is fine here: a work shard re-run
                # with resume skips every unit it completed
                m = RunManifest.load(self.output_folder,
                                     suffix=self._shard_suffix())
                if m is not None and not m.compatible_with(
                        params.to_dict(), self.options.output_fingerprint()):
                    raise ValueError(
                        f"refusing to resume into {self.output_folder}: "
                        f"its manifest was written with different "
                        f"parameters or output-affecting options")
                self.resumed = True
        elif resume:
            prior = find_resumable(self.input_folder, params.to_dict(),
                                   self.options.output_fingerprint())
            if prior is not None:
                self.output_folder = prior
                self.resumed = True
                self.reporter.status(f"Resuming run in {prior}", False)
            else:
                self.output_folder = params.stitched_folder
        else:
            self.output_folder = params.stitched_folder  # timestamp once
        self.output_format = params.output_format
        self.per_timepoint_region_output_template = os.path.join(
            self.output_folder, "{timepoint}_stitched",
            "{region}_stitched" + self.output_format)

        self.acq: Optional[Acquisition] = None
        self.flatfields: Dict[int, np.ndarray] = {}
        #: the host-fused run's fit, still running while fusion starts
        #: (:meth:`_prepare`), and the gate it publishes each field to
        self._ff_future = None
        self._ff_gate = None
        #: time.perf_counter() when the last flatfield fit finished
        self.fit_done_at: Optional[float] = None
        self._ff_recip_np_cache: Optional[np.ndarray] = None
        self._ff_recip_dev_cache: Optional[torch.Tensor] = None
        self._compressor_choice: Optional[Tuple[Optional[str], int, int]] \
            = None
        self._compressor_lock = threading.Lock()
        self.shifts = geo.RegistrationShifts(scan_pattern=params.scan_pattern)
        self.num_pyramid_levels = 1
        self.registration_channel = params.registration_channel
        #: per-region solved tile positions {region: {(row, col): (y, x)}}
        #: ('global' scope), integer and float
        self.global_positions: Dict = {}
        self.global_positions_float: Dict = {}
        self._global_rejected: set = set()  # regions whose solve failed
        #: pairs measured on the device in the last all-pairs run
        self.device_pairs = 0
        #: per-region registration reports ('registration_report')
        self.registration_reports: Dict[str, Dict] = {}
        self.saved_paths: List[str] = []
        self.timers = StageTimers()
        #: per-region fusion stats of the last run: batches placed, and on
        #: the band path the band fuser's stage seconds
        self.fuse_stats: Dict[str, Dict] = {}
        #: where the merges' time went (models/merge.py)
        self.merge_stats = MergeStats()
        self._manifest: Optional[RunManifest] = None

    # ------------------------------------------------------------------ util

    def _check_stop(self):
        if self.stop_event is not None and self.stop_event.is_set():
            raise StitchCancelled("stitching cancelled")

    def _shard_suffix(self) -> str:
        """'.shard{i}' for work shard i: the manifest and registration
        report of each shard sharing an output folder; '' otherwise."""
        shard = self.options.work_shard
        return f".shard{shard[0]}" if shard is not None else ""

    def _shard_barrier(self) -> None:
        """Wait for every cooperating process before the merges; a no-op
        without a process group of more than one process (sequential
        shards).

        Bounded: the wait is gloo's ``monitored_barrier`` with
        ``merge_barrier_timeout_s``, so a shard that died before the
        merge point FAILS this process with recovery guidance instead of
        deadlocking it; a timeout of 0 takes the untimed ``barrier``."""
        import datetime

        import torch.distributed as tdist
        if not (tdist.is_available() and tdist.is_initialized()
                and tdist.get_world_size() > 1):
            return
        from ..parallel.distributed import control_group
        group = control_group()
        timeout_s = self.options.merge_barrier_timeout_s
        try:
            if timeout_s:
                tdist.monitored_barrier(
                    group=group,
                    timeout=datetime.timedelta(seconds=timeout_s))
            else:
                tdist.barrier(group=group)
        except Exception as e:
            raise RuntimeError(
                "pre-merge shard barrier failed (timeout "
                f"{timeout_s:.0f}s) — a cooperating shard likely died "
                "before reaching the merge point. Recovery: re-run the "
                "dead shard with --resume into the same output folder "
                "(it skips its completed units), then re-run the "
                "coordinator shard with --resume to complete the "
                f"merges. (cause: {e})") from e

    def _dtype_max(self) -> float:
        dt = self.acq.dtype
        return float(np.iinfo(dt).max) if np.issubdtype(dt, np.integer) else 1.0

    # ----------------------------------------------------------- flatfields

    def flatfield_stacks(self) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield (monochrome channel index, (N, 96, 96) float32 sample
        stack) per channel, the samples every fit path uses.

        The sampling budget of the JAX package: per timepoint, up to
        ``flatfield_tiles_per_timepoint`` tiles shuffled by one
        ``random.Random(0)`` in tile-index order, stopping once more than
        ``flatfield_max_tiles`` are collected; samples are read
        decimated to the 96^2 working size. With
        ``flatfield_device='device'`` each stack is padded by cycling to
        ``flatfield_max_tiles + flatfield_tiles_per_timepoint``, as the
        JAX package pads it for its device solver."""
        from ..ops.flatfield import load_sample_small, pad_stack_cycled
        acq = self.acq
        opts = self.options
        target = opts.flatfield_max_tiles + opts.flatfield_tiles_per_timepoint
        rnd = random.Random(0)
        with ThreadPoolExecutor(opts.resolved_reader_threads(),
                                thread_name_prefix='fit-load') as pool:
            for channel in acq.channel_names:
                self._check_stop()
                paths = []
                for t in acq.timepoints:
                    t_paths = [rec.filepath for key, rec in acq.tiles.items()
                               if rec.channel == channel and key[0] == int(t)]
                    if not t_paths:
                        continue
                    rnd.shuffle(t_paths)
                    paths.extend(
                        t_paths[:min(opts.flatfield_tiles_per_timepoint,
                                     len(t_paths))])
                    if len(paths) > opts.flatfield_max_tiles:
                        break
                if not paths:
                    continue
                with span('fit.load'):
                    small = np.stack(list(pool.map(carry(load_sample_small),
                                                   paths[:target])))
                if opts.flatfield_device == 'device':
                    small = pad_stack_cycled(small, target)
                if small.ndim == 4 and small.shape[-1] == 3:
                    base = channel.split('_')[0]
                    for k, s in enumerate('RGB'):
                        yield (acq.monochrome_channels.index(f"{base}_{s}"),
                               small[..., k])
                else:
                    yield acq.monochrome_channels.index(channel), small

    def compute_flatfields(self):
        """Fit every channel's flatfield from :meth:`flatfield_stacks`:
        with the NumPy solver on the host, or with
        ``flatfield_device='device'`` with the torch solver on the
        pipeline's device, channel by channel; the field is stretched
        back to tile size on the host either way."""
        from ..ops.flatfield import (finalize_flatfield, fit_flatfield_stack,
                                     fit_flatfield_stack_np)
        acq = self.acq
        self.reporter.getting_flatfields()
        self._ff_recip_np_cache = None
        self._ff_recip_dev_cache = None
        on_device = self.options.flatfield_device == 'device'
        out_hw = (acq.input_height, acq.input_width)
        for idx, stack in self.flatfield_stacks():
            self._check_stop()
            with span('fit.solve', stack.nbytes):
                if on_device:
                    field = fit_flatfield_stack(
                        torch.from_numpy(stack).to(self.device)).cpu().numpy()
                else:
                    field = fit_flatfield_stack_np(stack)
                self.flatfields[idx] = finalize_flatfield(field, out_hw)
            if self._ff_gate is not None:
                self._ff_gate.publish(idx, self.flatfields[idx])
            self.reporter.update_progress(len(self.flatfields), acq.num_c)
        self.fit_done_at = time.perf_counter()

    def _await_ff(self) -> None:
        """Join the host-fused run's overlapped fit (no-op when none is in
        flight) and raise its error. Every reader of the complete field
        set comes through here; only the gated band fuser reads earlier."""
        fut = self._ff_future
        if fut is not None:
            fut.result()
            self._ff_future = None

    def _reap_fit(self) -> None:
        """After a failure: wait for an overlapped fit still running (it
        stops at its next cancellation check when the run was stopped);
        its own error is dropped, the run's is the one reported."""
        fut, self._ff_future = self._ff_future, None
        if fut is not None:
            try:
                fut.result()
            except Exception:
                pass

    def _ff_recip_or_none(self) -> Optional[np.ndarray]:
        """The complete reciprocal stack, or None when no field was
        fitted (read after the overlapped fit has joined)."""
        self._await_ff()
        return self._flatfield_recip_np() if self.flatfields else None

    def _flatfield_recip_np(self) -> np.ndarray:
        """(C, th, tw) f32 RECIPROCAL flatfield stack, ones where no field
        was fitted; computed once on the host so every backend multiplies
        the same values."""
        self._await_ff()
        if self._ff_recip_np_cache is None:
            acq = self.acq
            ff = np.ones((acq.num_c, acq.input_height, acq.input_width),
                         np.float32)
            for idx, field in self.flatfields.items():
                ff[idx] = 1.0 / field
            self._ff_recip_np_cache = ff
        return self._ff_recip_np_cache

    def _flatfield_recip(self) -> torch.Tensor:
        """:meth:`_flatfield_recip_np` on the pipeline's device (one
        upload per run)."""
        if self._ff_recip_dev_cache is None:
            self._ff_recip_dev_cache = torch.from_numpy(
                self._flatfield_recip_np()).to(self.device)
        return self._ff_recip_dev_cache

    def resolved_compressor(self) -> Tuple[Optional[str], int, int]:
        """(cname, clevel, shuffle) for the zarr writers. 'auto' stores
        raw chunks unless both gates pass: the median zlib-1 ratio of the
        first, center and last tiles is at most 0.6 (the content
        compresses; zlib-1 under-reports blosc's ratio), and the output
        device's probed write rate is under 300 MB/s per core (the disk,
        not the CPU, is the bottleneck); then blosc-lz4, clevel 5,
        shuffled. Decided once per run, under a lock, so every writer
        agrees (the JAX package's rule)."""
        opts = self.options
        if opts.compressor_cname != 'auto':
            return (opts.compressor_cname, opts.compressor_clevel,
                    opts.compressor_shuffle)
        with self._compressor_lock:
            if self._compressor_choice is None:
                self._compressor_choice = self._choose_compressor()
            return self._compressor_choice

    def _choose_compressor(self) -> Tuple[Optional[str], int, int]:
        import zlib
        from ..params import _available_cpus
        keys = sorted(self.acq.tiles.keys())
        ratios, probed = [], []
        for i in sorted({0, len(keys) // 2, len(keys) - 1}):
            rec = self.acq.tiles[keys[i]]
            flat = np.ravel(read_image(rec.filepath))
            raw = np.ascontiguousarray(
                flat[:(1 << 20) // flat.itemsize]).tobytes()
            ratios.append(len(zlib.compress(raw, 1)) / max(1, len(raw)))
            probed.append(os.path.basename(rec.filepath))
        ratio = float(np.median(ratios))
        detail = ", ".join(f"{n}={r:.2f}" for n, r in zip(probed, ratios))
        reason = None
        if ratio > 0.6:
            reason = "content doesn't compress enough"
        else:
            disk = self._probed_disk_mbps()
            ncores = _available_cpus()
            if disk is not None and disk >= 300.0 * ncores:
                reason = f"disk {disk:.0f} MB/s outruns {ncores}-core lz4"
        if reason is not None:
            self.reporter.status(
                f"compressor auto: median ratio {ratio:.2f} ({detail}) — "
                f"storing raw chunks ({reason})", False)
            return (None, 0, 0)
        self.reporter.status(
            f"compressor auto: median ratio {ratio:.2f} ({detail}) — "
            "blosc-lz4-5", False)
        return ('lz4', 5, 1)

    def _probed_disk_mbps(self) -> Optional[float]:
        """The output device's measured write rate (the better of the
        probe's buffered and direct arms), or None without a real
        measurement (O_DIRECT unsupported: 0.0 rates), so the decision
        falls back to the ratio gate alone."""
        from ..io.directio import probe_direct_io
        entry = probe_direct_io(os.path.dirname(self.output_folder) or '.')
        if entry:
            best = max(float(entry.get('buffered_mbps', 0.0)),
                       float(entry.get('direct_mbps', 0.0)))
            if best > 0.0:
                return best
        return None

    def _writer(self, t, region: str, output_path: str, shape,
                num_levels: int, slab_dtype):
        """The band-fed writer of one (timepoint, region) output: OME-Zarr
        (:class:`MultiscaleWriter`, handed slabs of ``slab_dtype``), or
        for ``.ome.tiff`` the streamed pyramidal OME-TIFF writer with the
        JAX band path's arguments."""
        acq = self.acq
        opts = self.options
        name = f"{region}_t{t}"
        if self.output_format.endswith('.tiff'):
            from ..io.ometiff import region_position_um, tiff_rgb_mode
            from ..io.tiffwriter import StreamingTiffWriter
            return StreamingTiffWriter(
                output_path, shape, num_levels, acq.dtype, name, acq.dz_um,
                acq.pixel_size_um, acq.monochrome_channels,
                acq.monochrome_colors,
                position_um=region_position_um(acq, t, region),
                rgb=tiff_rgb_mode(acq), compression=opts.tiff_compression,
                jpeg_quality=opts.tiff_jpeg_quality)
        cname, clevel, shuffle = self.resolved_compressor()
        return MultiscaleWriter(
            output_path, shape, num_levels, acq.dtype, opts.chunks, name,
            acq.dz_um, acq.pixel_size_um, acq.monochrome_channels,
            acq.monochrome_colors, cname=cname, clevel=clevel,
            shuffle=shuffle, zarr_format=opts.zarr_format,
            direct_io=opts.direct_io, slab_dtypes=[slab_dtype] * num_levels)

    # ---------------------------------------------------------- registration

    def _get_tile_image(self, t, region, x, y, channel, z_level) -> Optional[np.ndarray]:
        rec = self.acq.find_tile(t, region, x, y, channel, z_level)
        if rec is None:
            return None
        img = read_image(rec.filepath)
        if img.ndim == 3:  # RGB registration channel: correlate plane 0
            img = img[..., 0]
        return img

    def _measure_pair(self, img_a: np.ndarray, img_b: np.ndarray,
                      axis: str, max_overlap: int, debug_name: str = ''):
        """Normalize, crop the overlap strips (25% margin on the other
        axis), phase-correlate on the host; with ``debug_visuals`` the
        strips are written as ``{debug_name or axis}.png``."""
        dmax = self._dtype_max()
        a = normalize_to_dtype_range_np(img_a, dmax)
        b = normalize_to_dtype_range_np(img_b, dmax)
        margin_frac = self.options.registration_margin
        if axis == 'horizontal':
            margin = int(a.shape[0] * margin_frac)
            lo, hi = margin, a.shape[0] - margin
            strip_a = a[lo:hi, -max_overlap:]
            strip_b = b[lo:hi, :max_overlap]
        else:
            margin = int(a.shape[1] * margin_frac)
            lo, hi = margin, a.shape[1] - margin
            strip_a = a[-max_overlap:, lo:hi]
            strip_b = b[:max_overlap, lo:hi]
        if self.options.debug_visuals:
            self._visualize_strips(strip_a, strip_b, debug_name or axis)
        shift = phase_cross_correlation_np(
            strip_a, strip_b, upsample_factor=self.options.upsample_factor)
        return np.asarray(shift), strip_a.shape

    def _visualize_strips(self, s1: np.ndarray, s2: np.ndarray, title: str):
        """The two strips side by side ('horizontal*') or stacked, scaled
        to 8 bits as the JAX package scales them, as
        ``{output_folder}/{title}.png``. A debug image is best effort: a
        failure is reported and the run goes on, as in the JAX package."""
        from ..io.png import write_gray8
        combined = (np.hstack((s1, s2)) if title.startswith('horizontal')
                    else np.vstack((s1, s2)))
        img8 = (combined / self._dtype_max() * 255).astype(np.uint8)
        try:
            os.makedirs(self.output_folder, exist_ok=True)
            write_gray8(os.path.join(self.output_folder, f"{title}.png"), img8)
        except OSError as e:
            self.reporter.error(f"debug image {title}.png not written: {e}")

    def calculate_shifts(self, t, region: str):
        """Measure h/v (and S-Pattern reverse-h) shifts at the grid center."""
        self._check_stop()
        acq = self.acq
        if (not self.registration_channel
                or self.registration_channel not in acq.channel_names):
            self.registration_channel = acq.channel_names[0]
        z_level = self.params.registration_z_level

        xs, ys = acq.region_positions(int(t), region)
        h_shift: geo.Shift = (0, 0)
        v_shift: geo.Shift = (0, 0)
        h_shift_rev: geo.Shift = (0, 0)
        h_shift_rev_odd = 0

        dx_px = (xs[1] - xs[0]) * 1000 / acq.pixel_size_um if len(xs) > 1 else 0.0
        dy_px = (ys[1] - ys[0]) * 1000 / acq.pixel_size_um if len(ys) > 1 else 0.0
        max_x_overlap = geo.overlap_estimate(acq.input_width, dx_px,
                                             acq.pixel_binning,
                                             self.options.overlap_fudge)
        max_y_overlap = geo.overlap_estimate(acq.input_height, dy_px,
                                             acq.pixel_binning,
                                             self.options.overlap_fudge)

        cx = geo.grid_center_pair_indices(len(xs))
        cy = geo.grid_center_pair_indices(len(ys))
        center_x, center_y = xs[cx], ys[cy]
        right_x = xs[cx + 1] if cx + 1 < len(xs) else None
        bottom_y = ys[cy + 1] if cy + 1 < len(ys) else None
        ch = self.registration_channel

        if right_x is not None and max_x_overlap > 0:
            a = self._get_tile_image(t, region, center_x, center_y, ch, z_level)
            b = self._get_tile_image(t, region, right_x, center_y, ch, z_level)
            if a is not None and b is not None:
                shift, (_, sw) = self._measure_pair(a, b, 'horizontal',
                                                    max_x_overlap)
                h_shift = horizontal_shift_from_pcc(shift, sw)

        if bottom_y is not None and max_y_overlap > 0:
            a = self._get_tile_image(t, region, center_x, center_y, ch, z_level)
            b = self._get_tile_image(t, region, center_x, bottom_y, ch, z_level)
            if a is not None and b is not None:
                shift, (sh, _) = self._measure_pair(a, b, 'vertical',
                                                    max_y_overlap)
                v_shift = vertical_shift_from_pcc(shift, sh)

        if (self.params.scan_pattern == 'S-Pattern' and right_x is not None
                and bottom_y is not None and max_x_overlap > 0):
            a = self._get_tile_image(t, region, center_x, bottom_y, ch, z_level)
            b = self._get_tile_image(t, region, right_x, bottom_y, ch, z_level)
            if a is not None and b is not None:
                shift, (_, sw) = self._measure_pair(a, b, 'horizontal',
                                                    max_x_overlap,
                                                    'horizontal_rev')
                h_shift_rev = horizontal_shift_from_pcc(shift, sw)
                h_shift_rev_odd = int(cy % 2 == 0)

        self.shifts = geo.RegistrationShifts(
            h_shift=h_shift, v_shift=v_shift, h_shift_rev=h_shift_rev,
            h_shift_rev_odd=h_shift_rev_odd,
            scan_pattern=self.params.scan_pattern)
        if self.options.registration_report:
            self.registration_reports[str(region)] = {
                'scope': 'center',
                'channel': self.registration_channel,
                'z_level': z_level,
                'aggregated': {'h_shift': list(h_shift),
                               'v_shift': list(v_shift),
                               'h_shift_rev': list(h_shift_rev),
                               'h_shift_rev_odd': h_shift_rev_odd},
            }

    def calculate_shifts_all_pairs(self, t, region: str):
        """Every adjacent pair of the grid measured, then aggregated.

        Raw overlap strips of the registration channel stream through
        bounded batches of ``registration_batch_pairs`` pairs (phase
        correlation whitens the spectrum, so no normalization is
        needed); pairs touching a truncated tile are dropped. A batch of
        at most ``registration_device_threshold`` pairs runs the host
        twin, a larger one the batched version on ``self.device``. The
        grid shifts are the medians (parity-split rows for S-Pattern).
        With ``registration_scope='global'`` the pairs also feed a
        weighted least-squares solve for per-tile positions, clamped to
        the stage extent by dropping outlier constraints; a region whose
        solve stays outside falls back to the grid model."""
        from ..ops.globalopt import (grid_pairs_from_shifts,
                                     positions_to_int, solve_positions)
        self._check_stop()
        acq = self.acq
        if (not self.registration_channel
                or self.registration_channel not in acq.channel_names):
            self.registration_channel = acq.channel_names[0]
        ch = self.registration_channel
        z_level = self.params.registration_z_level
        opts = self.options

        xs, ys = acq.region_positions(int(t), region)
        n_cols, n_rows = len(xs), len(ys)
        dx_px = (xs[1] - xs[0]) * 1000 / acq.pixel_size_um if n_cols > 1 else 0.0
        dy_px = (ys[1] - ys[0]) * 1000 / acq.pixel_size_um if n_rows > 1 else 0.0
        ox = geo.overlap_estimate(acq.input_width, dx_px, acq.pixel_binning,
                                  opts.overlap_fudge)
        oy = geo.overlap_estimate(acq.input_height, dy_px, acq.pixel_binning,
                                  opts.overlap_fudge)
        my = int(acq.input_height * opts.registration_margin)
        mx = int(acq.input_width * opts.registration_margin)

        recs = {(r, c): acq.find_tile(t, region, xs[c], ys[r], ch, z_level)
                for r in range(n_rows) for c in range(n_cols)}
        h_keys = ([(r, c) for r in range(n_rows) for c in range(n_cols - 1)
                   if recs[(r, c)] and recs[(r, c + 1)]] if ox else [])
        v_keys = ([(r, c) for r in range(n_rows - 1) for c in range(n_cols)
                   if recs[(r, c)] and recs[(r + 1, c)]] if oy else [])
        sh_h = max(acq.input_height - 2 * my, 1)
        sw_v = max(acq.input_width - 2 * mx, 1)
        batch_pairs = max(1, opts.registration_batch_pairs)
        self.device_pairs = 0

        def fill(dst, src) -> bool:
            """Copy src into dst's top-left; True if src underfills it (a
            truncated tile: its zero remainder would feed the correlator
            a confident-looking wrong answer)."""
            s0 = min(dst.shape[0], src.shape[0])
            s1 = min(dst.shape[1], src.shape[1])
            dst[:s0, :s1] = src[:s0, :s1]
            return s0 < dst.shape[0] or s1 < dst.shape[1]

        def batch_measure(a, b):
            """(n, sh, sw) strip batches -> (shifts, confidences)."""
            n = len(a)
            if n <= opts.registration_device_threshold:
                out = [phase_cross_correlation_conf_np(
                    a[i], b[i], opts.upsample_factor) for i in range(n)]
                return ([np.asarray(s_) for s_, _ in out],
                        [float(c_) for _, c_ in out])
            shifts, peaks = phase_cross_correlation_conf_batch(
                torch.from_numpy(a).to(self.device),
                torch.from_numpy(b).to(self.device), opts.upsample_factor)
            self.device_pairs += n
            return (list(shifts.cpu().numpy()),
                    [float(c_) for c_ in peaks.cpu().tolist()])

        def measure_streamed(keys, kind):
            """Stream ``keys`` through bounded batches; returns (kept
            keys, shifts, confidences, pairs dropped). Memory held at
            any moment: two (batch, sh, sw) strip arrays."""
            shape = (sh_h, ox) if kind == 'h' else (oy, sw_v)
            kept, shifts, confs = [], [], []
            dropped = 0
            for start in range(0, len(keys), batch_pairs):
                chunk = list(keys[start:start + batch_pairs])
                n = len(chunk)
                a = np.zeros((n,) + shape, acq.dtype)
                b = np.zeros((n,) + shape, acq.dtype)
                partial = np.zeros(n, bool)
                # tile -> [(slot, side)]: each batch reads each tile once
                needs: Dict = {}
                for i, (r, c) in enumerate(chunk):
                    other = (r, c + 1) if kind == 'h' else (r + 1, c)
                    needs.setdefault((r, c), []).append((i, 'a'))
                    needs.setdefault(other, []).append((i, 'b'))

                def load(rc):
                    self._check_stop()
                    # whole-file readahead only for the h pass, whose
                    # column strips touch nearly every page
                    img = read_image(recs[rc].filepath, prefer_mmap=True,
                                     prefetch=(kind == 'h'))
                    if img.ndim == 3:
                        img = img[..., 0]
                    h_img, w_img = img.shape
                    for i, side in needs[rc]:
                        if kind == 'h':
                            src = (img[my:h_img - my, -ox:] if side == 'a'
                                   else img[my:h_img - my, :ox])
                        else:
                            src = (img[-oy:, mx:w_img - mx] if side == 'a'
                                   else img[:oy, mx:w_img - mx])
                        # store-only-True: both sides of a pair may run on
                        # different threads
                        if fill((a if side == 'a' else b)[i], src):
                            partial[i] = True

                with ThreadPoolExecutor(opts.resolved_reader_threads(),
                                        thread_name_prefix='pair-load'
                                        ) as pool:
                    list(pool.map(load, list(needs)))
                if partial.any():
                    dropped += int(partial.sum())
                    keep = ~partial
                    a, b = a[keep], b[keep]
                    chunk = [k for k, kp in zip(chunk, keep) if kp]
                if not chunk:
                    continue
                self._check_stop()
                s_, c_ = batch_measure(a, b)
                kept.extend(chunk)
                shifts.extend(s_)
                confs.extend(c_)
            return kept, shifts, confs, dropped

        h_keys, h_shifts, h_conf, dropped_h = measure_streamed(h_keys, 'h')
        v_keys, v_shifts, v_conf, dropped_v = measure_streamed(v_keys, 'v')
        if dropped_h or dropped_v:
            self.reporter.status(
                f"registration: dropping {dropped_h} horizontal"
                f" + {dropped_v} vertical pair(s) touching truncated tiles",
                False)

        def agg_h(shifts):
            if not shifts:
                return (0, 0)
            med = np.median(np.stack(shifts), axis=0)
            return (round(float(med[0])), round(float(med[1]) - ox))

        def agg_v(shifts):
            if not shifts:
                return (0, 0)
            med = np.median(np.stack(shifts), axis=0)
            return (round(float(med[0]) - oy), round(float(med[1])))

        if self.params.scan_pattern == 'S-Pattern' and h_shifts:
            even = [s_ for s_, (r, _) in zip(h_shifts, h_keys) if r % 2 == 0]
            odd = [s_ for s_, (r, _) in zip(h_shifts, h_keys) if r % 2 == 1]
            h_shift = agg_h(even) if even else (0, 0)
            h_shift_rev = agg_h(odd) if odd else h_shift
            h_shift_rev_odd = 1
        else:
            h_shift = agg_h(h_shifts)
            h_shift_rev = (0, 0)
            h_shift_rev_odd = 0
        self.shifts = geo.RegistrationShifts(
            h_shift=h_shift, v_shift=agg_v(v_shifts),
            h_shift_rev=h_shift_rev, h_shift_rev_odd=h_shift_rev_odd,
            scan_pattern=self.params.scan_pattern)
        report = None
        if opts.registration_report:
            def pair_records(keys, shifts, confs, direction, d_rc):
                return [{'a': [r, c], 'b': [r + d_rc[0], c + d_rc[1]],
                         'direction': direction,
                         'dy': float(s_[0]), 'dx': float(s_[1]),
                         'confidence': float(cf)}
                        for (r, c), s_, cf in zip(keys, shifts, confs)]
            report = {
                'scope': opts.registration_scope,
                'channel': ch, 'z_level': z_level,
                'strip_overlap': {'horizontal': int(ox), 'vertical': int(oy)},
                'pairs_dropped_truncated': dropped_h + dropped_v,
                'aggregated': {'h_shift': list(self.shifts.h_shift),
                               'v_shift': list(self.shifts.v_shift),
                               'h_shift_rev': list(self.shifts.h_shift_rev),
                               'h_shift_rev_odd': h_shift_rev_odd},
                'pairs': pair_records(h_keys, h_shifts, h_conf,
                                      'horizontal', (0, 1))
                + pair_records(v_keys, v_shifts, v_conf, 'vertical', (1, 0)),
            }
            self.registration_reports[str(region)] = report
        if opts.registration_scope != 'global':
            return

        pairs = grid_pairs_from_shifts(
            {k: tuple(map(float, s_)) for k, s_ in zip(h_keys, h_shifts)},
            {k: tuple(map(float, s_)) for k, s_ in zip(v_keys, v_shifts)},
            n_rows, n_cols, acq.input_width, acq.input_height, ox, oy,
            h_weights={k: float(c_) for k, c_ in zip(h_keys, h_conf)},
            v_weights={k: float(c_) for k, c_ in zip(v_keys, v_conf)})
        # Sanity clamp: solved positions must stay within the grid model's
        # extent plus slack, so one confidently wrong pair chain cannot
        # balloon the canvas. On a violation, drop the worst constraint
        # (a bounded number of times) and solve again; if the violation
        # survives the drop budget, the region uses the grid model.
        slack_y, slack_x = 2 * acq.input_height, 2 * acq.input_width
        exp = np.zeros((n_rows * n_cols, 2), np.float64)
        for r_ in range(n_rows):
            for c_ in range(n_cols):
                ex, ey = geo.tile_position_registered(
                    c_, r_, n_cols, n_rows, acq.input_width,
                    acq.input_height, self.shifts)
                exp[r_ * n_cols + c_] = (ey, ex)

        def violating_tiles(p, connected):
            """Tiles deviating from the grid model by more than the slack,
            modulo the solve's free translation (the median deviation)."""
            idx = sorted(connected)
            delta = p[idx].astype(np.float64) - exp[idx]
            dev = np.abs(delta - np.median(delta, axis=0))
            return {idx[k] for k in np.nonzero(
                (dev[:, 0] > slack_y) | (dev[:, 1] > slack_x))[0]}

        def dropped_records(dropped):
            return [{'i': int(i), 'j': int(j), 'dy': float(dy),
                     'dx': float(dx)} for i, j, dy, dx, _ in dropped]

        active = list(pairs)
        dropped_pairs = []
        max_drop = max(3, len(pairs) // 10)
        while True:
            pos_f = solve_positions(active, n_rows * n_cols)
            pos = positions_to_int(pos_f)
            # disconnected tiles sit at the solver's null position and
            # fall back to the grid model in _build_jobs
            connected = {i for p_ in active for i in (p_[0], p_[1])}
            bad = violating_tiles(pos, connected) if connected else set()
            if not bad:
                break
            incident = [k for k, (i, j, *_r) in enumerate(active)
                        if i in bad or j in bad]
            if not incident or len(dropped_pairs) >= max_drop:
                self.reporter.status(
                    f"global solve for region {region} exceeds the stage "
                    f"extent (+{slack_y}/{slack_x} px slack) even after "
                    f"dropping {len(dropped_pairs)} constraint(s); falling "
                    "back to the grid shift model", False)
                self._global_rejected.add(region)
                if report is not None:
                    report['global'] = {
                        'rejected': True,
                        'pairs_dropped': dropped_records(dropped_pairs),
                        'reason': 'solved positions exceed stage extent '
                                  f'(+{slack_y}/{slack_x} px slack) '
                                  f'after {len(dropped_pairs)} drops; '
                                  'grid shift model used instead'}
                return
            res = np.array([
                np.hypot(pos_f[j, 0] - pos_f[i, 0] - dy,
                         pos_f[j, 1] - pos_f[i, 1] - dx)
                for i, j, dy, dx, _ in active])
            if res[incident].max() > 3 * 3.0:
                # the flying tile's constraints disagree: drop the worst
                drop = [incident[int(res[incident].argmax())]]
            else:
                # self-consistent corruption: disconnect the tile so it,
                # not the region, falls back to the grid model
                drop = incident
            if len(dropped_pairs) + len(drop) > max_drop:
                drop = drop[:max_drop - len(dropped_pairs)]
            for k in sorted(drop, reverse=True):
                dropped_pairs.append(active.pop(k))
        if dropped_pairs:
            self.reporter.status(
                f"global solve for region {region}: dropped "
                f"{len(dropped_pairs)} outlier pair constraint(s) to stay "
                "within the stage extent", False)
        constrained = {i for p_ in active for i in (p_[0], p_[1])}
        self.global_positions[region] = {
            (r, c): (int(pos[r * n_cols + c, 0]), int(pos[r * n_cols + c, 1]))
            for r in range(n_rows) for c in range(n_cols)
            if r * n_cols + c in constrained}
        self.global_positions_float[region] = {
            (r, c): (float(pos_f[r * n_cols + c, 0]),
                     float(pos_f[r * n_cols + c, 1]))
            for r in range(n_rows) for c in range(n_cols)
            if r * n_cols + c in constrained}
        if report is not None:
            res = np.array([(pos_f[j, 0] - pos_f[i, 0] - dy,
                             pos_f[j, 1] - pos_f[i, 1] - dx)
                            for i, j, dy, dx, _ in active])
            report['global'] = {
                'rejected': False,
                'pairs_dropped': dropped_records(dropped_pairs),
                'tiles_solved': len(constrained),
                'tiles_total': n_rows * n_cols,
                # no pairs (a 1x1 region, or all truncated): no residuals
                'residual_rms_px': (float(np.sqrt((res ** 2).mean()))
                                    if res.size else None),
                'residual_max_px': (float(np.abs(res).max())
                                    if res.size else None),
            }

    def _ensure_global_positions(self, t, region: str):
        """Per-region global solve: each region's stage error is its own
        (solved the first time a region is stitched, and kept in the run
        manifest)."""
        if (self.options.registration_scope == 'global'
                and self.params.use_registration
                and region not in self.global_positions
                and region not in self._global_rejected):
            with self.timers.time('registration'):
                self.calculate_shifts_all_pairs(int(t), region)
            if self._manifest is not None:
                self._manifest.set_global_positions(
                    self.global_positions, self.global_positions_float)
                self._manifest.save()

    # -------------------------------------------------------------- stitching

    def _region_dimensions(self, t, region: str) -> Tuple[int, int]:
        acq = self.acq
        xs, ys = acq.region_positions(int(t), region)
        self._ensure_global_positions(t, region)
        region_pos = self.global_positions.get(region)
        if self.params.use_registration and region_pos:
            w = max(p[1] for p in region_pos.values()) + acq.input_width
            h = max(p[0] for p in region_pos.values()) + acq.input_height
            # unconstrained tiles fall back to the grid model; the canvas
            # must cover them too
            if len(region_pos) < len(xs) * len(ys):
                gw, gh = geo.output_dimensions_registered(
                    len(xs), len(ys), acq.input_width, acq.input_height,
                    self.shifts)
                w, h = max(w, gw), max(h, gh)
        elif self.params.use_registration:
            w, h = geo.output_dimensions_registered(
                len(xs), len(ys), acq.input_width, acq.input_height, self.shifts)
        else:
            w, h = geo.output_dimensions_coordinate(
                xs, ys, acq.input_width, acq.input_height, acq.pixel_size_um)
        if len(acq.regions) > 1:
            rows, cols = acq.rows_and_columns()
            max_dim = max(len(rows), len(cols))
        else:
            max_dim = 1
        self.num_pyramid_levels = geo.num_pyramid_levels(w, h, max_dim)
        return w, h

    def _build_jobs(self, t, region: str) -> List[TileJob]:
        acq = self.acq
        xs, ys = acq.region_positions(int(t), region)
        x_min, y_min = min(xs), min(ys)
        triples = []
        region_pos = self.global_positions.get(region, {})
        for rec in acq.region_tiles(int(t), region).values():
            if self.params.use_registration:
                col = xs.index(rec.x)
                row = ys.index(rec.y)
                if (row, col) in region_pos:
                    y_px, x_px = region_pos[(row, col)]
                    pos = (x_px, y_px)
                    if self.options.subpixel_placement:
                        fpos = self.global_positions_float[region][(row, col)]
                        y_px = int(np.floor(fpos[0]))
                        x_px = int(np.floor(fpos[1]))
                        # the content shifts by the fractional residual
                        # at load time (io/readers.py::load_tile_plane)
                        pos = (x_px, y_px, fpos[1] - x_px, fpos[0] - y_px)
                    # per-tile positions express stage jitter: keep whole
                    # tiles and let the blend resolve the overlaps
                    crops = (0, 0, 0, 0)
                else:
                    pos = geo.tile_position_registered(
                        col, row, len(xs), len(ys),
                        acq.input_width, acq.input_height, self.shifts)
                    crops = geo.tile_crops(col, row, len(xs), len(ys),
                                           self.shifts)
            else:
                pos = geo.tile_position_coordinate(
                    rec.x, rec.y, x_min, y_min, acq.pixel_size_um)
                crops = (0, 0, 0, 0)
            triples.append((rec, pos, crops))
        return expand_tile_jobs(acq.monochrome_channels, acq.rgb_channels,
                                triples)

    def stitch_region(self, t, region: str):
        """Fuse all tiles of one (timepoint, region) into one canvas on
        the pipeline's device; returns the cropped (C, Z, H, W) canvas.
        With ``fusion_device='host'`` the host fuser
        (``ops/host_fuse.HostCanvas``) fuses it into a NumPy canvas.

        The canvas carries a one-tile apron on the bottom and right
        (:func:`~image_stitcher_tpu_torch.ops.fuse.padded_canvas_shape`),
        its rows rounded up to a multiple of 8 elements as the band
        canvases' are, so the kernels store whole 16-byte vectors; it has
        no apron on top, and needs none: tiles start at y >= 0 and keep
        their ramps from their whole crop windows. Batches come from
        pinned host memory and go to ``cuda_fuse.fuse_overwrite``, or
        ``fuse_feather`` and then ``finalize_feather``, with the
        (C, th, tw) reciprocal flatfield fused in."""
        acq = self.acq
        opts = self.options
        width, height = self._region_dimensions(t, region)
        th, tw = acq.input_height, acq.input_width
        jobs = self._build_jobs(t, region)
        total = len(jobs)
        if opts.validate_plan:
            from ..utils.plan_check import summarize_plan
            self.reporter.status(summarize_plan(jobs, th, tw), False)
        if opts.fusion_device == 'host':
            from ..ops.host_fuse import HostCanvas
            hc = HostCanvas(acq.num_c, acq.num_z, height, width, acq.dtype,
                            num_threads=opts.resolved_fusion_threads(),
                            ff_recip=self._ff_recip_or_none(),
                            blend_method=opts.blend_method,
                            blend_px=opts.feather_px)
            hc.fuse_streaming(
                jobs, load_tile_plane,
                progress_cb=lambda n: self.reporter.update_progress(n, total),
                stop_check=self._check_stop)
            return hc.finalize()
        shape = list(padded_canvas_shape(acq.num_c, acq.num_z, height, width,
                                         th, tw))
        shape[3] = -(-shape[3] // 8) * 8
        self._await_ff()
        ff = self._flatfield_recip() if self.flatfields else None
        feather = opts.blend_method == 'feather'
        if feather:
            acc = torch.zeros(shape, dtype=torch.float32, device=self.device)
            wsum = torch.zeros(shape, dtype=torch.float32, device=self.device)
        else:
            canvas = torch.zeros(shape, dtype=device_dtype(acq.dtype),
                                 device=self.device)
        loader = TileBatchLoader(jobs, opts.fusion_batch, th, tw, acq.dtype,
                                 num_threads=opts.resolved_reader_threads(),
                                 pin_memory=self.device.type == 'cuda')
        processed = batches = 0
        for batch in loader:
            self._check_stop()
            tiles = batch.tiles.to(self.device, non_blocking=True)
            meta = (torch.from_numpy(batch.info),
                    torch.from_numpy(batch.crops),
                    torch.from_numpy(batch.valid))
            if feather:
                cuda_fuse.fuse_feather(acc, wsum, tiles, *meta, ff_recip=ff,
                                       blend_px=opts.feather_px)
            else:
                cuda_fuse.fuse_overwrite(canvas, tiles, *meta, ff_recip=ff)
            batches += 1
            processed += batch.count
            self.reporter.update_progress(processed, total)
        self.fuse_stats[f"{region}_t{t}"] = {'batches': batches}
        if feather:
            out = cuda_fuse.finalize_feather(acc, wsum,
                                             device_dtype(acq.dtype),
                                             (0, height), (0, width))
            del acc, wsum   # the stream orders their reuse after finalize
            return out
        return canvas[:, :, :height, :width]

    def _chunk_planes(self) -> Tuple[int, int]:
        """(channels, z planes) one output chunk spans: the band writers
        hand bands over chunk group by chunk group (``models/streaming.py::
        band_order``). (1, 1) for OME-TIFF, which has no chunks."""
        if self.output_format.endswith('.tiff'):
            return 1, 1
        return int(self.options.chunks[1]), int(self.options.chunks[2])

    def _should_stream(self, t, region: str) -> bool:
        """Band streaming for canvases over ``streaming_threshold_bytes``
        (unpadded (C, Z, H, W) bytes) under 'auto'; always under 'on';
        never under 'off'."""
        opts = self.options
        if opts.streaming != 'auto':
            return opts.streaming == 'on'
        acq = self.acq
        width, height = self._region_dimensions(t, region)
        canvas_bytes = (acq.num_c * acq.num_z * height * width
                        * acq.dtype.itemsize)
        return canvas_bytes > opts.streaming_threshold_bytes

    def _stitch_and_save_streaming(self, t, region: str) -> str:
        """Fuse + write one (timepoint, region) in bands: device-resident
        bands (:class:`~image_stitcher_tpu_torch.models.streaming.
        DeviceStreamingFuser`), or with ``fusion_device='host'`` host bands
        on a thread pool (:class:`~image_stitcher_tpu_torch.models.
        streaming.StreamingFuser`), which start each channel as soon as
        its field is fitted when the fit still runs."""
        from .streaming import DeviceStreamingFuser, StreamingFuser
        acq = self.acq
        opts = self.options
        width, height = self._region_dimensions(t, region)
        jobs = self._build_jobs(t, region)
        output_path = self.per_timepoint_region_output_template.format(
            timepoint=t, region=region)
        os.makedirs(os.path.dirname(output_path), exist_ok=True)
        writer = self._writer(t, region, output_path,
                              (1, acq.num_c, acq.num_z, height, width),
                              self.num_pyramid_levels,
                              acq.dtype if opts.fusion_device == 'host'
                              else device_np_dtype(acq.dtype))
        try:
            if opts.fusion_device == 'host':
                gate = self._ff_gate if self._ff_future is not None else None
                fuser = StreamingFuser(
                    writer, height, width, acq.input_height,
                    acq.input_width, acq.dtype, self.num_pyramid_levels,
                    opts.pyramid_downsample,
                    chunk_rows=opts.write_band_rows(),
                    num_threads=opts.resolved_fusion_threads(),
                    ff_recip=(None if gate is not None
                              else self._ff_recip_or_none()),
                    blend_method=opts.blend_method,
                    blend_px=opts.feather_px, ff_gate=gate,
                    chunk_planes=self._chunk_planes())
            else:
                fuser = DeviceStreamingFuser(
                    writer, height, width,
                    acq.input_height, acq.input_width, acq.dtype,
                    self.num_pyramid_levels, opts.pyramid_downsample,
                    chunk_rows=(opts.write_band_rows()
                                * opts.device_band_multiple),
                    batch_size=opts.fusion_batch,
                    reader_threads=opts.resolved_reader_threads(),
                    ff_recip=self._ff_recip_or_none(),
                    blend_method=opts.blend_method,
                    blend_px=opts.feather_px, device=self.device,
                    chunk_z=self._chunk_planes()[1])
        except BaseException:
            writer.abort()
            raise
        # run() closes the writer, or aborts it when the region fails
        if opts.fusion_device == 'host':
            fuser.run(jobs, load_tile_plane,
                      progress_cb=self.reporter.update_progress,
                      stop_check=self._check_stop)
            counts = {'bands': fuser.bands,
                      'first_band_at': fuser.first_band_at,
                      'blocks': fuser.blocks,
                      'block_refusals': fuser.block_refusals,
                      'block_cols': fuser.block_cols,
                      'fill_skips': fuser.fill_skips}
        else:
            fuser.run(jobs, progress_cb=self.reporter.update_progress,
                      stop_check=self._check_stop)
            counts = {'batches': fuser.batches}
        if hasattr(writer, 'peak_buffer_bytes'):
            counts['peak_buffer_bytes'] = writer.peak_buffer_bytes
        self.fuse_stats[f"{region}_t{t}"] = dict(fuser.stats, **counts)
        self.reporter.status(
            "stream stages: " + " ".join(
                f"{k}={v:.2f}s" for k, v in fuser.stats.items())
            + "".join(f" {k}={v}" for k, v in counts.items()), False)
        if getattr(fuser, 'cpu', None):
            # the host fuser's on-core sums beside its wall sums
            self.fuse_stats[f"{region}_t{t}"]['cpu'] = dict(fuser.cpu)
            self.reporter.status(
                "stream cpu: " + " ".join(
                    f"{k}={v:.2f}s" for k, v in fuser.cpu.items()), False)
        return output_path

    def _stitch_and_save_sharded(self, t, region: str) -> str:
        """Fuse one (timepoint, region) over a device mesh and write it
        band by band (``parallel/sharded_fuse.ShardedCanvas``): the
        canvas is cut into one Y band per device of the canvas axis, each
        band a multiple of the writer's band rows
        (``models/streaming.py::band_rows_for``), so no pyramid window
        crosses two bands, and a device whose band would start past the
        canvas holds nothing. After the last batch the bands go to the
        host piece by piece (:meth:`ShardedCanvas.iter_bands`): one (c, z)
        plane's rows of one band, cut again at the band path's band
        height, each copied on a side stream of its device only when the
        writer's hand-off has room. One writer thread writes each piece's
        rows and pyramid levels in the band path's order (chunk group by
        chunk group, ``models/streaming.py::band_order``). At most three
        pieces are alive on the host (one being written, one in the
        hand-off, one being copied; ``fuse_stats[...]['peak_host_bytes']``
        is their peak), besides the rows the writer gathers for chunks over
        several planes (``peak_buffer_bytes``: at most one piece's rows of
        every plane of a z group), so no device and no host buffer ever
        holds the whole canvas. Any writer of :meth:`_writer` takes them.

        The tree is the band path's: rows of a (c, z) plane that no tile
        reaches within one of the band path's bands
        (``DeviceStreamingFuser``'s band height) are not written, and
        read as the fill value, as the band path leaves them (an
        OME-TIFF file gets them as zeros,
        ``models/streaming.py::writer_planes``)."""
        from ..parallel.mesh import make_mesh
        from ..parallel.sharded_fuse import ShardedCanvas
        from .streaming import (band_levels, band_rows_for,
                                partition_jobs_by_band, write_band_levels,
                                write_behind, writer_planes)
        acq = self.acq
        opts = self.options
        width, height = self._region_dimensions(t, region)
        th, tw = acq.input_height, acq.input_width
        levels = self.num_pyramid_levels
        jobs = self._build_jobs(t, region)
        total = len(jobs)
        if opts.validate_plan:
            from ..utils.plan_check import summarize_plan
            self.reporter.status(summarize_plan(jobs, th, tw), False)
        mesh = make_mesh(opts.mesh_shape, self.mesh_devices)
        n_bands = opts.mesh_shape[1]
        align = band_rows_for(opts.write_band_rows(), levels)
        band = -(-(-(-height // n_bands)) // align) * align
        # the band path's bands
        path_band = band_rows_for(
            opts.write_band_rows() * opts.device_band_multiple, levels)
        self._await_ff()
        canvas = ShardedCanvas(mesh, acq.num_c, acq.num_z, height, width,
                               th, tw, acq.dtype,
                               blend_method=opts.blend_method,
                               blend_px=opts.feather_px,
                               ff_recip=self._ff_recip_or_none(), band=band)
        on_cuda = any(d.type == 'cuda' for d in canvas.devices)
        loader = TileBatchLoader(jobs, opts.fusion_batch, th, tw, acq.dtype,
                                 num_threads=opts.resolved_reader_threads(),
                                 pin_memory=on_cuda)
        # per band: its pieces' read-back waits and writes (seconds)
        stats = {'fuse': 0.0, 'readback_wait': [0.0] * len(canvas.bands),
                 'write': [0.0] * len(canvas.bands), 'close': 0.0,
                 'peak_host_bytes': 0}
        processed = batches = 0
        with timed('band.fuse') as fused:
            for batch in loader:
                self._check_stop()
                canvas.fuse_batch(batch.tiles, batch.info, batch.crops,
                                  batch.valid)
                batches += 1
                processed += batch.count
                self.reporter.update_progress(processed, total)
        stats['fuse'] = fused.seconds
        output_path = self.per_timepoint_region_output_template.format(
            timepoint=t, region=region)
        os.makedirs(os.path.dirname(output_path), exist_ok=True)
        writer = self._writer(t, region, output_path,
                              (1, acq.num_c, acq.num_z, height, width),
                              levels, device_np_dtype(acq.dtype))
        # which (c, z, band start) the band path writes
        written = set(partition_jobs_by_band(jobs, th, height, path_band,
                                             writer_planes(writer))[0])
        live = [0]        # host bytes of the pieces not yet written
        lock = threading.Lock()

        def pieces():
            for item in canvas.iter_bands(
                    piece_rows=path_band,
                    keep=lambda c, z, r0: (c, z, r0 // path_band
                                           * path_band) in written,
                    z_group=self._chunk_planes()[1]):
                with lock:
                    live[0] += item[3].nbytes
                    stats['peak_host_bytes'] = max(stats['peak_host_bytes'],
                                                   live[0])
                yield item
                item = None

        def write(item):
            c, z, r0, host, event = item
            with timed('band.readback_wait', host.nbytes) as waited:
                if event is not None:
                    event.synchronize()
            with timed('band.write') as wrote:
                write_band_levels(writer, c, z, r0, band_levels(
                    host.numpy(), levels, opts.pyramid_downsample))
            stats['readback_wait'][r0 // band] += waited.seconds
            stats['write'][r0 // band] += wrote.seconds
            with lock:
                live[0] -= host.nbytes

        write_behind(pieces(), write, writer)
        with timed('band.close') as closed:
            writer.close()
        stats['close'] = closed.seconds
        if hasattr(writer, 'peak_buffer_bytes'):
            stats['peak_buffer_bytes'] = writer.peak_buffer_bytes
        self.fuse_stats[f"{region}_t{t}"] = dict(
            stats, batches=batches, band_rows=band,
            bands=canvas.band_stats())
        self.reporter.status(
            f"mesh {opts.mesh_shape}: {len(canvas.bands)} bands of {band} "
            f"rows on {[str(d) for d in canvas.devices]}; fuse "
            f"{stats['fuse']:.2f}s, read-back waits "
            f"{sum(stats['readback_wait']):.2f}s, writes "
            f"{sum(stats['write']):.2f}s, close {stats['close']:.2f}s",
            False)
        return output_path

    # ------------------------------------------------------------------ save

    def save_region(self, t, region: str, canvas,
                    num_levels: Optional[int] = None,
                    ready: Optional[torch.cuda.Event] = None) -> str:
        """Write the multiscale OME-Zarr, or for ``.ome.tiff`` the
        pyramidal OME-TIFF (``io/ometiff.py``), of one (timepoint,
        region) from its (C, Z, H, W) canvas: the pyramid is built on the
        canvas's device, level from level (a NumPy canvas of the host
        fuser: on the host), and each level is copied to the host once
        (pinned memory for a CUDA canvas) and written.

        ``num_levels`` is passed by the pipelined save, so a background
        save is immune to the next region recomputing
        ``self.num_pyramid_levels``. A CUDA canvas is read on a side
        stream of this thread, after ``ready`` (an event recorded where
        the canvas was finished; the current stream when None), and
        recorded on that stream, so the caching allocator cannot hand its
        memory to the next region before the save has read it."""
        from ..ops.pyramid import iter_host_levels
        opts = self.options
        if num_levels is None:
            num_levels = self.num_pyramid_levels
        output_path = self.per_timepoint_region_output_template.format(
            timepoint=t, region=region)
        os.makedirs(os.path.dirname(output_path), exist_ok=True)
        on_cuda = (isinstance(canvas, torch.Tensor)
                   and canvas.device.type == 'cuda')
        scope = contextlib.nullcontext()
        if on_cuda:
            side = torch.cuda.Stream(canvas.device)
            if ready is not None:
                side.wait_event(ready)
            else:
                side.wait_stream(torch.cuda.current_stream(canvas.device))
            canvas.record_stream(side)
            scope = torch.cuda.stream(side)
        levels = iter_host_levels(canvas, num_levels, opts.pyramid_downsample)
        if self.output_format.endswith('.tiff'):
            from ..io.ometiff import write_ome_tiff_region
            with scope:
                return write_ome_tiff_region(self, t, region, list(levels),
                                             output_path)
        writer = self._writer(t, region, output_path,
                              (1,) + tuple(canvas.shape), num_levels,
                              canvas.dtype if isinstance(canvas, np.ndarray)
                              else device_np_dtype(self.acq.dtype))
        try:
            with scope:
                for lv, level in enumerate(levels):
                    writer.write_level(lv, level[None])
        except BaseException:
            writer.abort()   # queued chunks must not land after the error
            raise
        writer.close()
        return output_path

    # ------------------------------------------------------------------- run

    def _prepare(self, manifest: RunManifest):
        """Flatfields and registration: on a resumed run taken from its
        manifest (the fields from its sidecar, the shifts and global
        positions from the manifest itself), on a fresh run carried over
        from ``state`` where given; what is still missing is fitted and
        measured here (the fit on a worker thread, overlapped with the
        registration measurement: they read disjoint data and share no
        state; a host-fused run's fit runs on into fusion, publishing
        each channel's field to a ``FlatfieldGate``). The 'global' scope
        also needs positions to skip its
        measurement; regions without them are solved when they are
        stitched. The manifest then records the shifts and positions,
        and the sidecar every field not read from it."""
        state = self.state
        scope = self.options.registration_scope
        fields = None
        if self.params.apply_flatfield and self.resumed:
            fields = manifest.load_flatfields() or None
        from_sidecar = fields is not None
        if fields is None and state is not None:
            fields = state.flatfields
        shifts = positions = None
        saved = manifest.get_shifts() if self.resumed else None
        if saved is not None:
            shifts = saved
            ints, floats = manifest.get_global_positions()
            positions = (ints, floats) if ints else None
        elif state is not None and state.shifts is not None:
            shifts = state.shifts
            if scope == 'global' and state.global_positions is not None:
                positions = (state.global_positions,
                             state.global_positions_float or {})
        fit = self.params.apply_flatfield and fields is None
        measure = self.params.use_registration and (
            shifts is None or (scope == 'global' and positions is None))
        if self.params.apply_flatfield and not fit:
            self.flatfields = dict(fields)
        if self.params.use_registration and not measure:
            self.shifts = shifts
            if positions is not None:
                self.global_positions = dict(positions[0])
                self.global_positions_float = dict(positions[1])

        def fit_flatfields():
            with self.timers.time('flatfield_fit'):
                self.compute_flatfields()

        def measure_shifts():
            with self.timers.time('registration'):
                if scope in ('all-pairs', 'global'):
                    self.calculate_shifts_all_pairs(
                        int(self.acq.timepoints[0]), self.acq.regions[0])
                else:
                    self.calculate_shifts(self.acq.timepoints[0],
                                          self.acq.regions[0])

        # a host-fused run's fit also runs on into fusion: its band fuser
        # starts each channel as the channel's field is published to the
        # gate, and the fit thread saves the sidecar when it is done
        gated = (fit and self.options.overlap_prep
                 and self.options.fusion_device == 'host')
        if gated or (fit and measure and self.options.overlap_prep):
            # import scipy.fft once here: a first import from two threads
            # at once can observe a partly initialized module
            from scipy import fft as _scipy_fft  # noqa: F401
        if gated:
            from .streaming import FlatfieldGate
            gate = self._ff_gate = FlatfieldGate(
                self.acq.num_c, (self.acq.input_height,
                                 self.acq.input_width))

            def gated_fit():
                try:
                    fit_flatfields()
                except BaseException as e:
                    gate.fail(e)
                    raise
                gate.finish()
                manifest.save_flatfields(self.flatfields)

            pool = ThreadPoolExecutor(1, thread_name_prefix='flatfield-fit')
            self._ff_future = pool.submit(carry(gated_fit))
            pool.shutdown(wait=False)
            if measure:
                try:
                    measure_shifts()
                except BaseException:
                    self._reap_fit()
                    raise
        elif fit and measure and self.options.overlap_prep:
            with ThreadPoolExecutor(1, thread_name_prefix='flatfield-fit'
                                    ) as pool:
                ff_future = pool.submit(carry(fit_flatfields))
                try:
                    measure_shifts()
                finally:
                    ff_future.result()
        else:
            if fit:
                fit_flatfields()
            if measure:
                measure_shifts()
        if not from_sidecar and not gated:
            manifest.save_flatfields(self.flatfields)
        if self.params.use_registration:
            manifest.set_shifts(self.shifts)
            if self.global_positions:
                manifest.set_global_positions(self.global_positions,
                                              self.global_positions_float)

    def _process_regions(self, manifest: RunManifest) -> str:
        """Fuse and save every (timepoint, region) the manifest does not
        list as completed: canvases that :meth:`_should_stream` streams
        in bands, the others fused whole and saved, with
        ``pipelined_save`` on one background saver while the next region
        fuses (at most one canvas in flight). Each saved unit is marked
        completed in the manifest. With ``continue_on_error`` a failed
        region, fuse or save, is reported and skipped (and stays out of
        the manifest); cancellation always propagates."""
        final_path = ''
        pending = None  # (future, timepoint, region)
        executor = (ThreadPoolExecutor(max_workers=1,
                                       thread_name_prefix='region-saver')
                    if self.options.pipelined_save else None)

        def do_save(timepoint, region, canvas, num_levels, ready):
            with self.timers.time('save'):
                return self.save_region(timepoint, region, canvas,
                                        num_levels=num_levels, ready=ready)

        def failed(region, timepoint, e: Exception) -> None:
            if not self.options.continue_on_error:
                raise e
            self.reporter.error(f"region {region} t{timepoint} failed: {e}")

        def completed(path, timepoint, region) -> None:
            nonlocal final_path
            final_path = path
            self.saved_paths.append(path)
            manifest.mark_completed(timepoint, region)
            self.reporter.status(f"Completed region {region} t{timepoint}",
                                 False)

        def reap(entry) -> None:
            """Wait for a background save; its failure surfaces here."""
            future, timepoint, region = entry
            try:
                path = future.result()
            except Exception as e:
                failed(region, timepoint, e)
                return
            completed(path, timepoint, region)

        shard = self.options.work_shard
        unit_idx = -1
        try:
            for timepoint in self.acq.timepoints:
                timepoint = int(timepoint)
                os.makedirs(os.path.join(self.output_folder,
                                         f"{timepoint}_stitched"),
                            exist_ok=True)
                for region in self.acq.regions:
                    self._check_stop()
                    unit_idx += 1
                    if shard is not None and unit_idx % shard[1] != shard[0]:
                        # another shard owns this unit (deterministic
                        # round robin over the (t, region) enumeration)
                        continue
                    if manifest.is_completed(timepoint, region):
                        final_path = (self.per_timepoint_region_output_template
                                      .format(timepoint=timepoint,
                                              region=region))
                        self.reporter.status(
                            f"Skipping completed region {region} "
                            f"t{timepoint}", False)
                        continue
                    self.reporter.starting_stitching()
                    try:
                        # an explicit mesh overrides backend selection:
                        # bands over its devices, streamed to the writer
                        sharded = self.options.mesh_shape is not None
                        stream = sharded or self._should_stream(timepoint,
                                                                region)
                        if sharded:
                            with self.timers.time('sharded_fuse_save'):
                                path = self._stitch_and_save_sharded(
                                    timepoint, region)
                        elif stream:
                            with self.timers.time('stream_fuse_save'):
                                path = self._stitch_and_save_streaming(
                                    timepoint, region)
                        else:
                            with self.timers.time('fuse'):
                                canvas = self.stitch_region(timepoint, region)
                    except StitchCancelled:
                        raise
                    except Exception as e:
                        failed(region, timepoint, e)
                        continue
                    if stream:
                        completed(path, timepoint, region)
                        continue
                    self.reporter.starting_saving(False)
                    ready = None
                    if (isinstance(canvas, torch.Tensor)
                            and canvas.device.type == 'cuda'):
                        ready = torch.cuda.Event()
                        ready.record(torch.cuda.current_stream(canvas.device))
                    levels = self.num_pyramid_levels
                    if executor is not None:
                        if pending is not None:
                            reap(pending)  # bound in-flight canvases to 1
                        pending = (executor.submit(do_save, timepoint, region,
                                                   canvas, levels, ready),
                                   timepoint, region)
                        canvas = None
                        continue
                    try:
                        path = do_save(timepoint, region, canvas, levels,
                                       ready)
                    except Exception as e:
                        failed(region, timepoint, e)
                        continue
                    finally:
                        canvas = None
                    completed(path, timepoint, region)
            if pending is not None:
                reap(pending)
        finally:
            if executor is not None:
                executor.shutdown(wait=True)
        return final_path

    def _write_registration_report(self) -> None:
        """Write the per-region pair measurements and solve statistics to
        ``registration_report.json`` in the output folder (atomically: a
        temporary file, then a rename)."""
        if not (self.options.registration_report
                and self.registration_reports):
            return
        path = os.path.join(self.output_folder, "registration_report"
                            + self._shard_suffix() + ".json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"registration_channel": self.registration_channel,
                       "upsample_factor": self.options.upsample_factor,
                       "regions": self.registration_reports}, f, indent=2)
        os.replace(tmp, path)
        self.reporter.status(f"Registration report: {path}", False)

    def run(self) -> str:
        """Execute the full pipeline; returns the last saved path."""
        t0 = time.time()
        try:
            with self.timers.time('scan'):
                self.acq = scan_acquisition(self.input_folder)
            check_output_dtype(self.acq.dtype, self.output_format)
            os.makedirs(self.output_folder, exist_ok=True)
            suffix = self._shard_suffix()
            manifest = ((RunManifest.load(self.output_folder, suffix=suffix)
                         if self.resumed else None)
                        or RunManifest(self.output_folder, suffix=suffix))
            manifest.set_params(self.params.to_dict(),
                                self.options.output_fingerprint())
            self._prepare(manifest)
            manifest.save()
            self._manifest = manifest
            final_path = self._process_regions(manifest)
            self._await_ff()   # a host-fused run's fit: its error surfaces
            shard = self.options.work_shard
            do_merge = (self.params.merge_timepoints
                        or self.params.merge_hcs_regions)
            if do_merge and shard is not None:
                # the merges read every shard's region outputs: every
                # process meets here first
                with self.timers.time('shard_barrier'):
                    self._shard_barrier()
            if do_merge and shard is not None and shard[0] != 0:
                self.reporter.status(
                    "merges are the coordinator shard's job; skipping on "
                    f"shard {shard[0]}", False)
            elif do_merge:
                if self.resumed and manifest.data.get("merges_done"):
                    self.reporter.status("Merges already complete; skipping",
                                         False)
                else:
                    self.reporter.starting_saving(True)
                    # a resumed run may have skipped every region: the
                    # merges' pyramid depth comes from the first region
                    self._region_dimensions(int(self.acq.timepoints[0]),
                                            self.acq.regions[0])
                    with self.timers.time('merge'):
                        final_path = run_merges(self)
                    manifest.data["merges_done"] = True
                    manifest.save()
            self._write_registration_report()
            manifest.mark_finished()
            self.reporter.finished_saving(final_path, self.acq.dtype)
            for line in self.timers.summary():
                self.reporter.status(line, False)
            self.reporter.status(
                f"Total processing time: {time.time() - t0:.1f}s", False)
            return final_path
        except StitchCancelled:
            self._reap_fit()
            self.reporter.status("Stitching cancelled", False)
            raise
        except Exception as e:
            self._reap_fit()
            self.reporter.error(str(e))
            raise
