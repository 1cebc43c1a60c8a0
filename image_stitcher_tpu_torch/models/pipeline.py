"""StitchPipeline: the port's stitching engine for the main path.

The counterpart of the JAX package's ``models/pipeline.py``, for the path
it runs on a device with a canvas over the streaming threshold: scan the
acquisition, fit flatfields on the host, measure the center-pair
registration shifts on the host, then fuse every (timepoint, region)
through :class:`~image_stitcher_tpu_torch.models.streaming.
DeviceStreamingFuser` straight into raw OME-Zarr v2. Every canvas takes
the streaming path; the in-RAM path, merges, resume and the run manifest
are later items of the port.

Output tree: ``{out}/{t}_stitched/{region}_stitched.ome.zarr``, with the
same sampling, geometry and metadata as the JAX package, so the two
packages write equal trees for the same input (tested).

The pipeline runs on an explicit ``device``, CUDA by default. It never
moves to another device by itself: without CUDA, a CUDA pipeline raises.
"""

from __future__ import annotations

import os
import random
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import geometry as geo
from ..io.acquisition import Acquisition, read_image, scan_acquisition
from ..io.omezarr import MultiscaleWriter
from ..io.readers import TileJob, expand_tile_jobs
from ..ops.phasecorr import (horizontal_shift_from_pcc,
                             normalize_to_dtype_range_np,
                             phase_cross_correlation_np,
                             vertical_shift_from_pcc)
from ..params import EngineOptions, StitchingParameters, _not_ported
from ..state import CarriedState
from ..utils.profiling import StageTimers
from ..utils.progress import ProgressReporter, StitchCancelled


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


class StitchPipeline:
    """Orchestrates a full stitching run for one acquisition."""

    def __init__(self, params: StitchingParameters,
                 options: Optional[EngineOptions] = None,
                 reporter: Optional[ProgressReporter] = None,
                 stop_event=None, resume: bool = False, device=None,
                 state: Optional[CarriedState] = None):
        if resume:
            raise _not_ported("resuming a run", "item 'resume and run "
                              "manifest'")
        params.validate()
        self.params = params
        self.options = options or EngineOptions()
        self.options.validate()
        self.device = resolve_device(device)
        self.reporter = reporter or ProgressReporter()
        self.stop_event = stop_event
        self.state = state

        self.input_folder = params.input_folder
        self.output_folder = (self.options.output_folder
                              if self.options.output_folder is not None
                              else params.stitched_folder)  # timestamp once
        self.output_format = params.output_format
        self.per_timepoint_region_output_template = os.path.join(
            self.output_folder, "{timepoint}_stitched",
            "{region}_stitched" + self.output_format)

        self.acq: Optional[Acquisition] = None
        self.flatfields: Dict[int, np.ndarray] = {}
        self._ff_recip_np_cache: Optional[np.ndarray] = None
        self._compressor_checked = False
        self.shifts = geo.RegistrationShifts(scan_pattern=params.scan_pattern)
        self.num_pyramid_levels = 1
        self.registration_channel = params.registration_channel
        self.saved_paths: List[str] = []
        self.timers = StageTimers()
        #: per-region band-fuser stats of the last run (batches, stage s)
        self.fuse_stats: Dict[str, Dict] = {}

    # ------------------------------------------------------------------ util

    def _check_stop(self):
        if self.stop_event is not None and self.stop_event.is_set():
            raise StitchCancelled("stitching cancelled")

    def _dtype_max(self) -> float:
        dt = self.acq.dtype
        return float(np.iinfo(dt).max) if np.issubdtype(dt, np.integer) else 1.0

    # ----------------------------------------------------------- flatfields

    def compute_flatfields(self):
        """Sample tiles per channel and fit their flatfields on the host.

        The sampling budget of the JAX package: per timepoint, up to
        ``flatfield_tiles_per_timepoint`` tiles shuffled by one
        ``random.Random(0)`` in tile-index order, stopping once more than
        ``flatfield_max_tiles`` are collected; samples are read
        decimated to the 96^2 working size."""
        from ..ops.flatfield import (finalize_flatfield,
                                     fit_flatfield_stack_np,
                                     load_sample_small)
        acq = self.acq
        opts = self.options
        self.reporter.getting_flatfields()
        self._ff_recip_np_cache = None
        rnd = random.Random(0)
        out_hw = (acq.input_height, acq.input_width)
        with ThreadPoolExecutor(opts.resolved_reader_threads()) as pool:
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
                paths = paths[:opts.flatfield_max_tiles
                              + opts.flatfield_tiles_per_timepoint]
                small = np.stack(list(pool.map(load_sample_small, paths)))
                if small.ndim == 4 and small.shape[-1] == 3:
                    base = channel.split('_')[0]
                    planes = [(acq.monochrome_channels.index(f"{base}_{s}"),
                               small[..., k]) for k, s in enumerate('RGB')]
                else:
                    planes = [(acq.monochrome_channels.index(channel), small)]
                for idx, stack in planes:
                    self._check_stop()
                    self.flatfields[idx] = finalize_flatfield(
                        fit_flatfield_stack_np(stack), out_hw)
                    self.reporter.update_progress(len(self.flatfields),
                                                  acq.num_c)

    def _flatfield_recip_np(self) -> np.ndarray:
        """(C, th, tw) f32 RECIPROCAL flatfield stack, ones where no field
        was fitted; computed once on the host so every backend multiplies
        the same values."""
        if self._ff_recip_np_cache is None:
            acq = self.acq
            ff = np.ones((acq.num_c, acq.input_height, acq.input_width),
                         np.float32)
            for idx, field in self.flatfields.items():
                ff[idx] = 1.0 / field
            self._ff_recip_np_cache = ff
        return self._ff_recip_np_cache

    def _check_compressor(self) -> None:
        """The port writes raw chunks only. 'auto' stores raw chunks when
        the content does not compress (median zlib-1 ratio of the first,
        center and last tiles above 0.6); on compressible content it
        would choose blosc-lz4, which the port cannot write yet: raise."""
        if self.options.compressor_cname is None or self._compressor_checked:
            return
        import zlib
        keys = sorted(self.acq.tiles.keys())
        ratios = []
        for i in sorted({0, len(keys) // 2, len(keys) - 1}):
            flat = np.ravel(read_image(self.acq.tiles[keys[i]].filepath))
            raw = np.ascontiguousarray(
                flat[:(1 << 20) // flat.itemsize]).tobytes()
            ratios.append(len(zlib.compress(raw, 1)) / max(1, len(raw)))
        ratio = float(np.median(ratios))
        if ratio <= 0.6:
            raise _not_ported(
                f"compressor 'auto' on compressible content (median zlib "
                f"ratio {ratio:.2f}), which selects blosc-lz4",
                "item 'blosc-lz4 chunks'")
        self.reporter.status(
            f"compressor auto: median ratio {ratio:.2f} — storing raw "
            "chunks", False)
        self._compressor_checked = True

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
                      axis: str, max_overlap: int):
        """Normalize, crop the overlap strips (25% margin on the other
        axis), phase-correlate on the host."""
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
        shift = phase_cross_correlation_np(
            strip_a, strip_b, upsample_factor=self.options.upsample_factor)
        return np.asarray(shift), strip_a.shape

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
                                                    max_x_overlap)
                h_shift_rev = horizontal_shift_from_pcc(shift, sw)
                h_shift_rev_odd = int(cy % 2 == 0)

        self.shifts = geo.RegistrationShifts(
            h_shift=h_shift, v_shift=v_shift, h_shift_rev=h_shift_rev,
            h_shift_rev_odd=h_shift_rev_odd,
            scan_pattern=self.params.scan_pattern)

    # -------------------------------------------------------------- stitching

    def _region_dimensions(self, t, region: str) -> Tuple[int, int]:
        acq = self.acq
        xs, ys = acq.region_positions(int(t), region)
        if self.params.use_registration:
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
        for rec in acq.region_tiles(int(t), region).values():
            if self.params.use_registration:
                col = xs.index(rec.x)
                row = ys.index(rec.y)
                pos = geo.tile_position_registered(
                    col, row, len(xs), len(ys),
                    acq.input_width, acq.input_height, self.shifts)
                crops = geo.tile_crops(col, row, len(xs), len(ys), self.shifts)
            else:
                pos = geo.tile_position_coordinate(
                    rec.x, rec.y, x_min, y_min, acq.pixel_size_um)
                crops = (0, 0, 0, 0)
            triples.append((rec, pos, crops))
        return expand_tile_jobs(acq.monochrome_channels, acq.rgb_channels,
                                triples)

    def _stitch_and_save_streaming(self, t, region: str) -> str:
        """Fuse + write one (timepoint, region) in device-resident bands."""
        from .streaming import DeviceStreamingFuser
        acq = self.acq
        opts = self.options
        width, height = self._region_dimensions(t, region)
        jobs = self._build_jobs(t, region)
        output_path = self.per_timepoint_region_output_template.format(
            timepoint=t, region=region)
        os.makedirs(os.path.dirname(output_path), exist_ok=True)
        self._check_compressor()
        writer = MultiscaleWriter(
            output_path, (1, acq.num_c, acq.num_z, height, width),
            self.num_pyramid_levels, acq.dtype, opts.chunks,
            f"{region}_t{t}", acq.dz_um, acq.pixel_size_um,
            acq.monochrome_channels, acq.monochrome_colors)
        ff = self._flatfield_recip_np() if self.flatfields else None
        fuser = DeviceStreamingFuser(
            writer, height, width,
            acq.input_height, acq.input_width, acq.dtype,
            self.num_pyramid_levels, opts.pyramid_downsample,
            chunk_rows=opts.write_band_rows() * opts.device_band_multiple,
            batch_size=opts.fusion_batch,
            reader_threads=opts.resolved_reader_threads(),
            ff_recip=ff, device=self.device)
        fuser.run(jobs, progress_cb=self.reporter.update_progress,
                  stop_check=self._check_stop)
        self.fuse_stats[f"{region}_t{t}"] = dict(fuser.stats,
                                                 batches=fuser.batches)
        self.reporter.status(
            "stream stages: " + " ".join(
                f"{k}={v:.2f}s" for k, v in fuser.stats.items())
            + f" batches={fuser.batches}", False)
        return output_path

    # ------------------------------------------------------------------- run

    def _prepare(self):
        """Flatfields and registration shifts: carried over from
        ``state`` where given, else fitted and measured here (the fit on
        a worker thread, overlapped with the registration measurement:
        they read disjoint data and share no state)."""
        state = self.state
        fit = (self.params.apply_flatfield
               and not (state is not None and state.flatfields is not None))
        measure = (self.params.use_registration
                   and not (state is not None and state.shifts is not None))
        if self.params.apply_flatfield and not fit:
            self.flatfields = dict(state.flatfields)
        if self.params.use_registration and not measure:
            self.shifts = state.shifts

        def fit_flatfields():
            with self.timers.time('flatfield_fit'):
                self.compute_flatfields()

        def measure_shifts():
            with self.timers.time('registration'):
                self.calculate_shifts(self.acq.timepoints[0],
                                      self.acq.regions[0])

        if fit and measure and self.options.overlap_prep:
            # import scipy.fft once here: a first import from two threads
            # at once can observe a partly initialized module
            from scipy import fft as _scipy_fft  # noqa: F401
            with ThreadPoolExecutor(1) as pool:
                ff_future = pool.submit(fit_flatfields)
                try:
                    measure_shifts()
                finally:
                    ff_future.result()
            return
        if fit:
            fit_flatfields()
        if measure:
            measure_shifts()

    def run(self) -> str:
        """Execute the full pipeline; returns the last saved path."""
        t0 = time.time()
        try:
            with self.timers.time('scan'):
                self.acq = scan_acquisition(self.input_folder)
            os.makedirs(self.output_folder, exist_ok=True)
            self._prepare()
            final_path = ''
            for timepoint in self.acq.timepoints:
                timepoint = int(timepoint)
                os.makedirs(os.path.join(self.output_folder,
                                         f"{timepoint}_stitched"),
                            exist_ok=True)
                for region in self.acq.regions:
                    self._check_stop()
                    self.reporter.starting_stitching()
                    try:
                        with self.timers.time('stream_fuse_save'):
                            path = self._stitch_and_save_streaming(timepoint,
                                                                   region)
                    except StitchCancelled:
                        raise
                    except Exception as e:
                        if not self.options.continue_on_error:
                            raise
                        self.reporter.error(
                            f"region {region} t{timepoint} failed: {e}")
                        continue
                    final_path = path
                    self.saved_paths.append(path)
                    self.reporter.status(
                        f"Completed region {region} t{timepoint}", False)
            self.reporter.finished_saving(final_path, self.acq.dtype)
            for line in self.timers.summary():
                self.reporter.status(line, False)
            self.reporter.status(
                f"Total processing time: {time.time() - t0:.1f}s", False)
            return final_path
        except StitchCancelled:
            self.reporter.status("Stitching cancelled", False)
            raise
        except Exception as e:
            self.reporter.error(str(e))
            raise
