"""StitchPipeline: the port's stitching engine.

The counterpart of the JAX package's ``models/pipeline.py``, for the
paths it runs on one device: scan the acquisition, fit flatfields (on
the host, or with ``flatfield_device='device'`` on the device), measure
registration (the center pair on the host; or every adjacent pair, in
batches on the device, aggregated by median ('all-pairs') or solved for
per-tile positions ('global', optionally subpixel)), then fuse every
(timepoint, region) by overwrite or feathered blending into raw OME-Zarr
v2. A canvas over ``streaming_threshold_bytes`` (or any canvas with
``streaming='on'``) streams through :class:`~image_stitcher_tpu_torch.
models.streaming.DeviceStreamingFuser` in bands; a smaller one (every
well of an HCS plate) is fused whole on the device
(:meth:`StitchPipeline.stitch_region`) and saved with its pyramid built
on the device (:meth:`StitchPipeline.save_region`), region N saving on a
background thread while region N+1 fuses. With ``registration_report``
the per-pair measurements and solve statistics land in
``registration_report.json``; ``debug_visuals`` writes the center
pairs' overlap strips as PNGs. Merges, resume and the run manifest are
later items of the port.

Output tree: ``{out}/{t}_stitched/{region}_stitched.ome.zarr``, with the
same sampling, geometry and metadata as the JAX package, so the two
packages write equal trees for the same input (tested).

The pipeline runs on an explicit ``device``, CUDA by default. It never
moves to another device by itself: without CUDA, a CUDA pipeline raises.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core import geometry as geo
from ..io.acquisition import Acquisition, read_image, scan_acquisition
from ..io.omezarr import MultiscaleWriter
from ..io.readers import (TileBatchLoader, TileJob, expand_tile_jobs,
                          torch_dtype)
from ..ops import cuda_fuse
from ..ops.fuse import padded_canvas_shape
from ..ops.phasecorr import (horizontal_shift_from_pcc,
                             normalize_to_dtype_range_np,
                             phase_cross_correlation_conf_batch,
                             phase_cross_correlation_conf_np,
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
        self._ff_recip_dev_cache: Optional[torch.Tensor] = None
        self._compressor_checked = False
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

    # ------------------------------------------------------------------ util

    def _check_stop(self):
        if self.stop_event is not None and self.stop_event.is_set():
            raise StitchCancelled("stitching cancelled")

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
                small = np.stack(list(pool.map(load_sample_small,
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
            if on_device:
                field = fit_flatfield_stack(
                    torch.from_numpy(stack).to(self.device)).cpu().numpy()
            else:
                field = fit_flatfield_stack_np(stack)
            self.flatfields[idx] = finalize_flatfield(field, out_hw)
            self.reporter.update_progress(len(self.flatfields), acq.num_c)

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

    def _flatfield_recip(self) -> torch.Tensor:
        """:meth:`_flatfield_recip_np` on the pipeline's device (one
        upload per run)."""
        if self._ff_recip_dev_cache is None:
            self._ff_recip_dev_cache = torch.from_numpy(
                self._flatfield_recip_np()).to(self.device)
        return self._ff_recip_dev_cache

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

                with ThreadPoolExecutor(opts.resolved_reader_threads()) as pool:
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
        (solved the first time a region is stitched)."""
        if (self.options.registration_scope == 'global'
                and self.params.use_registration
                and region not in self.global_positions
                and region not in self._global_rejected):
            with self.timers.time('registration'):
                self.calculate_shifts_all_pairs(int(t), region)

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

    def stitch_region(self, t, region: str) -> torch.Tensor:
        """Fuse all tiles of one (timepoint, region) into one canvas on
        the pipeline's device; returns the cropped (C, Z, H, W) canvas.

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
        shape = list(padded_canvas_shape(acq.num_c, acq.num_z, height, width,
                                         th, tw))
        shape[3] = -(-shape[3] // 8) * 8
        ff = self._flatfield_recip() if self.flatfields else None
        feather = opts.blend_method == 'feather'
        if feather:
            acc = torch.zeros(shape, dtype=torch.float32, device=self.device)
            wsum = torch.zeros(shape, dtype=torch.float32, device=self.device)
        else:
            canvas = torch.zeros(shape, dtype=torch_dtype(acq.dtype),
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
                                             torch_dtype(acq.dtype),
                                             (0, height), (0, width))
            del acc, wsum   # the stream orders their reuse after finalize
            return out
        return canvas[:, :, :height, :width]

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
        """Fuse + write one (timepoint, region) in device-resident bands."""
        from .streaming import DeviceStreamingFuser
        acq = self.acq
        opts = self.options
        width, height = self._region_dimensions(t, region)
        jobs = self._build_jobs(t, region)
        output_path = self.per_timepoint_region_output_template.format(
            timepoint=t, region=region)
        os.makedirs(os.path.dirname(output_path), exist_ok=True)
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
            ff_recip=ff, blend_method=opts.blend_method,
            blend_px=opts.feather_px, device=self.device)
        fuser.run(jobs, progress_cb=self.reporter.update_progress,
                  stop_check=self._check_stop)
        self.fuse_stats[f"{region}_t{t}"] = dict(fuser.stats,
                                                 batches=fuser.batches)
        self.reporter.status(
            "stream stages: " + " ".join(
                f"{k}={v:.2f}s" for k, v in fuser.stats.items())
            + f" batches={fuser.batches}", False)
        return output_path

    # ------------------------------------------------------------------ save

    def save_region(self, t, region: str, canvas: torch.Tensor,
                    num_levels: Optional[int] = None,
                    ready: Optional[torch.cuda.Event] = None) -> str:
        """Write the multiscale OME-Zarr of one (timepoint, region) from
        its (C, Z, H, W) canvas: the pyramid is built on the canvas's
        device, level from level, and each level is copied to the host
        once (pinned memory for a CUDA canvas) and written.

        ``num_levels`` is passed by the pipelined save, so a background
        save is immune to the next region recomputing
        ``self.num_pyramid_levels``. A CUDA canvas is read on a side
        stream of this thread, after ``ready`` (an event recorded where
        the canvas was finished; the current stream when None), and
        recorded on that stream, so the caching allocator cannot hand its
        memory to the next region before the save has read it."""
        from ..ops.pyramid import iter_levels
        acq = self.acq
        opts = self.options
        if num_levels is None:
            num_levels = self.num_pyramid_levels
        output_path = self.per_timepoint_region_output_template.format(
            timepoint=t, region=region)
        os.makedirs(os.path.dirname(output_path), exist_ok=True)
        c, z, h, w = canvas.shape
        writer = MultiscaleWriter(
            output_path, (1, c, z, h, w), num_levels, acq.dtype, opts.chunks,
            f"{region}_t{t}", acq.dz_um, acq.pixel_size_um,
            acq.monochrome_channels, acq.monochrome_colors)
        on_cuda = canvas.device.type == 'cuda'
        scope = contextlib.nullcontext()
        if on_cuda:
            side = torch.cuda.Stream(canvas.device)
            if ready is not None:
                side.wait_event(ready)
            else:
                side.wait_stream(torch.cuda.current_stream(canvas.device))
            canvas.record_stream(side)
            scope = torch.cuda.stream(side)
        with scope:
            for lv, level in enumerate(iter_levels(canvas, num_levels,
                                                   opts.pyramid_downsample)):
                host = torch.empty(tuple(level.shape), dtype=level.dtype,
                                   pin_memory=on_cuda)
                host.copy_(level)   # waits for the copy: host is read next
                writer.write_level(lv, host.numpy()[None])
        writer.close()
        return output_path

    # ------------------------------------------------------------------- run

    def _prepare(self):
        """Flatfields and registration: carried over from ``state`` where
        given, else fitted and measured here (the fit on a worker thread,
        overlapped with the registration measurement: they read disjoint
        data and share no state). The 'global' scope also needs carried
        positions to skip its measurement; regions without them are
        solved when they are stitched."""
        state = self.state
        scope = self.options.registration_scope
        fit = (self.params.apply_flatfield
               and not (state is not None and state.flatfields is not None))
        carried = (state is not None and state.shifts is not None
                   and (scope != 'global'
                        or state.global_positions is not None))
        measure = self.params.use_registration and not carried
        if self.params.apply_flatfield and not fit:
            self.flatfields = dict(state.flatfields)
        if self.params.use_registration and not measure:
            self.shifts = state.shifts
            if scope == 'global':
                self.global_positions = dict(state.global_positions)
                self.global_positions_float = dict(
                    state.global_positions_float or {})

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

    def _process_regions(self) -> str:
        """Fuse and save every (timepoint, region): canvases that
        :meth:`_should_stream` streams in bands, the others fused whole
        and saved, with ``pipelined_save`` on one background saver while
        the next region fuses (at most one canvas in flight). With
        ``continue_on_error`` a failed region, fuse or save, is reported
        and skipped; cancellation always propagates."""
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

        try:
            for timepoint in self.acq.timepoints:
                timepoint = int(timepoint)
                os.makedirs(os.path.join(self.output_folder,
                                         f"{timepoint}_stitched"),
                            exist_ok=True)
                for region in self.acq.regions:
                    self._check_stop()
                    self.reporter.starting_stitching()
                    try:
                        self._check_compressor()
                        stream = self._should_stream(timepoint, region)
                        if stream:
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
                    if canvas.device.type == 'cuda':
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
        path = os.path.join(self.output_folder, "registration_report.json")
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
            os.makedirs(self.output_folder, exist_ok=True)
            self._prepare()
            final_path = self._process_regions()
            self._write_registration_report()
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
