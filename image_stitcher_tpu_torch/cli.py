#!/usr/bin/env python3
"""Stitching CLI of the port: every flag of the JAX package's CLI, with
its choices and defaults, plus ``--subpixel-placement`` and ``--device``.

Usage:
    python -m image_stitcher_tpu_torch.cli -i /path/to/acquisition [-r] [-ff]
        [--registration-scope {center,all-pairs,global}]
        [--blend-method {overwrite,feather}] [--streaming {auto,on,off}]
        [--flatfield-device {host,device}] [--zarr-format {2,3}]
        [--registration-report] [--continue-on-error] [--device cpu]

Flags for options the port does not run yet (``-f .ome.tiff``, ``-mt``,
``-mw``, ``--fusion-device host``, ``--resume``) are accepted and passed
on; the run then stops with ``NotImplementedError`` naming the ROADMAP
item that will bring the option. ``--tiff-compression`` and
``--tiff-jpeg-quality`` are checked as the JAX CLI checks them and act
only on OME-TIFF output.
"""

from __future__ import annotations

import argparse
import sys

from .params import EngineOptions, StitchingParameters


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Microscopy Image Stitching CLI (PyTorch + CUDA)")
    parser.add_argument('--input-folder', '-i', required=True,
                        help="Input folder containing images to stitch")
    parser.add_argument('--output-format', '-f',
                        choices=['.ome.zarr', '.ome.tiff'], default='.ome.zarr',
                        help="Output format for stitched data (default: .ome.zarr)")
    parser.add_argument('--apply-flatfield', '-ff', action='store_true',
                        help="Apply flatfield correction")
    parser.add_argument('--use-registration', '-r', action='store_true',
                        help="Enable image registration")
    parser.add_argument('--registration-channel', '-rc',
                        help="Channel to use for registration (default: first available channel)")
    parser.add_argument('--registration-z-level', '-rz', type=int, default=0,
                        help="Z-level to use for registration (default: 0)")
    parser.add_argument('--dynamic-registration', action='store_true',
                        help="Use dynamic registration for improved accuracy "
                             "(selects the all-pairs scope unless "
                             "--registration-scope is given)")
    parser.add_argument('--scan-pattern', '-s',
                        choices=['Unidirectional', 'S-Pattern'],
                        default='Unidirectional',
                        help="Microscope scanning pattern (default: Unidirectional)")
    parser.add_argument('--merge-timepoints', '-mt', action='store_true',
                        help="Merge all timepoints into a single dataset")
    parser.add_argument('--merge-hcs-regions', '-mw', action='store_true',
                        help="Merge all high-content screening regions (wells)")
    parser.add_argument('--params-json',
                        help="Path to a JSON file containing stitching parameters (overrides other arguments)")
    parser.add_argument('--blend-method', choices=['overwrite', 'feather'],
                        default='overwrite',
                        help="Fusion semantics: reference-parity overwrite or "
                             "feathered blending")
    parser.add_argument('--registration-scope',
                        choices=['center', 'all-pairs', 'global'],
                        default=None,
                        help="Shift measurement scope: reference-parity "
                             "center pair, robust all-pairs median, or the "
                             "global per-tile position solve")
    parser.add_argument('--subpixel-placement', action='store_true',
                        help="With the global scope: place tiles at their "
                             "solved float positions (bilinear shift at "
                             "load time)")
    parser.add_argument('--flatfield-device', choices=['host', 'device'],
                        default='host',
                        help="Where the flatfield ADMM solve runs")
    parser.add_argument('--fusion-device', choices=['auto', 'device', 'host'],
                        default='auto',
                        help="Where fusion runs (default: auto = the "
                             "device; 'host' is not ported yet)")
    parser.add_argument('--zarr-format', type=int, choices=[2, 3], default=2,
                        help="2 = zarr v2 + OME-NGFF 0.4 (reference-"
                             "compatible); 3 = zarr v3 sharded + NGFF 0.5 "
                             "(~10x fewer files at scale)")
    parser.add_argument('--streaming', choices=['auto', 'on', 'off'],
                        default='auto',
                        help="Bounded-memory band-streaming fusion "
                             "(default: auto above the canvas threshold)")
    parser.add_argument('--tiff-compression',
                        choices=['deflate', 'raw', 'jpeg'], default='deflate',
                        help=".ome.tiff tile codec: deflate (lossless, "
                             "default), raw, or jpeg (lossy, uint8 only)")
    parser.add_argument('--tiff-jpeg-quality', type=int, default=85,
                        help="JPEG quality 1-100 for --tiff-compression "
                             "jpeg (default 85)")
    parser.add_argument('--resume', action='store_true',
                        help="Continue the most recent interrupted run for this acquisition")
    parser.add_argument('--continue-on-error', action='store_true',
                        help="Log-and-continue on per-region failures")
    parser.add_argument('--registration-report', action='store_true',
                        help="Write registration_report.json (per-pair "
                             "shifts + confidences, solve residuals)")
    parser.add_argument('--chunk-size', type=int, default=2048,
                        help="Output zarr chunk edge in px (default: 2048)")
    parser.add_argument('--fusion-batch', type=int, default=8,
                        help="Tiles fused per device batch (default: 8)")
    parser.add_argument('--device', default='cuda',
                        help="torch device to fuse on (default: cuda)")
    return parser.parse_args(argv)


def create_params(args: argparse.Namespace) -> StitchingParameters:
    if args.params_json:
        return StitchingParameters.from_json(args.params_json)
    return StitchingParameters.from_dict({
        'input_folder': args.input_folder,
        'output_format': args.output_format,
        'apply_flatfield': args.apply_flatfield,
        'use_registration': args.use_registration,
        'registration_channel': args.registration_channel or '',
        'registration_z_level': args.registration_z_level,
        'scan_pattern': args.scan_pattern,
        'merge_timepoints': args.merge_timepoints,
        'merge_hcs_regions': args.merge_hcs_regions,
        'dynamic_registration': args.dynamic_registration,
    })


def create_options(args: argparse.Namespace) -> EngineOptions:
    return EngineOptions(
        chunks=(1, 1, 1, args.chunk_size, args.chunk_size),
        fusion_batch=args.fusion_batch, blend_method=args.blend_method,
        # an explicit --registration-scope wins; otherwise the reference's
        # dynamic_registration flag selects the all-pairs scope
        registration_scope=(args.registration_scope
                             or ('all-pairs' if args.dynamic_registration
                                 else 'center')),
        subpixel_placement=args.subpixel_placement,
        flatfield_device=args.flatfield_device, streaming=args.streaming,
        fusion_device=args.fusion_device, zarr_format=args.zarr_format,
        continue_on_error=args.continue_on_error,
        registration_report=args.registration_report,
        tiff_compression=args.tiff_compression,
        tiff_jpeg_quality=args.tiff_jpeg_quality)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        from .models.pipeline import StitchPipeline
        from .utils.progress import ProgressReporter
        params = create_params(args)
        reporter = ProgressReporter(
            update_progress=lambda cur, total: print(
                f"\rProgress: {cur}/{total}", end='', flush=True),
            status=lambda msg, is_saving=False: print(f"\n{msg}"),
            finished_saving=lambda path, dtype: print(f"\nSaved: {path}"),
        )
        pipeline = StitchPipeline(params, create_options(args), reporter,
                                  resume=args.resume, device=args.device)
        print(f"Input folder: {params.input_folder}")
        print(f"Apply flatfield: {params.apply_flatfield}")
        print(f"Use registration: {params.use_registration}")
        print(f"Device: {pipeline.device}")
        pipeline.run()
        return 0
    except Exception as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


if __name__ == '__main__':
    sys.exit(main())
