#!/usr/bin/env python3
"""Stitching CLI of the port: the JAX package's flags that the port runs.

Usage:
    python -m image_stitcher_tpu_torch.cli -i /path/to/acquisition [-r] [-ff]
        [--registration-scope {center,all-pairs,global}]
        [--blend-method {overwrite,feather}] [--streaming {auto,on,off}]
        [--flatfield-device {host,device}] [--registration-report]
        [--continue-on-error]
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
    parser.add_argument('--streaming', choices=['auto', 'on', 'off'],
                        default='auto',
                        help="Bounded-memory band-streaming fusion "
                             "(default: auto above the canvas threshold)")
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
        'apply_flatfield': args.apply_flatfield,
        'use_registration': args.use_registration,
        'registration_channel': args.registration_channel or '',
        'registration_z_level': args.registration_z_level,
        'scan_pattern': args.scan_pattern,
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
        continue_on_error=args.continue_on_error,
        registration_report=args.registration_report)


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
                                  device=args.device)
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
