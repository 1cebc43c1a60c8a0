#!/usr/bin/env python3
"""Worker-tuned direct-to-zarr stitching CLI of the port.

The counterpart of the JAX package's ``zarr_cli.py`` (parity with
reference zarr_stitcher_cli.py:1-132): the reduced flag set (-i, -r,
-rc, -rz, -s) plus --num-workers, --zarr-format, --resume and, as the
port's ``cli.py``, ``--device`` (default cuda), a child stitching
process, and queue monitoring. "Workers" tune host-side parallelism
(reader/fusion threads), the replacement for the reference's Pool of
re-opened zarr stores (zarr_stitcher.py:580-597).

Usage:
    python -m image_stitcher_tpu_torch.zarr_cli -i /path/to/acquisition [-r] [-w 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

from .params import EngineOptions, StitchingParameters


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Microscopy Image Stitching CLI")
    parser.add_argument('--input-folder', '-i', required=True,
                        help="Input folder containing images to stitch")
    parser.add_argument('--use-registration', '-r', action='store_true',
                        help="Enable cross-correlation registration")
    parser.add_argument('--registration-channel', '-rc',
                        help="Channel to use for registration (default: first available)")
    parser.add_argument('--registration-z-level', '-rz', type=int, default=0,
                        help="Z-level to use for registration (default: 0)")
    parser.add_argument('--scan-pattern', '-s',
                        choices=['Unidirectional', 'S-Pattern'],
                        default='Unidirectional',
                        help="Microscope scanning pattern (default: Unidirectional)")
    parser.add_argument('--num-workers', '-w', type=int,
                        help="Number of host worker threads (default: 4)")
    parser.add_argument('--zarr-format', type=int, choices=[2, 3], default=2,
                        help="2 = zarr v2 + NGFF 0.4; 3 = zarr v3 sharded "
                             "+ NGFF 0.5 (~10x fewer files)")
    parser.add_argument('--resume', action='store_true',
                        help="Continue an interrupted run of the same "
                             "acquisition + settings (skips completed "
                             "regions, reuses measured shifts/flatfields)")
    parser.add_argument('--device', default='cuda',
                        help="torch device to fuse on (default: cuda)")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    params = StitchingParameters(
        input_folder=args.input_folder,
        use_registration=args.use_registration,
        registration_channel=args.registration_channel or '',
        registration_z_level=args.registration_z_level,
        scan_pattern=args.scan_pattern,
    )
    try:
        params.validate()
    except Exception as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    workers = args.num_workers or 4
    options = EngineOptions(reader_threads=workers,
                            host_fusion_threads=workers,
                            zarr_format=getattr(args, 'zarr_format', 2))

    from .models.editions import StitcherProcess
    from .process_cli import monitor_process
    stitcher = StitcherProcess(params, options=options,
                               resume=getattr(args, 'resume', False),
                               device=args.device)
    print("\nStarting stitching process...")
    print(f"Input folder: {args.input_folder}")
    print(f"Using registration: {args.use_registration}")
    print(f"Scan pattern: {args.scan_pattern}")
    stitcher.start()
    return monitor_process(stitcher, stitcher.progress_queue,
                           stitcher.status_queue, stitcher.complete_queue,
                           stitcher.stop_event)


if __name__ == '__main__':
    sys.exit(main())
