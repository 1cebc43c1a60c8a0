#!/usr/bin/env python3
"""Child-process stitching CLI of the port, with live queue monitoring.

The counterpart of the JAX package's ``process_cli.py`` (parity with
reference stitcher_process_cli.py:1-235): the flags of the port's
``cli.py`` (``--device`` included: the child fuses on the card unless
given ``--device cpu``), a child process boundary, 10 Hz queue polling
with ANSI status redraw, Ctrl-C -> stop event -> join(timeout) ->
terminate escalation.

Usage:
    python -m image_stitcher_tpu_torch.process_cli -i /path/to/acquisition [-r] [-ff] [--device cpu]
"""

from __future__ import annotations

import os
import queue as queue_mod
import sys

from .cli import create_options, create_params, parse_args


def monitor_process(stitcher, progress_queue, status_queue, complete_queue,
                    stop_event, out=sys.stdout) -> int:
    """Poll queues until the child exits; returns an exit code."""
    status_line = ""
    completed_path = None
    dead_polls = 0
    try:
        while stitcher.is_alive() or not (progress_queue.empty()
                                          and status_queue.empty()
                                          and complete_queue.empty()):
            drained = False
            try:
                msg_type, data = progress_queue.get(timeout=0.1)
                if msg_type == 'progress':
                    cur, total = data
                    print(f"\rProgress: {cur}/{total}  {status_line}",
                          end='', flush=True, file=out)
                drained = True
            except queue_mod.Empty:
                pass
            try:
                msg_type, data = status_queue.get_nowait()
                if msg_type == 'status':
                    status_line = data[0]
                    print(f"\n{status_line}", file=out)
                elif msg_type == 'error':
                    print(f"\nError: {data}", file=out)
                drained = True
            except queue_mod.Empty:
                pass
            try:
                msg_type, data = complete_queue.get_nowait()
                if msg_type == 'complete':
                    completed_path, dtype = data
                    print(f"\nComplete: {completed_path} (dtype {dtype})",
                          file=out)
                drained = True
            except queue_mod.Empty:
                pass
            # messages flushed just before child exit can still sit in
            # the pipe buffer after is_alive() goes False; only break
            # after ~0.5 s of dead-and-silent polls so the final
            # 'complete' is never dropped
            if drained or stitcher.is_alive():
                dead_polls = 0
            elif dead_polls < 5:
                dead_polls += 1
            else:
                break
        if completed_path and os.path.isdir(completed_path) and (
                completed_path.endswith('.zarr')):
            # post-run structure dump, like the reference child's
            # print_zarr_structure (stitcher_process.py:2029)
            from .utils.inspect import format_zarr_tree
            print(format_zarr_tree(completed_path), file=out)
    except KeyboardInterrupt:
        print("\nStopping stitcher...", file=out)
        stop_event.set()
        stitcher.join(timeout=10)
        if stitcher.is_alive():
            print("Force terminating...", file=out)
            stitcher.terminate()
            stitcher.join(timeout=5)
        return 130
    stitcher.join()
    return stitcher.exitcode or 0


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        params = create_params(args)
        params.validate()
        options = create_options(args)
    except Exception as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    from .models.editions import StitcherProcess
    stitcher = StitcherProcess(params, options=options,
                               resume=getattr(args, 'resume', False),
                               device=args.device)
    print("Starting stitching process...")
    print(f"Input folder: {params.input_folder}")
    print(f"Output format: {params.output_format}")
    stitcher.start()
    return monitor_process(stitcher, stitcher.progress_queue,
                           stitcher.status_queue, stitcher.complete_queue,
                           stitcher.stop_event)


if __name__ == '__main__':
    sys.exit(main())
