#!/usr/bin/env python3
"""Save-method benchmark harness: time/size writer x chunk combinations.

The counterpart of the JAX package's ``tools/save_bench.py`` (itself the
counterpart of the reference's only test apparatus, save_region_test.py:
a writers bake-off): generates a synthetic uint16 TCZYX volume and
sweeps the port's own writers x chunk sizes, reporting seconds, MB on
disk and files, as the JAX tool's JSON rows (writer, chunk, seconds, mb,
files, size).

Writers swept: OME-Zarr v2 and v3 (sharded) with raw, blosc-lz4 and
blosc-zstd (clevel 1) chunks (``io/omezarr.MultiscaleWriter``),
pyramidal OME-TIFF with deflate, raw or JPEG tiles
(``io/tiffwriter.write_ome_tiff_pyramid``), and zlib-chunk files (the
no-framework floor).

Usage:
    python -m image_stitcher_tpu_torch.tools.save_bench [--sizes 6000] [--chunks 1024 2048 4096] [--writers ...] [--json]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
import zlib
from typing import Dict, List, Optional

import numpy as np


def du_mb(path: str) -> float:
    total = 0
    for root, _, files in os.walk(path):
        for f in files:
            total += os.path.getsize(os.path.join(root, f))
    if os.path.isfile(path):
        total = os.path.getsize(path)
    return total / 1e6


def write_ome_zarr(volume: np.ndarray, out: str, chunk: int,
                   cname: Optional[str] = 'zstd', zarr_format: int = 2,
                   clevel: int = 1) -> None:
    """One level through the port's MultiscaleWriter: raw chunks
    (``cname`` None) or blosc chunks of ``cname`` at ``clevel``."""
    from ..io.omezarr import MultiscaleWriter
    c = volume.shape[1]
    writer = MultiscaleWriter(out, volume.shape, 1, volume.dtype,
                              (1, 1, 1, chunk, chunk), "bench", 1.0, 1.0,
                              [f"ch{i}" for i in range(c)], [0xFFFFFF] * c,
                              cname=cname, clevel=clevel,
                              zarr_format=zarr_format)
    try:
        writer.write_level(0, volume)
    except BaseException:
        writer.abort()
        raise
    writer.close()


def write_ome_tiff(volume: np.ndarray, out: str, chunk: int,
                   compression: str = 'deflate') -> None:
    from ..io.tiffwriter import write_ome_tiff_pyramid
    if compression == 'jpeg' and volume.dtype != np.uint8:
        volume = (volume >> 8).astype(np.uint8)  # jpeg is 8-bit only
    write_ome_tiff_pyramid(out, [volume[0]], "bench",
                           [f"ch{i}" for i in range(volume.shape[1])],
                           [0xFFFFFF] * volume.shape[1], 1.0, 1.0,
                           compression=compression)


def write_zlib_chunks(volume: np.ndarray, out: str, chunk: int) -> None:
    os.makedirs(out, exist_ok=True)
    t, c, z, h, w = volume.shape
    for ci in range(c):
        for zi in range(z):
            for y in range(0, h, chunk):
                for x in range(0, w, chunk):
                    blob = zlib.compress(np.ascontiguousarray(
                        volume[0, ci, zi, y:y + chunk, x:x + chunk]).tobytes(), 1)
                    with open(os.path.join(out, f"{ci}.{zi}.{y}.{x}"), "wb") as f:
                        f.write(blob)


def count_files(path: str) -> int:
    return sum(len(fs) for _, _, fs in os.walk(path)) if os.path.isdir(path) else 1


def _zarr(cname, fmt):
    return (lambda v, o, c: write_ome_zarr(v, o, c, cname=cname,
                                           zarr_format=fmt),
            ".ome.zarr" if fmt == 2 else ".zarr")


WRITERS = {
    # the JAX package's default store (blosc zstd clevel 1, its
    # MultiscaleWriter's default) and its v3 sharded twin
    "v2_zstd": _zarr('zstd', 2),
    "v3_zstd": _zarr('zstd', 3),
    # the default compressor of a run (blosc-lz4) and raw chunks
    # (compressor None: the pwritev row writer)
    "v2_lz4": _zarr('lz4', 2),
    "v3_lz4": _zarr('lz4', 3),
    "v2_raw": _zarr(None, 2),
    "v3_raw": _zarr(None, 3),
    "ome_tiff_pyramidal": (write_ome_tiff, ".ome.tiff"),
    "tiff_raw": (
        lambda v, o, c: write_ome_tiff(v, o, c, compression='raw'),
        ".ome.tiff"),
    "tiff_jpeg": (
        lambda v, o, c: write_ome_tiff(v, o, c, compression='jpeg'),
        ".ome.tiff"),
    "zlib_chunks": (write_zlib_chunks, ".chunks"),
}
DEFAULT_WRITERS = ["v2_zstd", "v3_zstd", "ome_tiff_pyramidal", "zlib_chunks"]


def measure(size: int, z: int, c: int, chunks: List[int],
            writers: List[str]) -> List[Dict]:
    rng = np.random.default_rng(0)
    print(f"generating ({1},{c},{z},{size},{size}) uint16...", file=sys.stderr)
    volume = rng.integers(0, 65535, (1, c, z, size, size), dtype=np.uint16)
    # untimed warmup: the first timed cell otherwise runs slow on a cold
    # allocator and page state after the generation above (and builds
    # the C libraries), which would penalize whichever writer is first
    warm = os.path.join(tempfile.mkdtemp(prefix="save_bench_"), "warm")
    try:
        write_ome_zarr(volume[:, :1, :1, :2048, :2048], warm, 1024,
                       cname=None)
    finally:
        shutil.rmtree(os.path.dirname(warm), ignore_errors=True)
    results = []
    for wname in writers:
        fn, suffix = WRITERS[wname]
        for chunk in chunks:
            out = os.path.join(tempfile.mkdtemp(prefix="save_bench_"),
                               f"vol{suffix}")
            t0 = time.perf_counter()
            try:
                fn(volume, out, chunk)
                dt = time.perf_counter() - t0
                nf = count_files(out)
                results.append({"writer": wname, "chunk": chunk,
                                "seconds": round(dt, 2),
                                "mb": round(du_mb(out), 1),
                                "files": nf,
                                "size": size})
                print(f"{wname:>24} chunk={chunk:<5} {dt:7.2f}s "
                      f"{du_mb(out):9.1f} MB {nf:6d} files", file=sys.stderr)
            except Exception as e:
                print(f"{wname} chunk={chunk} FAILED: {e}", file=sys.stderr)
            finally:
                shutil.rmtree(os.path.dirname(out), ignore_errors=True)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Writer bake-off harness")
    p.add_argument("--sizes", type=int, nargs="+", default=[6000])
    p.add_argument("--z", type=int, default=2)
    p.add_argument("--channels", type=int, default=3)
    p.add_argument("--chunks", type=int, nargs="+", default=[1024, 2048, 4096])
    p.add_argument("--writers", nargs="+", default=DEFAULT_WRITERS,
                   choices=list(WRITERS))
    p.add_argument("--json", action="store_true", help="print JSON results")
    args = p.parse_args(argv)
    all_results = []
    for size in args.sizes:
        all_results.extend(measure(size, args.z, args.channels, args.chunks,
                                   args.writers))
    if args.json:
        print(json.dumps(all_results))
    return 0


if __name__ == '__main__':
    sys.exit(main())
