#!/usr/bin/env python3
"""Environment diagnosis of the card's host: the first checks, automated.

The counterpart of the JAX package's ``tools/doctor.py``, rewritten for
a CUDA host, with its sections and output format (``[Section]`` lines,
then indented lines). It reports:

- Device: whether torch sees a CUDA card, the card's name and power
  limit (``nvidia-smi``), the two CUDA kernel libraries built or loaded
  from ``csrc/`` (``fuse_overwrite``, ``fuse_feather``), and the pinned
  host<->card copy rates (256 MB each way, timed with CUDA events);
- Placement: the host C placement rate (``csrc/hostops.c``'s
  ``place_u16`` with the flatfield, the host fuser's inner loop). The
  link rate is reported, not used to choose: ``fusion_device='auto'``
  fuses on the card;
- Native: each host C library (the host fuser's ``hostops``, the chunk
  codecs ``blosc``, the ``tile_decode`` decoders, ``jpeg``) and the
  symbols bound from it, and whether the standard library's ``lzma``
  (LZMA TIFF tiles) is there;
- Disk: the write rate where outputs land and the O_DIRECT probe's
  verdict for raw chunk writes;
- Caches: the built libraries under ``build/`` and the probe cache.

Without a card the Device section says so (the port's entry points run
on the card unless given ``--device cpu``); the exit code is 0, as the
JAX doctor's.

Usage:
    python -m image_stitcher_tpu_torch.tools.doctor [--output-dir DIR] [--skip-device]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import List

import numpy as np

#: host C library -> the symbols the port binds from it
HOST_SYMBOLS = {
    'hostops': ('place_u16', 'place_u8', 'feather_u16', 'feather_u8',
                'finalize_feather_u16', 'finalize_feather_u8',
                'downsample2x_u16', 'downsample2x2_mean_u16',
                'write_rows_contig'),
    'blosc': ('blosc_compress', 'blosc_decompress', 'blosc_unshuffle_blocks',
              'all_zero', 'lz4_compress_block', 'lz4hc_compress_block',
              'blosclz_compress', 'snappy_compress', 'zlib_compress',
              'zstd_compress', 'lz4_decompress_block', 'blosclz_decompress',
              'snappy_decompress', 'zstd_decompress'),
    'tile_decode': ('tiff_lzw_decode', 'packbits_decode',
                    'tiff_predictor_undo', 'tiff_fp_predictor_undo',
                    'png_unfilter', 'reverse_bits', 'unpack_samples',
                    'ccitt_decode', 'bmp_rle_decode'),
    'jpeg': ('jpeg_info', 'jpeg_decode', 'jpeg_encode'),
}
#: the CUDA kernel libraries of csrc/
CUDA_LIBRARIES = ('fuse_overwrite', 'fuse_feather')
LINK_BYTES = 256 << 20
#: MB the disk check writes (and fsyncs)
DISK_MB = 256


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``,
    first card."""
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0]


def _build_line(name: str) -> str:
    from .. import native
    info = native.BUILDS[name]
    how = (f"loaded (built before) {info['path']}" if info['cached'] else
           f"built in {info['seconds']:.1f}s {info['path']}")
    return f"{name}: {how}"


def link_rates(nbytes: int = LINK_BYTES, reps: int = 3):
    """(H2D, D2H) GB/s of pinned copies of ``nbytes``, the best of
    ``reps``, timed with CUDA events."""
    import torch
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device='cuda')
    rates = []
    for dst, src in ((dev, host), (host, dev)):
        dst.copy_(src, non_blocking=True)   # warm
        torch.cuda.synchronize()
        best = float('inf')
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            dst.copy_(src, non_blocking=True)
            e1.record()
            e1.synchronize()
            best = min(best, e0.elapsed_time(e1))
        rates.append(nbytes / (best / 1e3) / 1e9)
    return tuple(rates)


def _check_device() -> List[str]:
    import torch
    lines = []
    if not torch.cuda.is_available():
        lines.append(f"torch.cuda: NOT AVAILABLE (torch {torch.__version__}, "
                     f"built for CUDA {torch.version.cuda}) — the port's "
                     "entry points run on the card by default; on this host "
                     "run them with --device cpu (device='cpu')")
        try:
            lines.append(f"nvidia-smi: {card_line()}")
        except (OSError, subprocess.SubprocessError) as e:
            lines.append(f"nvidia-smi: unavailable ({e.__class__.__name__})")
        lines.append("kernels: not built (no card)")
        return lines
    lines.append(f"torch.cuda: {torch.cuda.device_count()} device(s), "
                 f"{torch.cuda.get_device_name(0)} (torch "
                 f"{torch.__version__}, CUDA {torch.version.cuda})")
    try:
        lines.append(f"nvidia-smi: {card_line()}")
    except (OSError, subprocess.SubprocessError) as e:
        lines.append(f"nvidia-smi: unavailable ({e.__class__.__name__})")
    from .. import native
    for name in CUDA_LIBRARIES:
        try:
            native.load(name)
            lines.append(f"kernel {_build_line(name)}")
        except Exception as e:
            lines.append(f"kernel {name}: FAILED to build or load: {e}")
    h2d, d2h = link_rates()
    lines.append(f"pinned link ({LINK_BYTES >> 20} MB, CUDA events): "
                 f"H2D {h2d:.1f} GB/s, D2H {d2h:.1f} GB/s")
    return lines


def host_placement_rate(size_mb: int = 16) -> float:
    """Bytes/s of the host fuser's C placement: 1024^2 uint16 tiles
    through the f32 reciprocal field into a canvas (the JAX doctor's
    probe shape)."""
    from ..ops.host_fuse import place_window
    th = tw = 1024
    n_tiles = max(1, (size_mb << 20) // (th * tw * 2))
    rng = np.random.default_rng(0)
    tiles = rng.integers(0, 60000, (n_tiles, th, tw), dtype=np.uint16)
    recip = (np.float32(1.0) / (1.0 + rng.random((th, tw),
                                                 dtype=np.float32)))
    canvas = np.zeros((th * 2, tw * ((n_tiles + 1) // 2)), np.uint16)
    place_window(canvas, tiles[0], recip, 0, th, 0, tw, 0, 0)   # build
    t0 = time.perf_counter()
    for i in range(n_tiles):
        place_window(canvas, tiles[i], recip, 0, th, 0, tw,
                     (i % 2) * th, (i // 2) * tw)
    return n_tiles * th * tw * 2 / max(time.perf_counter() - t0, 1e-9)


def _check_placement() -> List[str]:
    return [f"host placement rate (C, hostops place_u16 with the field): "
            f"{host_placement_rate() / 1e9:.2f} GB/s",
            "fusion placement: 'auto' fuses on the card; 'host' only when "
            "asked (the link rate above is reported, not used to choose)"]


def _check_native() -> List[str]:
    from .. import native
    lines = []
    for name, symbols in HOST_SYMBOLS.items():
        try:
            lib = native.load(name)
        except Exception as e:
            lines.append(f"{name}: UNAVAILABLE ({e}) — nothing falls back "
                         "to a plain version; runs that need it raise")
            continue
        bound = [s for s in symbols if hasattr(lib, s)]
        missing = sorted(set(symbols) - set(bound))
        lines.append(f"{name}: OK ({', '.join(bound)})"
                     + (f"; MISSING {', '.join(missing)}" if missing else ""))
    try:
        import lzma  # noqa: F401
        lines.append("lzma: OK (the standard library's module: LZMA TIFF "
                     "tiles read)")
    except ImportError:
        lines.append("lzma: MISSING from this Python — LZMA TIFF tiles "
                     "(compression 34925) raise")
    return lines


def _check_disk(path: str, size_mb: int = DISK_MB) -> List[str]:
    from ..io.directio import probe_direct_io, use_direct_io
    buf = os.urandom(1 << 20)
    fd, tmp = tempfile.mkstemp(dir=path, prefix='.doctor_disk_')
    try:
        t0 = time.perf_counter()
        for _ in range(size_mb):
            os.write(fd, buf)
        os.fsync(fd)
        dt = time.perf_counter() - t0
    finally:
        os.close(fd)
        os.unlink(tmp)
    lines = [f"disk write ({path}): {size_mb / dt:.0f} MB/s "
             f"({size_mb} MB, fsync'd)"]
    entry = probe_direct_io(path)
    if not entry or entry.get('unsupported'):
        lines.append("direct-IO probe: O_DIRECT unsupported here; raw "
                     "chunks are written buffered")
    else:
        lines.append(
            f"direct-IO probe: buffered {entry['buffered_mbps']} MB/s, "
            f"direct {entry['direct_mbps']} MB/s -> raw chunks written "
            + ("O_DIRECT" if use_direct_io(path, 'auto') else "buffered"))
    return lines


def _check_caches() -> List[str]:
    from .. import native
    from ..io.directio import _cache_path
    built = sorted(glob.glob(os.path.join(native.BUILD_ROOT, '*', 'lib*.so')))
    names = sorted({os.path.basename(p)[3:-3] for p in built})
    lines = [f"built libraries: {len(built)} under {native.BUILD_ROOT}"
             + (f" ({', '.join(names)})" if names else "")]
    p = _cache_path()
    try:
        with open(p) as f:
            saved = json.load(f)
        probes = ', '.join(
            f"{k}: buffered={v['buffered_mbps']}/direct={v['direct_mbps']} "
            f"MB/s" for k, v in saved.items())
        lines.append(f"probe cache: {probes or 'empty'} ({p})")
    except (OSError, ValueError, KeyError, TypeError):
        lines.append(f"probe cache: none ({p})")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Diagnose the stitching environment of the card's host")
    ap.add_argument("--output-dir", default=tempfile.gettempdir(),
                    help="directory whose disk to probe (default: tmp)")
    ap.add_argument("--skip-device", action="store_true",
                    help="skip the card checks entirely")
    args = ap.parse_args(argv)

    sections = []
    if args.skip_device:
        sections.append(("Device", ["device checks: skipped"]))
    else:
        sections.append(("Device", _check_device()))
    sections.append(("Placement", _check_placement()))
    sections.append(("Native", _check_native()))
    try:
        sections.append(("Disk", _check_disk(args.output_dir, DISK_MB)))
    except OSError as e:
        sections.append(("Disk", [f"disk probe failed: {e}"]))
    sections.append(("Caches", _check_caches()))

    for title, lines in sections:
        print(f"[{title}]")
        for line in lines:
            print(f"  {line}")
    return 0


if __name__ == '__main__':
    sys.exit(main())
