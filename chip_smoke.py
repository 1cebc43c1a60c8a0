#!/usr/bin/env python3
"""Smoke run of image_stitcher_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. environment: torch/CUDA versions, card name and power limit;
  2. build: the CUDA kernels, compiled from csrc/ with nvcc, and the host
     chunk codec, tile decoders, host fuser and JPEG codec with the C
     compiler (one compiler per source, started together);
  3. kernel vs plain: every kernel against its plain PyTorch version on
     seeded batches at the main-path shapes (overwrite canvas byte-equal,
     feather acc/wsum bit-equal, finalize byte-equal): the band canvas at
     its padded and at an odd pitch, tile x origins at every residue
     mod 8, u16 and u8, cameras whose rows are not 16-byte aligned, and
     one HCS well's whole (3, 2, Hp, Wp) in-RAM canvas with a 3-plane
     field (channel and z indices both used; the feather case finalizes
     every plane); the band canvas in float32, int16 and float16 with and
     without the field, and a small canvas in int8, int32 and uint32
     (no field, no feathering for uint32). Per case: the kernel's time
     on the card (CUDA events, calls queued behind a spinning kernel so
     the host's enqueue is hidden), one call with the host's enqueue,
     the plain version's call, and the bound (bytes each input read once
     and each output written once, at 3.35 TB/s) with the kernel's share
     of it; then the batched device phase correlation against the host
     f64 twin on 180 main-path strip pairs (within 0.1 px);
  4. slice parity: 3x3 x 3-channel 2048^2 acquisitions stitched on the
     card and on the CPU through the band fuser (streaming='on') must
     decode to equal OME-Zarr trees: the main path, and the maximum-
     quality path with the card run's registration carried into the CPU
     run;
  5. main path: a 10x10 x 3-channel 2048^2 uint16 acquisition (~205 px
     overlap, center registration + flatfield, overwrite, raw OME-Zarr
     v2) stitched end to end through ``image_stitcher_tpu_torch.stitch``,
     with stage times and tiles/s (the acquisition and tree are kept for
     phases 15 and 16);
  6. maximum-quality path: an 8x8 cut of the same grid with +-3 px
     integer stage jitter, all-pairs registration on the card, the global position
     solve, subpixel placement and feathered blending; a 4096-row window
     of channel 0 is held against a NumPy reference;
  7. HCS plate: 8 wells (A1-H1) x 3x3 FOVs x 3 channels x 2048^2 uint16,
     each well's canvas under the streaming threshold, so the default
     'auto' fuses every well whole on the card and builds its pyramid
     there (the in-RAM path), with the device flatfield solver, the
     registration report and debug images; the same plate streamed in
     bands (streaming='on', the first run's fields and shifts carried)
     must write byte-equal trees; one well's channel 0 is held against a
     NumPy reference at levels 0 and 1, the device fields against the
     host solver, the report and PNGs checked;
  8. output layer: the blosc-lz4 codec (C, built with the system
     compiler; liblz4's LZ4_compress_fast rules, so its frames are
     c-blosc's) against its plain version, byte-equal frames and round
     trips on seeded 2048^2 and edge chunks (full entropy, compressible,
     all zero; u16 and u8); its MB/s on one thread and on the encode
     pool; the main path's grid on the JAX package's compressible
     benchmark content (bench.py's BENCH_CONTENT=compressible: a dark,
     gamma-3 texture with its 6 low bits zeroed, made on the card)
     with the default compressor (blosc-lz4), its tree decoded equal to
     a raw run's, with e2e, the writer's seconds, the bytes written and
     the ratio; the 'auto' compressor's decision and the disk probe's
     buffered and direct MB/s; a 3x3 raw run with direct_io='on'
     byte-equal to 'off'; a 3x3 zarr v3 (sharded) lz4 run decoded equal
     to the v2 run;
  9. tile input without OpenCV: (a) the C tile decoders (TIFF LZW,
     PackBits, the horizontal predictor, PNG row unfiltering) against
     their plain versions and their sources, BMP row layouts, and each
     routine's MB/s on 2048^2 u16 tiles on one thread and on the 8-thread
     reader pool; (b) the main path's grid and options (as phase 5) on the
     bench's compressible content, stored as uncompressed TIFF, and a
     4x4 grid of it (cut from 10x10 for the script's time) as
     uncompressed TIFF, as 16-bit PNG with the row filters cycling and
     as deflate + predictor TIFF in 2-row strips: the PNG and deflate
     trees decode equal to the uncompressed one, with e2e, tiles/s, the
     loader's and the writer's
     seconds, decode seconds a tile and decodes a file; (c) 3x3 grids: a
     u8 mono BMP acquisition (gray palette, bottom-up rows) equal to its
     uncompressed-TIFF twin, and a u8 RGB PNG acquisition on the in-RAM
     path, the card's tree equal to a CPU run's;
 10. merges and resume: 4 of phase 7's 8 wells at two timepoints (each
     its own seed; cut from 96 wells for the script's time), stitched
     with both merges on the card, stopped after its 5th unit and
     resumed: the resumed run skips those units, loads the fields from
     the sidecar (no fit) and writes the complete plate, its tree
     byte-equal to an uninterrupted run's;
     each merge pass (complete plate, per-timepoint plates, time series)
     timed on the finished stores with its bytes, MB/s and the split into
     band reads, the fold on the card (CUDA events) and chunk writes; the
     merged level 0 is each region's zero-padded, each merged level the
     2x2 mean (sum >> 2) of the one above, the plate and well metadata
     as plate_attrs/well_attrs give them, and a 3x3 two-well merge on the
     card byte-equal to the CPU pipeline's merge of the same stores;
 11. OME-TIFF output and the host fuser: (a) 3x3 grids written as
     ``.ome.tiff`` on the card and on the CPU (the card run's fields and
     shifts carried) are byte-equal files: u16 mono and u8 RGB (PNG
     tiles), in RAM and in bands, deflate and raw, overwrite and feather
     (four cases covering each value twice); (b) phase 5's options on a
     4x4 cut of its grid (cut for the script's time limit)
     written as deflate OME-TIFF: every page's level 0 and SubIFD
     levels, walked by ``io/tiff.py::read_pages``, decode equal to a zarr
     tree of the same acquisition, with e2e, tiles/s, the writer's
     seconds, the file's bytes and deflate ratio and the writer's
     ``peak_buffer_bytes``; (c) the same 4x4 grid with
     ``fusion_device='host'`` (the host band fuser through
     ``csrc/hostops.c``, the fit gated per channel; raw level-0 chunks
     written as chunk-column blocks from the band threads, bands the
     tiles cover left unfilled): its raw tree byte-equal to the device
     path's, with e2e, when the first band started against the end of
     the fit, the blocks written, the fills skipped and the stage sums
     over the threads, wall and on-core; then the same run into the
     default blosc-lz4 chunks (rows, no blocks), decoded equal to the
     device path's tree;
 12. (run right after phase 8, on its acquisitions and raw trees) the
     other blosc codecs (zstd, zlib, lz4hc, blosclz, snappy): (a) the C
     zstd encoder at clevel 1 to 9 byte-equal to libzstd 1.5.7's level 1,
     3, 5, ..., 15 and 22 frames of the seeded inputs of
     tests/torch_zstd_frames.py (their SHA-256 kept in
     tests/torch_zstd_frames.npz; C only: the Python version of the
     optimal parser is too slow for the card's host); the C snappy,
     zlib and blosclz encoders byte-equal to tensorstore's blosc frames
     of the seeded inputs of tests/torch_blosc_frames.py, snappy at
     clevel 9, zlib and blosclz at clevel 1-9, and to the streams those
     frames hold (their SHA-256 kept in tests/torch_blosc_frames.npz);
     and each codec's C encoder and decoder against its plain version on
     phase 8's chunks (the C frames of the full chunks decode exactly;
     the Python versions run on 512^2 cuts, zlib's on 256^2, on a pool
     of processes); (b) each codec's MB/s on one thread and on the encode
     pool, its ratio beside lz4's, and the zstd encoder's MB/s on one
     thread at clevel 1, 3, 4 and 5 (libzstd's fast, greedy, lazy and
     lazy2 rules) and 6 to 9 (lazy2, btlazy2 and btultra2 in 512 KiB and
     1 MiB blocks; clevel 9 on 2 MiB); (c) phase 8's grid and content in
     the reference
     production edition's setting, blosc zstd clevel 1 with byte shuffle,
     in blosc zlib at the JAX default clevel 5 and in blosclz-5, byte
     shuffle, each decoded equal to a raw run, with e2e, tiles/s, the
     writer's seconds, the pool's drain, bytes and ratio against phase
     8's lz4 run (blosclz's beside (b)'s one-thread blosclz and lz4
     MB/s); (d) a 3x3 grid for every other cname (snappy bit-shuffled) as
     zarr v2 and v3, each decoded equal to phase 8's raw 3x3 twin; (e) a
     2-well plate with the complete-plate merge in zstd, equal to the
     same merge in lz4;
 13. (run right after phase 9, beside its PNG rates) JPEG through the
     port's C codec (csrc/jpeg.c): (a) its encoder and decoder against
     the plain versions (io/jpeg_plain.py, on a pool of processes) on
     seeded cases: grey and RGB 4:4:4, 4:2:2, 4:2:0 and 4:4:0, quality
     50 / 85 / 95, odd sizes, restart intervals, a 2048^2 grey and a
     2048^2 RGB tile, byte-equal streams and pixels, round trips through
     both decoders; then OpenCV's streams kept in
     ``tests/torch_jpeg_streams.npz`` (progressive grey and RGB 4:4:4 to
     4:1:1, optimised tables, restart intervals; baseline 4:1:1; two
     2048^2 progressive tiles), decoded by C to OpenCV's pixels (their
     SHA-256) and, but the tiles, by the plain version to C's; (b) decode
     and encode MB/s of 2048^2 u8 tiles, grey q95 and RGB 4:2:0 q85, on
     one thread and on the 8-thread reader pool, and the decode MB/s of
     the kept 2048^2 progressive tiles (grey, RGB 4:2:0, q85, smooth
     content) beside the port's baseline streams of their pixels; (c)
     phase 5's options on a 4x4 cut of its grid (cut for the
     script's time limit) on grey u8 JPEG tiles (q95, OpenCV's imwrite
     default, Squid's tiles), written by the port's
     encoder, stitched on the card: its tree equal to an
     uncompressed-TIFF twin holding the C decoder's pixels, with e2e,
     tiles/s and the loaders' decode seconds beside the twin's e2e; (d)
     3x3 grey and RGB JPEG acquisitions written as JPEG ``.ome.tiff``
     (RGB pages 4:2:0, Photometric 6) on the card and on the CPU,
     byte-equal files; (c)'s acquisition as JPEG q85 ``.ome.tiff``,
     timed, every page and SubIFD level within PSNR 30 dB of (c)'s zarr
     levels;
 15. (run right after phase 10, on the acquisitions and trees of phases 5
     and 10) the mesh and the work shards: (b) phase 5's acquisition and
     options with ``mesh_shape=(1, n)`` (n = the cards when the host has
     two or more, else two bands on cuda:0), its tree byte-equal to
     phase 5's (SHA-256 of every file), with e2e and tiles/s against
     phase 5's, each band's device fuse ms, read-back wait and write
     seconds, each card's peak memory and the peak of the host's live
     band pieces, held under the whole canvas; (a), run after (b) on its
     canvas and bands, ``parallel/sharded_fuse.ShardedCanvas`` over
     (1, n) against the plain version at the main-path shapes (ten u16
     2048^2 tiles with the field, a grid row straddling the first band
     edge): overwrite byte-equal, feather acc/wsum bit-equal on every
     band, finalize byte-equal; (c) phase 10's plate in two ranks spawned
     together in one group (``parallel/distributed.py``), each on the
     card (device tensors over gloo when the ranks share one card, over
     NCCL when each has its own), each stitching its work shard through
     ``stitch_distributed``, rank 0 running both merges after the
     barrier: the tree byte-equal to phase 10's uninterrupted one, with
     the plate's e2e, each rank's start-up (apart) and barrier wait;
 16. (run right after phase 15, on phase 5's kept acquisition and tree)
     chunks over several planes: (a) phase 5's options with chunks (1, 3,
     1, 2048, 2048), raw, on the band path: levels decoded equal to phase
     5's tree, every all-zero chunk absent (the registered canvas's
     tile-less foot) and every other one stored, with e2e, tiles/s, the
     writer's seconds and the chunk-row buffer's peak host bytes; (b) the
     same on the mesh (1, n), its tree byte-equal to (a)'s; (c) a 3x3 x 3
     channel x Z=3 acquisition with chunks (1, 1, 2, 2048, 2048) in lz4
     on the band path, in RAM and through the host fuser, byte-equal
     trees decoded equal to a (1, 1, 1) run; (d) a 2-well, 2-timepoint
     plate merged (the complete plate) with chunks (2, 3, 1, 2048, 2048)
     in lz4, decoded equal to its (1, 1, 1) twin;
 14. (run right after phase 11, on 11a's mono 3x3 acquisition) the
     editions and front ends on the card: (a) the child-process edition
     (``models/editions.StitcherProcess``) on its default device, the
     spawned child fusing on the card, its queue messages (progress to
     the total, 'Stitching...', 'Saving...', one 'complete') and its tree
     byte-equal to an in-process card ``stitch()``, with both e2e; (b)
     ``python -m image_stitcher_tpu_torch.process_cli`` and ``.zarr_cli``
     with default flags as subprocesses, exit 0, trees byte-equal to
     (a)'s; (c) ``python -m image_stitcher_tpu_torch.tools.doctor``, exit
     0, its Device section naming this card and its power limit, with the
     pinned H2D and D2H rates.
 17. (run right after phase 16, on phase 5's kept acquisition) tile
     sample types: (a) phase 5's tiles rewritten as float32 (same
     values, 4.8 GB) and stitched with phase 5's options: '<f4' levels,
     OMERO window 0..1, channel 0 at full size equal to the NumPy
     reference (u16 values * ff_recip in f32), e2e and tiles/s; without
     the field the float32 tree decoded equal to a uint16 run's cast to
     float32; (b) int16 tiles 4x4 in RAM and in bands and (c) the
     feathered quality path in float32 at 4x4, each card tree equal to
     a CPU run's; (d) OpenCV's LZW/deflate, Predictor 2/3 tiles of every
     sample type (``tests/torch_tiff_samples.npz``) decoded by the C
     decoders to OpenCV's pixels, the plain versions to the same bytes,
     and float16 tiles of every layout the JAX package reads to the
     pixels imageio gave on the CPU test host; (e) float16, which the JAX
     package stitches to ``.ome.tiff`` only: a 4x4 x 1-channel cut of
     phase 5's grid as float16 deflate + Predictor 3 tiles, stitched to
     ``.ome.tiff`` in bands with the field, in RAM feathered and through
     the host band fuser, card files equal to CPU files (byte for byte;
     decoded pages on the host band path), the kernels' launches counted.
 18. (run right after phase 17) tile layouts, the rest of the JAX
     package's tile input: (a) CCITT (Modified Huffman, T.4 1-D and 2-D
     with fill bits, T.6), packed samples of 1-14 bits, the FillOrder 2
     bit reversal and BMP RLE8/RLE4 decoded in C at 2048^2 to their
     sources, old-style LZW on a 2048 x 128 strip, the plain versions to
     the same bytes (on the first 64 rows where they run in Python), and
     every file of ``tests/torch_tiff_layouts.npz`` (one of each layout,
     with the SHA-256 of the JAX package's ``read_image`` array on the
     CPU test host) read to that array; (b) 4x4 x 1-channel grids of
     2048^2 G4 bilevel, 8-bit LZW palette (RGB) and 12-bit LZW tiles
     stitched on the card (no field, no registration, overwrite, raw),
     each tree equal to its uncompressed twin's, with whole-tile decode
     MB/s on one thread and 8 and the launches.
 19. (run right after phase 18) the rest of the JPEG tile input: (a)
     every file of ``tests/torch_jpeg_formats.npz`` (lossless, arithmetic-
     coded, block-smoothed and JPEG-in-TIFF, with the SHA-256 of the JAX
     package's ``read_image`` array on the CPU test host) decoded by the
     C codec to that array and by the plain version to the same bytes;
     (b) whole-tile decode MB/s of 2048^2 lossless grey, arithmetic-coded
     progressive RGB 4:2:0 and JPEG-in-TIFF YCbCr 2x2 (256^2 tiles,
     JPEGTables) tiles on one thread and 8; (c) a 4x4 grid of each
     stitched on the card with the field (no registration, overwrite,
     raw), each tree equal to its uncompressed twin's, with the launches.

The line before the last is a JSON object with one entry per kernel, and
one per kernel's float16 instantiation (``name[float16]``: phase 3's
float16 band case with the field, launches from phase 17e); the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or
without the package beside this file, the script exits non-zero and
prints no result. The acquisitions are written to a temporary directory
and removed at the end.
"""

from __future__ import annotations

import collections
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

#: kernel -> (library, source, what it replaces in the JAX package)
KERNELS = {
    'fuse_overwrite': ('fuse_overwrite',
                       'image_stitcher_tpu_torch/csrc/fuse_overwrite.cu',
                       'image_stitcher_tpu/ops/pallas_fuse.py:492'),
    'fuse_feather': ('fuse_feather',
                     'image_stitcher_tpu_torch/csrc/fuse_feather.cu',
                     'image_stitcher_tpu/ops/pallas_fuse.py:407'),
    # the epilogue of the feathered path: XLA in the JAX package
    'finalize_feather': ('fuse_feather',
                         'image_stitcher_tpu_torch/csrc/fuse_feather.cu',
                         'image_stitcher_tpu/ops/fuse.py:121'),
}
LIBRARIES = sorted({lib for lib, _, _ in KERNELS.values()})
#: the host C sources, built with the C compiler: the chunk codecs
#: (csrc/blosc.c with the csrc/codec_*.h it includes), the tile decoders
#: (csrc/tile_decode.c), the host fuser's loops and pyramid folds
#: (csrc/hostops.c) and the JPEG codec (csrc/jpeg.c)
HOST_LIBRARIES = ['blosc', 'tile_decode', 'hostops', 'jpeg']
TILE = 2048
#: modules the card's host lacks; the port must load none of them
BANNED = ('jax', 'jaxlib', 'pandas', 'tensorstore', 'numcodecs', 'blosc',
          'zstandard', 'cv2', 'PIL', 'imageio', 'image_stitcher_tpu',
          'PyQt5', 'napari')
BLEND = 64


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ 1, 2

def phase_environment() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    card = card_line()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, numpy {np.__version__}")
    log(f"card: {card}")
    return card


def phase_build() -> None:
    from image_stitcher_tpu_torch import native
    libraries = LIBRARIES + HOST_LIBRARIES
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:
        list(pool.map(native.load, libraries))
    cc = os.path.basename(native.find_cc())
    log(f"build: {len(libraries)} sources in {time.perf_counter() - t0:.1f}s;"
        " nvcc " + " ".join(native.NVCC_FLAGS) + "; the codecs, the tile "
        f"decoders and JPEG {cc} " + " ".join(native.CC_FLAGS)
        + f"; hostops {cc} " + " ".join(native.SOURCE_CC_FLAGS['hostops']))
    for name in libraries:
        info = native.BUILDS[name]
        how = ('cached' if info['cached'] else
               'cc' if name in HOST_LIBRARIES else 'nvcc')
        log(f"build: {info['path']} ({how} {info['seconds']:.1f}s)")
        for line in info['log'].splitlines():
            if 'registers' in line or 'spill' in line or 'Compiling' in line:
                log("  ptxas: " + line.strip())


# --------------------------------------------------------------------- 3

#: the card's published peaks (NVIDIA H100 SXM data sheet, 700 W): device
#: memory bytes/s, and f32 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
BAND_W = 18635     # the main path's canvas width (10x10 grid of 2048^2)
BAND_ROWS = 8192   # its band height
#: the band canvas as models/streaming.py::band_canvas_shape makes it:
#: one-tile aprons, the row padded to a multiple of 8 elements
BAND_CANVAS = (1, 1, TILE + BAND_ROWS + TILE, -(-(BAND_W + TILE) // 8) * 8)
#: the same canvas at the unpadded, odd pitch
ODD_CANVAS = BAND_CANVAS[:3] + (BAND_W + TILE,)
#: one HCS well (3x3 FOVs of 2048^2 at ~205 px overlap) as the in-RAM
#: path fuses it: 3 channels, 2 z levels, the registered height, a
#: one-tile apron below and right, the row padded to 8 elements
WELL_H, WELL_W = 6554, 5734
WELL_CANVAS = (3, 2, WELL_H + TILE, -(-(WELL_W + TILE) // 8) * 8)


def kernel_batch(rng, n, th, tw, canvas_hw, num_c, num_z=1, overlap=205):
    """A fusion batch like the band fuser's: tiles on a grid with
    ~``overlap`` px overlaps and jitter, x origins at every residue mod 8
    (tile k at k % 8), nonzero crops, one tile placed twice (full
    overlap), and the last two entries invalid padding. Tile k goes to
    channel k % num_c and z level (k // num_c) % num_z."""
    hp, wp = canvas_hw
    step_y, step_x = th - overlap, tw - overlap
    cols = max(1, min(5, (wp - tw) // step_x + 1))
    tiles = rng.integers(0, 65536, (n, th, tw)).astype(np.uint16)
    info = np.zeros((n, 4), np.int32)
    crops = np.zeros((n, 4), np.int32)
    valid = np.ones(n, bool)
    for k in range(n):
        r, c = divmod(k, cols)
        y = min(r * step_y + int(rng.integers(0, 24)), hp - th)
        x = min(c * step_x + int(rng.integers(0, 24)), wp - tw)
        x = x - x % 8 + k % 8
        info[k] = (k % num_c, (k // num_c) % num_z, y,
                   x if x <= wp - tw else x - 8)
        crops[k] = [overlap // 2 if int(rng.integers(0, 4)) else 0
                    for _ in range(4)]
    info[1] = info[0]          # exact duplicate: the later one must win
    valid[-2:] = False
    info[-2:] = 0              # padding entries, as the loader pins them
    return tiles, info, crops, valid


def call_ms(fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings around one call of ``fn``
    (after a warm-up), the host's enqueue included: the card idles while
    the wrapper's Python runs."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _sleep_cycles_per_ms() -> float:
    """The rate of the card's spinning kernel (torch.cuda._sleep)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10 ** 7)
    b.record()
    b.synchronize()
    return 10 ** 7 / a.elapsed_time(b)


def device_ms(fn, reps: int = 20) -> float:
    """The card's time for one call of ``fn``: the median gap between CUDA
    events around each of ``reps`` back-to-back calls, all queued behind a
    spinning kernel, so the host's time to enqueue them (the wrapper's
    checks and its ctypes call) is hidden. Fails if the queue ran dry."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    hold = 5.0 + 3 * reps * host_ms
    cycles_per_ms = _sleep_cycles_per_ms()
    for _ in range(3):
        torch.cuda._sleep(int(hold * cycles_per_ms))  # the card spins
        held = torch.cuda.Event()
        held.record()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        ev[0].record()
        for k in range(reps):
            fn()
            ev[k + 1].record()
        ran_dry = held.query()
        torch.cuda.synchronize()
        if not ran_dry:
            return float(np.median([ev[k].elapsed_time(ev[k + 1])
                                    for k in range(reps)]))
        hold *= 4
    raise SystemExit("device_ms: the host could not keep the card's queue "
                     "ahead of the calls")


def bound_ms(nbytes: float, ops: float):
    """(least ms, 'bytes' or 'operations'): the larger of the bytes over
    the memory rate and the f32 operations over the f32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def phase_kernels(reps: int = 20):
    """Every kernel on the card vs its plain version, at every case of
    :func:`kernel_cases`; returns {kernel: numbers at the headline case}
    and {kernel + '[float16]': numbers at the float16 band case with the
    field}."""
    rng = np.random.default_rng(1234)
    over = [overwrite_case(rng, case, reps) for case in kernel_cases()]
    rng = np.random.default_rng(4321)
    # uint32 takes no feathering (the JAX package's clip bound overflows)
    feath = [feather_case(rng, case, reps) for case in kernel_cases()
             if case[1] != torch.uint32]
    pcc_check()
    out = {'fuse_overwrite': dict(over[0]),
           'fuse_feather': dict(feath[0]),
           'finalize_feather': dict(feath[0]['finalize'])}
    del out['fuse_feather']['finalize']
    out['fuse_overwrite']['max_abs_err'] = max(c['max_abs_err'] for c in over)
    out['fuse_feather']['max_abs_err'] = max(c['max_abs_err'] for c in feath)
    out['finalize_feather']['max_abs_err'] = max(
        c['finalize']['max_abs_err'] for c in feath if c.get('finalize'))
    half = [[c for c in cases if c['dtype'] == torch.float16 and c['with_ff']]
            for cases in (over, feath)]
    if not all(len(c) == 1 for c in half):
        raise SystemExit("kernels: no float16 band case with the field")
    out['fuse_overwrite[float16]'] = dict(half[0][0])
    out['fuse_feather[float16]'] = dict(half[1][0])
    out['finalize_feather[float16]'] = dict(half[1][0]['finalize'])
    del out['fuse_feather[float16]']['finalize']
    return out


def kernel_cases():
    """(name, dtype, with_ff, canvas shape, N, th, tw): the main path's
    band canvas (a 10x10 grid of 2048^2 tiles, N = 10) at its padded pitch
    (the first case is the headline) and at the odd unpadded pitch, u16
    and u8, with and without the field; cameras into a 3-channel canvas
    (ff picked per channel): 1920x1200, and rows of 1100 and 1201 pixels,
    which are not 16-byte aligned; the band canvas in float32 and int16,
    with and without the field (phase 17's sample types), and in
    float16 with and without the field (phase 17e); and a small
    2-channel canvas for each other sample type the kernels take (int8
    and int32 with and without the field, uint32 without: the JAX
    package gives it no field or feathering; float64 tiles reach the
    kernels as float32), rows of 1000 elements, not 16-byte aligned in
    int8."""
    cases = [('band', dtype, with_ff, BAND_CANVAS, 10, TILE, TILE)
             for dtype in (torch.uint16, torch.uint8)
             for with_ff in (True, False)]
    cases += [('band-odd-pitch', torch.uint16, True, ODD_CANVAS, 10, TILE,
               TILE),
              ('band-odd-pitch', torch.uint8, False, ODD_CANVAS, 10, TILE,
               TILE),
              ('camera', torch.uint16, True, (3, 1, 5000, 9000), 10, 1200,
               1920),
              ('camera', torch.uint16, True, (3, 1, 5000, 9000), 10, 1200,
               1100),
              ('camera', torch.uint8, False, (3, 1, 5000, 9001), 10, 1201,
               1201),
              ('well', torch.uint16, True, WELL_CANVAS, 10, TILE, TILE)]
    cases += [('band', dtype, with_ff, BAND_CANVAS, 10, TILE, TILE)
              for dtype in (torch.float32, torch.int16, torch.float16)
              for with_ff in (True, False)]
    cases += [('small', dtype, with_ff, (2, 1, 2400, 4200), 8, 1000, 1000)
              for dtype in (torch.int8, torch.int32, torch.uint32)
              for with_ff in ((False,) if dtype == torch.uint32
                              else (True, False))]
    return cases


def sample_tiles(tiles: np.ndarray, dtype) -> np.ndarray:
    """The uint16 ``tiles`` of :func:`kernel_batch` as ``dtype``: uint8 the
    high byte, int8 and int16 shifted to signed, 32-bit integers spread
    over their range (so the field's product clips at both bounds), float32
    with fractions, float16 the values / 16 (0 to 4096, rounded to
    float16's spacing)."""
    name = str(dtype).split('.')[-1]
    wide = tiles.astype(np.int64)
    if name == 'uint8':
        return (tiles >> 8).astype(np.uint8)
    if name == 'int8':
        return ((wide >> 8) - 128).astype(np.int8)
    if name == 'int16':
        return (wide - 32768).astype(np.int16)
    if name == 'int32':
        return ((wide - 32768) * 65537).astype(np.int32)
    if name == 'uint32':
        return (wide * 65537).astype(np.uint32)
    if name == 'float32':
        return tiles.astype(np.float32) / np.float32(65.536)
    if name == 'float16':
        return (tiles.astype(np.float32) / np.float32(16)).astype(np.float16)
    return tiles


def case_inputs(rng, case):
    """Device inputs of one case, and what its data needs: canvas pixels
    inside some valid window, the windows' summed area, and the bytes of
    the fields that its valid tiles use (each read once)."""
    name, dtype, with_ff, cshape, n, th, tw = case
    dev = torch.device('cuda')
    tiles, info, crops, valid = kernel_batch(rng, n, th, tw, cshape[2:],
                                             cshape[0], cshape[1])
    tiles = sample_tiles(tiles, dtype)
    ff = None
    if with_ff:
        ff = torch.from_numpy(
            (1.0 / rng.uniform(0.6, 1.4, (cshape[0], th, tw)))
            .astype(np.float32)).to(dev)
    mask = torch.zeros(cshape, dtype=torch.bool, device=dev)
    area = 0
    for k in np.flatnonzero(valid):
        c, z, y, x = (int(v) for v in info[k])
        top, bottom, left, right = (int(v) for v in crops[k])
        r0, r1 = max(top, 0), min(th - bottom, th)
        s0, s1 = max(left, 0), min(tw - right, tw)
        if r1 > r0 and s1 > s0:
            mask[c, z, y + r0:y + r1, x + s0:x + s1] = True
            area += (r1 - r0) * (s1 - s0)
    ff_bytes = (len(set(info[valid, 0].tolist())) * th * tw * 4
                if with_ff else 0)
    label = (f"{name} {str(dtype).split('.')[-1]} "
             f"{'ff' if with_ff else 'noff'} N={n} {th}x{tw} into "
             f"{'x'.join(map(str, cshape))}")
    meta = (torch.from_numpy(info), torch.from_numpy(crops),
            torch.from_numpy(valid))
    return (torch.from_numpy(tiles).to(dev), meta, ff, int(mask.sum()),
            area, ff_bytes, label)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over two tensors of one dtype, compared in float64
    (exact for every sample type; 0 only where they are equal). float16
    pairs are compared bit for bit: equal bits count 0 (infinities
    included), other bits their difference (inf where it is not a
    number, or a zero's sign differs)."""
    diff = (got.to(torch.float64) - want.to(torch.float64)).abs()
    if got.dtype == torch.float16:
        same = got.view(torch.int16) == want.view(torch.int16)
        diff = torch.where(same, 0.0,
                           torch.where(diff > 0, diff, float('inf')))
    return float(diff.max())


def timings(kernel, plain_fn, nbytes, ops, reps):
    ms = device_ms(kernel, reps)
    bound, by = bound_ms(nbytes, ops)
    return {'ms': ms, 'call_ms': call_ms(kernel), 'plain_ms': call_ms(
        plain_fn), 'bound_ms': bound, 'bound_by': by,
        'bound_share': bound / ms, 'library_ms': None}


def overwrite_case(rng, case, reps: int):
    """fuse_overwrite on the card vs its plain version, byte for byte; the
    bound counts each written pixel's tile read and canvas write, and
    each used field once."""
    from image_stitcher_tpu_torch.ops import cuda_fuse, fuse as plain
    _, dtype, with_ff, cshape, *_ = case
    d_tiles, meta, ff, written, _, ff_bytes, label = case_inputs(rng, case)
    gen = torch.Generator(device='cuda').manual_seed(7)
    if dtype == torch.float16:   # the tiles' range, all finite
        base = (torch.rand(cshape, generator=gen, device='cuda')
                * 4096).to(dtype)
    else:
        base = torch.randint(0, 256 if dtype == torch.uint8 else 65536,
                             cshape, generator=gen, device='cuda',
                             dtype=torch.int32).to(dtype)
    got = base.clone()
    want = base.clone()
    cuda_fuse.fuse_overwrite(got, d_tiles, *meta, ff)
    torch.cuda.synchronize()
    plain.fuse_overwrite(want, d_tiles, *meta, ff)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0:
        raise SystemExit(f"fuse_overwrite disagrees with its plain version "
                         f"on {label}: max_abs_err {err}")
    item = got.element_size()
    out = timings(lambda: cuda_fuse.fuse_overwrite(got, d_tiles, *meta, ff),
                  lambda: plain.fuse_overwrite(want, d_tiles, *meta, ff),
                  2 * item * written + ff_bytes, written if with_ff else 0,
                  reps)
    out.update(max_abs_err=err, dtype=dtype, with_ff=with_ff)
    log(f"kernel fuse_overwrite {label}: byte-equal, {written} px written; "
        f"kernel {out['ms']:.4f} ms (one call with the host's enqueue "
        f"{out['call_ms']:.4f}), plain {out['plain_ms']:.4f} ms, bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']}), "
        f"{out['bound_share']:.1%} of the bound")
    return out


def feather_case(rng, case, reps: int):
    """fuse_feather (acc, wsum bit-equal) on the card vs its plain version,
    and on the band and well canvases finalize_feather (byte-equal) over
    the band's real rows or every plane of the well; the bounds count
    each weighted pixel's acc and wsum read and written, each window's
    tile pixels and each used field once, and the finalize's reads and
    writes."""
    from image_stitcher_tpu_torch.ops import cuda_fuse, fuse as plain
    name, dtype, with_ff, cshape, _, th, _ = case
    d_tiles, meta, ff, weighted, area, ff_bytes, label = case_inputs(rng,
                                                                     case)
    # start from an earlier batch's sums, as a band's later batches do
    gen = torch.Generator(device='cuda').manual_seed(8)
    acc0 = torch.rand(cshape, generator=gen, device='cuda') * 65535
    wsum0 = torch.rand(cshape, generator=gen, device='cuda')
    got = (acc0.clone(), wsum0.clone())
    want = (acc0.clone(), wsum0.clone())
    del acc0, wsum0
    cuda_fuse.fuse_feather(*got, d_tiles, *meta, ff_recip=ff, blend_px=BLEND)
    torch.cuda.synchronize()
    plain.fuse_feather(*want, d_tiles, *meta, ff_recip=ff, blend_px=BLEND)
    torch.cuda.synchronize()
    err = max(float((got[k] - want[k]).abs().max()) for k in (0, 1))
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise SystemExit(f"fuse_feather disagrees with its plain version on "
                         f"{label}: max_abs_err {err}")
    item = d_tiles.element_size()
    out = timings(
        lambda: cuda_fuse.fuse_feather(*got, d_tiles, *meta, ff_recip=ff,
                                       blend_px=BLEND),
        lambda: plain.fuse_feather(*want, d_tiles, *meta, ff_recip=ff,
                                   blend_px=BLEND),
        16 * weighted + item * area + ff_bytes,
        area * (4 if with_ff else 3), reps)
    out.update(max_abs_err=err, dtype=dtype, with_ff=with_ff)
    log(f"kernel fuse_feather {label}: acc/wsum bit-equal, {weighted} px "
        f"weighted; kernel {out['ms']:.4f} ms (one call with the host's "
        f"enqueue {out['call_ms']:.4f}), plain {out['plain_ms']:.4f} ms, "
        f"bound {out['bound_ms']:.4f} ms ({out['bound_by']}), "
        f"{out['bound_share']:.1%} of the bound")
    if name.startswith(('band', 'well', 'small')):
        # the band's real rows, as the band fuser finalizes them, or every
        # plane of the well's real canvas, as the in-RAM path does (the
        # small canvas whole)
        rows, width = {'well': ((0, WELL_H), WELL_W),
                       'small': ((0, cshape[2]), cshape[3])}.get(
            name, ((th, th + BAND_ROWS), BAND_W))
        window = (rows, (0, width))
        real = (slice(*rows), slice(0, width))
        f_got = cuda_fuse.finalize_feather(*got, dtype, *window)
        f_want = plain.finalize_feather(got[0][..., real[0], real[1]],
                                        got[1][..., real[0], real[1]], dtype)
        torch.cuda.synchronize()
        f_err = max_abs_err(f_got, f_want)
        if f_err != 0:
            raise SystemExit(f"finalize_feather disagrees with its plain "
                             f"version on {label}: {f_err}")
        px = cshape[0] * cshape[1] * (rows[1] - rows[0]) * width
        fin = timings(
            lambda: cuda_fuse.finalize_feather(*got, dtype, *window),
            lambda: plain.finalize_feather(got[0][..., real[0], real[1]],
                                           got[1][..., real[0], real[1]],
                                           dtype),
            px * (8 + f_got.element_size()), px, reps)
        fin['max_abs_err'] = f_err
        out['finalize'] = fin
        log(f"kernel finalize_feather {rows[1] - rows[0]}x{width} of "
            f"{label}: byte-equal; kernel {fin['ms']:.4f} ms (one call "
            f"with the host's enqueue {fin['call_ms']:.4f}), plain "
            f"{fin['plain_ms']:.4f} ms, bound {fin['bound_ms']:.4f} ms "
            f"({fin['bound_by']}), {fin['bound_share']:.1%} of the bound")
        del f_got, f_want
    del got, want, d_tiles, ff
    torch.cuda.empty_cache()
    return out


def pcc_check(n: int = 90, tol: float = 0.1) -> None:
    """The batched phase correlation on the card (cuFFT + complex64
    matmuls) against the host f64 twin on ``n`` seeded horizontal and
    ``n`` vertical main-path strip pairs (1024 x 214 and 214 x 1024,
    known integer offsets up to the fixture's jitter)."""
    from image_stitcher_tpu_torch.ops.phasecorr import (
        phase_cross_correlation_conf_batch, phase_cross_correlation_conf_np)
    rng = np.random.default_rng(99)
    pad = 8
    worst = 0.0
    for sh, sw in ((1024, 214), (214, 1024)):
        tex = rng.integers(6553, 58982, (sh + 2 * pad, sw + 2 * pad),
                           dtype=np.uint16)
        d = rng.integers(-6, 7, (n, 2))
        a = np.broadcast_to(tex[pad:pad + sh, pad:pad + sw], (n, sh, sw))
        b = np.stack([tex[pad + dy:pad + dy + sh, pad + dx:pad + dx + sw]
                      for dy, dx in d])
        a = np.ascontiguousarray(a)
        t0 = time.perf_counter()
        shifts, peaks = phase_cross_correlation_conf_batch(
            torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda(), 10)
        shifts = shifts.cpu().numpy()
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = np.stack([phase_cross_correlation_conf_np(a[i], b[i], 10)[0]
                         for i in range(n)])
        t_host = time.perf_counter() - t0
        err = float(np.abs(shifts - host).max())
        worst = max(worst, err)
        log(f"pcc {n} pairs {sh}x{sw}: device batch {t_dev * 1e3:.1f} ms "
            f"(first call, incl. upload and cuFFT plans), host f64 twin "
            f"{t_host * 1e3:.1f} ms; max |device - host| {err:.4f} px, "
            f"max |device - truth| {float(np.abs(shifts - d).max()):.4f} px")
        if err > tol:
            raise SystemExit(f"pcc: the device batch is {err} px from the "
                             f"host twin on {sh}x{sw} strips")


# ------------------------------------------------------------ 4, 5: data

CHANNELS = ["Fluorescence 405 nm Ex", "Fluorescence 488 nm Ex",
            "Fluorescence 561 nm Ex"]
ACQ_PARAMS = {
    "dx(mm)": 0.1, "dy(mm)": 0.1, "dz(um)": 1.5, "Nz": 1, "Nt": 1,
    "objective": {"magnification": 10, "tube_lens_f_mm": 180,
                  "name": "10x"},
    "sensor_pixel_size_um": 10.0, "tube_lens_mm": 180,   # 1.0 um / px
    "pixel_binning": 2,
}


def tiff_bytes_header(h: int, w: int, dtype=np.uint16) -> bytes:
    """Classic little-endian TIFF header + IFD for one uncompressed strip
    of (h, w) ``dtype`` samples (SampleFormat by its kind) whose pixels
    follow at byte 160."""
    import struct
    data_off = 160
    dt = np.dtype(dtype)
    entries = [(256, 4, w), (257, 4, h), (258, 3, 8 * dt.itemsize),
               (259, 3, 1), (262, 3, 1), (273, 4, data_off), (277, 3, 1),
               (278, 4, h), (279, 4, h * w * dt.itemsize), (284, 3, 1),
               (339, 3, {'u': 1, 'i': 2, 'f': 3}[dt.kind])]
    out = bytearray(b'II' + struct.pack('<HI', 42, 8))
    out += struct.pack('<H', len(entries))
    for tag, typ, val in entries:
        payload = (struct.pack('<HH', val, 0) if typ == 3
                   else struct.pack('<I', val))
        out += struct.pack('<HHI', tag, typ, 1) + payload
    out += struct.pack('<I', 0)
    return bytes(out.ljust(data_off, b'\0'))


def write_acquisition(folder: str, grid: int, tile: int, overlap: int,
                      seed: int, jitter: int = 0, regions=('A1',),
                      texture=None, encode=None, suffix='tiff',
                      channels=CHANNELS, timepoints: int = 1,
                      num_z: int = 1, dtype=np.uint16):
    """A Squid acquisition: per timepoint and region (an HCS well; wells
    20 mm apart on the stage), grid x grid tiles of ``tile``^2 uint16 (or
    ``dtype``, which ``texture`` then gives) cut
    at ``overlap`` px overlap from one seeded texture of its own (full
    entropy, or ``texture(rng, side)``, which may be uint8 or (side,
    side, 3) RGB), each tile's window moved by up to +-``jitter`` px
    (stage error; the coordinates claim the ideal grid), written as
    uncompressed TIFF for every channel, or as the file bytes
    ``encode(tile)`` gives (one encode a tile on a thread pool, its bytes
    written for every channel, named ``*.{suffix}``), plus each
    timepoint's coordinates.csv and 'acquisition parameters.json' (the
    layout of the JAX package's test fixtures). Timepoint t > 0 draws
    from its own seed, (seed, t). With ``num_z`` planes, plane z of a
    tile is its window moved z px right (uncompressed TIFF only).
    Returns (texture, {fov: (y0, x0)}) of timepoint 0's first region."""
    import csv
    if encode is not None and num_z != 1:
        raise ValueError("encoded tiles are written for one z plane")
    step = tile - overlap
    margin = 8
    side = step * (grid - 1) + tile + 2 * margin
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, 'acquisition parameters.json'), 'w') as f:
        json.dump(dict(ACQ_PARAMS, Nx=grid, Ny=grid, Nt=timepoints,
                       Nz=num_z), f, indent=2)
    header = tiff_bytes_header(tile, tile, dtype)
    first = None

    for t in range(timepoints):
        rng = np.random.default_rng(seed if t == 0 else [seed, t])
        tdir = os.path.join(folder, str(t))
        os.makedirs(tdir)
        rows = []
        pending = []

        def write_encoded(item, tdir=tdir):
            region, fov, body = item
            data = encode(body)
            for ch in channels:
                name = f"{region}_{fov}_0_{ch.replace(' ', '_')}.{suffix}"
                with open(os.path.join(tdir, name), 'wb') as f:
                    f.write(data)

        for well, region in enumerate(regions):
            gt = (texture(rng, side) if texture is not None else
                  rng.integers(6553, 58982, (side, side), dtype=np.uint16))
            shake = rng.integers(-jitter, jitter + 1, (grid * grid, 2))
            origins = {}
            for r in range(grid):
                for c in range(grid):
                    fov = r * grid + c
                    y0 = margin + r * step + int(shake[fov, 0])
                    x0 = margin + c * step + int(shake[fov, 1])
                    origins[fov] = (y0, x0)
                    for z in range(num_z):
                        rows.append({"region": region, "fov": fov,
                                     "z_level": z,
                                     "x (mm)": round(c * step / 1000.0, 6),
                                     "y (mm)": round(20.0 * well
                                                     + r * step / 1000.0, 6),
                                     "z (um)": z * ACQ_PARAMS['dz(um)']})
                    if encode is not None:
                        pending.append((region, fov, np.ascontiguousarray(
                            gt[y0:y0 + tile, x0:x0 + tile])))
                        continue
                    for z in range(num_z):
                        body = np.ascontiguousarray(
                            gt[y0:y0 + tile, x0 + z:x0 + z + tile])
                        for ch in channels:
                            name = (f"{region}_{fov}_{z}_"
                                    f"{ch.replace(' ', '_')}.tiff")
                            with open(os.path.join(tdir, name), 'wb') as f:
                                f.write(header)
                                body.tofile(f)
            with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
                list(pool.map(write_encoded, pending))
            pending = []
            if first is None:
                first = (gt, origins)
        with open(os.path.join(tdir, 'coordinates.csv'), 'w',
                  newline='') as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
    return first


def smoke_options(out: str, quality: bool = False, **extra):
    from image_stitcher_tpu_torch import EngineOptions
    # the JAX package's benchmark options for this path; the maximum-
    # quality variant is bench.py's 'global+subpixel+feather'
    if quality:
        extra.update(registration_scope='global', subpixel_placement=True,
                     blend_method='feather')
    return EngineOptions(**{'fusion_batch': 10, 'reader_threads': 8,
                            'compressor_cname': 'auto',
                            'output_folder': out, **extra})


def read_tree(root: str):
    """{relative path: decoded level array or parsed JSON} of a tree: zarr
    v2 or v3 (sharded), raw or blosc chunks, read by the port's
    ``read_array``."""
    from image_stitcher_tpu_torch.io.zarr_store import read_array
    out = {}
    for dirpath, _, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        for name in files:
            if name in ('.zarray', '.zattrs', '.zgroup', 'zarr.json'):
                with open(os.path.join(dirpath, name)) as f:
                    meta = out[os.path.join(rel, name)] = json.load(f)
                if name == '.zarray' or (name == 'zarr.json' and
                                         meta.get('node_type') == 'array'):
                    out[rel] = read_array(dirpath)
    return out


# --------------------------------------------------------------------- 4

def phase_slice_parity(work: str, grid: int = 3, tile: int = TILE,
                       quality: bool = False) -> None:
    """The same acquisition stitched on the card and on the CPU must
    decode to equal OME-Zarr trees, and the card run must launch the
    path's kernels. On the maximum-quality path the card run's
    flatfields, shifts and positions are carried into the CPU run (the
    two FFT libraries may measure a pair a hair apart)."""
    from image_stitcher_tpu_torch import CarriedState, stitch
    from image_stitcher_tpu_torch.ops import cuda_fuse
    name = 'quality' if quality else 'main'
    counted = ((cuda_fuse.fuse_feather, cuda_fuse.finalize_feather)
               if quality else (cuda_fuse.fuse_overwrite,))
    acq = os.path.join(work, f'parity_{name}_{grid}x{grid}')
    write_acquisition(acq, grid, tile, overlap=205 * tile // TILE, seed=11,
                      jitter=3 if quality else 0)
    trees = {}
    state = None
    for run, dev in enumerate(('cuda', 'cpu')):
        for fn in counted:
            fn.launches = 0
        out = os.path.join(work, f'parity_{name}_out_{run}')
        t0 = time.perf_counter()
        # the band fuser: these canvases are under the streaming threshold
        pipe = stitch(acq, use_registration=True, apply_flatfield=True,
                      device=torch.device(dev), state=state,
                      options=smoke_options(out, quality, streaming='on'))
        launches = [fn.launches for fn in counted]
        log(f"slice parity ({name}): {grid}x{grid}x{len(CHANNELS)}ch "
            f"{tile}^2 on {dev}: {time.perf_counter() - t0:.2f}s, shifts "
            f"h={pipe.shifts.h_shift} v={pipe.shifts.v_shift}, kernel "
            f"launches {launches}")
        if dev == 'cuda':
            if min(launches) == 0:
                raise SystemExit(f"slice parity ({name}): the card run "
                                 f"launched {launches} of its kernels")
            if quality:
                state = CarriedState(
                    flatfields=pipe.flatfields, shifts=pipe.shifts,
                    global_positions=pipe.global_positions,
                    global_positions_float=pipe.global_positions_float)
        trees[run] = read_tree(out)
    a, b = trees[0], trees[1]
    if sorted(a) != sorted(b):
        raise SystemExit(f"slice parity ({name}): trees differ in layout: "
                         f"{sorted(set(a) ^ set(b))}")
    for key in sorted(a):
        same = (np.array_equal(a[key], b[key])
                if isinstance(a[key], np.ndarray) else a[key] == b[key])
        if not same:
            raise SystemExit(f"slice parity ({name}): {key} differs between "
                             f"the card and the CPU run")
    levels = sum(isinstance(v, np.ndarray) for v in a.values())
    log(f"slice parity ({name}): card and CPU trees equal ({len(a)} "
        f"entries, {levels} level arrays)")


# --------------------------------------------------------------------- 5

def reference_plane(pipe, gt, origins, channel: int, height: int,
                    width: int, region: str = 'A1', dtype=np.uint16,
                    copy: tuple = None) -> np.ndarray:
    """Level 0 of one channel, fused in plain NumPy from the texture the
    acquisition was cut from (``gt`` None: from the tile files of another
    copy of it, ``copy`` = (this acquisition's folder, the copy's), at
    each job's path): each job's crop window, flatfield-corrected (tile *
    recip in f32; for uint16 trunc(clip(.)), for float32 as it is),
    written in plan order."""
    from image_stitcher_tpu_torch.io.acquisition import read_image
    recip = pipe._flatfield_recip_np()[channel]
    tile = pipe.acq.input_height
    out = np.zeros((height, width), dtype)
    for job in pipe._build_jobs(0, region):
        if job.channel_idx != channel:
            continue
        if gt is None:
            path = os.path.join(copy[1], os.path.relpath(job.filepath,
                                                         copy[0]))
            t = read_image(path).astype(np.float32) * recip
        else:
            fov = int(os.path.basename(job.filepath).split('_')[1])
            y0, x0 = origins[fov]
            t = gt[y0:y0 + tile, x0:x0 + tile].astype(np.float32) * recip
        if dtype == np.uint16:
            t = np.clip(t, 0, 65535).astype(np.uint16)
        top, bottom, left, right = job.crops
        r1 = min(tile - bottom, height - job.y)
        s1 = min(tile - right, width - job.x)
        out[job.y + top:job.y + r1, job.x + left:job.x + s1] = \
            t[top:r1, left:s1]
    return out


def phase_main_path(work: str, card: str, grid: int = 10,
                    tile: int = TILE, device: str = 'cuda',
                    keep: str = None) -> dict:
    """5: the main path. With ``keep``, the acquisition and the tree are
    written there (they outlive ``work``, for phases 15b and 16a) and the
    result carries the tree's digest."""
    from image_stitcher_tpu_torch import stitch
    from image_stitcher_tpu_torch.io.omezarr import level_shapes
    from image_stitcher_tpu_torch.io.zarr_store import read_array
    from image_stitcher_tpu_torch.models.streaming import (
        band_canvas_shape, band_rows_for, partition_jobs_by_band)
    from image_stitcher_tpu_torch.ops import cuda_fuse
    acq = os.path.join(keep or work, f'main_{grid}x{grid}')
    t0 = time.perf_counter()
    gt, origins = write_acquisition(acq, grid, tile,
                                    overlap=205 * tile // TILE, seed=5)
    log(f"main path: wrote {grid}x{grid}x{len(CHANNELS)} {tile}^2 uint16 "
        f"tiles in {time.perf_counter() - t0:.1f}s")
    out = os.path.join(keep or work, 'main_out')
    dev = torch.device(device)
    cuda_fuse.fuse_overwrite.launches = 0
    t0 = time.perf_counter()
    pipe = stitch(acq, use_registration=True, apply_flatfield=True,
                  device=dev, options=smoke_options(out))
    e2e = time.perf_counter() - t0
    launches = cuda_fuse.fuse_overwrite.launches
    n_tiles = grid * grid * len(CHANNELS)

    width, height = pipe._region_dimensions(0, 'A1')
    streamed = pipe._should_stream(0, 'A1')
    log(f"main path: _should_stream(A1) = {streamed} (canvas "
        f"{len(CHANNELS) * height * width * 2} B, threshold "
        f"{pipe.options.streaming_threshold_bytes} B)")
    if not streamed or 'stream_fuse_save' not in pipe.timers.as_dict():
        raise SystemExit("main path: the canvas did not stream in bands")
    opts = pipe.options
    band = band_rows_for(opts.write_band_rows() * opts.device_band_multiple,
                         pipe.num_pyramid_levels)
    tasks, _ = partition_jobs_by_band(pipe._build_jobs(0, 'A1'), tile,
                                      height, band)
    batches = sum(-(-len(v) // opts.fusion_batch) for v in tasks.values())
    stats = pipe.fuse_stats['A1_t0']
    canvas = band_canvas_shape(tile, tile, band, width)
    if (band, width, tile) == (BAND_ROWS, BAND_W, TILE) \
            and canvas != BAND_CANVAS:
        raise SystemExit(f"main path: band canvas {canvas}, phase 3 timed "
                         f"{BAND_CANVAS}")
    log(f"main path: band canvas {canvas}")
    log(f"main path: shifts h={pipe.shifts.h_shift} v={pipe.shifts.v_shift}"
        f", canvas {len(CHANNELS)}x{height}x{width}, "
        f"{pipe.num_pyramid_levels} levels, band {band} rows, "
        f"{len(tasks)} bands, {batches} batches, kernel launches "
        f"{launches}")
    if (launches != (batches if dev.type == 'cuda' else 0)
            or stats['batches'] != batches):
        raise SystemExit(f"main path: {launches} kernel launches and "
                         f"{stats['batches']} fused batches for {batches} "
                         f"batches planned")
    zarr = os.path.join(out, '0_stitched', 'A1_stitched.ome.zarr')
    want = level_shapes((1, len(CHANNELS), 1, height, width),
                        pipe.num_pyramid_levels)
    for lv, shape in enumerate(want):
        with open(os.path.join(zarr, str(lv), '.zarray')) as f:
            got = tuple(json.load(f)['shape'])
        if got != shape:
            raise SystemExit(f"main path: level {lv} is {got}, not {shape}")
    level0 = read_array(os.path.join(zarr, '0'))
    ref = reference_plane(pipe, gt, origins, 0, height, width)
    if not np.array_equal(level0[0, 0, 0], ref):
        bad = int((level0[0, 0, 0] != ref).sum())
        raise SystemExit(f"main path: channel 0 level 0 differs from the "
                         f"NumPy reference in {bad} pixels")
    if pipe.num_pyramid_levels > 1:
        level1 = read_array(os.path.join(zarr, '1'))
        if not np.array_equal(level1[0, :, 0],
                              level0[0, :, 0, :height // 2 * 2:2,
                                     :width // 2 * 2:2]):
            raise SystemExit("main path: level 1 is not level 0 subsampled")
        del level1
    del level0, ref, gt
    banned = [m for m in BANNED if m in sys.modules]
    if banned:
        raise SystemExit(f"main path: loaded {banned}")
    t = pipe.timers.as_dict()
    log(f"main path on {card}: e2e {e2e:.3f}s = {n_tiles / e2e:.2f} "
        f"tiles/s ({n_tiles} tiles); stages scan={t.get('scan', 0):.3f}s "
        f"flatfield_fit={t.get('flatfield_fit', 0):.3f}s "
        f"registration={t.get('registration', 0):.3f}s (overlapped with "
        f"the fit) fuse+write={t.get('stream_fuse_save', 0):.3f}s; band "
        f"fuser: fuse={stats['fuse']:.3f}s readback_wait="
        f"{stats['readback_wait']:.3f}s write={stats['write']:.3f}s; "
        f"channel 0 level 0 equals the NumPy reference")
    return {'launches': launches, 'e2e_s': e2e,
            'tiles_per_s': n_tiles / e2e, 'acq': acq, 'out': out,
            'digest': tree_digest(out) if keep else None}


# --------------------------------------------------------------------- 6

def quality_reference(pipe, gt, origins, channel: int, rows, width: int,
                      blend_px: int = BLEND) -> np.ndarray:
    """Rows [r0, r1) of one channel's level 0 on the maximum-quality
    path, fused in plain NumPy from the texture the acquisition was cut
    from, with the pipeline's own positions and subpixel warp: each job's
    tile shifted by its residual, flatfield-corrected and quantized,
    weighted by its ramp and accumulated in plan order (an f32 product,
    then an f32 sum), then divided, rounded half to even and cast."""
    from image_stitcher_tpu_torch.io.readers import subpixel_shift
    recip = pipe._flatfield_recip_np()[channel]
    th, tw = pipe.acq.input_height, pipe.acq.input_width
    r0, r1 = rows
    acc = np.zeros((r1 - r0, width), np.float32)
    wsum = np.zeros((r1 - r0, width), np.float32)
    for job in pipe._build_jobs(0, 'A1'):
        top, bottom, left, right = job.crops
        a0 = max(job.y + max(top, 0), r0)
        a1 = min(job.y + min(th - bottom, th), r1)
        s0, s1 = max(left, 0), min(tw - right, tw, width - job.x)
        if job.channel_idx != channel or a1 <= a0 or s1 <= s0:
            continue
        fov = int(os.path.basename(job.filepath).split('_')[1])
        y0, x0 = origins[fov]
        t = gt[y0:y0 + th, x0:x0 + tw]
        if job.fy or job.fx:
            t = subpixel_shift(t, job.fy, job.fx)
        rr = np.arange(a0 - job.y, a1 - job.y)[:, None]
        ss = np.arange(s0, s1)[None, :]
        v = t[rr, ss].astype(np.float32) * recip[rr, ss]
        v = np.trunc(np.clip(v, 0, 65535)).astype(np.float32)
        d = np.minimum(np.minimum(rr - top + 1, th - bottom - rr),
                       np.minimum(ss - left + 1, tw - right - ss))
        ramp = np.clip(d.astype(np.float32) / np.float32(blend_px),
                       0, 1).astype(np.float32)
        win = (slice(a0 - r0, a1 - r0), slice(job.x + s0, job.x + s1))
        acc[win] += ramp * v
        wsum[win] += ramp
    out = acc / np.maximum(wsum, np.float32(1e-6))
    out = np.where(wsum > 0, out, np.float32(0))
    return np.clip(np.rint(out), 0, 65535).astype(np.uint16)


def phase_quality_path(work: str, card: str, grid: int = 10,
                       tile: int = TILE, jitter: int = 3) -> dict:
    """The maximum-quality path at full width: all-pairs registration on
    the card, global solve, subpixel placement, feathered blending."""
    from image_stitcher_tpu_torch import stitch
    from image_stitcher_tpu_torch.io.zarr_store import read_array
    from image_stitcher_tpu_torch.models.streaming import (
        band_rows_for, partition_jobs_by_band)
    from image_stitcher_tpu_torch.ops import cuda_fuse
    acq = os.path.join(work, f'quality_{grid}x{grid}')
    t0 = time.perf_counter()
    gt, origins = write_acquisition(acq, grid, tile,
                                    overlap=205 * tile // TILE, seed=6,
                                    jitter=jitter)
    log(f"quality path: wrote {grid}x{grid}x{len(CHANNELS)} {tile}^2 "
        f"uint16 tiles (+-{jitter} px jitter) in "
        f"{time.perf_counter() - t0:.1f}s")
    out = os.path.join(work, 'quality_out')
    cuda_fuse.fuse_feather.launches = 0
    cuda_fuse.finalize_feather.launches = 0
    t0 = time.perf_counter()
    pipe = stitch(acq, use_registration=True, apply_flatfield=True,
                  device=torch.device('cuda'),
                  options=smoke_options(out, quality=True))
    e2e = time.perf_counter() - t0
    launches = cuda_fuse.fuse_feather.launches
    fin_launches = cuda_fuse.finalize_feather.launches
    n_tiles = grid * grid * len(CHANNELS)

    fpos = pipe.global_positions_float.get('A1', {})
    if len(fpos) != grid * grid or 'A1' in pipe._global_rejected:
        raise SystemExit(f"quality path: the global solve placed "
                         f"{len(fpos)} of {grid * grid} tiles")
    # solved positions against the fixture's, the free translation removed
    keys = sorted(fpos)
    solved = np.array([fpos[k] for k in keys])
    truth = np.array([origins[r * grid + c] for r, c in keys], np.float64)
    delta = solved - truth
    pos_err = float(np.abs(delta - np.median(delta, axis=0)).max())
    if pos_err > 0.5:
        raise SystemExit(f"quality path: solved positions are {pos_err} px "
                         f"from the fixture's")
    width, height = pipe._region_dimensions(0, 'A1')
    opts = pipe.options
    band = band_rows_for(opts.write_band_rows() * opts.device_band_multiple,
                         pipe.num_pyramid_levels)
    jobs = pipe._build_jobs(0, 'A1')
    tasks, _ = partition_jobs_by_band(jobs, tile, height, band)
    batches = sum(-(-len(v) // opts.fusion_batch) for v in tasks.values())
    stats = pipe.fuse_stats['A1_t0']
    warped = sum(1 for j in jobs if j.fy or j.fx)
    log(f"quality path: {pipe.device_pairs} pairs measured on the card, "
        f"{len(fpos)} tiles solved (max {pos_err:.3f} px from the fixture),"
        f" {warped} of {len(jobs)} jobs shifted by a residual; canvas "
        f"{len(CHANNELS)}x{height}x{width}, band {band} rows, {len(tasks)} "
        f"bands, {batches} batches, fuse_feather launches {launches}, "
        f"finalize_feather launches {fin_launches}")
    if pipe.device_pairs == 0:
        raise SystemExit("quality path: no pair went through the device "
                         "phase correlation")
    if (launches != batches or stats['batches'] != batches
            or fin_launches != len(tasks)):
        raise SystemExit(f"quality path: {launches} accumulate and "
                         f"{fin_launches} finalize launches for {batches} "
                         f"batches and {len(tasks)} bands planned")
    zarr = os.path.join(out, '0_stitched', 'A1_stitched.ome.zarr')
    level0 = read_array(os.path.join(zarr, '0'))
    if level0.shape != (1, len(CHANNELS), 1, height, width):
        raise SystemExit(f"quality path: level 0 is {level0.shape}")
    rows = (max(0, band - 2048), min(height, band + 2048))  # straddles
    t0 = time.perf_counter()
    ref = quality_reference(pipe, gt, origins, 0, rows, width)
    t_ref = time.perf_counter() - t0
    got = level0[0, 0, 0, rows[0]:rows[1]]
    if not np.array_equal(got, ref):
        bad = int((got != ref).sum())
        raise SystemExit(f"quality path: channel 0 rows {rows} differ from "
                         f"the NumPy reference in {bad} pixels (max "
                         f"{int(np.abs(got.astype(int) - ref).max())})")
    del level0, got, ref, gt
    banned = [m for m in BANNED if m in sys.modules]
    if banned:
        raise SystemExit(f"quality path: loaded {banned}")
    t = pipe.timers.as_dict()
    log(f"quality path on {card}: e2e {e2e:.3f}s = {n_tiles / e2e:.2f} "
        f"tiles/s ({n_tiles} tiles); stages scan={t.get('scan', 0):.3f}s "
        f"flatfield_fit={t.get('flatfield_fit', 0):.3f}s "
        f"registration={t.get('registration', 0):.3f}s (overlapped with "
        f"the fit) fuse+write={t.get('stream_fuse_save', 0):.3f}s; band "
        f"fuser: fuse={stats['fuse']:.3f}s readback_wait="
        f"{stats['readback_wait']:.3f}s write={stats['write']:.3f}s; "
        f"channel 0 rows {rows[0]}-{rows[1]} equal the NumPy reference "
        f"({t_ref:.1f}s to build)")
    return {'launches': launches, 'finalize_launches': fin_launches,
            'e2e_s': e2e, 'tiles_per_s': n_tiles / e2e}


# --------------------------------------------------------------------- 7

WELLS = [f"{row}1" for row in "ABCDEFGH"]
#: phase 10's plate (and phase 15c's): 4 of phase 7's wells, cut for the
#: script's time
MERGE_WELLS = WELLS[:4]


def read_png_gray8(path: str) -> np.ndarray:
    """Decode an 8-bit grayscale PNG whose rows all use filter type 0 (as
    the port writes them); anything else fails the phase."""
    import struct
    import zlib
    with open(path, 'rb') as f:
        data = f.read()
    if data[:8] != b'\x89PNG\r\n\x1a\n':
        raise SystemExit(f"{path}: not a PNG")
    pos, idat, shape = 8, b'', None
    while pos < len(data):
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) != struct.unpack(
                '>I', data[pos + 8 + n:pos + 12 + n])[0]:
            raise SystemExit(f"{path}: bad CRC in {kind!r}")
        if kind == b'IHDR':
            w, h, depth, color, _, _, lace = struct.unpack('>IIBBBBB', body)
            if (depth, color, lace) != (8, 0, 0):
                raise SystemExit(f"{path}: not 8-bit grayscale")
            shape = (h, w)
        elif kind == b'IDAT':
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        shape[0], shape[1] + 1)
    if rows[:, 0].any():
        raise SystemExit(f"{path}: a row uses a PNG filter")
    return rows[:, 1:]


def compare_well_trees(a_root: str, b_root: str) -> int:
    """Byte-equal OME-Zarr trees, well by well (one well's levels in
    memory at a time); returns the number of level arrays compared."""
    levels = 0
    for well in WELLS:
        rel = os.path.join('0_stitched', f'{well}_stitched.ome.zarr')
        a = read_tree(os.path.join(a_root, rel))
        b = read_tree(os.path.join(b_root, rel))
        if not a or sorted(a) != sorted(b):
            raise SystemExit(f"plate: {well} trees differ in layout: "
                             f"{sorted(set(a) ^ set(b))}")
        for key in sorted(a):
            same = (np.array_equal(a[key], b[key])
                    if isinstance(a[key], np.ndarray) else a[key] == b[key])
            if not same:
                raise SystemExit(f"plate: {well}/{key} differs between the "
                                 f"in-RAM and the streamed run")
            levels += isinstance(a[key], np.ndarray)
    return levels


def phase_plate(work: str, card: str, grid: int = 3,
                tile: int = TILE) -> None:
    """An HCS plate through the in-RAM path, held against the same plate
    streamed in bands, a NumPy reference and the host flatfield solver.
    Cut from the 96-well plate of the JAX package's BASELINE.md to 8
    wells, to keep the script within its time limit."""
    from image_stitcher_tpu_torch import CarriedState, stitch
    from image_stitcher_tpu_torch.core import geometry as geo
    from image_stitcher_tpu_torch.io.zarr_store import read_array
    from image_stitcher_tpu_torch.ops import cuda_fuse
    from image_stitcher_tpu_torch.ops.flatfield import (
        fit_flatfield_stack, fit_flatfield_stack_np)
    from image_stitcher_tpu_torch.ops.pyramid import iter_levels
    acq = os.path.join(work, 'plate')
    t0 = time.perf_counter()
    gt, origins = write_acquisition(acq, grid, tile,
                                    overlap=205 * tile // TILE, seed=7,
                                    regions=WELLS)
    n_tiles = len(WELLS) * grid * grid * len(CHANNELS)
    log(f"plate: wrote {len(WELLS)} wells x {grid}x{grid} x "
        f"{len(CHANNELS)}ch {tile}^2 uint16 tiles in "
        f"{time.perf_counter() - t0:.1f}s")
    runs = {}
    state = None
    for name, extra in (
            ('in-RAM', dict(streaming='auto', flatfield_device='device',
                            registration_report=True, debug_visuals=True)),
            ('streamed', dict(streaming='on'))):
        out = os.path.join(work, f'plate_{name}')
        cuda_fuse.fuse_overwrite.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pipe = stitch(acq, use_registration=True, apply_flatfield=True,
                      device=torch.device('cuda'), state=state,
                      options=smoke_options(out, **extra))
        e2e = time.perf_counter() - t0
        launches = cuda_fuse.fuse_overwrite.launches
        peak = torch.cuda.max_memory_allocated()
        streams = {w: pipe._should_stream(0, w) for w in WELLS}
        batches = sum(s['batches'] for s in pipe.fuse_stats.values())
        t = pipe.timers.as_dict()
        log(f"plate ({name}) on {card}: e2e {e2e:.3f}s = "
            f"{n_tiles / e2e:.2f} tiles/s ({n_tiles} tiles); stages "
            f"flatfield_fit={t.get('flatfield_fit', 0):.3f}s "
            f"registration={t.get('registration', 0):.3f}s "
            f"fuse={t.get('fuse', 0):.3f}s save={t.get('save', 0):.3f}s "
            f"(the saver thread, overlapped with the next well's fuse) "
            f"stream_fuse_save={t.get('stream_fuse_save', 0):.3f}s; "
            f"max_memory_allocated {peak} B ({peak / 2 ** 30:.2f} GiB); "
            f"fuse_overwrite launches {launches} for {batches} batches; "
            f"_should_stream {streams}")
        want_stream = name == 'streamed'
        if any(v != want_stream for v in streams.values()):
            raise SystemExit(f"plate ({name}): wells took the wrong path: "
                             f"_should_stream {streams}")
        if ('stream_fuse_save' in t) != want_stream or launches == 0 \
                or launches != batches:
            raise SystemExit(f"plate ({name}): {launches} kernel launches "
                             f"for {batches} batches, stages {sorted(t)}")
        runs[name] = (pipe, out)
        if state is None:
            state = CarriedState(flatfields=pipe.flatfields,
                                 shifts=pipe.shifts)
    pipe, out = runs['in-RAM']

    # 1. the in-RAM tree is the streamed tree, byte for byte
    t0 = time.perf_counter()
    levels = compare_well_trees(out, runs['streamed'][1])
    log(f"plate: in-RAM and streamed trees byte-equal ({len(WELLS)} wells, "
        f"{levels} level arrays, {pipe.num_pyramid_levels} levels; "
        f"{time.perf_counter() - t0:.1f}s to compare)")

    # 2. one well's channel 0 against a NumPy reference, levels 0 and 1
    width, height = pipe._region_dimensions(0, WELLS[0])
    zarr = os.path.join(out, '0_stitched', f'{WELLS[0]}_stitched.ome.zarr')
    level0 = read_array(os.path.join(zarr, '0'))[0, 0, 0]
    level1 = read_array(os.path.join(zarr, '1'))[0, 0, 0]
    ref = reference_plane(pipe, gt, origins, 0, height, width, WELLS[0])
    if not np.array_equal(level0, ref):
        raise SystemExit(f"plate: {WELLS[0]} channel 0 level 0 differs from "
                         f"the NumPy reference in "
                         f"{int((level0 != ref).sum())} pixels")
    if not np.array_equal(level1, ref[:height // 2 * 2:2,
                                      :width // 2 * 2:2]):
        raise SystemExit(f"plate: {WELLS[0]} channel 0 level 1 is not the "
                         f"reference subsampled")
    log(f"plate: {WELLS[0]} channel 0 levels 0 ({height}x{width}) and 1 "
        f"equal the NumPy reference")
    del level0, level1, ref, gt

    # where one well's save goes: the pyramid built on the card with one
    # copy of each level to pinned host memory, then the chunk writes
    canvas = pipe.stitch_region(0, WELLS[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for level in iter_levels(canvas, pipe.num_pyramid_levels,
                             pipe.options.pyramid_downsample):
        torch.empty(tuple(level.shape), dtype=level.dtype,
                    pin_memory=True).copy_(level)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe.save_region(0, WELLS[0], canvas)
    t_save = time.perf_counter() - t0
    log(f"plate: one well's save alone on {card}: {t_save:.3f}s, of which "
        f"the pyramid on the card and the level copies to pinned host "
        f"memory {t_dev:.3f}s and the chunk writes ~{t_save - t_dev:.3f}s "
        f"({canvas.numel() * canvas.element_size() * 4 / 3 / 2 ** 20:.0f} "
        f"MiB of levels)")
    del canvas

    # 3. the device fields against the host solver on the same stacks
    worst = 0.0
    for idx, stack in pipe.flatfield_stacks():
        d_stack = torch.from_numpy(stack).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev = fit_flatfield_stack(d_stack).cpu().numpy()
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = fit_flatfield_stack_np(stack)
        t_host = time.perf_counter() - t0
        err = float(np.abs(dev - host).max())
        worst = max(worst, err)
        log(f"plate: flatfield channel {idx}, stack {tuple(stack.shape)}: "
            f"device fit {t_dev:.4f}s, host fit {t_host:.4f}s, max "
            f"|device - host| {err:.2e} at 96^2")
    if worst > 1e-4:
        raise SystemExit(f"plate: device flatfields are {worst} from the "
                         f"host solver's")

    # 4. the registration report and the debug images
    with open(os.path.join(out, 'registration_report.json')) as f:
        report = json.load(f)
    center = report['regions'][WELLS[0]]
    if (center['scope'] != 'center'
            or center['aggregated']['h_shift'] != list(pipe.shifts.h_shift)
            or center['aggregated']['v_shift'] != list(pipe.shifts.v_shift)):
        raise SystemExit(f"plate: the report's center pairs {center} do not "
                         f"give the run's shifts {pipe.shifts}")
    acqd = pipe.acq
    xs, ys = acqd.region_positions(0, WELLS[0])
    ox = geo.overlap_estimate(acqd.input_width, (xs[1] - xs[0]) * 1000
                              / acqd.pixel_size_um, acqd.pixel_binning,
                              pipe.options.overlap_fudge)
    oy = geo.overlap_estimate(acqd.input_height, (ys[1] - ys[0]) * 1000
                              / acqd.pixel_size_um, acqd.pixel_binning,
                              pipe.options.overlap_fudge)
    my = int(acqd.input_height * pipe.options.registration_margin)
    mx = int(acqd.input_width * pipe.options.registration_margin)
    want = {'horizontal.png': (acqd.input_height - 2 * my, 2 * ox),
            'vertical.png': (2 * oy, acqd.input_width - 2 * mx)}
    for name, shape in want.items():
        img = read_png_gray8(os.path.join(out, name))
        if img.shape != shape or not img.any():
            raise SystemExit(f"plate: {name} is {img.shape}, not {shape}")
    log(f"plate: registration_report.json gives the center pairs' shifts "
        f"h={center['aggregated']['h_shift']} "
        f"v={center['aggregated']['v_shift']}; debug images "
        + ", ".join(f"{n} {s[0]}x{s[1]}" for n, s in want.items()))
    banned = [m for m in BANNED if m in sys.modules]
    if banned:
        raise SystemExit(f"plate: loaded {banned}")


# --------------------------------------------------------------------- 8

def _gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """OpenCV's ``GaussianBlur(img, (0, 0), sigma)`` of a float32 plane:
    a separable kernel of ``round(8 sigma + 1) | 1`` taps, reflect-101
    borders."""
    import torch.nn.functional as F
    taps = int(round(8 * sigma + 1)) | 1
    x = torch.arange(taps, device=img.device, dtype=torch.float32)
    x -= taps // 2
    kern = torch.exp(-x * x / (2 * sigma * sigma))
    kern /= kern.sum()
    r = taps // 2
    out = img[None, None]
    out = F.conv2d(F.pad(out, (r, r, 0, 0), mode='reflect'),
                   kern.view(1, 1, 1, taps))
    out = F.conv2d(F.pad(out, (0, 0, r, r), mode='reflect'),
                   kern.view(1, 1, taps, 1))
    return out[0, 0]


def compressible(rng, side: int) -> np.ndarray:
    """A (side, side) uint16 texture with the JAX package's benchmark
    content for the compressed write path (bench.py with
    BENCH_CONTENT=compressible: ``tests/fixtures.py::make_ground_truth``
    at gamma 3.0, 6 low bits zeroed): uniform noise plus its Gaussian
    blurs at sigma 3, 9 and 27 (weights 3, 9, 27; the noise 0.3),
    normalised to [0, 1], cubed (a dark background under sparse bright
    structure), scaled to 10-90 % of the range, the 6 low bits zeroed.
    Made on the card (the CPU without one) with exact blurs, where the
    fixture blurs wide canvases at reduced resolution."""
    dev = torch.device('cuda' if torch.cuda.is_available() else 'cpu')
    gen = torch.Generator(dev).manual_seed(int(rng.integers(1 << 62)))
    img = torch.rand((side, side), generator=gen, device=dev)
    acc = 0.3 * img
    for k in (3, 9, 27):
        acc += k * _gaussian_blur(img, k)
    del img
    acc -= acc.min()
    acc /= acc.max().clamp_min(1e-9)
    acc = acc ** 3
    out = (acc * (65535 * 0.8) + 65535 * 0.1).to(torch.int32)
    return (out & ~63).cpu().numpy().astype(np.uint16)


def codec_chunks(rng):
    """{label: (chunk, typesize)}: 2048^2 chunks and the main path's right
    edge chunk (203 columns of data, zero past the array, as the writer
    pads it), full entropy, compressible (:func:`compressible`; its high
    byte for u8) and all zero, u16 and u8."""
    edge = BAND_W - (BAND_W // TILE) * TILE
    out = {}
    for dtype in (np.uint16, np.uint8):
        tex = compressible(rng, TILE)
        contents = {
            'full-entropy': rng.integers(0, np.iinfo(dtype).max + 1,
                                         (TILE, TILE), dtype=dtype),
            'compressible': (tex if dtype == np.uint16 else
                             (tex >> 8).astype(np.uint8)),
            'zero': np.zeros((TILE, TILE), dtype)}
        name = np.dtype(dtype).name
        for what, full in contents.items():
            out[f"{name} {what} {TILE}^2"] = (full, full.itemsize)
            part = np.zeros_like(full)
            part[:, :edge] = full[:, :edge]
            out[f"{name} {what} edge {edge} cols"] = (part, full.itemsize)
    return out


def codec_check(rng) -> None:
    """The C codec against its plain version: byte-equal frames, and both
    decoders give the input back."""
    from image_stitcher_tpu_torch.io import blosc
    t0 = time.perf_counter()
    for label, (chunk, ts) in codec_chunks(rng).items():
        frame = bytes(blosc.compress(chunk, ts))
        plain = blosc.compress_plain(chunk, ts)
        raw = chunk.tobytes()
        if frame != plain:
            raise SystemExit(f"codec: the C frame of {label} differs from "
                             f"the plain version's ({len(frame)} vs "
                             f"{len(plain)} bytes)")
        if (blosc.decompress(frame).tobytes() != raw
                or blosc.decompress_plain(frame) != raw):
            raise SystemExit(f"codec: {label} does not decode to its input")
        log(f"codec {label}: C and plain frames byte-equal, {len(frame)} "
            f"bytes ({len(frame) / len(raw):.4f} of {len(raw)}"
            f"{', memcpyed' if frame[2] & 0x02 else ''}); round trips exact")
    log(f"codec: checked in {time.perf_counter() - t0:.1f}s")


def codec_rates(rng, card: str) -> dict:
    """MB/s (input bytes) of the C encoder and decoder on distinct
    2048^2 u16 chunks: one thread, then a pool of one thread per CPU this
    process may run on (the writers' pool)."""
    from image_stitcher_tpu_torch.io import blosc
    from image_stitcher_tpu_torch.params import _available_cpus
    ncpu = _available_cpus()
    n = max(16, 2 * ncpu)
    rates = {}
    for what in ('compressible', 'full-entropy'):
        chunks = [compressible(rng, TILE) if what == 'compressible'
                  else rng.integers(0, 65536, (TILE, TILE), dtype=np.uint16)
                  for _ in range(n)]
        nbytes = sum(c.nbytes for c in chunks)
        frames = [blosc.compress(c, 2) for c in chunks]   # warm
        ratio = sum(len(f) for f in frames) / nbytes
        row = {'ratio': ratio}
        for threads in (1, ncpu):
            with ThreadPoolExecutor(threads) as pool:
                t0 = time.perf_counter()
                frames = list(pool.map(lambda c: blosc.compress(c, 2),
                                       chunks))
                enc = time.perf_counter() - t0
                t0 = time.perf_counter()
                list(pool.map(blosc.decompress, frames))
                dec = time.perf_counter() - t0
            row[threads] = (nbytes / enc / 1e6, nbytes / dec / 1e6)
        rates[what] = row
        log(f"codec MB/s on {card}, {what} 2048^2 u16 chunks (ratio "
            f"{ratio:.4f}, {n} chunks): encode {row[1][0]:.0f} on one "
            f"thread, {row[ncpu][0]:.0f} on {ncpu}; decode "
            f"{row[1][1]:.0f} / {row[ncpu][1]:.0f} (os.cpu_count() "
            f"{os.cpu_count()}, affinity {ncpu})")
    return rates


def tree_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, n))
               for d, _, names in os.walk(root) for n in names)


def compare_trees(a: dict, b: dict, what: str, arrays_only=False) -> int:
    """Equal decoded arrays (and, unless ``arrays_only``, equal JSON apart
    from the chunks' compressor); returns the number of arrays."""
    if not arrays_only and sorted(a) != sorted(b):
        raise SystemExit(f"{what}: trees differ in layout: "
                         f"{sorted(set(a) ^ set(b))}")
    arrays = sorted(k for k, v in a.items() if isinstance(v, np.ndarray))
    if not arrays or arrays != sorted(k for k, v in b.items()
                                      if isinstance(v, np.ndarray)):
        raise SystemExit(f"{what}: the trees hold different arrays")
    for key in arrays:
        if not np.array_equal(a[key], b[key]):
            raise SystemExit(f"{what}: {key} decodes differently")
    for key in ([] if arrays_only else sorted(a)):
        if isinstance(a[key], dict):
            strip = [{k: v for k, v in m.items() if k != 'compressor'}
                     for m in (a[key], b[key])]
            if strip[0] != strip[1]:
                raise SystemExit(f"{what}: {key} differs")
    return len(arrays)


def output_options(out: str, **extra):
    """The main path's options with the JAX package's default compressor
    (blosc-lz4), or what ``extra`` sets."""
    from image_stitcher_tpu_torch import EngineOptions
    return EngineOptions(fusion_batch=10, reader_threads=8,
                         output_folder=out, **extra)


def phase_output_layer(work: str, card: str, grid: int = 10,
                       tile: int = TILE, device: str = 'cuda') -> dict:
    """The OME-Zarr output layer on the card's host: codec, lz4 main path
    against its raw twin, 'auto', O_DIRECT, zarr v3. The main grid's and
    the 3x3 grid's acquisitions and raw trees stay in ``work`` for phase
    12 (their paths in the result)."""
    import zlib
    from image_stitcher_tpu_torch import (StitchingParameters,
                                          scan_acquisition, stitch)
    from image_stitcher_tpu_torch.io.directio import probe_direct_io
    from image_stitcher_tpu_torch.models.pipeline import StitchPipeline
    from image_stitcher_tpu_torch.models.streaming import (
        band_rows_for, partition_jobs_by_band)
    from image_stitcher_tpu_torch.ops import cuda_fuse
    from image_stitcher_tpu_torch.params import _available_cpus
    dev = torch.device(device)
    rng = np.random.default_rng(8)
    codec_check(rng)
    rates = codec_rates(rng, card)

    # the main path's grid, compressible, default compressor
    acq = os.path.join(work, f'comp_{grid}x{grid}')
    t0 = time.perf_counter()
    write_acquisition(acq, grid, tile, overlap=205 * tile // TILE, seed=9,
                      texture=compressible)
    scan = scan_acquisition(acq)
    keys = sorted(scan.tiles)
    ratios = []
    for i in sorted({0, len(keys) // 2, len(keys) - 1}):
        with open(scan.tiles[keys[i]].filepath, 'rb') as f:
            body = f.read()[160:160 + (1 << 20)]
        ratios.append(len(zlib.compress(body, 1)) / len(body))
    probe_ratio = float(np.median(ratios))
    log(f"output layer: wrote {grid}x{grid}x{len(CHANNELS)} {tile}^2 "
        f"compressible uint16 tiles (gamma 3, 6 low bits zeroed) in "
        f"{time.perf_counter() - t0:.1f}s; zlib-1 probe ratio "
        f"{probe_ratio:.4f} ({'within' if probe_ratio <= 0.6 else 'over'} "
        f"the 'auto' gate's 0.6)")
    runs = {}
    tree = None
    for name, extra in (('lz4', {}), ('raw', dict(compressor_cname=None))):
        out = os.path.join(work, f'comp_out_{name}')
        cuda_fuse.fuse_overwrite.launches = 0
        t0 = time.perf_counter()
        pipe = stitch(acq, use_registration=True, apply_flatfield=True,
                      device=dev,
                      options=output_options(out, **extra))
        e2e = time.perf_counter() - t0
        launches = cuda_fuse.fuse_overwrite.launches
        width, height = pipe._region_dimensions(0, 'A1')
        opts = pipe.options
        band = band_rows_for(opts.write_band_rows()
                             * opts.device_band_multiple,
                             pipe.num_pyramid_levels)
        tasks, _ = partition_jobs_by_band(pipe._build_jobs(0, 'A1'), tile,
                                          height, band)
        batches = sum(-(-len(v) // opts.fusion_batch)
                      for v in tasks.values())
        if (not pipe._should_stream(0, 'A1')
                or launches != (batches if dev.type == 'cuda' else 0)):
            raise SystemExit(f"output layer ({name}): {launches} kernel "
                             f"launches for {batches} batches, streamed "
                             f"{pipe._should_stream(0, 'A1')}")
        stats = pipe.fuse_stats['A1_t0']
        written = tree_bytes(out)
        t_read = time.perf_counter()
        got = read_tree(out)
        t_read = time.perf_counter() - t_read
        level_bytes = sum(v.nbytes for v in got.values()
                          if isinstance(v, np.ndarray))
        with open(os.path.join(out, '0_stitched', 'A1_stitched.ome.zarr',
                               '0', '.zarray')) as f:
            compressor = json.load(f)['compressor']
        if (compressor is None) != (name == 'raw'):
            raise SystemExit(f"output layer ({name}): chunks written with "
                             f"compressor {compressor}")
        t = pipe.timers.as_dict()
        n_tiles = grid * grid * len(CHANNELS)
        runs[name] = {'e2e_s': e2e, 'tiles_per_s': n_tiles / e2e,
                      'writer_s': stats['write'] + stats['close'],
                      'bytes': written, 'ratio': written / level_bytes,
                      'launches': launches}
        log(f"output layer ({name}) on {card}: e2e {e2e:.3f}s = "
            f"{n_tiles / e2e:.2f} tiles/s; fit={t.get('flatfield_fit', 0):.3f}"
            f"s registration={t.get('registration', 0):.3f}s fuse+write="
            f"{t.get('stream_fuse_save', 0):.3f}s; band fuser: fuse="
            f"{stats['fuse']:.3f}s readback_wait={stats['readback_wait']:.3f}"
            f"s write={stats['write']:.3f}s close={stats['close']:.3f}s "
            f"(writer {runs[name]['writer_s']:.3f}s); {written} bytes "
            f"written for {level_bytes} bytes of levels (ratio "
            f"{written / level_bytes:.4f}); fuse_overwrite launches "
            f"{launches} for {batches} batches; tree read back in "
            f"{t_read:.1f}s")
        if name != 'raw':
            shutil.rmtree(out)
        if tree is None:
            tree = got
        else:
            arrays = compare_trees(tree, got, 'output layer (lz4 vs raw)')
            log(f"output layer: the lz4 tree decodes equal to the raw "
                f"tree ({arrays} level arrays; JSON equal but for the "
                f"compressor)")
        del got
    del tree
    kept = {'main_acq': acq, 'main_raw': out}

    # 'auto' on this acquisition and this host's disk
    out = os.path.join(work, 'auto_out')
    pipe = StitchPipeline(StitchingParameters(input_folder=acq),
                          output_options(out, compressor_cname='auto'),
                          device=dev)
    pipe.acq = scan
    choice = pipe.resolved_compressor()
    entry = probe_direct_io(os.path.dirname(out))
    ncpu = _available_cpus()
    log(f"output layer: disk probe of {os.path.dirname(out)} on the card's "
        f"host: {entry}; 'auto' chooses {choice} (lz4 needs a zlib-1 ratio "
        f"<= 0.6, here {probe_ratio:.3f}, and a disk under 300 MB/s x "
        f"{ncpu} cores = {300 * ncpu} MB/s)")

    # 3x3: O_DIRECT on against off (raw), and zarr v3 against v2 (lz4)
    acq = os.path.join(work, 'comp_3x3')
    write_acquisition(acq, 3, tile, overlap=205 * tile // TILE, seed=10,
                      texture=compressible)
    try:
        fd = os.open(os.path.join(work, '.odirect'),
                     os.O_WRONLY | os.O_CREAT | os.O_DIRECT, 0o644)
        os.close(fd)
        direct_ok = True
    except OSError:
        direct_ok = False
    files = {}
    for mode in ('off', 'on'):
        out = os.path.join(work, f'direct_{mode}')
        stitch(acq, use_registration=True, apply_flatfield=True,
               device=dev,
               options=output_options(out, compressor_cname=None,
                                      direct_io=mode))
        files[mode] = {}
        for d, _, names in os.walk(out):
            for n in names:
                with open(os.path.join(d, n), 'rb') as f:
                    files[mode][os.path.relpath(os.path.join(d, n),
                                                out)] = f.read()
        if mode == 'off':
            kept.update(small_acq=acq, small_raw=out)
        else:
            shutil.rmtree(out)
    if not files['on'] or files['on'] != files['off']:
        raise SystemExit("output layer: direct_io='on' and 'off' wrote "
                         "different files")
    log(f"output layer: 3x3 raw run with direct_io='on' byte-equal to 'off' "
        f"({len(files['on'])} files, "
        f"{sum(map(len, files['on'].values()))} bytes; O_DIRECT opens "
        f"{'accepted' if direct_ok else 'refused, buffered fallback'} in "
        f"{work})")
    del files
    trees = {}
    for fmt in (2, 3):
        out = os.path.join(work, f'v{fmt}_out')
        cuda_fuse.fuse_overwrite.launches = 0
        t0 = time.perf_counter()
        stitch(acq, use_registration=True, apply_flatfield=True,
               device=dev,
               options=output_options(out, zarr_format=fmt))
        e2e = time.perf_counter() - t0
        if dev.type == 'cuda' and cuda_fuse.fuse_overwrite.launches == 0:
            raise SystemExit(f"output layer: the zarr v{fmt} run launched "
                             f"no kernel")
        trees[fmt] = read_tree(out)
        log(f"output layer: 3x3 lz4 zarr v{fmt} run: e2e {e2e:.3f}s, "
            f"{tree_bytes(out)} bytes written")
        shutil.rmtree(out)
    arrays = compare_trees(trees[2], trees[3], 'output layer (v3 vs v2)',
                           arrays_only=True)
    meta = trees[3][os.path.join('0_stitched', 'A1_stitched.ome.zarr',
                                 'zarr.json')]
    if meta['attributes']['ome']['version'] != '0.5':
        raise SystemExit(f"output layer: the v3 group is {meta}")
    log(f"output layer: the zarr v3 (sharded, NGFF 0.5) lz4 tree decodes "
        f"equal to the v2 tree ({arrays} level arrays)")
    banned = [m for m in BANNED if m in sys.modules]
    if banned:
        raise SystemExit(f"output layer: loaded {banned}")
    return {'rates': rates, 'runs': runs, 'auto': choice, 'probe': entry,
            **kept}


# --------------------------------------------------------------------- 9

#: the reader pool of the main path (``reader_threads=8``)
READERS = 8
GRAY_PALETTE = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)


def tile_files():
    """``tests/torch_tile_files.py``: plain encoders (TIFF LZW, PackBits,
    the predictor, PNG filters) and TIFF/PNG/BMP writers in NumPy and the
    standard library; the card's host has no OpenCV to write tiles."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'tests')
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_tile_files
    return torch_tile_files


def textures(rng, side: int, planes: int, dtype=np.uint16) -> np.ndarray:
    """(side, side) or (side, side, planes) of :func:`compressible`
    content (its high byte for uint8)."""
    out = [compressible(rng, side) for _ in range(planes)]
    if dtype == np.uint8:
        out = [(p >> 8).astype(np.uint8) for p in out]
    return out[0] if planes == 1 else np.stack(out, axis=-1)


def decoder_check(rng) -> None:
    """9a: each C decoder against its plain version and the data it was
    made from: LZW, PackBits and the predictor on u8 and u16 with 1 and 3
    samples a pixel (512^2 px: the plain LZW runs in Python); the PNG
    unfilter with the five filters cycling over the rows at 1-8 bytes a
    pixel (the C routine at 2048^2 against the source, the plain one on
    the first 16 rows); BMP row layouts, a 2048^2 deflate + predictor TIFF
    in 2-row strips and a 2048^2 16-bit PNG against their sources."""
    from image_stitcher_tpu_torch.io import tile_decode as td
    from image_stitcher_tpu_torch.io.bmp import decode_bmp
    from image_stitcher_tpu_torch.io.png import decode_png
    from image_stitcher_tpu_torch.io.tiff import decode_tiff
    tf = tile_files()
    t0 = time.perf_counter()
    side = 512
    for dtype in (np.uint8, np.uint16):
        for spp in (1, 3):
            img = textures(rng, side, spp, dtype).reshape(side, side * spp)
            diff = tf.apply_predictor(img, spp)
            raw = diff.tobytes()
            for codec, enc, fast, plain in (
                    ('LZW', tf.lzw_encode, td.lzw_decode,
                     td.lzw_decode_plain),
                    ('PackBits', tf.packbits_encode, td.packbits_decode,
                     td.packbits_decode_plain)):
                data = enc(raw)
                if (fast(data, len(raw)).tobytes() != raw
                        or plain(data, len(raw)).tobytes() != raw):
                    raise SystemExit(f"tile input: {codec} of "
                                     f"{np.dtype(dtype).name} x{spp} does "
                                     f"not decode to its source")
                log(f"tile input: {codec} {np.dtype(dtype).name} x{spp} "
                    f"{side}^2: C and plain decode byte-equal to the source "
                    f"({len(data)} bytes for {len(raw)})")
            if not (np.array_equal(td.undo_predictor(diff.copy(), spp), img)
                    and np.array_equal(td.undo_predictor_plain(diff.copy(),
                                                               spp), img)):
                raise SystemExit(f"tile input: the predictor of "
                                 f"{np.dtype(dtype).name} x{spp} differs")
    log("tile input: predictor undone byte-equal (C, plain) for u8/u16 "
        "x 1/3 samples")
    for bpp in (1, 2, 3, 4, 6, 8):
        rows = textures(rng, TILE, 1, np.uint8)
        rows = np.tile(rows, (1, bpp))
        data = tf.png_filter(rows, bpp, [r % 5 for r in range(TILE)])
        if not np.array_equal(td.png_unfilter(data, TILE, TILE * bpp, bpp),
                              rows):
            raise SystemExit(f"tile input: PNG unfilter at {bpp} bytes a "
                             f"pixel differs from the source")
        head = data[:16 * (TILE * bpp + 1)]
        if not np.array_equal(td.png_unfilter_plain(head, 16, TILE * bpp,
                                                    bpp), rows[:16]):
            raise SystemExit(f"tile input: plain PNG unfilter at {bpp} "
                             f"bytes a pixel differs")
    log(f"tile input: PNG unfilter, filters 0-4 cycling, 1/2/3/4/6/8 bytes "
        f"a pixel: C byte-equal to the source at {TILE}^2, plain equal on "
        f"16 rows")
    for width in (TILE - 1, TILE):
        idx = textures(rng, TILE, 1, np.uint8)[:, :width]
        color = rng.integers(0, 256, (256, 3), dtype=np.uint8)
        rgb = textures(rng, TILE, 3, np.uint8)[:, :width]
        rgba = np.concatenate([rgb, idx[..., None]], axis=2)
        for name, data, want in (
                ('8-bit gray', tf.bmp_bytes(idx, 8, GRAY_PALETTE), idx),
                ('8-bit gray top-down', tf.bmp_bytes(idx, 8, GRAY_PALETTE,
                                                     top_down=True), idx),
                ('8-bit colour', tf.bmp_bytes(idx, 8, color), color[idx]),
                ('24-bit', tf.bmp_bytes(rgb, 24), rgb),
                ('32-bit bitfields', tf.bmp_bytes(rgba, 32, compression=3,
                                                  header=124), rgb)):
            if not np.array_equal(decode_bmp(data), want):
                raise SystemExit(f"tile input: BMP {name} {width} wide "
                                 f"differs from its source")
    log(f"tile input: BMP rows (8-bit gray/colour palettes, bottom-up and "
        f"top-down, 24- and 32-bit, {TILE - 1} and {TILE} wide) equal "
        f"their sources")
    img = textures(rng, TILE, 1)
    if not np.array_equal(decode_tiff(tf.tiff_bytes(img, 8, 2,
                                                    rows_per_strip=2)), img):
        raise SystemExit("tile input: the deflate TIFF differs")
    if not np.array_equal(decode_png(tf.png_bytes(
            img, 0, 16, filters=range(5), level=1)), img):
        raise SystemExit("tile input: the 16-bit PNG differs")
    log(f"tile input: {TILE}^2 u16 deflate + predictor TIFF (2-row strips) "
        f"and 16-bit PNG (filters cycling) decode equal to their sources; "
        f"9a in {time.perf_counter() - t0:.1f}s")


def decoder_rates(rng, card: str) -> dict:
    """MB/s of output of each C routine, and of whole-tile decodes, on
    2048^2 u16 tiles: one thread, then the 8-thread reader pool (16
    tiles). LZW and PackBits tiles are 4 strips of 512 rows, each the
    same encoded strip (the Python encoders are slow)."""
    from image_stitcher_tpu_torch.io import tile_decode as td
    from image_stitcher_tpu_torch.io.png import decode_png
    from image_stitcher_tpu_torch.io.tiff import decode_tiff
    tf = tile_files()
    img = textures(rng, TILE, 1)
    diff = tf.apply_predictor(img, 1)
    strip = diff[:TILE // 4].tobytes()
    lzw, pb = tf.lzw_encode(strip), tf.packbits_encode(strip)
    rows = img.astype('>u2').view(np.uint8).reshape(TILE, 2 * TILE)
    filtered = tf.png_filter(rows, 2, [r % 5 for r in range(TILE)])
    png = tf.png_bytes(img, 0, 16, filters=range(5), level=1)
    tiff = tf.tiff_bytes(img, 8, 2, rows_per_strip=2)
    work = {
        'LZW (C)': lambda _: [td.lzw_decode(lzw, len(strip))
                              for _ in range(4)],
        'PackBits (C)': lambda _: [td.packbits_decode(pb, len(strip))
                                   for _ in range(4)],
        'predictor (C)': lambda buf: td.undo_predictor(buf, 1),
        'PNG unfilter (C)': lambda _: td.png_unfilter(filtered, TILE,
                                                      2 * TILE, 2),
        'PNG tile (zlib + C)': lambda _: decode_png(png),
        'deflate TIFF tile (zlib + C)': lambda _: decode_tiff(tiff),
    }
    n = 2 * READERS
    out_mb = n * img.nbytes / 1e6
    rates = {}
    for name, fn in work.items():
        bufs = [diff.copy() for _ in range(n)]
        fn(bufs[0])                                        # warm
        row = []
        for threads in (1, READERS):
            with ThreadPoolExecutor(threads) as pool:
                t0 = time.perf_counter()
                list(pool.map(fn, bufs))
                row.append(out_mb / (time.perf_counter() - t0))
        rates[name] = row
        log(f"tile input MB/s on {card}: {name} on {TILE}^2 u16 tiles: "
            f"{row[0]:.0f} on one thread, {row[1]:.0f} on {READERS} "
            f"({n} tiles, {out_mb:.0f} MB out)")
    log(f"tile input: sizes {len(png)} B (PNG), {len(tiff)} B (deflate "
        f"TIFF), {len(lzw) * 4} B (LZW) for {img.nbytes} B of pixels")
    return rates


class DecodeCounter:
    """Wraps the readers' whole-file decode (``io/acquisition.py::
    _decode``): decodes per file and seconds summed over threads."""

    def __init__(self):
        from image_stitcher_tpu_torch.io import acquisition
        self.module = acquisition
        self.inner = acquisition._decode
        self.lock = threading.Lock()
        self.calls = collections.Counter()
        self.seconds = 0.0

    def __call__(self, data, filepath):
        t0 = time.perf_counter()
        try:
            return self.inner(data, filepath)
        finally:
            dt = time.perf_counter() - t0
            with self.lock:
                self.calls[filepath] += 1
                self.seconds += dt

    def __enter__(self):
        self.module._decode = self
        return self

    def __exit__(self, *exc):
        self.module._decode = self.inner


def stitch_input(acq: str, out: str, dev, card: str, label: str,
                 use_registration: bool = True, apply_flatfield: bool = True,
                 **options) -> dict:
    """The main path's stitch of ``acq`` (phase 5's options, and
    ``options``), its kernel launches checked against the plan, its stage
    and decode seconds."""
    from image_stitcher_tpu_torch import stitch
    from image_stitcher_tpu_torch.models.streaming import (
        band_rows_for, partition_jobs_by_band)
    from image_stitcher_tpu_torch.ops import cuda_fuse
    cuda_fuse.fuse_overwrite.launches = 0
    with DecodeCounter() as counter:
        t0 = time.perf_counter()
        pipe = stitch(acq, use_registration=use_registration,
                      apply_flatfield=apply_flatfield, device=dev,
                      options=smoke_options(out, **options))
        e2e = time.perf_counter() - t0
    launches = cuda_fuse.fuse_overwrite.launches
    width, height = pipe._region_dimensions(0, 'A1')
    opts = pipe.options
    jobs = pipe._build_jobs(0, 'A1')
    tile = pipe.acq.input_height
    streamed = pipe._should_stream(0, 'A1')
    if streamed:
        band = band_rows_for(opts.write_band_rows()
                             * opts.device_band_multiple,
                             pipe.num_pyramid_levels)
        tasks, _ = partition_jobs_by_band(jobs, tile, height, band)
        batches = sum(-(-len(v) // opts.fusion_batch)
                      for v in tasks.values())
        touches = collections.Counter(j.filepath for v in tasks.values()
                                      for j, _ in v)
    else:
        batches = pipe.fuse_stats['A1_t0']['batches']
        touches = collections.Counter(j.filepath for j in jobs)
    if dev.type == 'cuda' and (launches != batches or not launches):
        raise SystemExit(f"tile input ({label}): {launches} kernel "
                         f"launches for {batches} batches")
    n_tiles = len(pipe.acq.tiles)
    decodes = sum(counter.calls.values())
    t = pipe.timers.as_dict()
    stats = pipe.fuse_stats['A1_t0']
    per_file = collections.Counter(counter.calls.values())
    planned = collections.Counter(touches.values())
    log(f"tile input ({label}) on {card}: e2e {e2e:.3f}s = "
        f"{n_tiles / e2e:.2f} tiles/s ({n_tiles} tiles, "
        f"{'bands' if streamed else 'in RAM'}); fit="
        f"{t.get('flatfield_fit', 0):.3f}s registration="
        f"{t.get('registration', 0):.3f}s "
        + (f"fuse+write={t.get('stream_fuse_save', 0):.3f}s; loader (main "
           f"thread: loads, uploads, launches)={stats.get('fuse', 0):.3f}s "
           f"writer={stats.get('write', 0) + stats.get('close', 0):.3f}s"
           if streamed else f"fuse={t.get('fuse', 0):.3f}s "
           f"save={t.get('save', 0):.3f}s")
        + f"; {decodes} whole-file decodes, "
        f"{counter.seconds:.3f}s summed over threads = "
        f"{counter.seconds / max(decodes, 1) * 1e3:.1f} ms a decode; "
        f"decodes a file {dict(sorted(per_file.items()))} (scan, fit and "
        f"registration reads included); fusion reads a file "
        f"{dict(sorted(planned.items()))}; launches {launches}")
    return {'e2e_s': e2e, 'tiles_per_s': n_tiles / e2e, 'launches': launches,
            'decodes': decodes, 'decode_s': counter.seconds,
            'streamed': streamed, 'pipe': pipe}


def phase_tile_input(work: str, card: str, grid: int = 10,
                     tile: int = TILE, device: str = 'cuda') -> dict:
    """9: tile input without OpenCV. 9a the C decoders; 9b the main path's
    grid stored as uncompressed TIFF, 4x4 grids as 16-bit PNG (filters
    cycling) and as deflate + predictor TIFF in 2-row strips,
    each stitched on the card, the PNG and deflate trees to the tree of
    an uncompressed-TIFF twin of their grid; 9c 3x3 grids: u8 mono
    BMP against its
    uncompressed-TIFF twin, u8 RGB PNG on the card against the CPU."""
    dev = torch.device(device)
    rng = np.random.default_rng(12)
    decoder_check(rng)
    rates = decoder_rates(rng, card)
    tf = tile_files()

    # 9b: the main path's grid and options, three encodings of one texture
    overlap = 205 * tile // TILE
    cache = {}

    def texture(r, side):
        if side not in cache:
            cache[side] = compressible(r, side)
        return cache[side]

    # the PNG and deflate runs are cut to a 4x4 grid (the smallest that
    # streams in bands; PNG tiles take 0.36 s each to write in Python),
    # both held to one uncompressed twin: their cost is the decodes,
    # which a cut grid still measures per tile; cut for the script's time
    small = 4
    formats = (
        ('tiff', None, 'tiff', grid),
        (f'tiff-{small}x{small}', None, 'tiff', small),
        ('png', lambda b: tf.png_bytes(b, 0, 16, filters=range(5), level=1),
         'png', small),
        ('deflate', lambda b: tf.tiff_bytes(b, 8, 2, rows_per_strip=2),
         'tiff', small))
    runs, twins = {}, {}
    for name, encode, suffix, g in formats:
        acq = os.path.join(work, f'input_{name}')
        t0 = time.perf_counter()
        write_acquisition(acq, g, tile, overlap, seed=13, texture=texture,
                          encode=encode, suffix=suffix)
        nbytes = tree_bytes(acq)
        log(f"tile input ({name}): wrote {g}x{g}x{len(CHANNELS)} "
            f"{tile}^2 u16 tiles, {nbytes} bytes, in "
            f"{time.perf_counter() - t0:.1f}s")
        out = os.path.join(work, f'input_out_{name}')
        run = stitch_input(acq, out, dev, card, name)
        if not run.pop('streamed'):
            raise SystemExit(f"tile input ({name}): the canvas did not "
                             f"stream in bands")
        run.pop('pipe')
        run['file_bytes'] = nbytes
        runs[name] = run
        tree = read_tree(out)
        shutil.rmtree(out)
        shutil.rmtree(acq)
        if g not in twins:
            twins[g] = tree
            continue
        arrays = compare_trees(twins[g], tree, f'tile input ({name} vs tiff)')
        log(f"tile input ({name}): tree decodes equal to the uncompressed-"
            f"TIFF twin's ({g}x{g}; {arrays} level arrays, JSON equal)")
        del tree
    del twins, cache

    # 9c: 3x3 grids, u8 mono BMP against its uncompressed-TIFF twin; u8
    # RGB PNG on the card against the CPU
    trees = {}
    for name, encode, suffix in (
            ('tiff-u8', lambda b: tf.tiff_bytes(b), 'tiff'),
            ('bmp-u8', lambda b: tf.bmp_bytes(b, 8, GRAY_PALETTE), 'bmp')):
        acq = os.path.join(work, f'input_{name}')
        write_acquisition(acq, 3, tile, overlap, seed=14,
                          texture=lambda r, side: textures(r, side, 1,
                                                           np.uint8),
                          encode=encode, suffix=suffix)
        out = os.path.join(work, f'input_out_{name}')
        stitch_input(acq, out, dev, card, name)
        trees[name] = read_tree(out)
        shutil.rmtree(out)
        shutil.rmtree(acq)
    arrays = compare_trees(trees['tiff-u8'], trees['bmp-u8'],
                           'tile input (bmp vs tiff, u8)')
    log(f"tile input (bmp-u8): 3x3 tree decodes equal to the uncompressed-"
        f"TIFF twin's ({arrays} level arrays)")
    trees = {}
    acq = os.path.join(work, 'input_rgb_png')
    write_acquisition(acq, 3, tile, overlap, seed=15,
                      texture=lambda r, side: textures(r, side, 3, np.uint8),
                      encode=lambda b: tf.png_bytes(b, 2, 8,
                                                    filters=range(5),
                                                    level=1),
                      suffix='png', channels=["BF LED matrix full"])
    for run_dev in (dev, torch.device('cpu')):
        out = os.path.join(work, f'input_out_rgb_{run_dev.type}')
        run = stitch_input(acq, out, run_dev, card, f'rgb-png-u8 on '
                           f'{run_dev.type}')
        planes = run['pipe'].acq.monochrome_channels
        if run['streamed'] or planes != [f"BF LED matrix full_{c}"
                                         for c in 'RGB']:
            raise SystemExit(f"tile input (rgb-png-u8): streamed "
                             f"{run['streamed']}, planes {planes}")
        trees[run_dev.type] = read_tree(out)
        shutil.rmtree(out)
    shutil.rmtree(acq)
    arrays = compare_trees(trees[dev.type], trees['cpu'],
                           'tile input (rgb png, card vs cpu)')
    log(f"tile input (rgb-png-u8): 3x3 in-RAM card tree equals the CPU "
        f"run's ({arrays} level arrays)")
    banned = [m for m in BANNED if m in sys.modules]
    if banned:
        raise SystemExit(f"tile input: loaded {banned}")
    return {'rates': rates, 'runs': runs}


# -------------------------------------------------------------------- 10

def files_equal(a_root: str, b_root: str, what: str, skip=()) -> int:
    """The same files under two roots, byte for byte (names in ``skip``
    aside); returns the bytes compared."""
    def listing(root):
        return sorted(os.path.relpath(os.path.join(d, n), root)
                      for d, _, names in os.walk(root) for n in names
                      if n not in skip)
    names = listing(a_root)
    if not names or names != listing(b_root):
        raise SystemExit(f"{what}: the trees hold different files: "
                         f"{sorted(set(names) ^ set(listing(b_root)))[:8]}")
    total = 0
    for rel in names:
        with open(os.path.join(a_root, rel), 'rb') as fa, \
                open(os.path.join(b_root, rel), 'rb') as fb:
            while True:
                x, y = fa.read(1 << 24), fb.read(1 << 24)
                if x != y:
                    raise SystemExit(f"{what}: {rel} differs")
                if not x:
                    break
                total += len(x)
    return total


def merge_split(stats: dict) -> str:
    return (f"band reads {stats['read_s']:.3f}s, card upload "
            f"{stats['h2d_ms']:.1f} ms + fold {stats['fold_ms']:.1f} ms + "
            f"copies back {stats['d2h_ms']:.1f} ms (CUDA events), chunk "
            f"writes {stats['write_s']:.3f}s + final drain "
            f"{stats['close_s']:.3f}s ({stats['units']} units, "
            f"{stats['bands']} bands; summed over the workers)")


def phase_merges(work: str, card: str, grid: int = 3,
                 tile: int = TILE) -> dict:
    """Merges and resume on the card: phase 7's plate at two timepoints
    (each its own seed), cut from the 96-well plate of the JAX package's
    BASELINE.md to 4 wells (``MERGE_WELLS``) for the script's time
    limit. (a) A run with both merges stopped after its 5th unit and
    resumed: the resumed run skips the 5 units, loads the fields from the
    sidecar (no fit), fuses the rest and writes the complete plate; its
    tree is byte-equal to an uninterrupted run's. (b) Each merge pass
    timed on the finished stores, with its bytes and the read / fold /
    write split. (c) Merged
    level 0 at [t] is region t's level 0 zero-padded, each merged level
    the 2x2 mean (sum >> 2) of the one above (channel 0, two wells), the
    plate and well metadata as plate_attrs/well_attrs give them, and a
    3x3 two-well card merge equal to the CPU pipeline's."""
    from image_stitcher_tpu_torch import (CarriedState, ProgressReporter,
                                          StitchCancelled, list_outputs,
                                          open_stitched, stitch)
    from image_stitcher_tpu_torch.io.omezarr import plate_attrs, well_attrs
    from image_stitcher_tpu_torch.io.zarr_store import open_array, read_attrs
    from image_stitcher_tpu_torch.models import merge
    from image_stitcher_tpu_torch.ops import cuda_fuse
    from image_stitcher_tpu_torch.utils.manifest import RunManifest
    acq = os.path.join(work, 'timelapse')
    t0 = time.perf_counter()
    write_acquisition(acq, grid, tile, overlap=205 * tile // TILE, seed=21,
                      regions=MERGE_WELLS, timepoints=2)
    n_tiles = 2 * len(MERGE_WELLS) * grid * grid * len(CHANNELS)
    log(f"merges: wrote 2 timepoints x {len(MERGE_WELLS)} wells x "
        f"{grid}x{grid} x {len(CHANNELS)}ch {tile}^2 uint16 tiles "
        f"({n_tiles}) in {time.perf_counter() - t0:.1f}s; disk free "
        f"{shutil.disk_usage(work).free / 2 ** 30:.0f} GiB")
    cuda = torch.device('cuda')
    kw = dict(use_registration=True, apply_flatfield=True,
              merge_timepoints=True, merge_hcs_regions=True)
    extra = dict(flatfield_device='device')

    # 10a: stopped after the 5th completed unit, then resumed
    out = os.path.join(work, 'merge_resumed')
    stop = threading.Event()
    done = []

    def on_status(msg, is_saving=False):
        if msg.startswith('Completed region'):
            done.append(msg)
            if len(done) == 5:
                stop.set()

    cuda_fuse.fuse_overwrite.launches = 0
    t0 = time.perf_counter()
    try:
        stitch(acq, device=cuda, reporter=ProgressReporter(status=on_status),
               stop_event=stop, options=smoke_options(out, **extra), **kw)
        raise SystemExit("merges: the run was not stopped")
    except StitchCancelled:
        pass
    t_stopped = time.perf_counter() - t0
    launches_stopped = cuda_fuse.fuse_overwrite.launches
    completed = RunManifest.load(out).data['completed']
    if len(completed) != 5 or os.path.exists(os.path.join(out,
                                                          'hcs_timepoints')):
        raise SystemExit(f"merges: the stopped run completed {completed}")
    msgs = []
    cuda_fuse.fuse_overwrite.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = stitch(acq, device=cuda, resume=True,
                  reporter=ProgressReporter(
                      status=lambda m, s=False: msgs.append(m)),
                  options=smoke_options(out, **extra), **kw)
    e2e = time.perf_counter() - t0
    launches = cuda_fuse.fuse_overwrite.launches
    timers = pipe.timers.as_dict()
    skipped = [m for m in msgs if m.startswith('Skipping completed')]
    log(f"merges (10a) on {card}: stopped after {len(completed)} units in "
        f"{t_stopped:.3f}s ({launches_stopped} fuse_overwrite launches); "
        f"resumed in {e2e:.3f}s: skipped {len(skipped)}, fused "
        f"{2 * len(MERGE_WELLS) - len(skipped)} ({launches} launches), stages "
        + " ".join(f"{k}={v:.3f}s" for k, v in sorted(timers.items())))
    if (not pipe.resumed or len(skipped) != 5 or 'flatfield_fit' in timers
            or 'registration' in timers or 'merge' not in timers
            or not launches_stopped or not launches):
        raise SystemExit(f"merges: the resumed run refitted, re-measured or "
                         f"re-fused: {skipped}, {sorted(timers)}, launches "
                         f"{launches_stopped}/{launches}")
    complete = (timers['merge'], pipe.merge_stats.as_dict())
    if complete[1]['h2d_ms'] <= 0 or complete[1]['fold_ms'] <= 0:
        raise SystemExit(f"merges: the fold did not run on the card: "
                         f"{complete[1]}")
    whole_out = os.path.join(work, 'merge_whole')
    t0 = time.perf_counter()
    stitch(acq, device=cuda, options=smoke_options(whole_out, **extra),
           state=CarriedState(flatfields=pipe.flatfields, shifts=pipe.shifts),
           **kw)
    t_whole = time.perf_counter() - t0
    t0 = time.perf_counter()
    nbytes = files_equal(out, whole_out, "merges (10a)",
                         skip=('.stitch_manifest.json', 'flatfields.npz'))
    # phase 15c holds the work-sharded plate to this tree
    result = {'acq': acq, 'digest': tree_digest(whole_out),
              'e2e_whole_s': t_whole, 'flatfields': pipe.flatfields,
              'shifts': pipe.shifts, 'kw': kw, 'extra': extra}
    log(f"merges (10a): the resumed tree ({2 * len(MERGE_WELLS)} region "
        f"stores + the complete plate) is byte-equal to an uninterrupted "
        f"run's ({t_whole:.3f}s, the resumed run's fields and shifts "
        f"carried): {nbytes} bytes compared in "
        f"{time.perf_counter() - t0:.1f}s")
    shutil.rmtree(whole_out)

    # 10b: each merge pass on the finished stores
    rel = os.path.join('hcs_timepoints', 'complete_hcs.ome.zarr')
    passes = [('complete plate', complete[0], complete[1],
               tree_bytes(os.path.join(out, rel)))]
    for name, fn, rels in (
            ('per-timepoint plates', merge.create_hcs_ome_zarr_per_timepoint,
             [os.path.join('hcs_timepoints', f'{t}_hcs.ome.zarr')
              for t in (0, 1)]),
            ('time series', merge.merge_timepoints_per_region,
             ['region_time_series'])):
        pipe.merge_stats = merge.MergeStats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(pipe)
        passes.append((name, time.perf_counter() - t0,
                       pipe.merge_stats.as_dict(),
                       sum(tree_bytes(os.path.join(out, r)) for r in rels)))
    workers = merge._merge_worker_count(len(MERGE_WELLS))
    for name, secs, stats, written in passes:
        log(f"merges (10b, {name}) on {card}: {secs:.3f}s, {workers} "
            f"workers; read {stats['bytes_read']} B = "
            f"{stats['bytes_read'] / secs / 1e6:.0f} MB/s, wrote {written} B "
            f"= {written / secs / 1e6:.0f} MB/s; {merge_split(stats)}")

    # 10c: merged level 0 is the regions' level 0, zero-padded; deeper
    # levels the 2x2 mean of the level above; the plate metadata
    t0 = time.perf_counter()
    plate = os.path.join(out, rel)
    levels = open_stitched(os.path.join(plate, 'A', '1', '0')).num_levels
    for well in MERGE_WELLS:
        m0 = open_array(os.path.join(plate, well[0], well[1:], '0', '0'))
        for t in (0, 1):
            src = open_array(os.path.join(out, f'{t}_stitched',
                                          f'{well}_stitched.ome.zarr', '0'))
            h, w = src.shape[-2:]
            got = m0[t]
            if (not np.array_equal(got[..., :h, :w], src[0])
                    or got[..., h:, :].any() or got[..., :, w:].any()):
                raise SystemExit(f"merges: {well} t={t} level 0 is not the "
                                 f"region's, zero-padded")
    for well in WELLS[:2]:
        image = os.path.join(plate, well[0], well[1:], '0')
        prev = open_array(os.path.join(image, '0'))[:, 0]
        for k in range(1, levels):
            cur = open_array(os.path.join(image, str(k)))[:, 0]
            a = prev.astype(np.uint32)
            h2, w2 = cur.shape[-2] * 2, cur.shape[-1] * 2
            want = ((a[..., 0:h2:2, 0:w2:2] + a[..., 0:h2:2, 1:w2:2]
                     + a[..., 1:h2:2, 0:w2:2] + a[..., 1:h2:2, 1:w2:2])
                    >> 2).astype(cur.dtype)
            if not np.array_equal(cur, want):
                raise SystemExit(f"merges: {well} level {k} channel 0 is not "
                                 f"the 2x2 mean of level {k - 1}")
            prev = cur
    del prev, cur, a, want
    want_attrs = {rel: plate_attrs(MERGE_WELLS, "Complete HCS Dataset",
                                   "Stitched Acquisition")}
    for t in (0, 1):
        want_attrs[os.path.join('hcs_timepoints', f'{t}_hcs.ome.zarr')] = \
            plate_attrs(MERGE_WELLS, f"HCS Dataset - Timepoint {t}",
                        f"Timepoint {t} Acquisition")
    for root, attrs in want_attrs.items():
        if read_attrs(os.path.join(out, root)) != attrs:
            raise SystemExit(f"merges: {root} plate metadata")
        for well in MERGE_WELLS:
            if read_attrs(os.path.join(out, root, well[0],
                                       well[1:])) != well_attrs():
                raise SystemExit(f"merges: {root}/{well} well metadata")
    listing = list_outputs(out)
    if (len(listing['regions']) != 2 * len(MERGE_WELLS)
            or len(listing['time_series']) != len(MERGE_WELLS)
            or len(listing['hcs']) != 3):
        raise SystemExit(f"merges: list_outputs gives {listing}")
    log(f"merges (10c): merged level 0 of {len(MERGE_WELLS)} wells x 2 "
        f"timepoints equals the regions' zero-padded; levels "
        f"1-{levels - 1} of channel 0 (2 wells) equal the 2x2 mean (sum "
        f">> 2) of the level above; plate/well metadata and list_outputs "
        f"as expected ({time.perf_counter() - t0:.1f}s)")
    shutil.rmtree(out)

    # 10c: a 3x3, two-well, two-timepoint card merge against the CPU
    # pipeline's merge of the same region stores
    small = os.path.join(work, 'timelapse_small')
    write_acquisition(small, grid, tile, overlap=205 * tile // TILE, seed=22,
                      regions=WELLS[:2], timepoints=2)
    card_out = os.path.join(work, 'small_card')
    stitch(small, device=cuda, options=smoke_options(card_out, **extra), **kw)
    cpu_out = os.path.join(work, 'small_cpu')
    shutil.copytree(card_out, cpu_out,
                    ignore=shutil.ignore_patterns('hcs_timepoints'))
    m = RunManifest.load(cpu_out)
    m.data.update(merges_done=False, finished=False)
    m.save()
    t0 = time.perf_counter()
    cpu_pipe = stitch(small, device=torch.device('cpu'), resume=True,
                      options=smoke_options(cpu_out, **extra), **kw)
    t_cpu = time.perf_counter() - t0
    if cpu_pipe.saved_paths or not cpu_pipe.resumed:
        raise SystemExit("merges: the CPU run fused again")
    nbytes = files_equal(os.path.join(card_out, 'hcs_timepoints'),
                         os.path.join(cpu_out, 'hcs_timepoints'),
                         "merges (card vs CPU)")
    log(f"merges (10c): the card's complete plate of {grid}x{grid} x 2 wells "
        f"x 2 timepoints is byte-equal to the CPU pipeline's merge of the "
        f"same stores ({nbytes} bytes; the CPU merge took {t_cpu:.3f}s: "
        f"{merge_split(cpu_pipe.merge_stats.as_dict())})")
    banned = [m for m in BANNED if m in sys.modules]
    if banned:
        raise SystemExit(f"merges: loaded {banned}")
    return result


# -------------------------------------------------------------------- 11

#: 11a: (label, RGB u8 or mono u16, streaming, tiff_compression, blend);
#: every value of each axis twice, every dtype with both modes
TIFF_CASES = (
    ('u16 mono, in RAM, deflate, overwrite', False, 'off', 'deflate',
     'overwrite'),
    ('u16 mono, bands, raw, feather', False, 'on', 'raw', 'feather'),
    ('u8 RGB, in RAM, raw, feather', True, 'off', 'raw', 'feather'),
    ('u8 RGB, bands, deflate, overwrite', True, 'on', 'deflate',
     'overwrite'))


def tiff_file(out: str, region: str = 'A1') -> str:
    return os.path.join(out, '0_stitched', f'{region}_stitched.ome.tiff')


class TiffWriterSplit:
    """Wall seconds of the band writer thread's pieces on an OME-TIFF run:
    the tile encode (``BigTiffWriter.encode_strip``: zlib on the encode
    pool), the file appends (``append_tile_data``) and the pyramid fold
    (``models/streaming.py::host_downsample``), each wrapped while the
    context is open; the writer's seconds less these is the row parking,
    the tile blocks' assembly and the lock."""

    def __init__(self):
        from image_stitcher_tpu_torch.io import tiffwriter
        from image_stitcher_tpu_torch.models import streaming
        self.targets = [(tiffwriter.BigTiffWriter, 'encode_strip'),
                        (tiffwriter.BigTiffWriter, 'append_tile_data'),
                        (streaming, 'host_downsample')]
        self.seconds = collections.Counter()
        self.saved = []

    def _timed(self, name, inner):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                self.seconds[name] += time.perf_counter() - t0
        return timed

    def __enter__(self):
        for owner, name in self.targets:
            inner = getattr(owner, name)
            self.saved.append((owner, name, inner))
            setattr(owner, name, self._timed(name, inner))
        return self

    def __exit__(self, *exc):
        for owner, name, inner in self.saved:
            setattr(owner, name, inner)


def _pool_width() -> int:
    from image_stitcher_tpu_torch.io.tiffwriter import _encode_pool_size
    return _encode_pool_size()


def deflate_rates(tile_path: str) -> list:
    """zlib level 1 MB/s (of input) on the 256^2 blocks of one u16 tile,
    as the TIFF writer encodes them: one thread, then its encode pool's
    width (``min(CPUs, 8)`` threads), 4 passes each."""
    import zlib
    from image_stitcher_tpu_torch.io.acquisition import read_image
    img = np.ascontiguousarray(read_image(tile_path))
    blocks = [np.ascontiguousarray(img[y:y + 256, x:x + 256]).tobytes()
              for y in range(0, img.shape[0], 256)
              for x in range(0, img.shape[1], 256)] * 4
    rates = []
    for threads in (1, _pool_width()):
        with ThreadPoolExecutor(threads) as pool:
            t0 = time.perf_counter()
            list(pool.map(lambda b: zlib.compress(b, 1), blocks))
            rates.append(len(blocks) * len(blocks[0]) / 1e6
                         / (time.perf_counter() - t0))
    return rates


def files_equal_but_zero_chunks(a_root: str, b_root: str, what: str,
                                skip=()):
    """:func:`files_equal` for two raw zarr trees of which one may lack
    chunk files the other holds as all zeros (the fill value: a band
    fuser writes no chunk for a band no tile touches, and the device
    fuser's taller bands cover rows the host fuser's do not). Returns
    (bytes compared, zero chunks held by one tree only)."""
    def listing(root):
        return {os.path.relpath(os.path.join(d, n), root)
                for d, _, names in os.walk(root) for n in names
                if n not in skip}
    names_a, names_b = listing(a_root), listing(b_root)
    only = sorted(names_a ^ names_b)
    for rel in only:
        root = a_root if rel in names_a else b_root
        if rel.endswith(('.zarray', '.zattrs', '.zgroup', 'zarr.json')):
            raise SystemExit(f"{what}: {rel} is in one tree only")
        with open(os.path.join(root, rel), 'rb') as f:
            if np.frombuffer(f.read(), np.uint8).any():
                raise SystemExit(f"{what}: {rel} (in one tree only) is not "
                                 f"an all-zero chunk")
    total = 0
    for rel in sorted(names_a & names_b):
        with open(os.path.join(a_root, rel), 'rb') as fa, \
                open(os.path.join(b_root, rel), 'rb') as fb:
            x, y = fa.read(), fb.read()
        if x != y:
            raise SystemExit(f"{what}: {rel} differs")
        total += len(x)
    return total, len(only)


HOST_STAGES = ('gate', 'fill', 'decode', 'place', 'finalize', 'pyramid',
               'write', 'close')


def host_stage_sums(stats: dict) -> str:
    """The host fuser's stage sums over its threads: wall seconds, then
    on-core seconds (``time.thread_time``)."""
    return ("summed wall: " + " ".join(f"{k}={stats[k]:.3f}s"
                                       for k in HOST_STAGES)
            + "; summed on-core: " + " ".join(
                f"{k}={stats['cpu'].get(k, 0.0):.3f}s" for k in HOST_STAGES))


def phase_ome_tiff(work: str, card: str, grid: int = 10,
                   tile: int = TILE, device: str = 'cuda') -> dict:
    """11: OME-TIFF output and the host fuser. (a) 3x3 grids stitched to
    ``.ome.tiff`` on the card and on the CPU (the card run's fields and
    shifts carried) write byte-equal files. (b) Phase 5's grid and options
    written as deflate OME-TIFF: every page's level 0 and SubIFD levels
    decode (``io/tiff.py::read_pages``) equal to a zarr tree of the same
    acquisition; e2e, the writer's seconds, the file's bytes and
    ``peak_buffer_bytes``. (c) The same grid through
    ``fusion_device='host'`` (the host band fuser, ``csrc/hostops.c``,
    the gated fit; raw chunks as chunk-column blocks written from the
    band threads, covered bands unfilled): its raw tree byte-equal to the
    device path's, and its lz4 tree decoded equal to it; the blocks
    written, the fills skipped and the stage sums, wall and on-core.
    Returns (b)'s numbers and (a)'s mono 3x3 acquisition, kept for phase
    14."""
    from image_stitcher_tpu_torch import CarriedState, stitch
    from image_stitcher_tpu_torch.io.tiff import read_pages
    from image_stitcher_tpu_torch.io.zarr_store import read_array
    from image_stitcher_tpu_torch.models.streaming import (
        band_rows_for, partition_jobs_by_band)
    from image_stitcher_tpu_torch.ops import cuda_fuse
    dev, cpu = torch.device(device), torch.device('cpu')
    overlap = 205 * tile // TILE
    kernels = (cuda_fuse.fuse_overwrite, cuda_fuse.fuse_feather,
               cuda_fuse.finalize_feather)
    tf = tile_files()
    skip = ('.stitch_manifest.json', 'flatfields.npz')

    # 11a: 3x3 grids, card against CPU
    acqs = {}
    for rgb in (False, True):
        acq = acqs[rgb] = os.path.join(work, 'tiff_3x3_rgb' if rgb
                                       else 'tiff_3x3_mono')
        if rgb:
            write_acquisition(
                acq, 3, tile, overlap, seed=31,
                texture=lambda r, side: textures(r, side, 3, np.uint8),
                encode=lambda b: tf.png_bytes(b, 2, 8, filters=range(5),
                                              level=1),
                suffix='png', channels=["BF LED matrix full"])
        else:
            write_acquisition(acq, 3, tile, overlap, seed=32)
    for label, rgb, streaming, compression, blend in TIFF_CASES:
        extra = dict(streaming=streaming, tiff_compression=compression,
                     blend_method=blend)
        outs, state, secs = {}, None, {}
        for run, run_dev in (('card', dev), ('cpu', cpu)):
            for fn in kernels:
                fn.launches = 0
            out = outs[run] = os.path.join(work, f'tiff_3x3_{run}')
            t0 = time.perf_counter()
            pipe = stitch(acqs[rgb], output_format='.ome.tiff',
                          use_registration=True, apply_flatfield=True,
                          device=run_dev, state=state,
                          options=smoke_options(out, **extra))
            secs[run] = time.perf_counter() - t0
            launches = [fn.launches for fn in kernels]
            if run == 'card':
                card_launches = launches
                peak = pipe.fuse_stats['A1_t0'].get('peak_buffer_bytes')
                state = CarriedState(flatfields=pipe.flatfields,
                                     shifts=pipe.shifts)
                used = launches[1:] if blend == 'feather' else launches[:1]
                if run_dev.type == 'cuda' and min(used) == 0:
                    raise SystemExit(f"ome-tiff (11a, {label}): the card run "
                                     f"launched {launches}")
            if (pipe._should_stream(0, 'A1') != (streaming == 'on')
                    or ('stream_fuse_save' in pipe.timers.as_dict())
                    != (streaming == 'on')):
                raise SystemExit(f"ome-tiff (11a, {label}): took the wrong "
                                 f"path")
        nbytes = files_equal(outs['card'], outs['cpu'],
                             f"ome-tiff (11a, {label})", skip=skip)
        with open(tiff_file(outs['card']), 'rb') as f:
            pages = read_pages(f.read())
        first = pages[0][1][0]
        if first.ndim != (3 if rgb else 2) or not first.any():
            raise SystemExit(f"ome-tiff (11a, {label}): page 0 is "
                             f"{first.shape}")
        log(f"ome-tiff (11a, {label}): 3x3 card file byte-equal to the CPU "
            f"run's ({nbytes} bytes, {len(pages)} pages, level 0 "
            f"{first.shape}); card {secs['card']:.3f}s (launches "
            f"{card_launches}), CPU {secs['cpu']:.3f}s"
            + (f"; peak_buffer_bytes {peak}" if peak is not None else ""))
        for out in outs.values():
            shutil.rmtree(out)
    # phase 14 drives the editions and front ends on the mono grid
    shutil.rmtree(acqs[True])

    # 11b: the main path as deflate OME-TIFF, against its zarr twin
    acq = os.path.join(work, 'tiff_main')
    t0 = time.perf_counter()
    write_acquisition(acq, grid, tile, overlap, seed=5)
    log(f"ome-tiff: wrote phase 5's {grid}x{grid}x{len(CHANNELS)} {tile}^2 "
        f"uint16 tiles in {time.perf_counter() - t0:.1f}s")
    twin = os.path.join(work, 'tiff_zarr_twin')
    t0 = time.perf_counter()
    stitch(acq, use_registration=True, apply_flatfield=True, device=dev,
           options=smoke_options(twin))
    t_twin = time.perf_counter() - t0
    out = os.path.join(work, 'tiff_main_out')
    cuda_fuse.fuse_overwrite.launches = 0
    with TiffWriterSplit() as split:
        t0 = time.perf_counter()
        pipe = stitch(acq, output_format='.ome.tiff', use_registration=True,
                      apply_flatfield=True, device=dev,
                      options=smoke_options(out))
        e2e = time.perf_counter() - t0
    launches = cuda_fuse.fuse_overwrite.launches
    n_tiles = grid * grid * len(CHANNELS)
    width, height = pipe._region_dimensions(0, 'A1')
    opts = pipe.options
    band = band_rows_for(opts.write_band_rows() * opts.device_band_multiple,
                         pipe.num_pyramid_levels)
    tasks, _ = partition_jobs_by_band(pipe._build_jobs(0, 'A1'), tile,
                                      height, band)
    batches = sum(-(-len(v) // opts.fusion_batch) for v in tasks.values())
    stats = pipe.fuse_stats['A1_t0']
    if ('stream_fuse_save' not in pipe.timers.as_dict()
            or launches != (batches if dev.type == 'cuda' else 0)):
        raise SystemExit(f"ome-tiff (11b): streamed "
                         f"{'stream_fuse_save' in pipe.timers.as_dict()}, "
                         f"{launches} launches for {batches} batches")
    path = tiff_file(out)
    file_bytes = os.path.getsize(path)
    t0 = time.perf_counter()
    with open(path, 'rb') as f:
        pages = read_pages(f.read())
    t_read = time.perf_counter() - t0
    zarr = os.path.join(twin, '0_stitched', 'A1_stitched.ome.zarr')
    if len(pages) != len(CHANNELS) + 1:
        raise SystemExit(f"ome-tiff (11b): {len(pages)} pages")
    level_bytes = 0
    for lv in range(pipe.num_pyramid_levels):
        want = read_array(os.path.join(zarr, str(lv)))
        for c in range(len(CHANNELS)):
            got = pages[c][1][lv]
            if not np.array_equal(got, want[0, c, 0]):
                raise SystemExit(f"ome-tiff (11b): channel {c} level {lv} "
                                 f"differs from the zarr twin")
            level_bytes += got.nbytes
        del want
    thumb = pages[-1][1][0]
    del pages
    t = pipe.timers.as_dict()
    writer_s = stats['write'] + stats['close']
    parts = split.seconds
    rates = deflate_rates(pipe.acq.tiles[sorted(pipe.acq.tiles)[0]].filepath)
    log(f"ome-tiff (11b) on {card}: the writer thread's {writer_s:.3f}s: "
        f"tile encode (zlib-1 on the pool) {parts['encode_strip']:.3f}s, "
        f"file appends {parts['append_tile_data']:.3f}s, pyramid fold (C) "
        f"{parts['host_downsample']:.3f}s, the rest (row parking, tile "
        f"blocks, lock) {writer_s - sum(parts.values()):.3f}s; zlib-1 on "
        f"256^2 u16 blocks of a tile: {rates[0]:.0f} MB/s on one thread, "
        f"{rates[1]:.0f} on the encode pool's {_pool_width()} threads")
    log(f"ome-tiff (11b) on {card}: e2e {e2e:.3f}s = {n_tiles / e2e:.2f} "
        f"tiles/s ({n_tiles} tiles; the zarr twin {t_twin:.3f}s); fit="
        f"{t.get('flatfield_fit', 0):.3f}s registration="
        f"{t.get('registration', 0):.3f}s fuse+write="
        f"{t.get('stream_fuse_save', 0):.3f}s; band fuser: fuse="
        f"{stats['fuse']:.3f}s readback_wait={stats['readback_wait']:.3f}s "
        f"write={stats['write']:.3f}s close={stats['close']:.3f}s (writer "
        f"{writer_s:.3f}s); {file_bytes} bytes for {level_bytes} bytes of "
        f"levels (deflate ratio {file_bytes / level_bytes:.4f}); "
        f"peak_buffer_bytes {stats['peak_buffer_bytes']}; "
        f"{len(CHANNELS)} pages x {pipe.num_pyramid_levels} levels decode "
        f"equal to the zarr twin (read back in {t_read:.1f}s), thumbnail "
        f"{thumb.shape}; launches {launches}")
    shutil.rmtree(out)
    tiff = {'e2e_s': e2e, 'tiles_per_s': n_tiles / e2e, 'writer_s': writer_s,
            'file_bytes': file_bytes, 'ratio': file_bytes / level_bytes,
            'peak_buffer_bytes': stats['peak_buffer_bytes'],
            'encode_s': parts['encode_strip'], 'deflate_mbps': rates}

    # 11c: the host fuser on the same grid, against the device path's tree
    host_out = os.path.join(work, 'tiff_host_out')
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    pipe = stitch(acq, use_registration=True, apply_flatfield=True,
                  device=dev, options=smoke_options(host_out,
                                                    fusion_device='host'))
    e2e_host = time.perf_counter() - t0
    stats = pipe.fuse_stats['A1_t0']
    first_band = stats['first_band_at'] - t0
    fit_done = pipe.fit_done_at - t0
    if any(fn.launches for fn in kernels) or not stats['bands']:
        raise SystemExit(f"ome-tiff (11c): the host run launched "
                         f"{[fn.launches for fn in kernels]}, ran "
                         f"{stats['bands']} host bands")
    nbytes, zero_chunks = files_equal_but_zero_chunks(
        twin, host_out, "ome-tiff (11c, host vs device)", skip=skip)
    # every band's every level-0 chunk column taken whole by the raw
    # writer: a refused block goes out as rows and would be counted apart
    if (not stats['block_cols'] or stats['block_refusals']
            or stats['blocks'] != stats['bands'] * stats['block_cols']
            or not stats['fill_skips']):
        raise SystemExit(f"ome-tiff (11c): the raw host run wrote "
                         f"{stats['blocks']} level-0 blocks for "
                         f"{stats['bands']} bands x {stats['block_cols']} "
                         f"chunk columns, {stats['block_refusals']} refused, "
                         f"and skipped {stats['fill_skips']} fills")
    t = pipe.timers.as_dict()
    log(f"ome-tiff (11c) on {card}: fusion_device='host' e2e "
        f"{e2e_host:.3f}s = {n_tiles / e2e_host:.2f} tiles/s; fit="
        f"{t.get('flatfield_fit', 0):.3f}s registration="
        f"{t.get('registration', 0):.3f}s fuse+write="
        f"{t.get('stream_fuse_save', 0):.3f}s; the first band started at "
        f"{first_band:.3f}s, the fit ended at {fit_done:.3f}s (the gate: "
        f"{fit_done - first_band:.3f}s of overlap); {stats['bands']} bands on "
        f"{opts.resolved_fusion_threads()} threads; {stats['blocks']} "
        f"level-0 chunk-column blocks ({stats['bands']} bands x "
        f"{stats['block_cols']} chunk columns) taken whole by the raw "
        f"writer from the band threads, {stats['block_refusals']} refused; "
        f"{stats['fill_skips']} of {stats['bands']} bands skipped their "
        f"fill; " + host_stage_sums(stats)
        + f"; its raw tree byte-equal to the device path's ({nbytes} bytes; "
        f"{zero_chunks} all-zero chunks of bands with no tile written by "
        f"the device path only, as the JAX package's two fusers do)")
    shutil.rmtree(host_out)
    # the host fuser into the JAX package's default codec: 8 band threads
    # hand each plane's bands to the lz4 writer in row order
    lz4_out = os.path.join(work, 'tiff_host_lz4_out')
    t0 = time.perf_counter()
    pipe = stitch(acq, use_registration=True, apply_flatfield=True,
                  device=dev, options=output_options(lz4_out,
                                                     fusion_device='host'))
    e2e_lz4 = time.perf_counter() - t0
    lz4_zarr = os.path.join(lz4_out, '0_stitched', 'A1_stitched.ome.zarr')
    for lv in range(pipe.num_pyramid_levels):
        if not np.array_equal(read_array(os.path.join(lz4_zarr, str(lv))),
                              read_array(os.path.join(zarr, str(lv)))):
            raise SystemExit(f"ome-tiff (11c, host lz4): level {lv} differs "
                             f"from the device path's raw tree")
    stats = pipe.fuse_stats['A1_t0']
    if (stats['blocks'] or stats['block_refusals'] or stats['block_cols']
            or not stats['fill_skips']):
        raise SystemExit(f"ome-tiff (11c, host lz4): {stats['blocks']} "
                         f"blocks, {stats['block_refusals']} refused (lz4 "
                         f"takes rows), {stats['fill_skips']} fills skipped")
    log(f"ome-tiff (11c) on {card}: fusion_device='host' into blosc-lz4 "
        f"e2e {e2e_lz4:.3f}s = {n_tiles / e2e_lz4:.2f} tiles/s; "
        f"{stats['bands']} bands (rows: lz4 takes no blocks), "
        f"{stats['fill_skips']} skipped their fill; "
        + host_stage_sums(stats) + f"; {pipe.num_pyramid_levels} levels "
        f"decode equal to the device path's raw tree")
    shutil.rmtree(lz4_out)
    shutil.rmtree(twin)
    shutil.rmtree(acq)
    banned = [m for m in BANNED if m in sys.modules]
    if banned:
        raise SystemExit(f"ome-tiff: loaded {banned}")
    return dict(tiff, host_e2e_s=e2e_host, gate_overlap_s=fit_done - first_band,
                host_lz4_e2e_s=e2e_lz4, grid_3x3=acqs[False])


# -------------------------------------------------------------------- 12

#: the codecs beside lz4 (phase 8), each at the setting phase 12 holds it
#: to: the reference production edition's zstd-1, the others at clevel 5,
#: snappy bit-shuffled
OTHER_CODECS = {'zstd': (1, 1), 'zlib': (5, 1), 'lz4hc': (5, 1),
                'blosclz': (5, 1), 'snappy': (5, 2)}
#: side of the cuts of ``codec_chunks`` the plain (Python) versions run on
PLAIN_CUT = 512
#: a smaller side for the codecs whose Python version is slower than
#: lz4hc's at PLAIN_CUT, so they do not set 12a's time
PLAIN_CUT_OF = {'zlib': 256}


def _plain_case(args):
    """One codec's plain version against its C frame on one cut: (cname,
    label, plain frame equal, both decoders exact, frame bytes)."""
    from image_stitcher_tpu_torch.io import blosc
    cname, clevel, shuffle, label, cut, ts = args
    frame = bytes(blosc.compress(cut, ts, clevel, shuffle, cname))
    plain = blosc.compress_plain(cut, ts, clevel, shuffle, cname)
    raw = cut.tobytes()
    exact = (blosc.decompress(frame).tobytes() == raw
             and blosc.decompress_plain(frame) == raw)
    return cname, label, frame == plain, exact, len(frame)


def _c_case(args):
    """One codec's C frame of one full chunk and its round trip."""
    from image_stitcher_tpu_torch.io import blosc
    cname, clevel, shuffle, label, chunk, ts = args
    frame = blosc.compress(chunk, ts, clevel, shuffle, cname)
    exact = blosc.decompress(frame).tobytes() == chunk.tobytes()
    return (cname, clevel, shuffle, label, chunk.nbytes, len(frame),
            bool(frame[2] & 0x02), exact)


def other_codec_check(rng) -> None:
    """12a: each codec's C encoder and decoder against its plain version
    on ``codec_chunks``: the C frames of the full chunks decode exactly
    (on a pool of threads); the plain versions (Python) run on the
    chunks' top-left PLAIN_CUT^2 cuts on a pool of processes meanwhile,
    byte-equal to the C frames of the cuts, with exact round trips
    through both decoders."""
    import multiprocessing
    t0 = time.perf_counter()
    chunks = codec_chunks(rng)
    full, cuts = [], []
    for cname, (clevel, shuffle) in OTHER_CODECS.items():
        for label, (chunk, ts) in chunks.items():
            full.append((cname, clevel, shuffle, label, chunk, ts))
            side = PLAIN_CUT_OF.get(cname, PLAIN_CUT)
            cuts.append((cname, clevel, shuffle, label, np.ascontiguousarray(
                chunk[:side, :side]), ts))
    ctx = multiprocessing.get_context('spawn')
    with ctx.Pool(os.cpu_count() or 1) as pool:
        plain = pool.map_async(_plain_case, cuts, chunksize=1)
        with ThreadPoolExecutor(os.cpu_count() or 1) as threads:
            for cname, clevel, shuffle, label, nbytes, size, memcpyed, \
                    exact in threads.map(_c_case, full):
                if not exact:
                    raise SystemExit(f"codecs: {cname} does not decode "
                                     f"{label}")
                log(f"codecs {cname}-{clevel} shuffle {shuffle} {label}: C "
                    f"frame {size} bytes ({size / nbytes:.4f}"
                    f"{', memcpyed' if memcpyed else ''}); C round trip "
                    "exact")
        results = plain.get(timeout=600)
    for cname, label, equal, exact, size in results:
        if not equal or not exact:
            raise SystemExit(f"codecs: {cname} on the "
                             f"{PLAIN_CUT_OF.get(cname, PLAIN_CUT)}^2 cut of "
                             f"{label}: plain frame equal {equal}, round "
                             f"trips exact {exact}")
    smaller = ', '.join(f"{c}'s {n}^2" for c, n in PLAIN_CUT_OF.items())
    log(f"codecs: the plain versions of {sorted(OTHER_CODECS)} on the "
        f"{PLAIN_CUT}^2 cuts ({smaller}) of {len(chunks)} chunks "
        f"({len(results)} cases, "
        f"cut because the Python versions take seconds per chunk): frames "
        f"byte-equal to C, round trips exact through both decoders; "
        f"{time.perf_counter() - t0:.1f}s with the C checks")


def zstd_libzstd_check() -> int:
    """12a: the C zstd encoder at blosc clevel 1 to 9 against libzstd
    1.5.7's frames at levels 1, 3, 5, ..., 15 and 22, whose SHA-256 the
    CPU test host keeps in ``tests/torch_zstd_frames.npz`` (this host has
    no libzstd binding): the seeded inputs of
    ``tests/torch_zstd_frames.py`` made here (their digests checked
    first), each frame's length and digest equal to the kept ones (on a
    pool of threads: the C encoder releases the interpreter lock).
    Returns the number of frames checked."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'tests')
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_zstd_frames as kept_frames
    from image_stitcher_tpu_torch.io import blosc
    t0 = time.perf_counter()
    kept = kept_frames.load()
    cases = kept_frames.inputs()
    if sorted(label for label, _ in cases) != sorted(kept):
        raise SystemExit("codecs (libzstd frames): the inputs are not the "
                         "kept file's")
    tasks = []
    for label, data in cases:
        digest, levels = kept[label]
        if kept_frames.sha(data) != digest:
            raise SystemExit(f"codecs (libzstd frames): input {label} is "
                             "not the one the kept digests were made from")
        tasks += [(label, data, clevel, want)
                  for clevel, want in levels.items()]
    # the slowest (1 MiB at level 22) first
    tasks.sort(key=lambda t: -len(t[1]) * (10 if t[2] == 9 else 1))

    def check(task):
        label, data, clevel, (size, want) = task
        frame = blosc.stream_compress('zstd', data, clevel)
        if (len(frame), kept_frames.sha(frame)) != (size, want):
            return (f"{label} at clevel {clevel}: a frame of {len(frame)} "
                    f"bytes is not libzstd's ({size} bytes)")
        return None

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        for err in pool.map(check, tasks):
            if err:
                raise SystemExit(f"codecs (libzstd frames): {err}")
    log(f"codecs (libzstd frames): {len(tasks)} C frames of {len(cases)} "
        f"kept inputs at blosc clevel 1 to 9 byte-equal to libzstd 1.5.7's "
        f"level 1, 3, 5, ..., 15 and 22 frames (tests/torch_zstd_frames.npz)"
        f" in {time.perf_counter() - t0:.2f}s")
    return len(tasks)


def blosc_frames_check() -> int:
    """12a: the C snappy, zlib and blosclz encoders against tensorstore's
    blosc frames (snappy 1.2, Chromium's zlib 1.3.1, c-blosc 1.x's
    blosclz), whose SHA-256 the CPU test host keeps in
    ``tests/torch_blosc_frames.npz`` (this host has no tensorstore): the
    seeded inputs of ``tests/torch_blosc_frames.py`` made here (their
    digests checked first), the port's frame of each (two blocks of
    zeros, then the input) at each kept setting, snappy at clevel 9,
    zlib and blosclz at clevel 1-9, and the codec's stream of the input
    where the frame holds one, each length and digest equal to the kept
    ones (on a pool of threads: the C encoders release the interpreter
    lock). Returns the number of frames and streams checked."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'tests')
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_blosc_frames as kept_frames
    from image_stitcher_tpu_torch.io import blosc
    t0 = time.perf_counter()
    kept = kept_frames.load()
    cases = kept_frames.inputs()
    if sorted(label for label, _ in cases) != sorted(kept):
        raise SystemExit("codecs (tensorstore frames): the inputs are not "
                         "the kept file's")
    tasks = []
    for label, data in cases:
        digest, settings = kept[label]
        if kept_frames.sha(data) != digest:
            raise SystemExit(f"codecs (tensorstore frames): input {label} is "
                             "not the one the kept digests were made from")
        for setting, want in settings.items():
            tasks.append((label, data, setting, want))

    def check(task):
        label, data, (cname, clevel), (flen, fsha, slen, ssha) = task
        frame = bytes(blosc.compress(kept_frames.framed(data, cname, clevel),
                                     1, clevel, 0, cname))
        if (len(frame), kept_frames.sha(frame)) != (flen, fsha):
            return (f"{label}: the {cname}-{clevel} frame of {len(frame)} "
                    f"bytes is not tensorstore's ({flen} bytes)"), 0
        if slen is None:
            return None, 1
        stream = blosc.stream_compress(cname, data, clevel)
        if (len(stream), kept_frames.sha(stream)) != (slen, ssha):
            return (f"{label}: the {cname}-{clevel} stream of {len(stream)} "
                    f"bytes is not tensorstore's ({slen} bytes)"), 1
        return None, 2

    checked = 0
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        for err, n in pool.map(check, tasks):
            if err:
                raise SystemExit(f"codecs (tensorstore frames): {err}")
            checked += n
    log(f"codecs (tensorstore frames): {len(tasks)} C frames and "
        f"{checked - len(tasks)} snappy, zlib and blosclz streams of "
        f"{len(cases)} kept inputs (snappy at clevel 9, zlib and blosclz "
        f"at clevel 1-9) byte-equal to tensorstore's "
        f"(tests/torch_blosc_frames.npz) in "
        f"{time.perf_counter() - t0:.2f}s")
    return checked


#: 12b's zstd clevels, and the rows of the 2048^2 chunk each encodes
#: (clevel 9, libzstd's level 22, on 2 MiB: its search runs at a few MB/s)
ZSTD_RATE_ROWS = {1: TILE, 3: TILE, 4: TILE, 5: TILE, 6: TILE, 7: TILE,
                  8: TILE, 9: 512}


def zstd_level_rates(rng, card: str) -> dict:
    """12b: the C zstd encoder's MB/s (input bytes) on one thread, byte
    shuffle, on one compressible 2048^2 u16 chunk (phase 8's content) at
    clevel 1, 3, 4 and 5 (libzstd's fast, and its greedy, lazy and lazy2
    parsers in 128 and 256 KiB blosc blocks) and 6 to 9 (lazy2 and
    btlazy2 in 512 KiB blocks, btultra2 in 1 MiB ones on the chunk's
    first 2 MiB), with the ratio."""
    from image_stitcher_tpu_torch.io import blosc
    chunk = compressible(rng, TILE)
    blosc.compress(chunk[:256], 2, 5, 1, 'zstd')           # warm
    rates = {}
    for clevel, rows in ZSTD_RATE_ROWS.items():
        cut = np.ascontiguousarray(chunk[:rows])
        t0 = time.perf_counter()
        frame = blosc.compress(cut, 2, clevel, 1, 'zstd')
        dt = time.perf_counter() - t0
        rates[clevel] = (cut.nbytes / dt / 1e6, len(frame) / cut.nbytes)
    log(f"zstd encode MB/s on {card}, one thread, a compressible 2048^2 u16 "
        f"chunk (clevel 9: its first 2 MiB), byte shuffle: " + "; ".join(
            f"clevel {c} {r:.2f} (ratio {q:.4f})"
            for c, (r, q) in rates.items()))
    return rates


def other_codec_rates(rng, card: str) -> dict:
    """12b: MB/s (input bytes) of every codec's C encoder and decoder on
    distinct 2048^2 compressible u16 chunks, on one thread and on a pool
    of one thread per CPU (the writers' pool), with its ratio beside
    lz4's."""
    from image_stitcher_tpu_torch.io import blosc
    from image_stitcher_tpu_torch.params import _available_cpus
    ncpu = _available_cpus()
    chunks = [compressible(rng, TILE) for _ in range(max(8, ncpu))]
    nbytes = sum(c.nbytes for c in chunks)
    rates = {}
    for cname, (clevel, shuffle) in [('lz4', (5, 1))] + list(
            OTHER_CODECS.items()):
        def enc(c, cname=cname, clevel=clevel, shuffle=shuffle):
            return blosc.compress(c, 2, clevel, shuffle, cname)
        frames = [enc(c) for c in chunks[:2]]          # warm
        row = {}
        for threads in (1, ncpu):
            with ThreadPoolExecutor(threads) as pool:
                t0 = time.perf_counter()
                frames = list(pool.map(enc, chunks))
                t_enc = time.perf_counter() - t0
                t0 = time.perf_counter()
                list(pool.map(blosc.decompress, frames))
                t_dec = time.perf_counter() - t0
            row[threads] = (nbytes / t_enc / 1e6, nbytes / t_dec / 1e6)
        row['ratio'] = sum(len(f) for f in frames) / nbytes
        rates[cname] = row
        lz4 = rates['lz4']['ratio']
        log(f"codec MB/s on {card}, {cname}-{clevel} shuffle {shuffle}, "
            f"{len(chunks)} compressible 2048^2 u16 chunks: ratio "
            f"{row['ratio']:.4f} (lz4-5 {lz4:.4f}); encode {row[1][0]:.1f} "
            f"on one thread, {row[ncpu][0]:.1f} on {ncpu}; decode "
            f"{row[1][1]:.1f} / {row[ncpu][1]:.1f}")
    return rates


def compare_trees_banded(a_root: str, b_root: str, what: str,
                         arrays_only: bool = False, rows: int = TILE) -> int:
    """Equal decoded arrays (read in bands of ``rows`` rows on a pool of
    threads, the C decoders releasing the interpreter lock) and, unless
    ``arrays_only`` (a v2 tree against a v3 one), equal JSON but for the
    chunks' codec; returns the number of arrays."""
    from image_stitcher_tpu_torch.io.zarr_store import open_array
    from image_stitcher_tpu_torch.params import _available_cpus

    def walk(root):
        arrays, meta = [], {}
        for d, _, names in os.walk(root):
            rel = os.path.relpath(d, root)
            for n in names:
                if n in ('.zarray', '.zattrs', '.zgroup', 'zarr.json'):
                    with open(os.path.join(d, n)) as f:
                        m = json.load(f)
                    if n == '.zarray':
                        m.pop('compressor')
                    elif n == 'zarr.json' and m.get('node_type') == 'array':
                        m.pop('codecs')
                    meta[os.path.join(rel, n)] = m
                    if n == '.zarray' or (n == 'zarr.json' and m.get(
                            'node_type') == 'array'):
                        arrays.append(rel)
        return sorted(arrays), meta

    arrays, meta = walk(a_root)
    b_arrays, b_meta = walk(b_root)
    if not arrays or arrays != b_arrays:
        raise SystemExit(f"{what}: the trees hold different arrays")
    if not arrays_only and meta != b_meta:
        raise SystemExit(f"{what}: the trees' metadata differ: "
                         f"{[k for k in meta if meta[k] != b_meta.get(k)]}")
    tasks = []
    for rel in arrays:
        a, b = open_array(os.path.join(a_root, rel)), \
            open_array(os.path.join(b_root, rel))
        if a.shape != b.shape:
            raise SystemExit(f"{what}: {rel} is {a.shape} and {b.shape}")
        for y0 in range(0, a.shape[3], rows):
            tasks.append((rel, a, b, y0))

    def same(task):
        rel, a, b, y0 = task
        sel = (Ellipsis, slice(y0, y0 + rows), slice(None))
        return np.array_equal(a[sel], b[sel]), rel, y0

    with ThreadPoolExecutor(_available_cpus()) as pool:
        for ok, rel, y0 in pool.map(same, tasks):
            if not ok:
                raise SystemExit(f"{what}: {rel} rows {y0}.. decode "
                                 "differently")
    return len(arrays)


def main_path_codec_run(work: str, card: str, output_layer: dict, dev,
                        cname: str, clevel: int, grid: int) -> dict:
    """12c: phase 8's main-path grid and content in blosc ``cname`` at
    ``clevel`` with byte shuffle, streamed in bands as phase 8's runs:
    e2e, tiles/s, the writer's seconds, the encode pool's drain (the
    close), bytes and ratio, the tree decoded equal to phase 8's raw
    tree, beside phase 8's lz4 run. The tree is removed."""
    from image_stitcher_tpu_torch import stitch
    from image_stitcher_tpu_torch.ops import cuda_fuse
    what = f"{cname}-{clevel}"
    lz4_run = output_layer['runs']['lz4']
    out = os.path.join(work, f'{cname}_out')
    cuda_fuse.fuse_overwrite.launches = 0
    t0 = time.perf_counter()
    # streamed in bands as phase 8's runs ('auto' streams this canvas)
    pipe = stitch(output_layer['main_acq'], use_registration=True,
                  apply_flatfield=True, device=dev, options=output_options(
                      out, streaming='on', compressor_cname=cname,
                      compressor_clevel=clevel, compressor_shuffle=1))
    e2e = time.perf_counter() - t0
    launches = cuda_fuse.fuse_overwrite.launches
    if dev.type == 'cuda' and launches == 0:
        raise SystemExit(f"codecs ({what}): no kernel launch")
    stats = pipe.fuse_stats['A1_t0']
    with open(os.path.join(out, '0_stitched', 'A1_stitched.ome.zarr', '0',
                           '.zarray')) as f:
        comp = json.load(f)['compressor']
    if (comp['cname'], comp['clevel'], comp['shuffle']) != (cname, clevel,
                                                             1):
        raise SystemExit(f"codecs ({what}): chunks written as {comp}")
    written = tree_bytes(out)
    level_bytes = 0
    for d, _, names in os.walk(out):
        if '.zarray' in names:
            with open(os.path.join(d, '.zarray')) as f:
                level_bytes += 2 * int(np.prod(json.load(f)['shape']))
    n_tiles = grid * grid * len(CHANNELS)
    run = {'e2e_s': e2e, 'tiles_per_s': n_tiles / e2e,
           'writer_s': stats['write'] + stats['close'],
           'close_s': stats['close'], 'bytes': written,
           'ratio': written / level_bytes, 'launches': launches}
    log(f"codecs ({what}) main path on {card}: e2e {e2e:.3f}s = "
        f"{n_tiles / e2e:.2f} tiles/s; band fuser: fuse={stats['fuse']:.3f}s "
        f"write={stats['write']:.3f}s close (the pool's drain)="
        f"{stats['close']:.3f}s (writer {run['writer_s']:.3f}s); {written} "
        f"bytes for {level_bytes} bytes of levels (ratio "
        f"{written / level_bytes:.4f}); fuse_overwrite launches {launches}")
    t0 = time.perf_counter()
    arrays = compare_trees_banded(output_layer['main_raw'], out,
                                  f'codecs ({what} vs raw)')
    log(f"codecs: the {what} tree decodes equal to phase 8's raw tree "
        f"({arrays} level arrays, compared in {time.perf_counter() - t0:.1f}"
        f"s); {what} e2e {e2e:.3f}s, ratio {run['ratio']:.4f} against "
        f"phase 8's lz4 e2e {lz4_run['e2e_s']:.3f}s, ratio "
        f"{lz4_run['ratio']:.4f} (same acquisition, this call)")
    shutil.rmtree(out)
    return run


def phase_other_codecs(work: str, card: str, output_layer: dict,
                       grid: int = 10, tile: int = TILE,
                       device: str = 'cuda') -> dict:
    """12: the other blosc codecs. (a) C against the kept digests and
    against plain; (b) MB/s; (c) the reference production setting (zstd,
    clevel 1, byte shuffle), zlib at the JAX default clevel 5 and
    blosclz-5, byte shuffle, on phase 8's grid and content, each decoded
    equal to a raw run, with e2e, tiles/s, the writer's seconds, the
    encode pool's drain, bytes and ratio against phase 8's lz4 run; (d)
    a 3x3 grid for every other cname, v2 and v3, each decoded equal to
    its raw twin; (e) a 2-well plate with the complete-plate merge in
    zstd, equal to the same merge in lz4.
    ``output_layer`` is phase 8's result: its lz4 run, and the
    acquisitions and raw trees (c) and (d) reuse, which this phase
    removes."""
    from image_stitcher_tpu_torch import CarriedState, list_outputs, stitch
    from image_stitcher_tpu_torch.ops import cuda_fuse
    dev = torch.device(device)
    t_phase = time.perf_counter()
    rng = np.random.default_rng(12)
    libzstd_frames = zstd_libzstd_check()
    blosc_frames = blosc_frames_check()
    other_codec_check(rng)
    rates = other_codec_rates(rng, card)
    zstd_rates = zstd_level_rates(rng, card)
    overlap = 205 * tile // TILE

    # 12c: the main path's grid in zstd-1, zlib-5 and blosclz-5, against
    # phase 8's raw twin
    runs = {cname: main_path_codec_run(work, card, output_layer, dev, cname,
                                       clevel, grid)
            for cname, clevel in (('zstd', 1), ('zlib', 5), ('blosclz', 5))}
    blz, lz4_run = runs['blosclz'], output_layer['runs']['lz4']
    log(f"codecs: blosclz-5 main path e2e {blz['e2e_s']:.3f}s, tree ratio "
        f"{blz['ratio']:.4f}, one-thread encode "
        f"{rates['blosclz'][1][0]:.1f} MB/s (12b); lz4-5 e2e "
        f"{lz4_run['e2e_s']:.3f}s, tree ratio {lz4_run['ratio']:.4f}, "
        f"one-thread encode {rates['lz4'][1][0]:.1f} MB/s (same call)")
    for path in (output_layer['main_raw'], output_layer['main_acq']):
        shutil.rmtree(path)

    # 12d: 3x3 grids, every other cname, v2 and v3, against a raw twin
    acq, raw_out = output_layer['small_acq'], output_layer['small_raw']
    small = {}
    for cname, (clevel, shuffle) in OTHER_CODECS.items():
        for fmt in (2, 3):
            out = os.path.join(work, f'codecs_3x3_{cname}_v{fmt}')
            cuda_fuse.fuse_overwrite.launches = 0
            t0 = time.perf_counter()
            stitch(acq, use_registration=True, apply_flatfield=True,
                   device=dev, options=output_options(
                       out, compressor_cname=cname, compressor_clevel=clevel,
                       compressor_shuffle=shuffle, zarr_format=fmt))
            e2e = time.perf_counter() - t0
            if dev.type == 'cuda' and cuda_fuse.fuse_overwrite.launches == 0:
                raise SystemExit(f"codecs: the 3x3 {cname} v{fmt} run "
                                 "launched no kernel")
            arrays = compare_trees_banded(raw_out, out,
                                          f"codecs (3x3 {cname} v{fmt})",
                                          arrays_only=fmt == 3)
            small[f'{cname} v{fmt}'] = (e2e, tree_bytes(out))
            shutil.rmtree(out)
        log(f"codecs: 3x3 {cname}-{clevel} shuffle {shuffle} (v3: byte "
            f"shuffle) v2 e2e {small[f'{cname} v2'][0]:.3f}s "
            f"{small[f'{cname} v2'][1]} bytes, v3 e2e "
            f"{small[f'{cname} v3'][0]:.3f}s {small[f'{cname} v3'][1]} "
            f"bytes; both decode equal to the raw twin ({arrays} arrays)")
    shutil.rmtree(raw_out)
    shutil.rmtree(acq)

    # 12e: a 2-well plate, the complete-plate merge in zstd against lz4
    acq = os.path.join(work, 'codecs_plate')
    write_acquisition(acq, 3, tile, overlap=overlap, seed=11,
                      regions=WELLS[:2], texture=compressible)
    plates = {}
    state = None
    for cname in ('lz4', 'zstd'):
        out = os.path.join(work, f'codecs_plate_{cname}')
        t0 = time.perf_counter()
        pipe = stitch(acq, use_registration=True, apply_flatfield=True,
                      device=dev, merge_hcs_regions=True, state=state,
                      options=output_options(
                          out, compressor_cname=cname,
                          compressor_clevel=1 if cname == 'zstd' else 5))
        state = state or CarriedState(flatfields=pipe.flatfields,
                                      shifts=pipe.shifts)
        e2e = time.perf_counter() - t0
        hcs = list_outputs(out)['hcs']
        if len(hcs) != 1:
            raise SystemExit(f"codecs: the {cname} plate wrote {hcs}")
        plates[cname] = (hcs[0], e2e, pipe.timers.as_dict().get('merge', 0),
                         out)
    arrays = compare_trees_banded(plates['lz4'][0], plates['zstd'][0],
                                  'codecs (plate merge zstd vs lz4)')
    for plate in plates.values():
        shutil.rmtree(plate[3])
    log(f"codecs: 2-well plate with the complete-plate merge: zstd-1 e2e "
        f"{plates['zstd'][1]:.3f}s (merge {plates['zstd'][2]:.3f}s), lz4 "
        f"e2e {plates['lz4'][1]:.3f}s (merge {plates['lz4'][2]:.3f}s); the "
        f"zstd plate decodes equal to the lz4 plate ({arrays} arrays)")
    shutil.rmtree(acq)
    banned = [m for m in BANNED if m in sys.modules]
    if banned:
        raise SystemExit(f"codecs: loaded {banned}")
    seconds = time.perf_counter() - t_phase
    log(f"codecs: phase 12 in {seconds:.1f}s")
    return {'rates': rates, 'zstd_main': runs['zstd'],
            'zlib_main': runs['zlib'], 'blosclz_main': runs['blosclz'],
            'small': small,
            'libzstd_frames': libzstd_frames, 'blosc_frames': blosc_frames,
            'zstd_rates': zstd_rates,
            'seconds': seconds}


# -------------------------------------------------------------------- 13

#: 13a: seeded JPEG cases, (label, height, width, RGB, luma sampling,
#: quality, restart interval): grey and RGB, 4:4:4, 4:2:2, 4:2:0 and
#: 4:4:0, quality 50 / 85 / 95, odd sizes, restart intervals, and whole
#: 2048^2 tiles
JPEG_CASES = (
    ('grey 37x53 q50', 37, 53, False, (1, 1), 50, 0),
    ('grey 131x77 q85 restart 5', 131, 77, False, (1, 1), 85, 5),
    ('grey 255x257 q95', 255, 257, False, (1, 1), 95, 0),
    ('RGB 4:4:4 61x45 q50', 61, 45, True, (1, 1), 50, 0),
    ('RGB 4:2:2 99x131 q85', 99, 131, True, (2, 1), 85, 0),
    ('RGB 4:2:0 129x203 q95 restart 3', 129, 203, True, (2, 2), 95, 3),
    ('RGB 4:2:0 257x255 q85', 257, 255, True, (2, 2), 85, 0),
    ('RGB 4:4:0 45x77 q95', 45, 77, True, (1, 2), 95, 0),
    ('grey 2048^2 tile q95', TILE, TILE, False, (1, 1), 95, 0),
    ('RGB 4:2:0 2048^2 tile q85', TILE, TILE, True, (2, 2), 85, 0))
#: quality of the JPEG tiles (OpenCV's imwrite default, Squid's tiles) and
#: of the JPEG OME-TIFF tiles (the JAX package's tiff_jpeg_quality)
TILE_QUALITY, TIFF_QUALITY = 95, 85


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float('inf') if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _jpeg_case(args):
    """One 13a case, in a worker process: the C stream against the plain
    encoder's (``part`` 'encode'), or both decoders of it against each
    other (``part`` 'decode'); (label, part, equal, stream bytes, PSNR of
    the decoded pixels against the input)."""
    from image_stitcher_tpu_torch.io import jpeg, jpeg_plain
    label, img, sampling, quality, restart, part = args
    stream = jpeg.encode(img, quality, sampling, restart)
    if part == 'encode':
        equal = jpeg_plain.encode(img, quality, sampling, restart) == stream
        return label, part, equal, len(stream), None
    pixels = jpeg.decode(stream)
    equal = np.array_equal(jpeg_plain.decode(stream), pixels)
    return label, part, equal, len(stream), psnr(pixels, img)


def jpeg_streams():
    """``tests/torch_jpeg_streams.py``: progressive and 4:1:1 streams
    written by OpenCV on the CPU test host (the port's encoder writes
    baseline only, and this host has no OpenCV), each with the SHA-256
    of OpenCV's pixels."""
    tile_files()      # puts tests/ on the path
    import torch_jpeg_streams
    return torch_jpeg_streams


def _kept_case(name):
    """One 13a case of a kept OpenCV stream, in a worker process: the C
    decoder's pixels against OpenCV's digest and (but for the 2048^2
    tiles) the plain decoder's pixels; (label, part, equal, stream bytes,
    None)."""
    from image_stitcher_tpu_torch.io import jpeg, jpeg_plain
    streams = jpeg_streams()
    data, digest = streams.load()[name]
    pixels = jpeg.decode(data)
    equal = streams.pixel_digest(pixels) == digest and (
        name.startswith('tile') or np.array_equal(jpeg_plain.decode(data),
                                                  pixels))
    return name, 'kept', equal, len(data), None


def jpeg_check(rng) -> None:
    """13a: the C encoder and decoder against the plain versions on
    ``JPEG_CASES`` (the content: :func:`textures` in u8), byte-equal
    streams and pixels, the round trip through both decoders; then the
    kept OpenCV streams (progressive grey and RGB 4:4:4 to 4:1:1 with
    optimised tables and restart intervals, baseline 4:1:1), each
    decoded by C to OpenCV's pixels (their SHA-256) and, but the 2048^2
    tiles, by the plain version to the C decoder's. The plain (Python)
    halves run on a pool of processes."""
    import multiprocessing
    t0 = time.perf_counter()
    tasks = []
    for label, h, w, rgb, sampling, quality, restart in JPEG_CASES:
        side = max(h, w, 256)     # the texture's widest blur
        img = np.ascontiguousarray(
            textures(rng, side, 3 if rgb else 1, np.uint8)[:h, :w])
        for part in ('encode', 'decode'):
            tasks.append((label, img, sampling, quality, restart, part))
    # the whole tiles first: they take longest
    tasks.sort(key=lambda t: -t[1].size)
    kept = [c[0] for c in jpeg_streams().CASES]
    ctx = multiprocessing.get_context('spawn')
    with ctx.Pool(min(len(tasks), os.cpu_count() or 1)) as pool:
        pending = pool.map_async(_kept_case, kept, chunksize=1)
        results = pool.map(_jpeg_case, tasks, chunksize=1)
        results += pending.get()
    for label, part, equal, size, quality in sorted(results):
        if part == 'kept':
            if not equal:
                raise SystemExit(f"jpeg: kept stream {label}: the decoders "
                                 "differ from OpenCV's pixels or each other")
            log(f"jpeg {label}: OpenCV's stream ({size} bytes) decoded by C "
                f"to OpenCV's pixels (SHA-256)"
                + ("" if label.startswith('tile') else
                   ", the plain decoder's equal"))
            continue
        if not equal:
            raise SystemExit(f"jpeg: {label}: the C {part}r differs from "
                             f"the plain version")
        if part == 'decode' and not quality > 20:
            raise SystemExit(f"jpeg: {label}: the round trip's PSNR is "
                             f"{quality:.1f} dB")
        if part == 'decode':
            log(f"jpeg {label}: C and plain streams byte-equal ({size} "
                f"bytes), both decoders' pixels equal, round trip PSNR "
                f"{quality:.2f} dB")
    log(f"jpeg: {len(JPEG_CASES)} cases, C equal to plain, and "
        f"{len(kept)} kept OpenCV streams equal to OpenCV's pixels; 13a in "
        f"{time.perf_counter() - t0:.1f}s (plain halves on a process pool)")


def jpeg_rates(rng, card: str, png_rates) -> dict:
    """13b: MB/s (pixel bytes) of the C encoder and decoder on 2048^2 u8
    tiles, grey at the tiles' quality and RGB 4:2:0 at the OME-TIFF
    quality: one thread, then the reader pool's 8 (``READERS`` tiles a
    pass); beside phase 9's 16-bit PNG tile decode."""
    from image_stitcher_tpu_torch.io import jpeg
    rates = {}
    for label, planes, sampling, quality in (
            ('grey u8', 1, (1, 1), TILE_QUALITY),
            ('RGB u8 4:2:0', 3, (2, 2), TIFF_QUALITY)):
        imgs = [textures(rng, TILE, planes, np.uint8)
                for _ in range(2)] * (READERS // 2)
        streams = [jpeg.encode(img, quality, sampling) for img in imgs]
        jpeg.decode(streams[0])                                # warm
        nbytes = sum(img.nbytes for img in imgs)
        row = {'ratio': sum(map(len, streams)) / nbytes}
        for threads in (1, READERS):
            with ThreadPoolExecutor(threads) as pool:
                t0 = time.perf_counter()
                list(pool.map(lambda i: jpeg.encode(i, quality, sampling),
                              imgs))
                enc = time.perf_counter() - t0
                t0 = time.perf_counter()
                list(pool.map(jpeg.decode, streams))
                dec = time.perf_counter() - t0
            row[threads] = (nbytes / enc / 1e6, nbytes / dec / 1e6)
        rates[label] = row
        png = png_rates.get('PNG tile (zlib + C)', (0.0, 0.0))
        log(f"jpeg MB/s on {card}: {label} 2048^2 q{quality} (ratio "
            f"{row['ratio']:.4f}): decode {row[1][1]:.0f} on one thread, "
            f"{row[READERS][1]:.0f} on {READERS}; encode {row[1][0]:.0f} / "
            f"{row[READERS][0]:.0f} (phase 9's 16-bit PNG tile decode: "
            f"{png[0]:.0f} / {png[1]:.0f})")
    # progressive tiles: OpenCV's q85 streams of smooth content, beside
    # the port's baseline streams of the same pixels at the same quality
    kept = jpeg_streams().load()
    for label, name, sampling in (('grey u8 progressive', 'tile-prog-grey',
                                   (1, 1)),
                                  ('RGB u8 4:2:0 progressive',
                                   'tile-prog-420', (2, 2))):
        prog = kept[name][0]
        pixels = jpeg.decode(prog)
        base = jpeg.encode(pixels, 85, sampling)
        row = {'ratio': len(prog) / pixels.nbytes,
               'baseline_ratio': len(base) / pixels.nbytes}
        for kind, stream in (('progressive', prog), ('baseline', base)):
            streams = [stream] * READERS
            nbytes = pixels.nbytes * READERS
            for threads in (1, READERS):
                with ThreadPoolExecutor(threads) as pool:
                    t0 = time.perf_counter()
                    list(pool.map(jpeg.decode, streams))
                    row[kind, threads] = nbytes / (time.perf_counter()
                                                   - t0) / 1e6
        rates[label] = row
        log(f"jpeg MB/s on {card}: {label} 2048^2 q85 (OpenCV's stream, "
            f"ratio {row['ratio']:.4f}): decode "
            f"{row['progressive', 1]:.0f} on one thread, "
            f"{row['progressive', READERS]:.0f} on {READERS}; the port's "
            f"baseline stream of its pixels (ratio "
            f"{row['baseline_ratio']:.4f}): {row['baseline', 1]:.0f} / "
            f"{row['baseline', READERS]:.0f}")
    return rates


def phase_jpeg(work: str, card: str, png_rates=None, grid: int = 10,
               tile: int = TILE, device: str = 'cuda') -> dict:
    """13: JPEG. (a) the C codec against its plain version; (b) its MB/s;
    (c) the main path's grid and options on grey u8 JPEG tiles (quality
    95, written by the port's encoder) stitched on the card, its tree
    equal to an uncompressed-TIFF twin holding the C decoder's pixels;
    (d) 3x3 grey and RGB JPEG acquisitions written as JPEG ``.ome.tiff``
    on the card and on the CPU, byte-equal files; (c)'s acquisition as
    JPEG ``.ome.tiff``, every page and SubIFD level within PSNR 30 dB of
    (c)'s zarr levels."""
    from image_stitcher_tpu_torch import CarriedState, stitch
    from image_stitcher_tpu_torch.io import jpeg
    from image_stitcher_tpu_torch.io.tiff import read_pages
    from image_stitcher_tpu_torch.ops import cuda_fuse
    t_phase = time.perf_counter()
    dev, cpu = torch.device(device), torch.device('cpu')
    rng = np.random.default_rng(13)
    jpeg_check(rng)
    rates = jpeg_rates(rng, card, png_rates or {})
    tf = tile_files()
    overlap = 205 * tile // TILE
    skip = ('.stitch_manifest.json', 'flatfields.npz')
    cache = {}

    def gray(r, side):
        if side not in cache:
            cache[side] = textures(r, side, 1, np.uint8)
        return cache[side]

    # 13c: the main path on JPEG tiles, against its uncompressed twin
    acq, twin_acq = (os.path.join(work, 'jpeg_main'),
                     os.path.join(work, 'jpeg_twin'))
    t0 = time.perf_counter()
    write_acquisition(acq, grid, tile, overlap, seed=41, texture=gray,
                      encode=lambda b: jpeg.encode(b, TILE_QUALITY),
                      suffix='jpg')
    nbytes = tree_bytes(acq)
    t_write = time.perf_counter() - t0
    write_acquisition(twin_acq, grid, tile, overlap, seed=41, texture=gray,
                      encode=lambda b: tf.tiff_bytes(jpeg.decode(
                          jpeg.encode(b, TILE_QUALITY))))
    del cache
    n_tiles = grid * grid * len(CHANNELS)
    log(f"jpeg (13c): wrote {grid}x{grid}x{len(CHANNELS)} {tile}^2 grey u8 "
        f"q{TILE_QUALITY} tiles with the port's encoder in {t_write:.1f}s, "
        f"{nbytes} bytes for {n_tiles * tile * tile} of pixels")
    runs, trees = {}, {}
    for name, folder in (('jpeg', acq), ('tiff twin', twin_acq)):
        out = os.path.join(work, f'jpeg_out_{name.split()[-1]}')
        # in bands, as the main path: the 4x4 u8 canvas is under the
        # 'auto' threshold
        run = runs[name] = stitch_input(folder, out, dev, card,
                                        f'13c {name}', streaming='on')
        if not run.pop('streamed'):
            raise SystemExit(f"jpeg (13c {name}): the canvas did not "
                             f"stream in bands")
        run.pop('pipe')
        trees[name] = read_tree(out)
        shutil.rmtree(out)
    shutil.rmtree(twin_acq)
    arrays = compare_trees(trees['tiff twin'], trees['jpeg'],
                           'jpeg (13c, jpeg vs tiff twin)')
    tree = trees['jpeg']
    del trees
    log(f"jpeg (13c): the JPEG-tile tree decodes equal to the uncompressed "
        f"twin's ({arrays} level arrays); e2e {runs['jpeg']['e2e_s']:.3f}s "
        f"= {runs['jpeg']['tiles_per_s']:.2f} tiles/s against the twin's "
        f"{runs['tiff twin']['e2e_s']:.3f}s; loaders' decode "
        f"{runs['jpeg']['decode_s']:.3f}s summed over threads")

    # 13d: 3x3 grey and RGB JPEG acquisitions to JPEG .ome.tiff, card
    # against CPU
    small = {}
    for rgb in (False, True):
        folder = small[rgb] = os.path.join(work, f'jpeg_3x3_{int(rgb)}')
        write_acquisition(
            folder, 3, tile, overlap, seed=43 + rgb,
            texture=lambda r, side, p=3 if rgb else 1: textures(
                r, side, p, np.uint8),
            encode=lambda b: jpeg.encode(b, TILE_QUALITY),
            suffix='jpg',
            channels=["BF LED matrix full"] if rgb else CHANNELS)
    for rgb, folder in small.items():
        label = 'RGB' if rgb else 'grey'
        outs, state, secs = {}, None, {}
        for run, run_dev in (('card', dev), ('cpu', cpu)):
            cuda_fuse.fuse_overwrite.launches = 0
            out = outs[run] = os.path.join(work, f'jpeg_tiff_{run}')
            t0 = time.perf_counter()
            pipe = stitch(folder, output_format='.ome.tiff',
                          use_registration=True, apply_flatfield=True,
                          device=run_dev, state=state,
                          options=smoke_options(
                              out, tiff_compression='jpeg'))
            secs[run] = time.perf_counter() - t0
            if run == 'card':
                launches = cuda_fuse.fuse_overwrite.launches
                if run_dev.type == 'cuda' and not launches:
                    raise SystemExit(f"jpeg (13d, {label}): no launches")
                state = CarriedState(flatfields=pipe.flatfields,
                                     shifts=pipe.shifts)
        nb = files_equal(outs['card'], outs['cpu'],
                         f"jpeg (13d, {label})", skip=skip)
        with open(tiff_file(outs['card']), 'rb') as f:
            pages = read_pages(f.read())
        first = pages[0][1][0]
        if first.ndim != (3 if rgb else 2) or not first.any():
            raise SystemExit(f"jpeg (13d, {label}): page 0 is "
                             f"{first.shape}")
        log(f"jpeg (13d, {label}): 3x3 JPEG .ome.tiff from the card "
            f"byte-equal to the CPU run's ({nb} bytes, {len(pages)} pages, "
            f"level 0 {first.shape}); card {secs['card']:.3f}s (launches "
            f"{launches}), CPU {secs['cpu']:.3f}s")
        for out in outs.values():
            shutil.rmtree(out)
        shutil.rmtree(folder)

    # 13d: (c)'s acquisition as JPEG .ome.tiff, against (c)'s zarr levels
    out = os.path.join(work, 'jpeg_tiff_main')
    cuda_fuse.fuse_overwrite.launches = 0
    t0 = time.perf_counter()
    pipe = stitch(acq, output_format='.ome.tiff', use_registration=True,
                  apply_flatfield=True, device=dev,
                  options=smoke_options(out, tiff_compression='jpeg',
                                        tiff_jpeg_quality=TIFF_QUALITY,
                                        streaming='on'))
    e2e = time.perf_counter() - t0
    launches = cuda_fuse.fuse_overwrite.launches
    stats = pipe.fuse_stats['A1_t0']
    path = tiff_file(out)
    file_bytes = os.path.getsize(path)
    with open(path, 'rb') as f:
        pages = read_pages(f.read())
    if len(pages) != len(CHANNELS) + 1 or (dev.type == 'cuda'
                                           and not launches):
        raise SystemExit(f"jpeg (13d): {len(pages)} pages, {launches} "
                         f"launches")
    zarr = '0_stitched/A1_stitched.ome.zarr'
    worst, level_bytes = float('inf'), 0
    for lv in range(pipe.num_pyramid_levels):
        want = tree[os.path.join(zarr, str(lv))]
        for c in range(len(CHANNELS)):
            got = pages[c][1][lv]
            if got.shape != want[0, c, 0].shape:
                raise SystemExit(f"jpeg (13d): channel {c} level {lv} is "
                                 f"{got.shape}")
            quality = psnr(got, want[0, c, 0])
            worst = min(worst, quality)
            level_bytes += got.nbytes
            if not quality > 30:
                raise SystemExit(f"jpeg (13d): channel {c} level {lv} at "
                                 f"PSNR {quality:.2f} dB")
    del pages, tree
    shutil.rmtree(out)
    shutil.rmtree(acq)
    seconds = time.perf_counter() - t_phase
    log(f"jpeg (13d) on {card}: (c)'s acquisition as JPEG q{TIFF_QUALITY} "
        f".ome.tiff: e2e {e2e:.3f}s = {n_tiles / e2e:.2f} tiles/s, writer "
        f"{stats['write'] + stats['close']:.3f}s, launches {launches}; "
        f"{file_bytes} bytes for {level_bytes} of levels (ratio "
        f"{file_bytes / level_bytes:.4f}); {len(CHANNELS)} pages x "
        f"{pipe.num_pyramid_levels} levels, worst PSNR {worst:.2f} dB "
        f"against the zarr levels; phase 13 in {seconds:.1f}s")
    banned = [m for m in BANNED if m in sys.modules]
    if banned:
        raise SystemExit(f"jpeg: loaded {banned}")
    return {'rates': rates, 'runs': runs, 'tiff_e2e_s': e2e,
            'seconds': seconds}


# -------------------------------------------------------------------- 14

def _drain_child(proc, timeout: float = 300.0):
    """Every message of a child edition's three queues until it exits
    and they stay empty: ({queue: [messages]}, exit code)."""
    import queue as queue_mod
    msgs = {'progress': [], 'status': [], 'complete': []}
    queues = {'progress': proc.progress_queue, 'status': proc.status_queue,
              'complete': proc.complete_queue}
    deadline = time.time() + timeout
    quiet = 0
    while quiet < 5:
        if time.time() > deadline:
            proc.terminate()
            raise SystemExit("editions (14a): the child did not finish")
        got = False
        for name, q in queues.items():
            try:
                while True:
                    msgs[name].append(q.get(timeout=0.05))
                    got = True
            except queue_mod.Empty:
                pass
        quiet = 0 if got or proc.is_alive() else quiet + 1
    proc.join()
    return msgs, proc.exitcode


def _cli_output(acq: str, label: str) -> str:
    """The one run folder a CLI wrote beside ``acq``, renamed to
    ``{acq}_{label}`` so the next CLI's timestamped folder cannot meet
    it."""
    parent = os.path.dirname(acq)
    outs = [d for d in os.listdir(parent)
            if d.startswith(os.path.basename(acq) + '_stitched_')]
    if len(outs) != 1:
        raise SystemExit(f"editions (14b, {label}): run folders {outs}")
    dst = f"{acq}_{label}"
    os.rename(os.path.join(parent, outs[0]), dst)
    return dst


def phase_editions(work: str, card: str, acq: str) -> dict:
    """14: the editions, their CLIs and the doctor on the card, on phase
    11a's mono 3x3 acquisition. (a) ``StitcherProcess`` on its default
    device: the spawned child fuses on the card and speaks the queue
    protocol (progress up to its total, 'Stitching...', 'Saving...', one
    'complete'); its tree byte-equal to an in-process card ``stitch()`` of
    the same folder and options, which launches ``fuse_overwrite``. (b)
    ``python -m image_stitcher_tpu_torch.process_cli`` and ``.zarr_cli``
    with default flags, as subprocesses: exit 0, trees byte-equal to (a).
    (c) ``python -m image_stitcher_tpu_torch.tools.doctor``: exit 0, its
    Device section names this card and its power limit and gives the
    pinned link rates."""
    import re
    from image_stitcher_tpu_torch import (EngineOptions, StitchingParameters,
                                          stitch)
    from image_stitcher_tpu_torch.models.editions import StitcherProcess
    from image_stitcher_tpu_torch.ops import cuda_fuse
    skip = ('.stitch_manifest.json', 'flatfields.npz')
    t0 = time.perf_counter()
    inproc = os.path.join(work, 'editions_inproc')
    cuda_fuse.fuse_overwrite.launches = 0
    stitch(acq, device=torch.device('cuda'),
           options=EngineOptions(output_folder=inproc))
    e2e_inproc = time.perf_counter() - t0
    launches = cuda_fuse.fuse_overwrite.launches
    if not launches:
        raise SystemExit("editions (14a): the in-process card run launched "
                         "no fuse_overwrite")
    # (a) the child-process edition, default device: the card
    child_out = os.path.join(work, 'editions_child')
    proc = StitcherProcess(StitchingParameters(input_folder=acq),
                           options=EngineOptions(output_folder=child_out))
    if proc.device != 'cuda':
        raise SystemExit(f"editions (14a): default device {proc.device}")
    t0 = time.perf_counter()
    proc.start()
    msgs, code = _drain_child(proc)
    e2e_child = time.perf_counter() - t0
    errors = [m for m in msgs['status'] if m[0] == 'error']
    statuses = [m[1][0] for m in msgs['status'] if m[0] == 'status']
    progress = [m[1] for m in msgs['progress']]
    complete = msgs['complete']
    if code != 0 or errors:
        raise SystemExit(f"editions (14a): child exit {code}, {errors}")
    want_order = ['Stitching...', 'Saving...']
    if ([s for s in statuses if s in want_order] != want_order
            or not progress or progress[-1][0] != progress[-1][1]
            or len(complete) != 1 or complete[0][1][1] != 'uint16'):
        raise SystemExit(f"editions (14a): protocol {progress[-3:]} "
                         f"{statuses} {complete}")
    nbytes = files_equal(inproc, child_out, "editions (14a, child vs "
                         "in-process)", skip=skip)
    log(f"editions (14a) on {card}: StitcherProcess on its default device "
        f"(cuda, spawned child) e2e {e2e_child:.3f}s from start() to exit "
        f"(spawn, imports and CUDA start-up included) against the "
        f"in-process card stitch() {e2e_inproc:.3f}s ({launches} "
        f"fuse_overwrite launches); {len(progress)} progress messages up "
        f"to {progress[-1]}, statuses {[s for s in statuses if s in want_order]}"
        f", complete {os.path.relpath(complete[0][1][0], child_out)}; "
        f"trees byte-equal ({nbytes} bytes)")
    # (b) the CLIs as a user runs them, default flags
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (os.path.dirname(os.path.abspath(__file__)),
                    env.get('PYTHONPATH')) if p)
    cli_s = {}
    for module in ('process_cli', 'zarr_cli'):
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, '-m', f'image_stitcher_tpu_torch.{module}',
             '-i', acq], capture_output=True, text=True, timeout=300,
            env=env)
        cli_s[module] = time.perf_counter() - t0
        if run.returncode != 0 or 'Complete:' not in run.stdout:
            raise SystemExit(f"editions (14b, {module}): exit "
                             f"{run.returncode}\n{run.stdout[-2000:]}\n"
                             f"{run.stderr[-2000:]}")
        out = _cli_output(acq, module)
        nbytes = files_equal(child_out, out, f"editions (14b, {module})",
                             skip=skip)
        log(f"editions (14b) on {card}: python -m "
            f"image_stitcher_tpu_torch.{module} -i <3x3>: exit 0 in "
            f"{cli_s[module]:.3f}s (process start-up included), tree "
            f"byte-equal to (a)'s ({nbytes} bytes)")
        shutil.rmtree(out)
    # (c) the doctor
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, '-m', 'image_stitcher_tpu_torch.tools.doctor',
         '--output-dir', work], capture_output=True, text=True, timeout=300,
        env=env)
    doctor_s = time.perf_counter() - t0
    device = run.stdout.split('[Placement]')[0]
    rates = re.search(r'H2D ([0-9.]+) GB/s, D2H ([0-9.]+) GB/s', device)
    if (run.returncode != 0 or card not in device or rates is None
            or 'FAILED' in device):
        raise SystemExit(f"editions (14c, doctor): exit {run.returncode}\n"
                         f"{run.stdout[-3000:]}\n{run.stderr[-2000:]}")
    for line in run.stdout.splitlines():
        log(f"editions (14c) doctor | {line}")
    h2d, d2h = float(rates.group(1)), float(rates.group(2))
    log(f"editions (14c) on {card}: the doctor exit 0 in {doctor_s:.3f}s; "
        f"pinned H2D {h2d} GB/s, D2H {d2h} GB/s (256 MB, CUDA events)")
    for out in (inproc, child_out):
        shutil.rmtree(out)
    banned = [m for m in BANNED if m in sys.modules]
    if banned:
        raise SystemExit(f"editions: loaded {banned}")
    return {'child_e2e_s': e2e_child, 'inproc_e2e_s': e2e_inproc,
            'h2d_gbps': h2d, 'd2h_gbps': d2h}


# -------------------------------------------------------------------- 15

def tree_digest(root: str) -> dict:
    """{relative path: SHA-256} of every file of a run's tree but its
    manifests and field sidecar (which record how the run went, not what
    it wrote), hashed on a thread pool."""
    import hashlib
    rels = sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names
                  if not n.startswith(('.stitch_manifest.json',
                                       'flatfields.npz')))

    def digest(rel):
        h = hashlib.sha256()
        with open(os.path.join(root, rel), 'rb') as f:
            while chunk := f.read(1 << 24):
                h.update(chunk)
        return h.hexdigest()

    with ThreadPoolExecutor(8) as pool:
        return dict(zip(rels, pool.map(digest, rels)))


def digests_equal(want: dict, got: dict, what: str) -> int:
    if want != got:
        diff = sorted(k for k in set(want) | set(got)
                      if want.get(k) != got.get(k))
        raise SystemExit(f"{what}: {len(diff)} files differ, e.g. "
                         f"{diff[:6]}")
    return len(want)


def mesh_devices():
    """The mesh of phase 15: every card when the host has two or more,
    else two bands on cuda:0 (a repeated device)."""
    n = torch.cuda.device_count()
    if n >= 2:
        return [torch.device('cuda', i) for i in range(n)]
    return [torch.device('cuda', 0)] * 2


def sharded_check(card: str, devices, H: int, W: int, band: int) -> None:
    """15a: ShardedCanvas over (1, len(devices)) against the plain version
    at the main-path shapes: ten u16 2048^2 tiles with the field, in two
    grid rows whose second straddles the first band edge, on phase 15b's
    canvas (the main path's height and width) cut into 15b's bands.
    Overwrite byte-equal; feather acc/wsum bit-equal on every band's real
    rows, its finalize byte-equal."""
    from image_stitcher_tpu_torch.ops import fuse as plain
    from image_stitcher_tpu_torch.parallel.mesh import make_mesh
    from image_stitcher_tpu_torch.parallel.sharded_fuse import ShardedCanvas
    rng = np.random.default_rng(1515)
    n = len(devices)
    tiles, info, crops, valid = kernel_batch(rng, 10, TILE, TILE,
                                             (2 * TILE, W), 1)
    # the two grid rows moved down: the second straddles row ``band``
    info[valid, 2] += band - TILE // 2 - (TILE - 205)
    ff = (1.0 / rng.uniform(0.6, 1.4, (1, TILE, TILE))).astype(np.float32)
    host = torch.from_numpy(tiles).pin_memory()
    dev0 = devices[0]
    d_tiles = host.to(dev0)
    d_ff = torch.from_numpy(ff).to(dev0)
    meta = (torch.from_numpy(info), torch.from_numpy(crops),
            torch.from_numpy(valid))
    shape = (1, 1, H + TILE, -(-(W + TILE) // 8) * 8)
    for blend in ('overwrite', 'feather'):
        canvas = ShardedCanvas(make_mesh((1, n), devices), 1, 1, H, W, TILE,
                               TILE, np.uint16, blend_method=blend,
                               blend_px=BLEND, ff_recip=ff, band=band)
        straddle = sum(int(y) < b.start < int(y) + TILE
                       for b in canvas.bands for y, ok in
                       zip(info[:, 2], valid) if ok)
        canvas.fuse_batch(host, info, crops, valid)
        if blend == 'feather':
            acc = torch.zeros(shape, device=dev0)
            wsum = torch.zeros(shape, device=dev0)
            plain.fuse_feather(acc, wsum, d_tiles, *meta, ff_recip=d_ff,
                               blend_px=BLEND)
            for b in canvas.bands:
                rows = slice(TILE, TILE + b.rows)
                want = slice(b.start, b.start + b.rows)
                for got_t, want_t in ((b.acc, acc), (b.wsum, wsum)):
                    if not torch.equal(got_t[..., rows, :W].to(dev0),
                                       want_t[..., want, :W]):
                        raise SystemExit(f"sharded (15a): band {b.index}'s "
                                         f"feather sums differ")
            want = plain.finalize_feather(acc, wsum, torch.uint16)
        else:
            want = plain.fuse_overwrite(
                torch.zeros(shape, dtype=torch.uint16, device=dev0),
                d_tiles, *meta, ff_recip=d_ff)
        got = canvas.finalize()
        torch.cuda.synchronize()
        err = int((got.to(torch.int32)
                   - want[..., :H, :W].to(torch.int32)).abs().max())
        if err:
            raise SystemExit(f"sharded (15a): {blend} finalize differs from "
                             f"the plain version by {err}")
        ms = call_ms(lambda: canvas.fuse_batch(host, info, crops, valid),
                     reps=5)
        log(f"sharded (15a) {blend} on {card}: (1, {n}) over "
            f"{[str(d) for d in devices]}, bands of {canvas.band} rows, "
            f"{straddle} tiles straddle a band edge; "
            f"{'acc/wsum bit-equal, ' if blend == 'feather' else ''}"
            f"finalize byte-equal to the plain version; fuse_batch "
            f"{ms:.3f} ms (one upload a card, a launch a band, host "
            f"enqueue included), launches per band "
            f"{[b['launches'] for b in canvas.band_stats()]}")
        del canvas, got, want
        torch.cuda.empty_cache()


def mesh_main_path(work: str, card: str, devices, main_run: dict) -> dict:
    """15b: phase 5's acquisition and options with mesh_shape=(1, n): the
    tree byte-equal to phase 5's, e2e against phase 5's, per-band device
    fuse ms, read-back waits and writes, each card's peak memory."""
    from image_stitcher_tpu_torch import stitch
    from image_stitcher_tpu_torch.ops import cuda_fuse
    n = len(devices)
    out = os.path.join(work, 'mesh_out')
    distinct = list(dict.fromkeys(devices))
    for d in distinct:
        torch.cuda.reset_peak_memory_stats(d)
    cuda_fuse.fuse_overwrite.launches = 0
    t0 = time.perf_counter()
    pipe = stitch(main_run['acq'], use_registration=True,
                  apply_flatfield=True, device=devices,
                  options=smoke_options(out, mesh_shape=(1, n)))
    e2e = time.perf_counter() - t0
    launches = cuda_fuse.fuse_overwrite.launches
    peaks = {str(d): torch.cuda.max_memory_allocated(d) for d in distinct}
    stats = pipe.fuse_stats['A1_t0']
    bands = stats['bands']
    width, height = pipe._region_dimensions(0, 'A1')
    canvas_bytes = pipe.acq.num_c * height * width * 2
    peak_host = stats['peak_host_bytes']
    if launches == 0 or launches != sum(b['launches'] for b in bands):
        raise SystemExit(f"mesh (15b): {launches} fuse_overwrite launches "
                         f"for bands {bands}")
    if not 0 < peak_host < canvas_bytes:
        raise SystemExit(f"mesh (15b): the host held {peak_host} B of "
                         f"pieces at once, the whole canvas is "
                         f"{canvas_bytes} B")
    t_cmp = time.perf_counter()
    files = digests_equal(main_run['digest'], tree_digest(out),
                          "mesh (15b) against phase 5's tree")
    n_tiles = len(pipe._build_jobs(0, 'A1'))
    log(f"mesh (15b) on {card}: (1, {n}) over {[str(d) for d in devices]}: "
        f"tree byte-equal to phase 5's ({files} files, SHA-256, "
        f"{time.perf_counter() - t_cmp:.1f}s); e2e {e2e:.3f}s = "
        f"{n_tiles / e2e:.2f} tiles/s against phase 5's "
        f"{main_run['e2e_s']:.3f}s = {main_run['tiles_per_s']:.2f} tiles/s "
        f"in this call; fuse_overwrite launches {launches}")
    for b, waited, wrote in zip(bands, stats['readback_wait'],
                                stats['write']):
        log(f"mesh (15b) band {b['band']} on {b['device']}: rows "
            f"{b['start']}-{b['start'] + b['rows']}, {b['launches']} "
            f"launches, fuse {b['fuse_ms']:.3f} ms on the card (CUDA "
            f"events), read-back wait {waited:.3f}s, write {wrote:.3f}s")
    log(f"mesh (15b): loads + uploads + launches {stats['fuse']:.3f}s, "
        f"writer close {stats['close']:.3f}s; peak device memory "
        + ", ".join(f"{d} {v / 2 ** 30:.3f} GiB" for d, v in peaks.items())
        + f" (a repeated device holds each of its bands); the whole canvas "
        f"{canvas_bytes / 2 ** 30:.3f} GiB, the peak of the host's live "
        f"pieces {peak_host / 2 ** 30:.3f} GiB")
    shutil.rmtree(out)
    return {'e2e_s': e2e, 'tiles_per_s': n_tiles / e2e,
            'launches': launches, 'peaks': peaks, 'height': height,
            'width': width, 'band_rows': stats['band_rows']}


#: one rank of phase 15c: joins the group, warms its card, then stitches
#: its work shard of the plate with stitch_distributed (argv: rank, ranks,
#: port, the parent's clock at the spawn, the config file)
RANK_SCRIPT = r"""
import json, sys, time
rank, ranks, port, t_spawn, cfg = (int(sys.argv[1]), int(sys.argv[2]),
                                   int(sys.argv[3]), float(sys.argv[4]),
                                   sys.argv[5])
import numpy as np, torch
from image_stitcher_tpu_torch import (CarriedState, EngineOptions,
                                      StitchingParameters)
from image_stitcher_tpu_torch.core.geometry import RegistrationShifts
from image_stitcher_tpu_torch.parallel import distributed as dist
c = dist.initialize(f"localhost:{port}", num_processes=ranks, process_id=rank)
torch.zeros(1, device=c.device)
if c.device.type == 'cuda':
    torch.cuda.synchronize(c.device)
startup = time.time() - t_spawn
with open(cfg) as f:
    cfg = json.load(f)
with np.load(cfg['flatfields']) as z:
    fields = {int(k): z[k] for k in z.files}
shifts = {k: tuple(v) if isinstance(v, list) else v
          for k, v in cfg['shifts'].items()}
state = CarriedState(flatfields=fields, shifts=RegistrationShifts(**shifts))
params = StitchingParameters(input_folder=cfg['acq'], **cfg['kw'])
opts = EngineOptions(output_folder=cfg['out'], **{
    k: tuple(v) if isinstance(v, list) else v for k, v in cfg['opts'].items()})
torch.distributed.barrier()
t0 = time.perf_counter()
pipe = dist.stitch_distributed(params, opts, state=state)
e2e = time.perf_counter() - t0
t = pipe.timers.as_dict()
print("RANK-RESULT " + json.dumps({
    "rank": rank, "startup_s": startup, "e2e_s": e2e,
    "units": len(pipe.saved_paths), "shard": list(pipe.options.work_shard),
    "barrier_s": t.get('shard_barrier', 0.0), "merge_s": t.get('merge', 0.0),
    "device": str(pipe.device), "backend": c.device_backend}), flush=True)
dist.shutdown()
"""


def sharded_plate(work: str, card: str, merges: dict, ranks: int = 2) -> dict:
    """15c: phase 10's plate (both timepoints, every well) in ``ranks``
    processes spawned together, one group on this host; each stitches
    its work shard, rank 0 runs both merges after the barrier. The tree
    is byte-equal to phase 10's uninterrupted one (its fields and shifts
    carried into every rank)."""
    import dataclasses
    import socket
    out = os.path.join(work, 'plate_sharded')
    fields = os.path.join(work, 'plate_fields.npz')
    np.savez(fields, **{str(k): v for k, v in merges['flatfields'].items()})
    opts = dataclasses.asdict(smoke_options(out, **merges['extra']))
    del opts['output_folder']
    cfg = os.path.join(work, 'plate_ranks.json')
    with open(cfg, 'w') as f:
        json.dump({'acq': merges['acq'], 'out': out, 'flatfields': fields,
                   'shifts': dataclasses.asdict(merges['shifts']),
                   'kw': merges['kw'], 'opts': opts}, f)
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    t_spawn = time.time()
    procs = [subprocess.Popen(
        [sys.executable, '-c', RANK_SCRIPT, str(r), str(ranks), str(port),
         repr(t_spawn), cfg], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, cwd=root)
        for r in range(ranks)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for r, (p, text) in enumerate(zip(procs, outs)):
        line = [x for x in text.splitlines() if x.startswith('RANK-RESULT ')]
        if p.returncode != 0 or not line:
            raise SystemExit(f"sharded plate (15c): rank {r} exited "
                             f"{p.returncode}:\n{text[-3000:]}")
        results.append(json.loads(line[-1].split(' ', 1)[1]))
        for x in text.splitlines():
            if x.startswith('distributed:'):
                log(f"sharded plate (15c) rank {r}: {x}")
    # every rank on a card; ranks that share a card pass device tensors
    # over gloo, ranks with a card each over NCCL
    backend = 'nccl' if torch.cuda.device_count() >= ranks else 'gloo'
    for r in results:
        if not r['device'].startswith('cuda:') or r['backend'] != backend:
            raise SystemExit(f"sharded plate (15c): rank {r['rank']} on "
                             f"{r['device']} over {r['backend']}, not a card "
                             f"over {backend}")
    units = 2 * len(MERGE_WELLS)
    share = sorted(units // ranks + (k < units % ranks) for k in range(ranks))
    if sorted(r['units'] for r in results) != share \
            or results[0]['merge_s'] <= 0 \
            or any(r['merge_s'] for r in results[1:]):
        raise SystemExit(f"sharded plate (15c): units or merges {results}")
    files = digests_equal(merges['digest'], tree_digest(out),
                          "sharded plate (15c) against phase 10's tree")
    e2e = max(r['e2e_s'] for r in results)
    log(f"sharded plate (15c) on {card}: {ranks} ranks on "
        f"{sorted({r['device'] for r in results})}, device tensors over "
        f"{results[0]['backend']}; tree byte-equal to phase 10's "
        f"uninterrupted one ({files} files); e2e {e2e:.3f}s (the slower "
        f"rank, from a barrier after start-up) against phase 10's "
        f"single-process {merges['e2e_whole_s']:.3f}s in this call")
    for r in results:
        log(f"sharded plate (15c) rank {r['rank']}: shard {r['shard']}, "
            f"{r['units']} units, start-up {r['startup_s']:.3f}s (spawn, "
            f"imports, the group, the card), e2e {r['e2e_s']:.3f}s, barrier "
            f"wait {r['barrier_s']:.3f}s, merges {r['merge_s']:.3f}s")
    shutil.rmtree(out)
    return {'e2e_s': e2e, 'ranks': results}


def phase_mesh(work: str, card: str, main_run: dict, merges: dict) -> dict:
    """15: the mesh and the work shards on the card (run after phase 10,
    on the acquisitions and trees of phases 5 and 10)."""
    t_phase = time.perf_counter()
    devices = mesh_devices()
    run = mesh_main_path(work, card, devices, main_run)
    sharded_check(card, devices, run['height'], run['width'], run['band_rows'])
    if torch.cuda.device_count() >= 2:
        # one process a card: device tensors over NCCL
        from image_stitcher_tpu_torch.parallel import distributed
        t0 = time.perf_counter()
        distributed.run_localhost_validation(
            num_processes=torch.cuda.device_count(), devices_per_process=1,
            timeout=300, platform='cuda')
        log(f"mesh (15a): the localhost validation over "
            f"{torch.cuda.device_count()} processes, one card each, passed "
            f"in {time.perf_counter() - t0:.1f}s")
    plate = sharded_plate(work, card, merges)
    banned = [m for m in BANNED if m in sys.modules]
    if banned:
        raise SystemExit(f"mesh: loaded {banned}")
    if torch.cuda.current_device() != 0:
        raise SystemExit("mesh: a launch left another card current")
    log(f"mesh: phase 15 in {time.perf_counter() - t_phase:.1f}s")
    return {'run': run, 'plate': plate}


# ------------------------------------------------------------------ main

# -------------------------------------------------------------------- 16

def zero_chunks_absent(root: str, what: str):
    """In every level array of a raw zarr v2 tree under ``root``, a chunk
    file is there exactly when its decoded block is not all zero (the
    tensorstore rule for chunks over several planes), each chunk row
    read on a thread pool; returns (chunks stored, chunks absent)."""
    from image_stitcher_tpu_torch.io.zarr_store import open_array
    from image_stitcher_tpu_torch.params import _available_cpus
    tasks = []
    for d, _, names in os.walk(root):
        if '.zarray' not in names:
            continue
        arr = open_array(d)
        ct, cc, cz, cy, cx = arr.chunks
        for key in np.ndindex(*(-(-n // k) for n, k in
                                zip(arr.shape[:4], arr.chunks[:4]))):
            tasks.append((d, arr, key))

    def check(task):
        d, arr, (ti, ci, zi, yi) = task
        ct, cc, cz, cy, cx = arr.chunks
        band = arr[ti * ct:(ti + 1) * ct, ci * cc:(ci + 1) * cc,
                   zi * cz:(zi + 1) * cz, yi * cy:(yi + 1) * cy]
        out = [0, 0]
        for xi in range(-(-arr.shape[4] // cx)):
            full = bool(band[..., xi * cx:(xi + 1) * cx].any())
            there = os.path.exists(os.path.join(
                d, str(ti), str(ci), str(zi), str(yi), str(xi)))
            if full != there:
                return f"{d} chunk {(ti, ci, zi, yi, xi)}: stored {there}, " \
                    f"not all zero {full}"
            out[not there] += 1
        return out

    stored = absent = 0
    with ThreadPoolExecutor(_available_cpus()) as pool:
        for res in pool.map(check, tasks):
            if isinstance(res, str):
                raise SystemExit(f"{what}: {res}")
            stored, absent = stored + res[0], absent + res[1]
    return stored, absent


def chunk_options(out: str, chunks, **extra):
    """Phase 5's options (``smoke_options``) with ``chunks`` and the
    compressor ``extra`` names (raw unless it names one)."""
    from image_stitcher_tpu_torch import EngineOptions
    extra.setdefault('compressor_cname', None)
    return EngineOptions(fusion_batch=10, reader_threads=8,
                         output_folder=out, chunks=chunks, **extra)


def phase_chunks(work: str, card: str, main_run: dict, tile: int = TILE,
                 device: str = 'cuda') -> dict:
    """16: chunks over several planes. (a) Phase 5's acquisition and
    options with chunks (1, 3, 1, 2048, 2048), raw, on the band path: its
    levels decoded equal to phase 5's tree, and every chunk that is all
    zero absent (the registered canvas's tile-less foot); e2e, tiles/s,
    the writer's seconds, the chunk-row buffer's peak host bytes. (b) The
    same on the mesh (1, n), its tree byte-equal to (a)'s. (c) A 3x3 x 3
    channel x Z=3 acquisition with chunks (1, 1, 2, 2048, 2048) in lz4 on
    the band path, in RAM and through the host fuser: byte-equal trees,
    decoded equal to a (1, 1, 1) run. (d) A 2-well, 2-timepoint plate
    merged (the complete plate) with chunks (2, 3, 1, 2048, 2048) in lz4,
    decoded equal to its (1, 1, 1) twin."""
    from image_stitcher_tpu_torch import CarriedState, stitch
    from image_stitcher_tpu_torch.ops import cuda_fuse
    dev = torch.device(device)
    on_cuda = dev.type == 'cuda'
    overlap = 205 * tile // TILE
    skip = ('.stitch_manifest.json', 'flatfields.npz')
    whole = (tile, tile)
    zarr_of = lambda out: os.path.join(out, '0_stitched',     # noqa: E731
                                       'A1_stitched.ome.zarr')
    res = {}

    # 16a: the main path, a chunk the three channels deep
    out = os.path.join(work, 'chunks_a')
    cuda_fuse.fuse_overwrite.launches = 0
    t0 = time.perf_counter()
    pipe = stitch(main_run['acq'], use_registration=True,
                  apply_flatfield=True, device=dev,
                  options=chunk_options(out, (1, 3, 1) + whole))
    e2e = time.perf_counter() - t0
    launches = cuda_fuse.fuse_overwrite.launches
    stats = pipe.fuse_stats['A1_t0']
    n_tiles = len(pipe._build_jobs(0, 'A1'))
    if not stats['batches'] or launches != (stats['batches'] if on_cuda
                                            else 0):
        raise SystemExit(f"chunks (16a): {launches} launches for "
                         f"{stats['batches']} batches")
    t1 = time.perf_counter()
    arrays = compare_trees_banded(zarr_of(main_run['out']), zarr_of(out),
                                  "chunks (16a) against phase 5's tree",
                                  arrays_only=True)
    stored, absent = zero_chunks_absent(zarr_of(out), "chunks (16a)")
    if not absent:
        raise SystemExit("chunks (16a): no all-zero chunk, though the "
                         "registered canvas's foot holds no tile")
    digest = tree_digest(out)
    writer_s = stats['write'] + stats['close']
    res['a'] = dict(e2e_s=e2e, tiles_per_s=n_tiles / e2e, writer_s=writer_s,
                    peak_buffer_bytes=stats['peak_buffer_bytes'])
    log(f"chunks (16a) on {card}: chunks (1, 3, 1, {tile}, {tile}) raw on "
        f"the band path: e2e {e2e:.3f}s = {n_tiles / e2e:.2f} tiles/s "
        f"(phase 5: {main_run['e2e_s']:.3f}s in this call); fuse "
        f"{stats['fuse']:.3f}s, writer {stats['write']:.3f}s + close "
        f"{stats['close']:.3f}s; the chunk-row buffer's peak "
        f"{stats['peak_buffer_bytes'] / 2 ** 20:.1f} MiB; {launches} "
        f"launches; {arrays} levels decoded equal to phase 5's tree; "
        f"{stored} chunks stored, {absent} all-zero chunks absent "
        f"(checked in {time.perf_counter() - t1:.1f}s)")
    shutil.rmtree(out)

    # 16b: the same on the mesh
    devices = mesh_devices() if on_cuda else [dev] * 2
    out = os.path.join(work, 'chunks_b')
    t0 = time.perf_counter()
    pipe = stitch(main_run['acq'], use_registration=True,
                  apply_flatfield=True, device=devices,
                  options=chunk_options(out, (1, 3, 1) + whole,
                                        mesh_shape=(1, len(devices))))
    e2e = time.perf_counter() - t0
    stats = pipe.fuse_stats['A1_t0']
    files = digests_equal(digest, tree_digest(out),
                          "chunks (16b, mesh) against 16a")
    res['b'] = dict(e2e_s=e2e, peak_buffer_bytes=stats['peak_buffer_bytes'],
                    peak_host_bytes=stats['peak_host_bytes'])
    log(f"chunks (16b) on {card}: the mesh (1, {len(devices)}) over "
        f"{[str(d) for d in devices]}: tree byte-equal to 16a's ({files} "
        f"files, SHA-256); e2e {e2e:.3f}s = {n_tiles / e2e:.2f} tiles/s; "
        f"host pieces' peak {stats['peak_host_bytes'] / 2 ** 30:.3f} GiB, "
        f"the chunk-row buffer's {stats['peak_buffer_bytes'] / 2 ** 20:.1f}"
        f" MiB")
    shutil.rmtree(out)

    # 16c: z planes two a chunk, on three paths, in lz4
    acq = os.path.join(work, 'chunks_z3')
    write_acquisition(acq, 3, tile, overlap, seed=61, num_z=3)
    runs, state = {}, None
    for name, key, extra in (
            ('band', 'band', dict(streaming='on')),
            ('in RAM', 'inram', dict(streaming='off')),
            ('host', 'host', dict(streaming='on', fusion_device='host')),
            ('(1, 1, 1) twin', 'twin', dict(streaming='on'))):
        chunks = ((1, 1, 1) if key == 'twin' else (1, 1, 2)) + whole
        out = os.path.join(work, 'chunks_c_' + key)
        cuda_fuse.fuse_overwrite.launches = 0
        t0 = time.perf_counter()
        pipe = stitch(acq, use_registration=True, apply_flatfield=True,
                      device=dev, state=state, options=chunk_options(
                          out, chunks, compressor_cname='lz4', **extra))
        e2e = time.perf_counter() - t0
        state = state or CarriedState(flatfields=pipe.flatfields,
                                      shifts=pipe.shifts)
        launches = cuda_fuse.fuse_overwrite.launches
        if on_cuda and (key == 'host') != (launches == 0):
            raise SystemExit(f"chunks (16c, {name}): {launches} launches")
        peak = pipe.fuse_stats.get('A1_t0', {}).get('peak_buffer_bytes')
        runs[name] = (out, e2e)
        log(f"chunks (16c) on {card}: 3x3 x {len(CHANNELS)} ch x 3 z "
            f"{tile}^2, chunks {chunks} lz4, {name}: e2e {e2e:.3f}s = "
            f"{81 / e2e:.2f} tiles/s, {launches} launches"
            + (f", the chunk-row buffer's peak {peak / 2 ** 20:.1f} MiB"
               if peak is not None else ""))
    band = runs['band'][0]
    nbytes = 0
    for name in ('in RAM', 'host'):
        nbytes = files_equal(band, runs[name][0],
                             f"chunks (16c, {name} against the band path)",
                             skip=skip)
    arrays = compare_trees_banded(zarr_of(runs['(1, 1, 1) twin'][0]),
                                  zarr_of(band), "chunks (16c, against the "
                                  "(1, 1, 1) twin)", arrays_only=True)
    log(f"chunks (16c): band path, in RAM and host fuser trees byte-equal "
        f"({nbytes} bytes); {arrays} levels decoded equal to the (1, 1, 1) "
        f"twin's")
    res['c'] = {name: e2e for name, (_, e2e) in runs.items()}
    for out, _ in runs.values():
        shutil.rmtree(out)
    shutil.rmtree(acq)

    # 16d: a plate merged with two timepoints a chunk
    acq = os.path.join(work, 'chunks_plate')
    write_acquisition(acq, 3, tile, overlap, seed=71, regions=('A1', 'B1'),
                      timepoints=2)
    plates = {}
    for chunks in ((2, 3, 1) + whole, (1, 1, 1) + whole):
        out = os.path.join(work, f'chunks_d_{chunks[0]}')
        t0 = time.perf_counter()
        pipe = stitch(acq, use_registration=True, apply_flatfield=True,
                      merge_timepoints=True, merge_hcs_regions=True,
                      device=dev, options=chunk_options(
                          out, chunks, compressor_cname='lz4'))
        e2e = time.perf_counter() - t0
        merge_s = pipe.timers.as_dict().get('merge', 0.0)
        plates[chunks[0]] = out
        log(f"chunks (16d) on {card}: 2 wells x 2 timepoints x 3x3 x "
            f"{len(CHANNELS)} ch {tile}^2, chunks {chunks} lz4, the "
            f"complete plate: e2e {e2e:.3f}s, merge {merge_s:.3f}s ("
            + merge_split(pipe.merge_stats.as_dict()) + ")")
        res.setdefault('d', {})[chunks[0]] = (e2e, merge_s)
    plate = os.path.join('hcs_timepoints', 'complete_hcs.ome.zarr')
    arrays = compare_trees_banded(os.path.join(plates[1], plate),
                                  os.path.join(plates[2], plate),
                                  "chunks (16d, against the (1, 1, 1) twin)",
                                  arrays_only=True)
    log(f"chunks (16d): the complete plate's {arrays} arrays decoded equal "
        f"to the (1, 1, 1) twin's")
    for out in plates.values():
        shutil.rmtree(out)
    shutil.rmtree(acq)
    banned = [m for m in BANNED if m in sys.modules]
    if banned:
        raise SystemExit(f"chunks: loaded {banned}")
    return res


# -------------------------------------------------------------------- 17

def retype_acquisition(src: str, dst: str, dtype) -> int:
    """Phase 5's acquisition at ``src`` (uncompressed uint16 tiles) with
    every tile rewritten as ``dtype`` holding the same values, through the
    port's ``io/fast_tiff.py::write_tiff_fast``, on a thread pool; the
    coordinates and parameters copied. Returns the tiles written."""
    from image_stitcher_tpu_torch.io.acquisition import read_image
    from image_stitcher_tpu_torch.io.fast_tiff import write_tiff_fast
    jobs = []
    for dirpath, _, names in os.walk(src):
        out_dir = os.path.join(dst, os.path.relpath(dirpath, src))
        os.makedirs(out_dir, exist_ok=True)
        for name in names:
            if name.endswith('.tiff'):
                jobs.append((os.path.join(dirpath, name),
                             os.path.join(out_dir, name)))
            else:
                shutil.copy(os.path.join(dirpath, name), out_dir)

    def rewrite(job):
        write_tiff_fast(job[1], read_image(job[0]).astype(dtype))

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(rewrite, jobs))
    return len(jobs)


def card_and_cpu(acq: str, work: str, label: str, quality: bool = False,
                 **extra) -> int:
    """One acquisition stitched on the card and on the CPU (the card
    run's fields, shifts and positions carried into the CPU run): their
    trees decode equal and the card run launched its path's kernels.
    Returns the card run's launches of each of the path's kernels."""
    from image_stitcher_tpu_torch import CarriedState, stitch
    from image_stitcher_tpu_torch.ops import cuda_fuse
    counted = ((cuda_fuse.fuse_feather, cuda_fuse.finalize_feather)
               if quality else (cuda_fuse.fuse_overwrite,))
    trees, state, launches = [], None, []
    for dev in ('cuda', 'cpu'):
        for fn in counted:
            fn.launches = 0
        out = os.path.join(work, f'{label}_{dev}')
        t0 = time.perf_counter()
        pipe = stitch(acq, use_registration=True, apply_flatfield=True,
                      device=torch.device(dev), state=state,
                      options=smoke_options(out, quality, **extra))
        seconds = time.perf_counter() - t0
        if dev == 'cuda':
            launches = [fn.launches for fn in counted]
            if min(launches) == 0:
                raise SystemExit(f"sample types ({label}): the card run "
                                 f"launched {launches}")
            state = CarriedState(
                flatfields=pipe.flatfields, shifts=pipe.shifts,
                global_positions=pipe.global_positions,
                global_positions_float=pipe.global_positions_float)
            card_s = seconds
        trees.append(read_tree(out))
        shutil.rmtree(out)
    a, b = trees
    if sorted(a) != sorted(b) or any(
            not (np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray)
                 else a[k] == b[k]) for k in a):
        raise SystemExit(f"sample types ({label}): the card's tree differs "
                         f"from the CPU's")
    dtypes = {v.dtype.str for v in a.values() if isinstance(v, np.ndarray)}
    log(f"sample types ({label}): card {card_s:.2f}s, CPU {seconds:.2f}s, "
        f"trees equal ({sorted(dtypes)}), launches "
        f"{dict(zip((fn.__name__ for fn in counted), launches))}")
    return launches


def kept_tiff_check():
    """17d: the tiles of every sample type kept in
    ``tests/torch_tiff_samples.npz`` (OpenCV's, and float16 files of every
    layout the JAX package reads, whose pixels imageio gave) decoded by
    the C decoders to those pixels (their SHA-256), and by the plain
    versions to the same bytes. Returns (files, float16 files)."""
    from image_stitcher_tpu_torch.io.tiff import decode_tiff
    tile_files()      # puts tests/ on the path
    import torch_tiff_samples
    kept = torch_tiff_samples.load()
    names = [c[0] for c in torch_tiff_samples.cases()]
    for name in names:
        got = decode_tiff(kept[name])
        if torch_tiff_samples.pixel_digest(got) != str(kept[name + ':sha256']):
            raise SystemExit(f"sample types (17d): {name} does not decode to "
                             f"its kept pixels")
        if decode_tiff(kept[name], plain=True).tobytes() != got.tobytes():
            raise SystemExit(f"sample types (17d): {name}: the plain "
                             f"decoders differ from the C ones")
    return len(names), sum(name.startswith('float16') for name in names)


def cut_acquisition(src: str, dst: str, keep: int, channels,
                    encode) -> int:
    """The top-left ``keep`` x ``keep`` FOVs of the square grid at ``src``
    (one region and timepoint, as phase 5 writes it) in ``channels``,
    renumbered row by row, each tile rewritten as the file bytes
    ``encode(pixels)`` on a thread pool; coordinates.csv cut to them, the
    parameters with Nx = Ny = ``keep``. Returns the tiles written."""
    import csv
    from image_stitcher_tpu_torch.io.acquisition import read_image
    with open(os.path.join(src, 'acquisition parameters.json')) as f:
        params = json.load(f)
    grid = int(params['Nx'])
    os.makedirs(os.path.join(dst, '0'))
    with open(os.path.join(dst, 'acquisition parameters.json'), 'w') as f:
        json.dump(dict(params, Nx=keep, Ny=keep), f, indent=2)
    renumber = {r * grid + c: r * keep + c
                for r in range(keep) for c in range(keep)}
    with open(os.path.join(src, '0', 'coordinates.csv'), newline='') as f:
        rows = list(csv.DictReader(f))
    with open(os.path.join(dst, '0', 'coordinates.csv'), 'w',
              newline='') as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(dict(row, fov=renumber[int(row['fov'])]) for row in rows
                    if int(row['fov']) in renumber)
    suffixes = tuple(f"_{ch.replace(' ', '_')}.tiff" for ch in channels)
    jobs = []
    for name in sorted(os.listdir(os.path.join(src, '0'))):
        if not name.endswith(suffixes):
            continue
        region, fov, rest = name.split('_', 2)
        if int(fov) in renumber:
            jobs.append((os.path.join(src, '0', name),
                         os.path.join(dst, '0', f"{region}_"
                                      f"{renumber[int(fov)]}_{rest}")))

    def rewrite(job):
        data = encode(read_image(job[0]))
        with open(job[1], 'wb') as f:
            f.write(data)

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(rewrite, jobs))
    return len(jobs)


#: 17e: (label, engine options, the kernels the card run must launch,
#: whether the files are compared by decoded pages)
FLOAT16_CASES = (
    ('bands with the field', dict(streaming='on'), ('fuse_overwrite',),
     False),
    ('in RAM, feathered', dict(streaming='off', blend_method='feather'),
     ('fuse_feather', 'finalize_feather'), False),
    # the host band fuser lays its tiles' data out in the order its band
    # threads finish (as the JAX package's does): pages compared decoded
    ('host-fused bands', dict(streaming='on', fusion_device='host'), (),
     True))


def float16_paths(work: str, card: str, main_run: dict, keep: int = 4,
                  channels=CHANNELS[:1]) -> dict:
    """17e: float16 tiles, which the JAX package stitches to ``.ome.tiff``
    only. A ``keep`` x ``keep`` cut of phase 5's acquisition in
    ``channels`` (cut for the script's time), its values / 16 rewritten
    as float16 deflate + Predictor 3 TIFFs in 256-row strips, stitched to
    deflate ``.ome.tiff`` with registration and the field through each
    path of :data:`FLOAT16_CASES` on the card and on the CPU (the card
    run's fields and shifts carried): the files byte-equal, or on the
    host band path every page, description and SubIFD level equal bit
    for bit; page 0 float16 and finite. Returns the card runs' launches
    of each kernel, counted from 0 just before the run that uses it."""
    from image_stitcher_tpu_torch import CarriedState, stitch
    from image_stitcher_tpu_torch.io.tiff import read_pages
    from image_stitcher_tpu_torch.ops import cuda_fuse
    tf = tile_files()
    kernels = {fn.__name__: fn for fn in (cuda_fuse.fuse_overwrite,
                                          cuda_fuse.fuse_feather,
                                          cuda_fuse.finalize_feather)}
    acq = os.path.join(work, f'f16_{keep}x{keep}')
    t0 = time.perf_counter()
    n_files = cut_acquisition(
        main_run['acq'], acq, keep, channels,
        lambda img: tf.tiff_bytes((img.astype(np.float32) / np.float32(16))
                                  .astype(np.float16), 8, 3,
                                  rows_per_strip=256))
    log(f"sample types (17e): cut phase 5's grid to {keep}x{keep} x "
        f"{len(channels)} channel(s), {n_files} tiles rewritten as float16 "
        f"deflate + Predictor 3 in {time.perf_counter() - t0:.1f}s")
    launches = {}
    for label, extra, used, decoded in FLOAT16_CASES:
        outs, state, secs = {}, None, {}
        for run in ('cuda', 'cpu'):
            for fn in kernels.values():
                fn.launches = 0
            out = outs[run] = os.path.join(work, f'f16_{run}')
            t0 = time.perf_counter()
            pipe = stitch(acq, output_format='.ome.tiff',
                          use_registration=True, apply_flatfield=True,
                          device=torch.device(run), state=state,
                          options=smoke_options(out, **extra))
            secs[run] = time.perf_counter() - t0
            if run == 'cuda':
                counts = {name: fn.launches for name, fn in kernels.items()}
                if (any(counts[name] == 0 for name in used)
                        or (not used and any(counts.values()))):
                    raise SystemExit(f"sample types (17e, {label}): the card "
                                     f"run launched {counts}")
                launches.update((name, counts[name]) for name in used)
                state = CarriedState(flatfields=pipe.flatfields,
                                     shifts=pipe.shifts)
        files = []
        for run in ('cuda', 'cpu'):
            with open(tiff_file(outs[run]), 'rb') as f:
                files.append(f.read())
        pages = [read_pages(data) for data in files]
        first = pages[0][0][1][0]
        if (first.dtype != np.float16 or not first.any()
                or not np.isfinite(first).all()):
            raise SystemExit(f"sample types (17e, {label}): page 0 is "
                             f"{first.dtype}, finite "
                             f"{bool(np.isfinite(first).all())}")
        if decoded:
            same = len(pages[0]) == len(pages[1]) and all(
                da == db and len(la) == len(lb) and all(
                    a.shape == b.shape and np.array_equal(
                        a.view(np.uint16), b.view(np.uint16))
                    for a, b in zip(la, lb))
                for (da, la), (db, lb) in zip(*pages))
        else:
            same = files[0] == files[1]
        if not same:
            raise SystemExit(f"sample types (17e, {label}): the card's file "
                             f"differs from the CPU's")
        log(f"sample types (17e, float16 .ome.tiff, {label}): card "
            f"{secs['cuda']:.3f}s, CPU {secs['cpu']:.3f}s, files "
            f"{'decoded' if decoded else 'byte'}-equal ({len(files[0])} "
            f"bytes, {len(pages[0])} pages, level 0 {first.shape} "
            f"{first.dtype}); launches "
            f"{ {name: launches[name] for name in used} }")
        for out in outs.values():
            shutil.rmtree(out)
    shutil.rmtree(acq)
    return launches


def phase_sample_types(work: str, card: str, main_run: dict,
                       tile: int = TILE, small: int = 4) -> dict:
    """17: tiles of other sample types. (a) Phase 5's kept acquisition
    rewritten as uncompressed float32 TIFFs of the same values (300
    tiles, 4.8 GB) stitched with phase 5's options: the levels '<f4',
    the OMERO window 0..1, channel 0 at full size equal to the NumPy
    reference (u16 values * ff_recip in f32, nothing truncated); e2e and
    tiles/s against phase 5's. Then without the field: the float32 tree
    decoded equal to a uint16 run's (no field) cast to float32. (b) int16
    tiles (``small`` x ``small``, one channel, values below and above 0)
    in RAM and in bands, and (c) the feathered maximum-quality path in
    float32 (``small`` x ``small``, one channel, +-3 px jitter), each
    card tree equal to a CPU run's. (d) :func:`kept_tiff_check`. (e)
    :func:`float16_paths`, whose card runs' launches it returns under
    'f16_launches'."""
    from image_stitcher_tpu_torch import stitch
    from image_stitcher_tpu_torch.io.zarr_store import open_array
    from image_stitcher_tpu_torch.ops import cuda_fuse
    t_phase = time.perf_counter()
    res = {}
    zarr_of = lambda out: os.path.join(out, '0_stitched',     # noqa: E731
                                       'A1_stitched.ome.zarr')

    # 17a: the main path in float32
    acq = os.path.join(work, 'main_f32')
    t0 = time.perf_counter()
    n_files = retype_acquisition(main_run['acq'], acq, np.float32)
    log(f"sample types (17a): rewrote phase 5's {n_files} tiles as float32 "
        f"in {time.perf_counter() - t0:.1f}s")
    out = os.path.join(work, 'f32_out')
    cuda_fuse.fuse_overwrite.launches = 0
    t0 = time.perf_counter()
    pipe = stitch(acq, use_registration=True, apply_flatfield=True,
                  device=torch.device('cuda'), options=smoke_options(out))
    e2e = time.perf_counter() - t0
    launches = cuda_fuse.fuse_overwrite.launches
    stats = pipe.fuse_stats['A1_t0']
    if launches == 0 or launches != stats['batches']:
        raise SystemExit(f"sample types (17a): {launches} launches for "
                         f"{stats['batches']} batches")
    zarr = zarr_of(out)
    for lv in range(pipe.num_pyramid_levels):
        with open(os.path.join(zarr, str(lv), '.zarray')) as f:
            if json.load(f)['dtype'] != '<f4':
                raise SystemExit(f"sample types (17a): level {lv} is not <f4")
    with open(os.path.join(zarr, '.zattrs')) as f:
        windows = [c['window'] for c in json.load(f)['omero']['channels']]
    if any((w['min'], w['max'], w['start'], w['end']) != (0, 1, 0, 1)
           for w in windows):
        raise SystemExit(f"sample types (17a): OMERO windows {windows}")
    width, height = pipe._region_dimensions(0, 'A1')
    t1 = time.perf_counter()
    level0 = open_array(os.path.join(zarr, '0'))[0, 0, 0]
    # from phase 5's uint16 tiles: not through the float32 write and read
    ref = reference_plane(pipe, None, None, 0, height, width,
                          dtype=np.float32, copy=(acq, main_run['acq']))
    if not np.array_equal(level0, ref):
        raise SystemExit(f"sample types (17a): channel 0 level 0 differs "
                         f"from the NumPy reference in "
                         f"{int((level0 != ref).sum())} pixels")
    fractions = float(np.mean(ref != np.trunc(ref)))
    del level0, ref
    n_tiles = len(pipe._build_jobs(0, 'A1'))
    res['a'] = dict(e2e_s=e2e, tiles_per_s=n_tiles / e2e)
    log(f"sample types (17a) on {card}: float32 main path e2e {e2e:.3f}s "
        f"= {n_tiles / e2e:.2f} tiles/s (phase 5's uint16: "
        f"{main_run['e2e_s']:.3f}s in this call); fuse {stats['fuse']:.3f}s "
        f"readback_wait {stats['readback_wait']:.3f}s write "
        f"{stats['write']:.3f}s; {launches} launches; levels <f4, OMERO "
        f"window 0..1; channel 0 level 0 equals the NumPy reference "
        f"({fractions:.1%} of its pixels not whole; checked in "
        f"{time.perf_counter() - t1:.1f}s)")
    shutil.rmtree(out)
    outs = {}
    for name, src in (('u16', main_run['acq']), ('f32', acq)):
        outs[name] = os.path.join(work, f'{name}_noff')
        t0 = time.perf_counter()
        stitch(src, use_registration=True, device=torch.device('cuda'),
               options=smoke_options(outs[name]))
        res[f'noff_{name}_s'] = time.perf_counter() - t0
    arrays = compare_trees_banded(zarr_of(outs['u16']), zarr_of(outs['f32']),
                                  "sample types (17a) without the field",
                                  arrays_only=True)
    log(f"sample types (17a): without the field the float32 tree "
        f"({res['noff_f32_s']:.3f}s) decodes equal to the uint16 tree "
        f"({res['noff_u16_s']:.3f}s) cast to float32 ({arrays} levels)")
    for path in (acq, *outs.values()):
        shutil.rmtree(path)

    # 17b, 17c: int16 in RAM and in bands, the float32 quality path
    overlap = 205 * tile // TILE
    acq = os.path.join(work, f'i16_{small}x{small}')
    write_acquisition(acq, small, tile, overlap, seed=21,
                      channels=CHANNELS[:1], dtype=np.int16,
                      texture=lambda rng, side: (rng.integers(
                          -20000, 20000, (side, side))).astype(np.int16))
    for streaming in ('off', 'on'):
        card_and_cpu(acq, work, f'17b int16 streaming={streaming}',
                     streaming=streaming)
    shutil.rmtree(acq)
    acq = os.path.join(work, f'f32q_{small}x{small}')
    write_acquisition(acq, small, tile, overlap, seed=22, jitter=3,
                      channels=CHANNELS[:1], dtype=np.float32,
                      texture=lambda rng, side: rng.uniform(
                          100.0, 900.0, (side, side)).astype(np.float32))
    card_and_cpu(acq, work, '17c float32 quality', quality=True)
    shutil.rmtree(acq)

    # 17d: OpenCV's tiles of every sample type, imageio's float16 ones
    t0 = time.perf_counter()
    n, n_half = kept_tiff_check()
    log(f"sample types (17d): {n - n_half} OpenCV-written LZW/deflate, "
        f"Predictor 2/3 TIFFs of every sample type decode to OpenCV's "
        f"pixels (C) and the same bytes (plain), and {n_half} float16 "
        f"TIFFs of every layout the JAX package reads to imageio's, in "
        f"{time.perf_counter() - t0:.1f}s")

    # 17e: float16 to .ome.tiff on three paths
    res['f16_launches'] = float16_paths(work, card, main_run)
    res['seconds'] = time.perf_counter() - t_phase
    log(f"sample types: phase 17 in {res['seconds']:.1f}s")
    return res


# -------------------------------------------------------------------- 18

#: 18b's grids: (label, channel, the tile's file bytes from its texture
#: window, the pixels the JAX package reads from them, dtype)
LAYOUT_CHANNEL = "Fluorescence 488 nm Ex"


def bilevel_texture(rng, side: int) -> np.ndarray:
    """0/1 blobs: the brightest 30 % of a :func:`compressible` texture of
    an eighth of the side, each pixel an 8 x 8 block (~34 changes a 2048-
    pixel row: the Python CCITT encoder writes a tile in ~0.2 s)."""
    tex = compressible(rng, side // 8 + 1)
    blobs = (tex > np.percentile(tex, 70)).astype(np.uint8)
    return np.repeat(np.repeat(blobs, 8, 0), 8, 1)[:side, :side].copy()


def index_texture(rng, side: int, bits: int) -> np.ndarray:
    """Palette indices of ``bits`` bits with runs for BMP RLE: stripes of
    61 px over :func:`bilevel_texture`'s blobs, every 16th row noise (the
    encoder's absolute runs)."""
    x = np.arange(side)
    idx = ((x // 61)[None] + 5 * bilevel_texture(rng, side)) % (1 << bits)
    idx[::16] = rng.integers(0, 1 << bits, (len(idx[::16]), side))
    return idx.astype(np.uint8)


def layout_grids(tf, cmap: np.ndarray):
    """18b: (label, texture, encode, twin, channel) of the three grids:
    G4 bilevel (MinIsWhite: a 1 bit reads 0, a 0 bit 255), an 8-bit LZW
    palette (read as RGB through the 16-bit ColorMap's high bytes) and
    12-bit LZW (read scaled to 16 bits). ``twin`` writes the pixels the
    JAX package reads from ``encode``'s file as an uncompressed TIFF."""
    rgb = (cmap >> 8).astype(np.uint8).T
    literals = tf.lzw_encode_literals      # Python's LZW is too slow there
    return (
        ('g4-bilevel', bilevel_texture,
         lambda b: tf.tiff_bytes(b, 4, bits=1, photometric=0,
                                 rows_per_strip=256),
         lambda b: tf.tiff_bytes(np.where(b == 1, 0, 255).astype(np.uint8)),
         LAYOUT_CHANNEL),
        ('lzw-palette', lambda r, side: (compressible(r, side) >> 8).astype(
            np.uint8),
         lambda b: tf.tiff_bytes(b, 5, photometric=3, colormap=cmap,
                                 rows_per_strip=256, lzw=literals),
         lambda b: tf.tiff_bytes(rgb[b]), "BF LED matrix full"),
        ('lzw-12bit', lambda r, side: compressible(r, side) >> 4,
         lambda b: tf.tiff_bytes(b, 5, bits=12, rows_per_strip=256,
                                 lzw=literals),
         lambda b: tf.tiff_bytes(b << 4), LAYOUT_CHANNEL))


def layout_decoder_check(rng) -> dict:
    """18a: each C routine the rest of item 6 added against its plain
    version and the data it was made from, at 2048^2 (the plain CCITT and
    RLE decoders, which run in Python, on the first 64 rows of the same
    stream; old-style LZW, whose encoder runs in Python, on one 2048 x
    128 strip): CCITT Modified Huffman, T.4 1-D, T.4 2-D with fill bits
    and T.6; packed samples of 1, 2, 4, 10, 12 and 14 bits; the FillOrder
    2 bit reversal; BMP RLE8 and RLE4. Returns each C routine's output
    MB/s on one thread."""
    from image_stitcher_tpu_torch.io import tile_decode as td
    tf = tile_files()
    t0 = time.perf_counter()
    rates = {}

    def timed(name, fn, nbytes):
        t = time.perf_counter()
        out = fn()
        rates[name] = nbytes / 1e6 / (time.perf_counter() - t)
        return out

    window = 64
    bw = bilevel_texture(rng, TILE) ^ (rng.random((TILE, TILE)) < 0.01)
    for label, comp, opts in (('MH', 2, 0), ('T.4 1-D', 3, 0),
                              ('T.4 2-D, fill bits', 3, 5), ('T.6', 4, 0)):
        data = tf.ccitt_encode(bw, comp, opts)
        got = timed(f'CCITT {label} (C)', lambda: td.ccitt_decode(
            data, TILE, TILE, comp, opts), TILE * TILE // 8)
        if not np.array_equal(got, np.packbits(bw, axis=1)):
            raise SystemExit(f"tile layouts (18a): CCITT {label} (C) does "
                             f"not give its source")
        plain = td.ccitt_decode_plain(data, window, TILE, comp, opts)
        if plain.tobytes() != got[:window].tobytes():
            raise SystemExit(f"tile layouts (18a): CCITT {label}: plain "
                             f"differs from C")
    for bits in (1, 2, 4, 10, 12, 14):
        values = rng.integers(0, 1 << bits, (TILE, TILE))
        packed = tf.pack_samples(values, bits)
        got = timed(f'unpack {bits}-bit (C)', lambda: td.unpack_samples(
            packed, TILE, packed.shape[1], TILE, bits), values.size
            * (1 if bits <= 8 else 2))
        plain = td.unpack_samples_plain(packed, TILE, packed.shape[1], TILE,
                                        bits)
        if not np.array_equal(got, values) or \
                plain.tobytes() != got.tobytes():
            raise SystemExit(f"tile layouts (18a): {bits}-bit unpacking "
                             f"differs (C, plain, source)")
    raw = rng.integers(0, 256, 2 * TILE * TILE, dtype=np.uint8)
    got = timed('FillOrder 2 reversal (C)', lambda: td.reverse_bits(raw),
                raw.size)
    if got.tobytes() != td.reverse_bits_plain(raw).tobytes() or \
            td.reverse_bits(got).tobytes() != raw.tobytes():
        raise SystemExit("tile layouts (18a): bit reversal differs")
    strip = (compressible(rng, TILE)[:128] >> 8).astype(np.uint8).tobytes()
    old = tf.lzw_encode_old(strip)
    got = timed('old-style LZW (C)', lambda: td.lzw_decode(old, len(strip)),
                len(strip))
    cut = window * TILE
    if got.tobytes() != strip or td.lzw_decode_plain(
            old, cut).tobytes() != strip[:cut]:
        raise SystemExit("tile layouts (18a): old-style LZW differs")
    for bits in (8, 4):
        idx = index_texture(rng, TILE, bits)
        data = tf.rle_encode(idx, bits)
        got = timed(f'BMP RLE{bits} (C)', lambda: td.bmp_rle_decode(
            data, TILE, TILE, bits), idx.size)
        plain = td.bmp_rle_decode_plain(data, TILE, window, bits)
        if not np.array_equal(got[::-1], idx) or \
                plain.tobytes() != got[:window].tobytes():
            raise SystemExit(f"tile layouts (18a): RLE{bits} differs (C, "
                             f"plain, source)")
    log(f"tile layouts (18a): CCITT (MH, T.4 1-D, T.4 2-D with fill bits, "
        f"T.6), 1/2/4/10/12/14-bit unpacking, the bit reversal and RLE8/4 "
        f"at {TILE}^2 and old-style LZW on a {TILE}x128 strip give their "
        f"sources in C, the plain versions the same bytes (CCITT, RLE and "
        f"LZW on the first {window} rows), in "
        f"{time.perf_counter() - t0:.1f}s")
    return rates


def kept_layouts_check(work: str) -> int:
    """18a: every file of ``tests/torch_tiff_layouts.npz`` (one of each
    layout, with the SHA-256 of the JAX package's ``read_image`` array on
    the CPU test host) read by the port's ``read_image`` to that array,
    and decoded by the plain versions to the same bytes."""
    from image_stitcher_tpu_torch.io.acquisition import read_image
    from image_stitcher_tpu_torch.io.bmp import decode_bmp
    from image_stitcher_tpu_torch.io.tiff import decode_tiff
    tile_files()      # puts tests/ on the path
    import torch_tiff_layouts as layouts
    kept = layouts.load()
    for name in layouts.names():
        data = kept[name].tobytes()
        path = os.path.join(work, 'A1_0_0_layout' + layouts.suffix(name))
        with open(path, 'wb') as f:
            f.write(data)
        if layouts.digest(read_image(path)) != str(kept[name + ':sha256']):
            raise SystemExit(f"tile layouts (18a): {name} does not read to "
                             f"the JAX package's array")
        decode = decode_bmp if name in layouts.BMP_LAYOUTS else decode_tiff
        if decode(data, plain=True).tobytes() != decode(data).tobytes():
            raise SystemExit(f"tile layouts (18a): {name}: the plain "
                             f"decoders differ from the C ones")
        os.unlink(path)
    return len(layouts.names())


def layout_rates(tf, rng, card: str, cmap: np.ndarray) -> dict:
    """MB/s of pixels out of whole-tile reads (``decode_tiff``) of 18b's
    three layouts at 2048^2, on one thread, then on the 8-thread reader
    pool (16 tiles each)."""
    from image_stitcher_tpu_torch.io.tiff import decode_tiff
    rates = {}
    for label, texture, encode, _, _ in layout_grids(tf, cmap):
        data = encode(np.ascontiguousarray(texture(rng, TILE)))
        out = decode_tiff(data)
        n = 2 * READERS
        out_mb = n * out.nbytes / 1e6
        row = []
        for threads in (1, READERS):
            with ThreadPoolExecutor(threads) as pool:
                t0 = time.perf_counter()
                list(pool.map(lambda _: decode_tiff(data), range(n)))
                row.append(out_mb / (time.perf_counter() - t0))
        rates[label] = row
        log(f"tile layouts MB/s on {card}: {label} {TILE}^2 tiles "
            f"({len(data)} B a file, {out.dtype} {out.shape} out): "
            f"{row[0]:.0f} on one thread, {row[1]:.0f} on {READERS}")
    return rates


def phase_tile_layouts(work: str, card: str, grid: int = 4,
                       tile: int = TILE, device: str = 'cuda') -> dict:
    """18: the rest of item 6's tile input. (a) :func:`layout_decoder_check`
    and :func:`kept_layouts_check`; (b) three ``grid`` x ``grid`` x 1-
    channel grids of ``tile``^2 tiles stitched on the card through the
    main path (flatfield and registration off, overwrite, raw OME-Zarr):
    G4 bilevel, an 8-bit LZW palette (RGB, so three planes) and 12-bit
    LZW (uint16), each tree decoded equal to that of its uncompressed
    twin, whose tiles hold the pixels the JAX package reads, with the
    decode MB/s on one thread and eight and the launches."""
    t_phase = time.perf_counter()
    dev = torch.device(device)
    rng = np.random.default_rng(18)
    tf = tile_files()
    res = {'c_rates': layout_decoder_check(rng)}
    t0 = time.perf_counter()
    n = kept_layouts_check(work)
    log(f"tile layouts (18a): {n} kept files (tests/torch_tiff_layouts.npz)"
        f" read to the JAX package's arrays, the plain decoders to the same"
        f" bytes, in {time.perf_counter() - t0:.1f}s; C routines' MB/s on "
        f"one thread: " + ", ".join(f"{k} {v:.0f}"
                                    for k, v in res['c_rates'].items()))
    cmap = rng.integers(256, 65536, (3, 256))
    res['rates'] = layout_rates(tf, rng, card, cmap)

    overlap = 205 * tile // TILE
    res['runs'] = {}
    for label, texture, encode, twin, channel in layout_grids(tf, cmap):
        trees = {}
        for kind, write in (('twin', twin), ('file', encode)):
            acq = os.path.join(work, f'layout_{label}_{kind}')
            t0 = time.perf_counter()
            write_acquisition(acq, grid, tile, overlap, seed=19,
                              texture=texture, encode=write,
                              channels=[channel])
            written = time.perf_counter() - t0
            out = os.path.join(work, f'layout_out_{label}_{kind}')
            run = stitch_input(acq, out, dev, card, f'{label} {kind}',
                               use_registration=False,
                               apply_flatfield=False,
                               compressor_cname=None)
            run.pop('pipe')
            run['write_s'] = written
            trees[kind] = read_tree(out)
            shutil.rmtree(out)
            shutil.rmtree(acq)
            if kind == 'file':
                res['runs'][label] = run
        arrays = compare_trees(trees['twin'], trees['file'],
                               f'tile layouts ({label} vs its twin)')
        run = res['runs'][label]
        log(f"tile layouts (18b) on {card}: {grid}x{grid} {label} tree "
            f"decodes equal to its uncompressed twin's ({arrays} level "
            f"arrays); files written in {run['write_s']:.1f}s, e2e "
            f"{run['e2e_s']:.3f}s, {run['decodes']} decodes at "
            f"{run['decode_s'] / max(run['decodes'], 1) * 1e3:.1f} ms, "
            f"fuse_overwrite launches {run['launches']}")
        del trees
    banned = [m for m in BANNED if m in sys.modules]
    if banned:
        raise SystemExit(f"tile layouts: loaded {banned}")
    res['seconds'] = time.perf_counter() - t_phase
    log(f"tile layouts: phase 18 in {res['seconds']:.1f}s")
    return res


# --------------------------------------------------------------------- 19

def jpeg_formats():
    """``tests/torch_jpeg_coders.py`` (the lossless encoder, JPEG-in-TIFF
    files) and ``tests/torch_jpeg_formats.py`` (the kept files)."""
    tile_files()      # puts tests/ on the path
    import torch_jpeg_coders
    import torch_jpeg_formats
    return torch_jpeg_coders, torch_jpeg_formats


def kept_formats_check() -> int:
    """19a: every file of ``tests/torch_jpeg_formats.npz`` (lossless,
    arithmetic-coded, smoothed and JPEG-in-TIFF, each with the SHA-256 of
    the JAX package's ``read_image`` array on the CPU test host) decoded
    by the C codec to that array, and by the plain version (but the
    2048^2 tile) to the same bytes."""
    _, formats = jpeg_formats()
    from torch_jpeg_streams import pixel_digest
    kept = formats.load()
    for name, (data, digest) in kept.items():
        got = formats.decode(name, data)
        if pixel_digest(got) != digest:
            raise SystemExit(f"JPEG formats (19a): {name} does not decode "
                             f"to the JAX package's array")
        if not name.startswith('tile') and formats.decode(
                name, data, plain=True).tobytes() != got.tobytes():
            raise SystemExit(f"JPEG formats (19a): {name}: the plain "
                             f"version differs from the C codec")
    return len(kept)


def format_grids(coders, formats):
    """19b, c: (label, texture, encode, twin, channel) of the three
    grids: lossless 8-bit grey (predictor 1, a restart every 16 rows;
    the texture repeats with the grid's step, so every tile is one
    stream, encoded once: the NumPy encoder is slow on this host), the
    kept arithmetic-coded progressive RGB 4:2:0 tile with a restart
    interval at every position, and JPEG-in-TIFF YCbCr 2x2 in 256^2
    tiles with JPEGTables (the port's C encoder, q85). ``twin`` writes
    the pixels of ``encode``'s file as an uncompressed TIFF."""
    from image_stitcher_tpu_torch.io import jpeg
    from image_stitcher_tpu_torch.io.tiff import decode_tiff
    tf = tile_files()
    lock = threading.Lock()
    cache = {}

    def once(key, make):
        with lock:
            if key not in cache:
                cache[key] = make()
            return cache[key]

    def periodic(step):
        def texture(rng, side):
            base = (compressible(rng, step) >> 8).astype(np.uint8)
            reps = -(-side // step)
            return np.tile(base, (reps, reps))[:side, :side]
        return texture

    arith, _ = formats.load()['tile-ar-prog-420-rst']
    arith_px = jpeg.decode(arith)

    def ycc_tiff(b):
        return coders.jpeg_tiff(b, 6, 85, (2, 2), tile=(256, 256),
                                encode=jpeg.encode)

    def rgb(r, side):
        return np.zeros((side, side), np.uint8)

    def colour(r, side):
        p = (compressible(r, side) >> 8).astype(np.uint8)
        return np.stack([p, p[::-1], p[:, ::-1]], -1)

    return (
        ('lossless-grey', periodic,
         lambda b: once(('ll', b.tobytes()), lambda: coders.lossless(
             [b], 8, 1, restart=16 * b.shape[1])),
         lambda b: tf.tiff_bytes(b), LAYOUT_CHANNEL, 'jpg'),
        ('arith-prog-420-rst', lambda step: rgb,
         lambda b: arith, lambda b: tf.tiff_bytes(arith_px),
         "BF LED matrix full", 'jpg'),
        ('jpeg-tiff-ycc22', lambda step: colour,
         ycc_tiff, lambda b: tf.tiff_bytes(decode_tiff(ycc_tiff(b))),
         "BF LED matrix full", 'tiff'))


def format_rates(card: str, grids, grid: int, tile: int, overlap: int,
                 seed: int) -> dict:
    """MB/s of pixels out of whole-file decodes of each grid's first tile
    (``io/acquisition.py::_decode``, the readers' path), on one thread and
    on the 8-thread reader pool."""
    from image_stitcher_tpu_torch.io import acquisition
    rates = {}
    step = tile - overlap
    side = step * (grid - 1) + tile + 16
    for label, texture, encode, _, _, suffix in grids:
        gt = texture(step)(np.random.default_rng(seed), side)
        data = encode(np.ascontiguousarray(gt[8:8 + tile, 8:8 + tile]))
        path = f'A1_0_0_rate.{suffix}'
        out = acquisition._decode(data, path)[0]
        n = READERS
        out_mb = n * out.nbytes / 1e6
        row = []
        for threads in (1, READERS):
            with ThreadPoolExecutor(threads) as pool:
                t0 = time.perf_counter()
                list(pool.map(lambda _: acquisition._decode(data, path),
                              range(n)))
                row.append(out_mb / (time.perf_counter() - t0))
        rates[label] = row
        log(f"JPEG formats MB/s on {card}: {label} {tile}^2 tiles "
            f"({len(data)} B a file, {out.dtype} {out.shape} out): "
            f"{row[0]:.0f} on one thread, {row[1]:.0f} on {READERS}")
    return rates


def phase_jpeg_formats(work: str, card: str, grid: int = 4,
                       tile: int = TILE, device: str = 'cuda') -> dict:
    """19: the rest of JPEG tile input. (a) :func:`kept_formats_check`;
    (b) decode MB/s of each grid's format (:func:`format_rates`); (c)
    three ``grid`` x ``grid`` grids of ``tile``^2 tiles (lossless grey,
    arithmetic-coded progressive RGB 4:2:0 with restarts, JPEG-in-TIFF
    YCbCr 2x2 256^2 tiles with JPEGTables; :func:`format_grids`)
    stitched on the card through the main path with the flatfield
    (registration off, overwrite, raw OME-Zarr), each tree decoded equal
    to that of its uncompressed twin, whose tiles hold the pixels the
    port decodes (the kept files hold the JAX package's to 19a), with
    e2e and the launches."""
    t_phase = time.perf_counter()
    dev = torch.device(device)
    coders, formats = jpeg_formats()
    t0 = time.perf_counter()
    n = kept_formats_check()
    log(f"JPEG formats (19a): {n} kept files (tests/torch_jpeg_formats.npz)"
        f" decoded by the C codec to the JAX package's arrays, by the plain "
        f"version (but the {TILE}^2 tile) to the same bytes, in "
        f"{time.perf_counter() - t0:.1f}s")
    overlap = 205 * tile // TILE
    grids = format_grids(coders, formats)
    res = {'rates': format_rates(card, grids, grid, tile, overlap, 19),
           'runs': {}}
    for label, texture, encode, twin, channel, suffix in grids:
        trees = {}
        for kind, write, ext in (('twin', twin, 'tiff'),
                                 ('file', encode, suffix)):
            acq = os.path.join(work, f'format_{label}_{kind}')
            t0 = time.perf_counter()
            write_acquisition(acq, grid, tile, overlap, seed=19,
                              texture=texture(tile - overlap), encode=write,
                              suffix=ext, channels=[channel],
                              dtype=np.uint8)
            written = time.perf_counter() - t0
            out = os.path.join(work, f'format_out_{label}_{kind}')
            run = stitch_input(acq, out, dev, card, f'{label} {kind}',
                               use_registration=False, apply_flatfield=True,
                               compressor_cname=None)
            run.pop('pipe')
            run['write_s'] = written
            trees[kind] = read_tree(out)
            shutil.rmtree(out)
            shutil.rmtree(acq)
            if kind == 'file':
                res['runs'][label] = run
        arrays = compare_trees(trees['twin'], trees['file'],
                               f'JPEG formats ({label} vs its twin)')
        run = res['runs'][label]
        log(f"JPEG formats (19c) on {card}: {grid}x{grid} {label} tree "
            f"decodes equal to its uncompressed twin's ({arrays} level "
            f"arrays); files written in {run['write_s']:.1f}s, e2e "
            f"{run['e2e_s']:.3f}s, {run['decodes']} decodes at "
            f"{run['decode_s'] / max(run['decodes'], 1) * 1e3:.1f} ms, "
            f"fuse_overwrite launches {run['launches']}")
        del trees
    banned = [m for m in BANNED if m in sys.modules]
    if banned:
        raise SystemExit(f"JPEG formats: loaded {banned}")
    res['seconds'] = time.perf_counter() - t_phase
    log(f"JPEG formats: phase 19 in {res['seconds']:.1f}s")
    return res


def main() -> int:
    spent = {}

    def timed(name, phase, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return phase(*args, **kwargs)
        finally:
            spent[name] = round(time.perf_counter() - t0, 1)

    card = timed('1 environment', phase_environment)
    timed('2 build', phase_build)
    kern = timed('3 kernels', phase_kernels)
    work = tempfile.mkdtemp(prefix='chip_smoke_')
    # phase 5's acquisition, kept for phase 15
    keep = tempfile.mkdtemp(prefix='chip_smoke_keep_')
    try:
        timed('4 slice parity', phase_slice_parity, work)
        timed('4 slice parity, quality', phase_slice_parity, work,
              quality=True)
        main_run = timed('5 main path', phase_main_path, work, card,
                         keep=keep)
        quality_run = timed('6 quality path', phase_quality_path, work, card,
                            grid=8)
        shutil.rmtree(work, ignore_errors=True)   # the plate needs the room
        os.makedirs(work)
        timed('7 plate', phase_plate, work, card)
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        output_layer = timed('8 output layer', phase_output_layer, work, card)
        timed('12 other codecs', phase_other_codecs, work, card,
              output_layer)
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        tile_input = timed('9 tile input', phase_tile_input, work, card)
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        # 13c/13d and 11b/11c on 4x4 cuts of the main grid: the script's
        # time
        timed('13 jpeg', phase_jpeg, work, card, tile_input['rates'], grid=4)
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        merges = timed('10 merges', phase_merges, work, card)
        timed('15 mesh', phase_mesh, work, card, main_run, merges)
        timed('16 chunks', phase_chunks, work, card, main_run)
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        sample_types = timed('17 sample types', phase_sample_types, work,
                             card, main_run)
        shutil.rmtree(keep, ignore_errors=True)
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        timed('18 tile layouts', phase_tile_layouts, work, card)
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        timed('19 jpeg formats', phase_jpeg_formats, work, card)
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        ome_tiff = timed('11 ome-tiff', phase_ome_tiff, work, card, grid=4)
        timed('14 editions', phase_editions, work, card,
              ome_tiff['grid_3x3'])
    finally:
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(keep, ignore_errors=True)
    log(f"phase seconds: {json.dumps(spent)} "
        f"(sum {sum(spent.values()):.1f})")
    launches = {'fuse_overwrite': main_run['launches'],
                'fuse_feather': quality_run['launches'],
                'finalize_feather': quality_run['finalize_launches']}
    # the float16 instantiations: launches on 17e's float16 paths
    launches.update((f'{name}[float16]', n)
                    for name, n in sample_types['f16_launches'].items())
    entries = []
    for name in kern:
        _, source, replaces = KERNELS[name.split('[')[0]]
        k = kern[name]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": k['max_abs_err'], "ms": k['ms'],
            "plain_ms": k['plain_ms'], "bound_ms": k['bound_ms'],
            "bound_by": k['bound_by'], "bound_share": k['bound_share'],
            "library_ms": k['library_ms']})
    log(f"card: {card}")
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
