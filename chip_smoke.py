#!/usr/bin/env python3
"""Smoke run of image_stitcher_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. environment: torch/CUDA versions, card name and power limit;
  2. build: the CUDA kernels, compiled from csrc/ with nvcc (one nvcc per
     source, started together);
  3. kernel vs plain: every kernel against its plain PyTorch version on
     seeded batches at the main-path shapes (overwrite canvas byte-equal,
     feather acc/wsum bit-equal, finalize byte-equal): the band canvas at
     its padded and at an odd pitch, tile x origins at every residue
     mod 8, u16 and u8, cameras whose rows are not 16-byte aligned, and
     one HCS well's whole (3, 2, Hp, Wp) in-RAM canvas with a 3-plane
     field (channel and z indices both used; the feather case finalizes
     every plane). Per case: the kernel's time on the card (CUDA events,
     calls queued behind a spinning kernel so the host's enqueue is
     hidden), one call with the host's enqueue, the plain version's
     call, and the bound (bytes each input read once and each output
     written once, at 3.35 TB/s) with the kernel's share of it; then the
     batched device
     phase correlation against the host f64 twin on 180 main-path strip
     pairs (within 0.1 px);
  4. slice parity: 3x3 x 3-channel 2048^2 acquisitions stitched on the
     card and on the CPU through the band fuser (streaming='on') must
     decode to equal OME-Zarr trees: the main path, and the maximum-
     quality path with the card run's registration carried into the CPU
     run;
  5. main path: a 10x10 x 3-channel 2048^2 uint16 acquisition (~205 px
     overlap, center registration + flatfield, overwrite, raw OME-Zarr
     v2) stitched end to end through ``image_stitcher_tpu_torch.stitch``,
     with stage times and tiles/s;
  6. maximum-quality path: the same grid with +-3 px integer stage
     jitter, all-pairs registration on the card, the global position
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
     host solver, the report and PNGs checked.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or
without the package beside this file, the script exits non-zero and
prints no result. The acquisitions are written to a temporary directory
and removed at the end.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
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
TILE = 2048
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
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        list(pool.map(native.load, LIBRARIES))
    log(f"build: {len(LIBRARIES)} sources in {time.perf_counter() - t0:.1f}s;"
        " nvcc " + " ".join(native.NVCC_FLAGS))
    for name in LIBRARIES:
        info = native.BUILDS[name]
        log(f"build: {info['path']} ({'cached' if info['cached'] else 'nvcc'}"
            f" {info['seconds']:.1f}s)")
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
    :func:`kernel_cases`; returns {kernel: numbers at the headline case}."""
    rng = np.random.default_rng(1234)
    over = [overwrite_case(rng, case, reps) for case in kernel_cases()]
    rng = np.random.default_rng(4321)
    feath = [feather_case(rng, case, reps) for case in kernel_cases()]
    pcc_check()
    out = {'fuse_overwrite': dict(over[0]),
           'fuse_feather': dict(feath[0]),
           'finalize_feather': dict(feath[0]['finalize'])}
    del out['fuse_feather']['finalize']
    out['fuse_overwrite']['max_abs_err'] = max(c['max_abs_err'] for c in over)
    out['fuse_feather']['max_abs_err'] = max(c['max_abs_err'] for c in feath)
    out['finalize_feather']['max_abs_err'] = max(
        c['finalize']['max_abs_err'] for c in feath if c.get('finalize'))
    return out


def kernel_cases():
    """(name, dtype, with_ff, canvas shape, N, th, tw): the main path's
    band canvas (a 10x10 grid of 2048^2 tiles, N = 10) at its padded pitch
    (the first case is the headline) and at the odd unpadded pitch, u16
    and u8, with and without the field; cameras into a 3-channel canvas
    (ff picked per channel): 1920x1200, and rows of 1100 and 1201 pixels,
    which are not 16-byte aligned."""
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
    return cases


def case_inputs(rng, case):
    """Device inputs of one case, and what its data needs: canvas pixels
    inside some valid window, the windows' summed area, and the bytes of
    the fields that its valid tiles use (each read once)."""
    name, dtype, with_ff, cshape, n, th, tw = case
    dev = torch.device('cuda')
    tiles, info, crops, valid = kernel_batch(rng, n, th, tw, cshape[2:],
                                             cshape[0], cshape[1])
    if dtype == torch.uint8:
        tiles = (tiles >> 8).astype(np.uint8)
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
    base = torch.randint(0, 256 if dtype == torch.uint8 else 65536, cshape,
                         generator=gen, device='cuda',
                         dtype=torch.int32).to(dtype)
    got = base.clone()
    want = base.clone()
    cuda_fuse.fuse_overwrite(got, d_tiles, *meta, ff)
    torch.cuda.synchronize()
    plain.fuse_overwrite(want, d_tiles, *meta, ff)
    torch.cuda.synchronize()
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
    if err != 0:
        raise SystemExit(f"fuse_overwrite disagrees with its plain version "
                         f"on {label}: max_abs_err {err}")
    item = got.element_size()
    out = timings(lambda: cuda_fuse.fuse_overwrite(got, d_tiles, *meta, ff),
                  lambda: plain.fuse_overwrite(want, d_tiles, *meta, ff),
                  2 * item * written + ff_bytes, written if with_ff else 0,
                  reps)
    out['max_abs_err'] = err
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
    out['max_abs_err'] = err
    log(f"kernel fuse_feather {label}: acc/wsum bit-equal, {weighted} px "
        f"weighted; kernel {out['ms']:.4f} ms (one call with the host's "
        f"enqueue {out['call_ms']:.4f}), plain {out['plain_ms']:.4f} ms, "
        f"bound {out['bound_ms']:.4f} ms ({out['bound_by']}), "
        f"{out['bound_share']:.1%} of the bound")
    if name.startswith(('band', 'well')):
        # the band's real rows, as the band fuser finalizes them, or every
        # plane of the well's real canvas, as the in-RAM path does
        rows, width = ((th, th + BAND_ROWS), BAND_W) if name != 'well' \
            else ((0, WELL_H), WELL_W)
        window = (rows, (0, width))
        real = (slice(*rows), slice(0, width))
        f_got = cuda_fuse.finalize_feather(*got, dtype, *window)
        f_want = plain.finalize_feather(got[0][..., real[0], real[1]],
                                        got[1][..., real[0], real[1]], dtype)
        torch.cuda.synchronize()
        f_err = int((f_got.to(torch.int32)
                     - f_want.to(torch.int32)).abs().max())
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


def tiff_bytes_header(h: int, w: int) -> bytes:
    """Classic little-endian TIFF header + IFD for one uncompressed
    uint16 strip of (h, w) whose pixels follow at byte 160."""
    import struct
    data_off = 160
    entries = [(256, 4, w), (257, 4, h), (258, 3, 16), (259, 3, 1),
               (262, 3, 1), (273, 4, data_off), (277, 3, 1), (278, 4, h),
               (279, 4, h * w * 2), (284, 3, 1), (339, 3, 1)]
    out = bytearray(b'II' + struct.pack('<HI', 42, 8))
    out += struct.pack('<H', len(entries))
    for tag, typ, val in entries:
        payload = (struct.pack('<HH', val, 0) if typ == 3
                   else struct.pack('<I', val))
        out += struct.pack('<HHI', tag, typ, 1) + payload
    out += struct.pack('<I', 0)
    return bytes(out.ljust(data_off, b'\0'))


def write_acquisition(folder: str, grid: int, tile: int, overlap: int,
                      seed: int, jitter: int = 0, regions=('A1',)):
    """A Squid acquisition: per region (an HCS well; wells 20 mm apart on
    the stage), grid x grid tiles of ``tile``^2 uint16 cut at ``overlap``
    px overlap from one seeded full-entropy texture of its own, each
    tile's window moved by up to +-``jitter`` px (stage error; the
    coordinates claim the ideal grid), written as uncompressed TIFF for
    every channel, plus coordinates.csv and 'acquisition
    parameters.json' (the layout of the JAX package's test fixtures).
    Returns (texture, {fov: (y0, x0)}) of the first region."""
    import csv
    step = tile - overlap
    margin = 8
    side = step * (grid - 1) + tile + 2 * margin
    rng = np.random.default_rng(seed)
    tdir = os.path.join(folder, '0')
    os.makedirs(tdir)
    with open(os.path.join(folder, 'acquisition parameters.json'), 'w') as f:
        json.dump(dict(ACQ_PARAMS, Nx=grid, Ny=grid), f, indent=2)
    header = tiff_bytes_header(tile, tile)
    rows = []
    first = None
    for well, region in enumerate(regions):
        gt = rng.integers(6553, 58982, (side, side), dtype=np.uint16)
        shake = rng.integers(-jitter, jitter + 1, (grid * grid, 2))
        origins = {}
        for r in range(grid):
            for c in range(grid):
                fov = r * grid + c
                y0 = margin + r * step + int(shake[fov, 0])
                x0 = margin + c * step + int(shake[fov, 1])
                origins[fov] = (y0, x0)
                rows.append({"region": region, "fov": fov, "z_level": 0,
                             "x (mm)": round(c * step / 1000.0, 6),
                             "y (mm)": round(20.0 * well + r * step / 1000.0,
                                             6),
                             "z (um)": 0.0})
                body = np.ascontiguousarray(gt[y0:y0 + tile, x0:x0 + tile])
                for ch in CHANNELS:
                    name = f"{region}_{fov}_0_{ch.replace(' ', '_')}.tiff"
                    with open(os.path.join(tdir, name), 'wb') as f:
                        f.write(header)
                        body.tofile(f)
        if first is None:
            first = (gt, origins)
    with open(os.path.join(tdir, 'coordinates.csv'), 'w', newline='') as f:
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
    return EngineOptions(fusion_batch=10, reader_threads=8,
                         compressor_cname='auto', output_folder=out, **extra)


def read_tree(root: str):
    """{relative path: decoded level array or parsed JSON} of a tree."""
    from image_stitcher_tpu_torch.io.zarr_store import read_array
    out = {}
    for dirpath, _, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        if '.zarray' in files:
            out[rel] = read_array(dirpath)
        for name in files:
            if name in ('.zarray', '.zattrs', '.zgroup'):
                with open(os.path.join(dirpath, name)) as f:
                    out[os.path.join(rel, name)] = json.load(f)
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
                    width: int, region: str = 'A1') -> np.ndarray:
    """Level 0 of one channel, fused in plain NumPy from the texture the
    acquisition was cut from: each job's crop window, flatfield-corrected
    (trunc(clip(tile * recip))), written in plan order."""
    recip = pipe._flatfield_recip_np()[channel]
    tile = pipe.acq.input_height
    out = np.zeros((height, width), np.uint16)
    for job in pipe._build_jobs(0, region):
        if job.channel_idx != channel:
            continue
        fov = int(os.path.basename(job.filepath).split('_')[1])
        y0, x0 = origins[fov]
        t = gt[y0:y0 + tile, x0:x0 + tile].astype(np.float32) * recip
        t = np.clip(t, 0, 65535).astype(np.uint16)
        top, bottom, left, right = job.crops
        r1 = min(tile - bottom, height - job.y)
        s1 = min(tile - right, width - job.x)
        out[job.y + top:job.y + r1, job.x + left:job.x + s1] = \
            t[top:r1, left:s1]
    return out


def phase_main_path(work: str, card: str, grid: int = 10,
                    tile: int = TILE, device: str = 'cuda') -> dict:
    from image_stitcher_tpu_torch import stitch
    from image_stitcher_tpu_torch.io.omezarr import level_shapes
    from image_stitcher_tpu_torch.io.zarr_store import read_array
    from image_stitcher_tpu_torch.models.streaming import (
        band_canvas_shape, band_rows_for, partition_jobs_by_band)
    from image_stitcher_tpu_torch.ops import cuda_fuse
    acq = os.path.join(work, f'main_{grid}x{grid}')
    t0 = time.perf_counter()
    gt, origins = write_acquisition(acq, grid, tile,
                                    overlap=205 * tile // TILE, seed=5)
    log(f"main path: wrote {grid}x{grid}x{len(CHANNELS)} {tile}^2 uint16 "
        f"tiles in {time.perf_counter() - t0:.1f}s")
    out = os.path.join(work, 'main_out')
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
    banned = [m for m in ('jax', 'jaxlib', 'pandas', 'tensorstore', 'cv2',
                          'image_stitcher_tpu') if m in sys.modules]
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
            'tiles_per_s': n_tiles / e2e}


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
    banned = [m for m in ('jax', 'jaxlib', 'pandas', 'tensorstore', 'cv2',
                          'image_stitcher_tpu') if m in sys.modules]
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
    banned = [m for m in ('jax', 'jaxlib', 'pandas', 'tensorstore', 'cv2',
                          'image_stitcher_tpu') if m in sys.modules]
    if banned:
        raise SystemExit(f"plate: loaded {banned}")


# ------------------------------------------------------------------ main

def main() -> int:
    card = phase_environment()
    phase_build()
    kern = phase_kernels()
    work = tempfile.mkdtemp(prefix='chip_smoke_')
    try:
        phase_slice_parity(work)
        phase_slice_parity(work, quality=True)
        main_run = phase_main_path(work, card)
        quality_run = phase_quality_path(work, card)
        shutil.rmtree(work, ignore_errors=True)   # the plate needs the room
        os.makedirs(work)
        phase_plate(work, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = {'fuse_overwrite': main_run['launches'],
                'fuse_feather': quality_run['launches'],
                'finalize_feather': quality_run['finalize_launches']}
    entries = []
    for name, (_, source, replaces) in KERNELS.items():
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
