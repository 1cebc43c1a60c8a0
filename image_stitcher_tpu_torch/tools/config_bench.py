#!/usr/bin/env python3
"""Throughput bench for the remaining BASELINE.md eval configs, on the port.

The counterpart of the JAX package's ``tools/config_bench.py``:
BASELINE.md's eval list names two shapes the main-path bench does not
time, the Z=20 TCZYX multiscale stack and a 96-well HCS multi-region,
multi-timepoint run with streamed merges (reference merge path:
stitcher.py:900-1218). This tool records their wall time and per-stage
decomposition, as the JAX tool's JSON.

The card's host has no OpenCV, so the acquisitions are not written by
``tests/fixtures.py``: :func:`write_acquisition` writes them with NumPy
(a blurred seeded texture, scipy's Gaussian for OpenCV's) and the
port's uncompressed-TIFF writer (``io/fast_tiff.write_tiff_fast``),
with the fixture's grid, tile, overlap, z levels, jitter and seed.

    python -m image_stitcher_tpu_torch.tools.config_bench [--reps N] [--device cpu]
    python -m image_stitcher_tpu_torch.tools.config_bench --config z20

Prints one JSON list on stdout; progress and diagnostics on stderr.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np

#: the JAX test fixture's acquisition parameters (1 um / px)
ACQ_PARAMS = {
    "dx(mm)": 0.1, "dy(mm)": 0.1, "dz(um)": 1.5,
    "Nx": 2, "Ny": 2, "Nz": 1, "Nt": 1,
    "objective": {"magnification": 10, "tube_lens_f_mm": 180, "name": "10x"},
    "sensor_pixel_size_um": 10.0,
    "tube_lens_mm": 180,
    "pixel_binning": 1,
}


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def ground_truth(height: int, width: int, seed: int) -> np.ndarray:
    """A smooth-ish seeded uint16 texture with structure at several
    scales (the fixture's recipe: Gaussian blurs at sigma 3, 9, 27
    weighted by sigma, plus 0.3 of the noise, stretched to 10-90 % of
    the range), so phase correlation has signal everywhere."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    img = rng.random((height, width)).astype(np.float32)
    acc = 0.3 * img
    for k in (3, 9, 27):
        acc += gaussian_filter(img, k, mode='reflect') * k
    acc -= acc.min()
    acc /= max(float(acc.max()), 1e-9)
    return (acc * 65535 * 0.8 + 65535 * 0.1).astype(np.uint16)


def write_acquisition(folder: str, grid_cols: int, grid_rows: int,
                      tile_w: int, tile_h: int, overlap: int,
                      num_z: int = 1, jitter: int = 0, seed: int = 0,
                      regions: Optional[Sequence[str]] = None,
                      timepoints: int = 1,
                      channels: Sequence[str] = ("Fluorescence 488 nm Ex",)
                      ) -> None:
    """A Squid acquisition laid out as ``tests/fixtures.py`` writes it:
    tiles cut from one texture at the ideal grid moved by a seeded
    integer jitter (drawn in the fixture's order), the same tile at
    every z level, uncompressed TIFFs, a ``coordinates.csv`` per
    timepoint (the bytes pandas writes) and 'acquisition
    parameters.json'."""
    from ..io.fast_tiff import write_tiff_fast
    from ..utils.csvtable import write_csv
    regions = list(regions or ["A1"])
    pixel_size_um = (ACQ_PARAMS["sensor_pixel_size_um"]
                     / (ACQ_PARAMS["tube_lens_mm"]
                        / (ACQ_PARAMS["objective"]["tube_lens_f_mm"]
                           / ACQ_PARAMS["objective"]["magnification"])))
    step_x, step_y = tile_w - overlap, tile_h - overlap
    margin = 2 * max(jitter, 0) + 8
    gt = ground_truth(step_y * (grid_rows - 1) + tile_h + 2 * margin,
                      step_x * (grid_cols - 1) + tile_w + 2 * margin, seed)
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "acquisition parameters.json"), "w") as f:
        json.dump(ACQ_PARAMS, f, indent=2)
    rng = np.random.default_rng(seed + 1)
    for t in range(timepoints):
        tdir = os.path.join(folder, str(t))
        os.makedirs(tdir, exist_ok=True)
        rows = []
        for region in regions:
            for r in range(grid_rows):
                for c in range(grid_cols):
                    fov = r * grid_cols + c
                    jy = int(rng.integers(-jitter, jitter + 1)) if jitter else 0
                    jx = int(rng.integers(-jitter, jitter + 1)) if jitter else 0
                    y0, x0 = margin + r * step_y + jy, margin + c * step_x + jx
                    tile = gt[y0:y0 + tile_h, x0:x0 + tile_w]
                    for z in range(num_z):
                        rows.append((region, fov, z,
                                     round(c * step_x * pixel_size_um / 1000.0,
                                           6),
                                     round(r * step_y * pixel_size_um / 1000.0,
                                           6),
                                     z * ACQ_PARAMS["dz(um)"]))
                        for ch in channels:
                            write_tiff_fast(os.path.join(
                                tdir, f"{region}_{fov}_{z}_"
                                      f"{ch.replace(' ', '_')}.tiff"), tile)
        cols = list(zip(*rows))
        write_csv(os.path.join(tdir, "coordinates.csv"), {
            "region": ('object', list(cols[0])),
            "fov": ('int', list(cols[1])), "z_level": ('int', list(cols[2])),
            "x (mm)": ('float', list(cols[3])),
            "y (mm)": ('float', list(cols[4])),
            "z (um)": ('float', [float(v) for v in cols[5]])})


def _run(params, options, device):
    from ..models.pipeline import StitchPipeline
    pipe = StitchPipeline(params, options, device=device)
    t0 = time.perf_counter()
    pipe.run()
    return time.perf_counter() - t0, pipe


def _best(acq: str, reps: int, label: str, n_tiles: int, params, options,
          device):
    best, stages = None, None
    for rep in range(reps):
        dt, pipe = _run(params, options, device)
        merge = pipe.timers.as_dict().get('merge')
        _log(f"{label}[{rep}]: {dt:.1f}s = {n_tiles / dt:.1f} tiles/s"
             + (f" (merge {merge:.1f}s)" if merge is not None else ""))
        if best is None or dt < best:
            best, stages = dt, pipe.timers.as_dict()
        for d in glob.glob(acq + "_stitched_*"):
            shutil.rmtree(d, ignore_errors=True)
    return best, stages


def bench_z20(workdir: str, reps: int, tile: int = 1024, num_z: int = 20,
              device='cuda'):
    """Z=20 TCZYX multiscale: 3x3 grid of ``tile``^2 single-channel tiles
    at ``num_z`` z-levels (180 tiles, ~360 MB raw at the defaults) ->
    registered multiscale OME-Zarr."""
    from .. import EngineOptions, StitchingParameters
    acq = os.path.join(workdir, "z20")
    _log(f"building z20 acquisition (3x3 x {num_z}z {tile}^2)...")
    write_acquisition(acq, grid_cols=3, grid_rows=3, tile_w=tile,
                      tile_h=tile, overlap=104 * tile // 1024, num_z=num_z,
                      jitter=2, seed=5)
    n_tiles = 3 * 3 * num_z
    best, stages = _best(
        acq, reps, "z20", n_tiles,
        StitchingParameters(input_folder=acq, use_registration=True),
        EngineOptions(compressor_cname='auto'), device)
    return {"config": f"z20-tczyx-multiscale (3x3 x{num_z}z {tile}^2)",
            "seconds": round(best, 2),
            "tiles_per_s": round(n_tiles / best, 2),
            "stages": {k: round(v, 2) for k, v in sorted(
                stages.items(), key=lambda kv: -kv[1])}}


def bench_hcs96(workdir: str, reps: int, tile: int = 512, wells: int = 96,
                device='cuda'):
    """96-well HCS plate: every well A1..H12 (the first ``wells``) a 1x1
    FOV of ``tile``^2, two timepoints, coordinate stitch + per-timepoint
    HCS plate merge + complete (timepoint) merge: the streamed merge
    tree."""
    from .. import EngineOptions, StitchingParameters
    acq = os.path.join(workdir, "hcs96")
    regions = [f"{r}{c}" for r in "ABCDEFGH" for c in range(1, 13)][:wells]
    _log(f"building {wells}-well acquisition (1x1 {tile}^2 x 2t)...")
    write_acquisition(acq, grid_cols=1, grid_rows=1, tile_w=tile,
                      tile_h=tile, overlap=0, regions=regions, timepoints=2,
                      seed=6)
    n_tiles = wells * 2
    best, stages = _best(
        acq, reps, "hcs96", n_tiles,
        StitchingParameters(input_folder=acq, merge_timepoints=True,
                            merge_hcs_regions=True),
        EngineOptions(compressor_cname='auto'), device)
    return {"config": f"hcs-{wells}well x2t streamed merges ({tile}^2 wells)",
            "seconds": round(best, 2),
            "tiles_per_s": round(n_tiles / best, 2),
            "merge_seconds": round(stages.get('merge', 0.0), 2),
            "stages": {k: round(v, 2) for k, v in sorted(
                stages.items(), key=lambda kv: -kv[1])}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--config", choices=["z20", "hcs96", "all"],
                   default="all")
    p.add_argument("--device", default="cuda",
                   help="torch device to fuse on (default: cuda)")
    args = p.parse_args(argv)
    workdir = tempfile.mkdtemp(prefix="config_bench_")
    results = []
    try:
        if args.config in ("z20", "all"):
            results.append(bench_z20(workdir, args.reps, device=args.device))
        if args.config in ("hcs96", "all"):
            results.append(bench_hcs96(workdir, args.reps,
                                       device=args.device))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps(results))
    return 0


if __name__ == '__main__':
    sys.exit(main())
