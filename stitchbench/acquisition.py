"""The acquisition generator: one traffic mix's parameters, one seed, one
Squid acquisition on disk.

The layout is Squid's (and the JAX package's test fixtures'): a numeric
timepoint folder holding ``{region}_{fov}_{z}_{channel}.tiff`` tiles,
uncompressed 16-bit TIFF, and ``coordinates.csv``, with
``acquisition parameters.json`` beside it. The stage coordinates claim
the ideal grid; each tile's true origin may be moved from it by stage
error (``jitter_px``, whole pixels, and with ``subpixel`` a fraction of
0.3 to 0.7 px as well).

The content model is 12-bit widefield fluorescence: per region and
channel, Gaussian nuclei (sizes and peaks drawn from the mix's ranges)
covering a share of the field taken from the mix's range, a smooth
vignetting field fixed in tile coordinates (what the flatfield fit has to
find), Poisson shot noise, Gaussian read noise and a dark offset, clipped
to the camera's bit depth. Every tile is rendered from the nuclei's
continuous positions (one matrix product a tile: the nuclei's separable
row and column profiles), so overlapping tiles show the same content at
any fractional offset.

Every seed makes the same amount of work: the same grid, tile count and
nuclei counts. The field of each region and channel is cut into grid x
grid cells that take the coverages of the mix's range, evenly spaced,
in an order drawn from the seed, so every region and channel holds the
same set of dense and sparse fields; positions, sizes, peaks, jitter and
noise are drawn from the seed too. Tiles are made on ``device`` (the
card in a run) with a ``torch.Generator`` there.
"""

from __future__ import annotations

import csv
import json
import math
import os
import struct
from typing import Dict, List, Tuple

import numpy as np
import torch

#: optics of the generated acquisitions: 1.0 um a pixel, binning 2
ACQ_PARAMS = {
    "dx(mm)": 0.1, "dy(mm)": 0.1, "dz(um)": 1.5, "Nz": 1, "Nt": 1,
    "objective": {"magnification": 10, "tube_lens_f_mm": 180,
                  "name": "10x"},
    "sensor_pixel_size_um": 10.0, "tube_lens_mm": 180,
    "pixel_binning": 2,
}
PIXEL_UM = 1.0
MARGIN = 8


def tiff_header(h: int, w: int) -> bytes:
    """A little-endian TIFF header and IFD for one uncompressed strip of
    (h, w) uint16 samples that follow at byte 160."""
    entries = [(256, 4, w), (257, 4, h), (258, 3, 16), (259, 3, 1),
               (262, 3, 1), (273, 4, 160), (277, 3, 1), (278, 4, h),
               (279, 4, h * w * 2), (284, 3, 1), (339, 3, 1)]
    out = bytearray(b'II' + struct.pack('<HI', 42, 8))
    out += struct.pack('<H', len(entries))
    for tag, typ, val in entries:
        payload = (struct.pack('<HH', val, 0) if typ == 3
                   else struct.pack('<I', val))
        out += struct.pack('<HHI', tag, typ, 1) + payload
    out += struct.pack('<I', 0)
    return bytes(out.ljust(160, b'\0'))


def tile_name(region: str, fov: int, channel: str) -> str:
    return f"{region}_{fov}_0_{channel.replace(' ', '_')}.tiff"


def layout(traffic: Dict, seed: int) -> Dict:
    """The acquisition's geometry and draws that are not pixels: per
    region the true tile origins (y, x) in the region's frame, and per
    (region, channel) the coverage of each of its grid x grid cells."""
    grid = int(traffic['grid'])
    tile = int(traffic['tile'])
    step = tile - int(traffic['overlap_px'])
    jitter = int(traffic.get('jitter_px', 0))
    regions = list(traffic['regions'])
    channels = list(traffic['channels'])
    rng = np.random.default_rng(seed)
    lo, hi = traffic['content']['cover']
    levels = np.linspace(lo, hi, grid * grid)
    cover = {(reg, ch): levels[rng.permutation(grid * grid)]
             for reg in regions for ch in channels}
    origins = {}
    for region in regions:
        whole = rng.integers(-jitter, jitter + 1, (grid * grid, 2))
        frac = np.zeros((grid * grid, 2))
        if traffic.get('subpixel'):
            frac = rng.integers(3, 8, (grid * grid, 2)) / 10.0
        o = np.empty((grid * grid, 2))
        for r in range(grid):
            for c in range(grid):
                k = r * grid + c
                o[k] = (MARGIN + r * step, MARGIN + c * step)
        o += whole + frac
        if traffic.get('subpixel'):
            # the tile that sits first on an axis is where a solve puts 0:
            # keep it whole there, so every other position's fraction is
            # 0.3 to 0.7 px away from a whole pixel
            for axis in (0, 1):
                k = int(np.argmin(o[:, axis]))
                o[k, axis] = math.floor(o[k, axis])
        origins[region] = o
    side = step * (grid - 1) + tile + 2 * MARGIN + 2 * jitter + 2
    return {'grid': grid, 'tile': tile, 'step': step, 'side': side,
            'regions': regions, 'channels': channels, 'origins': origins,
            'cover': cover}


def nuclei_count(content: Dict, cover: float, area: float) -> int:
    """Nuclei that cover ``cover`` of a field of ``area`` px, a nucleus
    counting the disc of radius 2 sigma."""
    s0, s1 = content['sigma_px']
    mean_sq = (s0 * s0 + s0 * s1 + s1 * s1) / 3.0
    return int(round(cover * area / (4.0 * math.pi * mean_sq)))


def draw_nuclei(content: Dict, covers, grid: int, side: int,
                gen: torch.Generator, device) -> Tuple[torch.Tensor, ...]:
    """(y, x, sigma, peak) of the nuclei of one region and channel: in
    cell k of the grid x grid cells of the side x side field, as many as
    cover ``covers[k]`` of it, uniformly placed."""
    cell = side / grid
    counts = [nuclei_count(content, float(c), cell * cell) for c in covers]
    n = sum(counts)
    u = torch.rand((4, n), device=device, generator=gen)
    k = torch.repeat_interleave(torch.arange(grid * grid, device=device),
                                torch.tensor(counts, device=device))
    s0, s1 = content['sigma_px']
    p0, p1 = content['peak']
    return ((k // grid + u[0]) * cell, (k % grid + u[1]) * cell,
            s0 + (s1 - s0) * u[2], p0 + (p1 - p0) * u[3])


def vignette(content: Dict, th: int, tw: int, device) -> torch.Tensor:
    """(th, tw) float32 field: 1 at the centre falling as r^2 to
    1 - vignette at the corners."""
    y = (torch.arange(th, device=device, dtype=torch.float32) - (th - 1) / 2)
    x = (torch.arange(tw, device=device, dtype=torch.float32) - (tw - 1) / 2)
    r2 = (y[:, None] ** 2 + x[None, :] ** 2) / ((th - 1) ** 2 / 4
                                               + (tw - 1) ** 2 / 4)
    return 1.0 - float(content['vignette']) * r2


def render_tile(nuclei: Tuple[torch.Tensor, ...], origin, th: int, tw: int,
                content: Dict, field: torch.Tensor,
                gen: torch.Generator) -> torch.Tensor:
    """One (th, tw) uint16 tile whose top-left pixel sits at ``origin``
    (y, x) in the region's frame."""
    ys, xs, sig, amp = nuclei
    oy, ox = float(origin[0]), float(origin[1])
    reach = 4.0 * float(content['sigma_px'][1])
    keep = ((ys > oy - reach) & (ys < oy + th + reach)
            & (xs > ox - reach) & (xs < ox + tw + reach))
    dev = ys.device
    if bool(keep.any()):
        y, x, s, a = ys[keep], xs[keep], sig[keep], amp[keep]
        # double-precision offsets keep the profiles exact far from the
        # region's origin; the products are float32
        rows = torch.arange(th, device=dev, dtype=torch.float64) + oy
        cols = torch.arange(tw, device=dev, dtype=torch.float64) + ox
        inv = (1.0 / (2.0 * s.double() ** 2))[:, None]
        gy = torch.exp(-(rows[None, :] - y.double()[:, None]) ** 2 * inv)
        gx = torch.exp(-(cols[None, :] - x.double()[:, None]) ** 2 * inv)
        signal = (gy.float() * a[:, None]).T @ gx.float()
    else:
        signal = torch.zeros((th, tw), device=dev)
    mean = (float(content['background']) + signal) * field
    counts = torch.poisson(mean, generator=gen)
    counts += float(content['read_noise']) * torch.randn(
        (th, tw), device=dev, generator=gen)
    counts += float(content['dark_offset'])
    top = float(2 ** int(content['bits']) - 1)
    return torch.round(counts).clamp_(0, top).to(torch.int32).to(
        torch.uint16)


def write_acquisition(folder: str, traffic: Dict, seed: int,
                      device=None) -> Dict:
    """Write the acquisition of ``traffic`` and ``seed`` into ``folder``
    (made here); returns :func:`layout`'s dict with 'nuclei' counts per
    (region, channel) and 'bytes' written."""
    device = torch.device(device or 'cpu')
    lay = layout(traffic, seed)
    content = traffic['content']
    grid, th = lay['grid'], lay['tile']
    tw = th
    side = lay['side']
    os.makedirs(os.path.join(folder, '0'))
    with open(os.path.join(folder, 'acquisition parameters.json'), 'w') as f:
        json.dump(dict(ACQ_PARAMS, Nx=grid, Ny=grid), f, indent=2)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    field = vignette(content, th, tw, device)
    header = tiff_header(th, tw)
    rows: List[Dict] = []
    counts = {}
    written = 0
    pitch = float(traffic.get('well_pitch_mm', 9.0))
    for w, region in enumerate(lay['regions']):
        for channel in lay['channels']:
            nuclei = draw_nuclei(content, lay['cover'][(region, channel)],
                                 grid, side, gen, device)
            counts[(region, channel)] = int(nuclei[0].numel())
            for fov in range(grid * grid):
                img = render_tile(nuclei, lay['origins'][region][fov], th, tw,
                                  content, field, gen).cpu().numpy()
                path = os.path.join(folder, '0',
                                    tile_name(region, fov, channel))
                with open(path, 'wb') as f:
                    f.write(header)
                    img.tofile(f)
                written += len(header) + img.nbytes
        for fov in range(grid * grid):
            r, c = divmod(fov, grid)
            rows.append({"region": region, "fov": fov, "z_level": 0,
                         "x (mm)": round(c * lay['step'] * PIXEL_UM / 1000,
                                         6),
                         "y (mm)": round(pitch * w
                                         + r * lay['step'] * PIXEL_UM / 1000,
                                         6),
                         "z (um)": 0.0})
    with open(os.path.join(folder, '0', 'coordinates.csv'), 'w',
              newline='') as f:
        wr = csv.DictWriter(f, fieldnames=list(rows[0]))
        wr.writeheader()
        wr.writerows(rows)
    lay['nuclei'] = counts
    lay['bytes'] = written
    return lay
