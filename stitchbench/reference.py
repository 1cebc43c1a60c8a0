"""The plain reference: what a stitch of a generated acquisition should
write, worked out again from its tiles.

It follows the semantics the program documents (Squid's stitcher as the
JAX package models it), written here in float64 NumPy and plain PyTorch,
importing nothing of the program and taking nothing it made:

- the flatfield: BaSiC's ADMM (sparse error, DCT-L1 smooth field, one
  baseline a tile) on up to 32 sample tiles a channel drawn as Python's
  ``random.Random(0)`` shuffles the scan's tile order, each decimated by
  a stride of ``tile // 192`` and OpenCV's INTER_AREA to 96^2; the field
  resized back with INTER_LINEAR, floored at 1e-3, unit mean;
- registration: phase correlation with the upsampled-DFT refinement
  (Guizar-Sicairos et al. 2008, as scikit-image computes it), on the
  overlap strips of the centre pair of the first region ('center' scope:
  one horizontal and one vertical shift for the grid), or of every
  adjacent pair ('global' scope), whose displacements and correlation
  peaks feed a weighted least-squares solve of the tile positions with
  three Cauchy-reweighted passes (the anchor tile at 0, then the minimum
  moved to 0);
- placement: each tile multiplied by its channel's field's reciprocal,
  clipped and truncated to uint16, then written over the canvas in scan
  order inside its crop window ('overwrite': interior edges shed half the
  overlap), or with subpixel placement shifted by its fractional
  position (bilinear, replicated borders, rounded half to even) and
  blended with weights rising linearly over ``feather_px`` from its
  edges, the sum rounded half to even ('feather');
- the pyramid: every other pixel of the level above ('nearest');
- the OME-Zarr v2 metadata (NGFF 0.4) of each level and region.

The global scope's pair answers are judged, not decided here: given the
program's answer of each pair (its refined shift, read from its
registration report), the reference reads its own float64 correlation at
that answer and records how far it lies below its own best, then solves
and places with the program's answers and its own weights. So a 0.1 px
neighbour that float32 ranks first on a near-tie is judged by its gap, as
a served token is judged by its logit's gap to the best, and every later
stage is the reference's own (see ``check.py``).

``precision='bfloat16'`` computes the fit, the field's product, the
blend and the pairs' correlations one precision below the program's
float32: the control the output check must fail.
"""

from __future__ import annotations

import csv
import json
import math
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

WORKING = 96


# ------------------------------------------------------------------ scan

def pixel_size(params: Dict) -> Tuple[float, int]:
    obj = params['objective']
    mag = params['tube_lens_mm'] / (obj['tube_lens_f_mm'] / obj['magnification'])
    return params['sensor_pixel_size_um'] / mag, params.get('pixel_binning', 1)


def scan(folder: str) -> Dict:
    """The acquisition as the reference needs it: tiles in scan (file
    name) order with their stage positions, the sorted regions and
    channels, the optics."""
    with open(os.path.join(folder, 'acquisition parameters.json')) as f:
        params = json.load(f)
    tdir = os.path.join(folder, '0')
    with open(os.path.join(tdir, 'coordinates.csv'), newline='') as f:
        coords = {(r['region'], int(r['fov'])): (float(r['x (mm)']),
                                                  float(r['y (mm)']))
                  for r in csv.DictReader(f)}
    tiles = []
    for name in sorted(os.listdir(tdir)):
        if not name.endswith('.tiff'):
            continue
        region, fov, _z, rest = name.split('_', 3)
        channel = rest[:-len('.tiff')].replace('_', ' ')
        x, y = coords[(region, int(fov))]
        tiles.append({'path': os.path.join(tdir, name), 'region': region,
                      'fov': int(fov), 'channel': channel, 'x': x, 'y': y})
    px, binning = pixel_size(params)
    first = read_tile(tiles[0]['path'])
    return {'tiles': tiles, 'params': params, 'pixel_um': px,
            'binning': binning,
            'regions': sorted({t['region'] for t in tiles}),
            'channels': sorted({t['channel'] for t in tiles}),
            'shape': first.shape}


def read_tile(path: str) -> np.ndarray:
    """A generated tile: one uncompressed strip of uint16 after a
    160-byte header (its width and height read from the IFD)."""
    with open(path, 'rb') as f:
        data = f.read()
    ifd = int.from_bytes(data[4:8], 'little')
    n = int.from_bytes(data[ifd:ifd + 2], 'little')
    tags = {}
    for k in range(n):
        e = data[ifd + 2 + 12 * k: ifd + 14 + 12 * k]
        tag, typ = int.from_bytes(e[0:2], 'little'), int.from_bytes(e[2:4], 'little')
        val = int.from_bytes(e[8:10] if typ == 3 else e[8:12], 'little')
        tags[tag] = val
    w, h, off = tags[256], tags[257], tags[273]
    return np.frombuffer(data, '<u2', h * w, off).reshape(h, w)


def grid_of(acq: Dict, region: str):
    """Sorted stage x and y positions of a region (mm)."""
    tiles = [t for t in acq['tiles'] if t['region'] == region]
    return (sorted({t['x'] for t in tiles}), sorted({t['y'] for t in tiles}))


# ------------------------------------------------------------- flatfield

def area_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) weights of OpenCV's INTER_AREA downscale: each output
    cell averages the source cells it covers, partial cells by their
    covered share; slivers under 1e-3 px are left out, as OpenCV leaves
    them."""
    scale = src / dst
    m = np.zeros((dst, src))
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s1 = math.ceil(f1)
        s2 = min(math.floor(f2), src - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            m[d, s1 - 1] += (s1 - f1) / cell
        for s in range(s1, s2):
            m[d, s] += 1.0 / cell
        if f2 - s2 > 1e-3:
            m[d, s2] += min(min(f2 - s2, 1.0), cell) / cell
    return m


def linear_taps(src: int, dst: int):
    """Source index and weight of OpenCV's INTER_LINEAR: centres at
    (d + 0.5) * src / dst - 0.5, clamped to the edge pixels."""
    pos = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    i0 = np.floor(pos)
    a = pos - i0
    i0 = i0.astype(np.intp)
    low, high = i0 < 0, i0 >= src - 1
    i0[low], a[low] = 0, 0.0
    i0[high], a[high] = src - 1, 0.0
    return i0, np.minimum(i0 + 1, src - 1), a


def resize_linear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    y0, y1, ay = linear_taps(img.shape[0], h)
    x0, x1, ax = linear_taps(img.shape[1], w)
    hor = img[:, x0] * (1 - ax) + img[:, x1] * ax
    return hor[y0] * (1 - ay)[:, None] + hor[y1] * ay[:, None]


def to_bfloat16(x):
    """``x`` rounded to bfloat16 (nearest, ties to even), as float64."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


def basic_fit(stack: np.ndarray, iters: int = 35, smooth: float = 1.0,
              mu0: float = 0.02, rho: float = 1.3,
              precision: str = 'float64') -> np.ndarray:
    """BaSiC's flatfield S (unit mean) of an (N, h, w) stack: minimise
    |E|_1 + smooth |DCT(S)|_1 with D_n = b_n S + E_n, by ADMM with the
    scaled multiplier z, mu growing by ``rho`` a step. In 'bfloat16' every
    array is rounded to bfloat16 after each step."""
    from scipy.fft import dctn, idctn
    q = to_bfloat16 if precision == 'bfloat16' else (lambda x: x)
    d = q(stack.astype(np.float64))
    d = q(d / np.maximum(d.mean(axis=(1, 2), keepdims=True), 1e-6))
    n = d.shape[0]
    s = d.mean(axis=0)
    e = np.zeros_like(d)
    z = np.zeros_like(d)
    b = np.ones(n)
    mu = mu0
    for _ in range(iters):
        w = q(d + z)
        bsq = b @ b + 1e-6
        s_ls = q(np.tensordot(b, q(w - e), axes=1) / bsq)
        c = q(dctn(s_ls, norm='ortho'))
        t = smooth / (mu * bsq)
        s = q(idctn(q(np.sign(c) * np.maximum(np.abs(c) - t, 0.0)),
                    norm='ortho'))
        x = q(w - q(b[:, None, None] * s))
        e = q(np.sign(x) * np.maximum(np.abs(x) - 1.0 / mu, 0.0))
        v = q(w - e)
        ssq = float((s * s).sum()) + 1e-6
        b = q(np.maximum(np.tensordot(v, s, axes=2) / ssq, 0.0))
        mu_new = min(mu * rho, 1e6)
        z = q(q(v - q(b[:, None, None] * s)) * (mu / mu_new))
        mu = mu_new
    s = np.maximum(s, 1e-3)
    return q(s / s.mean())


def flatfields(acq: Dict, per_timepoint: int = 32, cap: int = 48,
               precision: str = 'float64') -> Dict[int, np.ndarray]:
    """{channel index: (h, w) float64 field} for every channel (fitted
    and resized in bfloat16 for ``precision='bfloat16'``)."""
    h, w = acq['shape']
    sy, sx = max(1, h // (2 * WORKING)), max(1, w // (2 * WORKING))
    rnd = random.Random(0)
    fields = {}
    for idx, channel in enumerate(acq['channels']):
        paths = [t['path'] for t in acq['tiles'] if t['channel'] == channel]
        rnd.shuffle(paths)
        paths = paths[:min(per_timepoint, len(paths))][:cap + per_timepoint]
        small = []
        for p in paths:
            img = read_tile(p)[::sy, ::sx].astype(np.float64)
            my = area_matrix(img.shape[0], WORKING)
            mx = area_matrix(img.shape[1], WORKING)
            small.append(my @ img @ mx.T)
        field = resize_linear(basic_fit(np.stack(small),
                                        precision=precision), h, w)
        if precision == 'bfloat16':
            field = to_bfloat16(field)
        field = np.maximum(field, 1e-3)
        fields[idx] = field / field.mean()
    return fields


# ---------------------------------------------------------- registration

def _dft_patch(data: np.ndarray, ups: int, uf: float, offsets,
               qc=lambda z: z) -> np.ndarray:
    """The inverse DFT of ``data`` on an ups x ups patch at 1/uf px
    spacing, its corner at ``offsets`` (scikit-image's
    ``_upsampled_dft``); ``qc`` rounds each step's result."""
    for n, off in zip(data.shape[::-1], offsets[::-1]):
        freqs = np.fft.fftfreq(n, uf)
        kernel = qc(np.exp(-2j * np.pi * (np.arange(ups)[:, None] - off)
                           * freqs[None, :]))
        data = qc(np.tensordot(kernel, data, axes=(1, -1)))
    return data


def _q_complex(q):
    """``q`` applied to the real and imaginary parts of a complex array."""
    return lambda z: q(np.real(z)) + 1j * q(np.imag(z))


class PairCorrelation:
    """The whitened cross-correlation of two strips: its coarse peak
    (``peak``, the pair's weight), the refined shift (``shift``, (dy, dx)
    that registers ``mov`` to ``ref``, to 1/uf px) and the refinement's
    best value (``best``); :meth:`value_at` reads the correlation at any
    shift, so an answer of the program can be judged by how far it lies
    below ``best``. With ``precision='bfloat16'`` every array is rounded
    to bfloat16 after each step (the control)."""

    def __init__(self, ref: np.ndarray, mov: np.ndarray, uf: int = 10,
                 precision: str = 'float64'):
        q = to_bfloat16 if precision == 'bfloat16' else (lambda x: x)
        qc = _q_complex(q) if precision == 'bfloat16' else (lambda z: z)
        a = q(np.asarray(ref, np.float64))
        b = q(np.asarray(mov, np.float64))
        shape = np.array(a.shape)
        prod = qc(qc(np.fft.fft2(a)) * np.conj(qc(np.fft.fft2(b))))
        prod = qc(prod / np.maximum(np.abs(prod),
                                    100 * np.finfo(np.float64).eps))
        corr = q(np.abs(np.fft.ifft2(prod)))
        self.peak = float(corr.max())
        shifts = np.array(np.unravel_index(np.argmax(corr), corr.shape),
                          np.float64)
        mids = np.fix(shape / 2)
        shifts[shifts > mids] -= shape[shifts > mids]
        shifts = np.round(shifts * uf) / uf
        ups = int(math.ceil(uf * 1.5))
        centre = float(np.fix(ups / 2.0))
        patch = q(np.abs(_dft_patch(np.conj(prod), ups, float(uf),
                                    centre - shifts * uf, qc)))
        best = np.array(np.unravel_index(np.argmax(patch), patch.shape))
        self.shift = shifts + (best.astype(np.float64) - centre) / uf
        self.best = float(patch.max())
        self.prod = prod
        self.uf = uf

    def value_at(self, shift) -> float:
        """The correlation's magnitude at ``shift`` (dy, dx), px."""
        return float(np.abs(_dft_patch(
            np.conj(self.prod), 1, float(self.uf),
            -np.asarray(shift, np.float64) * self.uf))[0, 0])

    def gap(self, shift) -> float:
        """How far the correlation at ``shift`` lies below the best, as a
        share of the best."""
        return (self.best - self.value_at(shift)) / self.best


def phase_correlation(ref: np.ndarray, mov: np.ndarray, uf: int = 10):
    """(shift (dy, dx) that registers ``mov`` to ``ref``, peak of the
    whitened cross-correlation), refined to 1/uf px."""
    pc = PairCorrelation(ref, mov, uf)
    return pc.shift, pc.peak


def overlap_strip(frame: int, step_px: float, binning: int,
                  fudge: float) -> int:
    """Width of the strips correlated across an overlap."""
    return round(abs(frame - step_px) * fudge) // 2 * binning


def centre_shifts(acq: Dict, opts: Dict) -> Dict:
    """The grid's horizontal and vertical shifts from the centre pair of
    the first region, each (dy, dx) in whole pixels."""
    region = acq['regions'][0]
    channel = acq['channels'][0]
    xs, ys = grid_of(acq, region)
    h, w = acq['shape']
    px = acq['pixel_um']
    by = {(t['x'], t['y']): t for t in acq['tiles']
          if t['region'] == region and t['channel'] == channel}

    def norm(t):
        img = read_tile(t['path']).astype(np.float64)
        lo, hi = img.min(), img.max()
        return (img - lo) / max(hi - lo, 1e-12) * 65535.0

    cx, cy = (len(xs) - 1) // 2, (len(ys) - 1) // 2
    out = {'h_shift': [0, 0], 'v_shift': [0, 0]}
    uf = opts['upsample_factor']
    margin = opts['registration_margin']
    fudge = opts['overlap_fudge']
    if cx + 1 < len(xs):
        ov = overlap_strip(w, (xs[1] - xs[0]) * 1000 / px, acq['binning'],
                           fudge)
        a = norm(by[(xs[cx], ys[cy])])
        b = norm(by[(xs[cx + 1], ys[cy])])
        m = int(h * margin)
        s, _ = phase_correlation(a[m:h - m, -ov:], b[m:h - m, :ov], uf)
        out['h_shift'] = [round(float(s[0])), round(float(s[1]) - ov)]
    if cy + 1 < len(ys):
        ov = overlap_strip(h, (ys[1] - ys[0]) * 1000 / px, acq['binning'],
                           fudge)
        a = norm(by[(xs[cx], ys[cy])])
        b = norm(by[(xs[cx], ys[cy + 1])])
        m = int(w * margin)
        s, _ = phase_correlation(a[-ov:, m:w - m], b[:ov, m:w - m], uf)
        out['v_shift'] = [round(float(s[0]) - ov), round(float(s[1]))]
    return out


def laplacian(pairs, wts, n: int):
    """(n, n) weighted graph Laplacian of the pairs, row 0 pinning tile 0,
    and the (n, 2) right-hand side of their displacements."""
    lap = np.zeros((n, n))
    rhs = np.zeros((n, 2))
    for (i, j, dy, dx, _), wt in zip(pairs, wts):
        lap[i, i] += wt
        lap[j, j] += wt
        lap[i, j] -= wt
        lap[j, i] -= wt
        rhs[i] -= wt * np.array([dy, dx])
        rhs[j] += wt * np.array([dy, dx])
    lap[0, :] = 0.0
    lap[0, 0] = 1.0
    rhs[0] = 0.0
    return lap, rhs


def solve_positions(pairs, n: int, iters: int = 3, scale: float = 3.0,
                    weights: bool = False):
    """(n, 2) positions minimising sum w (p_j - p_i - d_ij)^2, tile 0
    pinned while solving, with ``iters`` Cauchy reweightings of scale
    ``scale`` px; the minimum moved to 0 on each axis. With ``weights``,
    also the weights of the last solve."""
    wts = np.array([p[4] for p in pairs])
    base = wts

    def once(w):
        return np.linalg.lstsq(*laplacian(pairs, w, n), rcond=None)[0]

    pos = once(wts)
    for _ in range(iters):
        res = np.array([math.hypot(pos[j, 0] - pos[i, 0] - dy,
                                   pos[j, 1] - pos[i, 1] - dx)
                        for i, j, dy, dx, _ in pairs])
        wts = base / (1.0 + (res / scale) ** 2)
        pos = once(wts)
    pos = pos - pos.min(axis=0, keepdims=True)
    return (pos, wts) if weights else pos


def global_registration(acq: Dict, region: str, opts: Dict,
                        answers: Optional[Dict] = None,
                        precision: str = 'float64') -> Dict:
    """A region's global registration: every adjacent pair's correlation
    of raw overlap strips, each pair's displacement weighted by its
    correlation peak, and the positions (rows * cols, 2) (y, x) that
    :func:`solve_positions` makes of them.

    Each pair's answer (its refined shift) is the reference's own, or,
    where ``answers`` ({((r, c), (r2, c2)): (sy, sx)}, the program's) is
    given, the program's: refinement values of 0.1 px neighbours can lie
    closer together than float32 (the program's) resolves, so either may
    be right. ``gaps`` holds, for each pair, how far the answer taken
    lies below the reference's best, as a share of it (a pair the program
    did not answer counts 1): what the output check judges.

    Returns {'positions', 'gaps', 'answers', 'own'} ('own': the
    reference's own answers)."""
    channel = acq['channels'][0]
    xs, ys = grid_of(acq, region)
    h, w = acq['shape']
    px = acq['pixel_um']
    fudge = opts['overlap_fudge']
    ox = overlap_strip(w, (xs[1] - xs[0]) * 1000 / px, acq['binning'], fudge)
    oy = overlap_strip(h, (ys[1] - ys[0]) * 1000 / px, acq['binning'], fudge)
    my = int(h * opts['registration_margin'])
    mx = int(w * opts['registration_margin'])
    cols = len(xs)
    imgs = {}
    for t in acq['tiles']:
        if t['region'] == region and t['channel'] == channel:
            imgs[(ys.index(t['y']), xs.index(t['x']))] = read_tile(t['path'])
    uf = opts['upsample_factor']
    pairs, gaps, taken, own = [], [], {}, {}

    def add(rc, rc2, a, b, base):
        pc = PairCorrelation(a, b, uf, precision)
        s = pc.shift
        own[(rc, rc2)] = (float(s[0]), float(s[1]))
        if answers is not None:
            got = answers.get((rc, rc2))
            gaps.append(1.0 if got is None else pc.gap(got))
            s = s if got is None else np.asarray(got, np.float64)
        taken[(rc, rc2)] = (float(s[0]), float(s[1]))
        pairs.append((rc[0] * cols + rc[1], rc2[0] * cols + rc2[1],
                      base[0] + float(s[0]), base[1] + float(s[1]),
                      max(pc.peak, 1e-6)))

    for r in range(len(ys)):
        for c in range(cols - 1):
            add((r, c), (r, c + 1), imgs[(r, c)][my:h - my, -ox:],
                imgs[(r, c + 1)][my:h - my, :ox], (0.0, w - ox))
    for r in range(len(ys) - 1):
        for c in range(cols):
            add((r, c), (r + 1, c), imgs[(r, c)][-oy:, mx:w - mx],
                imgs[(r + 1, c)][:oy, mx:w - mx], (h - oy, 0.0))
    return {'positions': solve_positions(pairs, len(ys) * cols),
            'gaps': gaps, 'answers': taken, 'own': own}


# ------------------------------------------------------------- placement

def grid_position(col: int, row: int, cols: int, rows: int, h: int, w: int,
                  hs, vs) -> Tuple[int, int]:
    """(x, y) of a tile's corner on the centre-registered grid: steps of
    frame + shift, the cross-axis drift accumulated from the side its sign
    points to."""
    x = col * (w + hs[1])
    y = row * (h + vs[0])
    y += (cols - 1 - col) * abs(hs[0]) if hs[0] < 0 else col * hs[0]
    x += (rows - 1 - row) * abs(vs[1]) if vs[1] < 0 else row * vs[1]
    return x, y


def grid_crops(col: int, row: int, cols: int, rows: int, hs, vs):
    """(top, bottom, left, right): half the overlap shed on each edge
    that faces a neighbour."""
    yt = max(0, (-vs[0] // 2) - abs(hs[0]) // 2)
    xt = max(0, (-hs[1] // 2) - abs(vs[1]) // 2)
    return (yt if row > 0 else 0, yt if row < rows - 1 else 0,
            xt if col > 0 else 0, xt if col < cols - 1 else 0)


def shift_subpixel(img: torch.Tensor, fy: float, fx: float,
                   dtype) -> torch.Tensor:
    """out(y, x) = img(y - fy, x - fx), bilinear, borders replicated,
    rounded half to even into [0, 65535], in ``dtype``."""
    h, w = img.shape

    def taps(n, f):
        pos = torch.arange(n, dtype=torch.float64, device=img.device) - f
        i0 = torch.floor(pos)
        a = (pos - i0).to(dtype)
        i0 = i0.long()
        return i0.clamp(0, n - 1), (i0 + 1).clamp(0, n - 1), a

    x0, x1, ax = taps(w, fx)
    y0, y1, ay = taps(h, fy)
    src = img.to(dtype)
    hor = src[:, x0] + ax[None, :] * (src[:, x1] - src[:, x0])
    out = hor[y0] + ay[:, None] * (hor[y1] - hor[y0])
    return torch.round(out.double()).clamp(0, 65535)


def correct(img: torch.Tensor, recip: torch.Tensor, dtype) -> torch.Tensor:
    """trunc(clip(img * recip)) as uint16 values (in float64)."""
    v = (img.to(dtype) * recip.to(dtype)).double()
    return torch.trunc(v.clamp(0, 65535))


def feather_ramp(h: int, w: int, px: int, device) -> torch.Tensor:
    r = torch.arange(h, device=device, dtype=torch.float64)[:, None]
    c = torch.arange(w, device=device, dtype=torch.float64)[None, :]
    d = torch.minimum(torch.minimum(r + 1, h - r), torch.minimum(c + 1, w - c))
    return (d / px).clamp(0, 1)


def pyramid_levels(w: int, h: int, grid_dim: int) -> int:
    return max(1, math.ceil(math.log2(max(w, h) / 1024 * grid_dim)))


def run(folder: str, config: Dict, device='cpu', precision: str = 'float64',
        answers: Optional[Dict[str, Dict]] = None) -> Dict:
    """The reference's output for the acquisition in ``folder`` under a
    configuration: {'fields', 'registration', 'scope', 'gaps', 'answers',
    'own', 'regions': {region: {'levels': [(C, h, w) int32 tensors on
    ``device``], 'meta': expected metadata}}}. With the global scope,
    ``answers`` ({region: pair answers}, the program's) are the pairs'
    answers taken, each judged in 'gaps' (:func:`global_registration`);
    'answers' holds those taken, 'own' the reference's own."""
    opts = config['options']
    device = torch.device(device)
    dtype = {'float64': torch.float64, 'bfloat16': torch.bfloat16}[precision]
    acq = scan(folder)
    h, w = acq['shape']
    fields = (flatfields(acq, opts['flatfield_tiles_per_timepoint'],
                         opts['flatfield_max_tiles'], precision)
              if config['stitch'].get('apply_flatfield') else {})
    recips = {k: torch.from_numpy(1.0 / f).to(device) for k, f in
              fields.items()}
    scope = opts['registration_scope']
    reg: Dict = {}
    if scope == 'center':
        reg = centre_shifts(acq, opts)
    nchan = len(acq['channels'])
    rows_hcs = sorted({r[0] for r in acq['regions']})
    cols_hcs = sorted({r[1:] for r in acq['regions']})
    grid_dim = (max(len(rows_hcs), len(cols_hcs))
                if len(acq['regions']) > 1 else 1)
    out = {'fields': fields, 'registration': reg, 'regions': {},
           'scope': scope, 'gaps': {}, 'answers': {}, 'own': {}}
    for region in acq['regions']:
        xs, ys = grid_of(acq, region)
        cols, rows = len(xs), len(ys)
        place = {}
        if scope == 'global':
            g = global_registration(
                acq, region, opts, None if answers is None
                else answers.get(region, {}), precision)
            pos = reg[region] = g['positions']
            out['gaps'][region] = g['gaps']
            out['answers'][region] = g['answers']
            out['own'][region] = g['own']
            ints = np.round(pos).astype(np.int64)
            cw = int(ints[:, 1].max()) + w
            ch = int(ints[:, 0].max()) + h
            for k in range(rows * cols):
                fy, fx = float(pos[k, 0]), float(pos[k, 1])
                y0, x0 = math.floor(fy), math.floor(fx)
                place[k] = (y0, x0, fy - y0, fx - x0, (0, 0, 0, 0))
        else:
            hs, vs = reg['h_shift'], reg['v_shift']
            mh = abs(hs[0]), abs(hs[1])
            cw = int(w + (cols - 1) * (w - mh[1])) + abs((rows - 1) * vs[1])
            ch = int(h + (rows - 1) * (h - vs[0])) + abs((cols - 1) * mh[0])
            for r in range(rows):
                for c in range(cols):
                    x, y = grid_position(c, r, cols, rows, h, w, hs, vs)
                    place[r * cols + c] = (y, x, 0.0, 0.0,
                                           grid_crops(c, r, cols, rows,
                                                      hs, vs))
        feather = opts['blend_method'] == 'feather'
        shape = (nchan, ch + h, cw + w)
        if feather:
            acc = torch.zeros(shape, dtype=torch.float64, device=device)
            wsum = torch.zeros(shape, dtype=torch.float64, device=device)
            ramp = feather_ramp(h, w, opts['feather_px'], device)
        else:
            canvas = torch.zeros(shape, dtype=torch.float64, device=device)
        for t in acq['tiles']:
            if t['region'] != region:
                continue
            ci = acq['channels'].index(t['channel'])
            k = ys.index(t['y']) * cols + xs.index(t['x'])
            y, x, fy, fx, (top, bot, left, right) = place[k]
            img = torch.from_numpy(read_tile(t['path']).astype(np.int32)).to(
                device)
            if fy or fx:
                img = shift_subpixel(img, fy, fx, dtype)
            v = (correct(img, recips[ci], dtype) if ci in recips
                 else img.double())
            win = (ci, slice(y + top, y + h - bot), slice(x + left, x + w - right))
            part = v[top:h - bot, left:w - right]
            if feather:
                rp = ramp[top:h - bot, left:w - right].to(dtype)
                acc[win] = (acc[win].to(dtype) + rp * part.to(dtype)).double()
                wsum[win] = (wsum[win].to(dtype) + rp).double()
            else:
                canvas[win] = part
        if feather:
            res = torch.where(wsum > 0, acc / wsum.clamp(min=1e-6),
                              torch.zeros((), dtype=torch.float64,
                                          device=device))
            canvas = torch.round(res).clamp(0, 65535)
            del acc, wsum
        level = canvas[:, :ch, :cw].to(torch.int32)
        del canvas
        n_levels = pyramid_levels(cw, ch, grid_dim)
        levels = [level]
        for _ in range(1, n_levels):
            prev = levels[-1]
            levels.append(prev[:, :prev.shape[1] // 2 * 2:2,
                               :prev.shape[2] // 2 * 2:2].contiguous())
        out['regions'][region] = {
            'levels': levels,
            'meta': expected_meta(config, acq, region,
                                  [tuple(lv.shape) for lv in levels])}
    return out


# -------------------------------------------------------------- metadata

def expected_meta(config: Dict, acq: Dict, region: str,
                  shapes: List[Tuple[int, int, int]]) -> Dict:
    """The NGFF 0.4 ``.zattrs`` multiscales and each level's ``.zarray``
    that the configuration's writer settings fix."""
    opts = config['options']
    chunks = opts['chunks']
    dz = float(acq['params'].get('dz(um)', 1.0))
    px = acq['pixel_um']
    axes = [{"name": "t", "type": "time", "unit": "second"},
            {"name": "c", "type": "channel"},
            {"name": "z", "type": "space", "unit": "micrometer"},
            {"name": "y", "type": "space", "unit": "micrometer"},
            {"name": "x", "type": "space", "unit": "micrometer"}]
    datasets = [{"path": str(k), "coordinateTransformations": [{
        "type": "scale", "scale": [1, 1, dz, px * 2 ** k, px * 2 ** k]}]}
        for k in range(len(shapes))]
    arrays = []
    for c, hh, ww in shapes:
        shape = [1, c, 1, hh, ww]
        arrays.append({
            'chunks': [min(int(a), int(b)) for a, b in zip(chunks, shape)],
            'compressor': {'blocksize': 0, 'clevel': opts['compressor_clevel'],
                           'cname': opts['compressor_cname'], 'id': 'blosc',
                           'shuffle': opts['compressor_shuffle']},
            'dimension_separator': '/', 'dtype': '<u2', 'fill_value': 0,
            'filters': None, 'order': 'C', 'shape': shape, 'zarr_format': 2})
    return {'axes': axes, 'datasets': datasets, 'version': '0.4',
            'channels': list(acq['channels']), 'arrays': arrays}
