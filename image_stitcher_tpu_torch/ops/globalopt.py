"""Global position optimization over the pairwise-shift graph.

A copy of the JAX package's ``ops/globalopt.py`` (NumPy only): every
adjacent pair's measured displacement becomes a constraint
p_j - p_i = d_ij, and tile positions come from the weighted
least-squares solution of that graph (a graph-Laplacian linear system,
solved per axis), robustified by IRLS. Handles per-tile stage error that
no grid model can express. The pairwise measurements come from
``models/pipeline.py::calculate_shifts_all_pairs``; the solve is a tiny
dense system (n_tiles x n_tiles) on the host.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

Pair = Tuple[int, int, float, float, float]  # (i, j, dy, dx, weight)


def _solve_once(pairs: Sequence[Pair], weights: np.ndarray, n_tiles: int,
                anchor: int) -> np.ndarray:
    lap = np.zeros((n_tiles, n_tiles), np.float64)
    rhs = np.zeros((n_tiles, 2), np.float64)
    for (i, j, dy, dx, _), w in zip(pairs, weights):
        lap[i, i] += w
        lap[j, j] += w
        lap[i, j] -= w
        lap[j, i] -= w
        rhs[i] -= w * np.array([dy, dx])
        rhs[j] += w * np.array([dy, dx])
    lap[anchor, :] = 0.0
    lap[anchor, anchor] = 1.0
    rhs[anchor] = 0.0
    pos, *_ = np.linalg.lstsq(lap, rhs, rcond=None)
    return pos


def solve_positions(pairs: Sequence[Pair], n_tiles: int,
                    anchor: int = 0, irls_iters: int = 3,
                    irls_scale_px: float = 3.0) -> np.ndarray:
    """Positions (n_tiles, 2) minimizing sum w*(p_j - p_i - d_ij)^2.

    Robustified by IRLS: after each solve, constraints are reweighted by
    a Cauchy function of their residual, so outlier measurements (e.g.
    pairs involving a corrupted tile) stop polluting their neighbors —
    confidence weights alone only down-weight them proportionally.

    The system is singular up to a global translation; the anchor tile is
    pinned at the origin, then positions are shifted so min is 0.
    Disconnected tiles (no constraints) stay at the anchor position.
    """
    if not pairs:
        return np.zeros((n_tiles, 2), np.float64)
    base_w = np.array([p[4] for p in pairs], np.float64)
    weights = base_w.copy()
    pos = _solve_once(pairs, weights, n_tiles, anchor)
    for _ in range(irls_iters):
        res = np.array([
            np.hypot(pos[j, 0] - pos[i, 0] - dy, pos[j, 1] - pos[i, 1] - dx)
            for i, j, dy, dx, _ in pairs])
        weights = base_w / (1.0 + (res / irls_scale_px) ** 2)
        pos = _solve_once(pairs, weights, n_tiles, anchor)
    pos -= pos.min(axis=0, keepdims=True)
    return pos


def grid_pairs_from_shifts(
    h_shifts: Dict[Tuple[int, int], Tuple[float, float]],
    v_shifts: Dict[Tuple[int, int], Tuple[float, float]],
    n_rows: int, n_cols: int,
    tile_w: int, tile_h: int,
    strip_w: int, strip_h: int,
    h_weights: Dict[Tuple[int, int], float] = None,
    v_weights: Dict[Tuple[int, int], float] = None,
) -> List[Pair]:
    """Convert measured strip correlations into absolute constraints.

    ``h_shifts[(r, c)]`` is the pcc result (sy, sx) between tile (r,c)'s
    right strip and (r,c+1)'s left strip; the implied displacement is
    dx = tile_w + (sx - strip_w), dy = sy (reference convention,
    stitcher.py:511). Vertical analog with dy = tile_h + (sy - strip_h).
    """
    pairs: List[Pair] = []

    def idx(r, c):
        return r * n_cols + c

    for (r, c), (sy, sx) in h_shifts.items():
        w = (h_weights or {}).get((r, c), 1.0)
        pairs.append((idx(r, c), idx(r, c + 1),
                      float(sy), tile_w + float(sx) - strip_w, max(w, 1e-6)))
    for (r, c), (sy, sx) in v_shifts.items():
        w = (v_weights or {}).get((r, c), 1.0)
        pairs.append((idx(r, c), idx(r + 1, c),
                      tile_h + float(sy) - strip_h, float(sx), max(w, 1e-6)))
    return pairs


def positions_to_int(pos: np.ndarray) -> np.ndarray:
    """Round optimized positions to integer pixel placements."""
    return np.round(pos).astype(np.int64)
