"""Data-parallel wrappers for the batched compute ops.

The counterpart of the JAX package's ``parallel/sharded_ops.py``: batch
work (registration pairs, tile correction) splits its leading axis over
the devices of the mesh's data axis (:meth:`~.mesh.Mesh.column` 0);
each device runs the port's batch function on its slice, and the
results are gathered in order on the first of them. A repeated device
runs its slices one after the other.
"""

from __future__ import annotations

from typing import List

import torch

from ..ops.fuse import apply_flatfield
from ..ops.phasecorr import phase_cross_correlation_conf_batch
from .mesh import Mesh


def shard_batch(mesh: Mesh, *arrays):
    """Split each array's leading axis over the data-axis devices: per
    array, a list of (as equal as possible) slices, one per device, each
    copied to its device. Returns the list, or a tuple of lists for
    several arrays."""
    devices = mesh.column(0)
    out = []
    for a in arrays:
        a = torch.as_tensor(a)
        pieces = torch.tensor_split(a, len(devices), dim=0)
        out.append([p.to(d) for p, d in zip(pieces, devices)])
    return tuple(out) if len(out) > 1 else out[0]


def _gather(pieces: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([p.to(pieces[0].device) for p in pieces], dim=0)


def sharded_phase_cross_correlation(mesh: Mesh, refs, movings,
                                    upsample_factor: int = 10
                                    ) -> torch.Tensor:
    """(N, h, w) strip pairs split over the data axis -> (N, 2) float32
    shifts (dy, dx), on the first data-axis device."""
    refs, movings = shard_batch(mesh, refs, movings)
    return _gather([phase_cross_correlation_conf_batch(a, b,
                                                       upsample_factor)[0]
                    for a, b in zip(refs, movings)])


def sharded_apply_flatfield(mesh: Mesh, tiles, flatfields, channel_idx,
                            out_dtype: torch.dtype) -> torch.Tensor:
    """trunc(clip(tile * recip)) of (N, th, tw) tiles split over the data
    axis, ``flatfields`` (C, th, tw) float32 reciprocal fields copied to
    each device once; the (N, th, tw) result on the first device."""
    tiles, channel_idx = shard_batch(mesh, tiles, channel_idx)
    fields = {}
    for t in tiles:
        if t.device not in fields:
            fields[t.device] = torch.as_tensor(flatfields).to(t.device)
    return _gather([apply_flatfield(t, fields[t.device], c, out_dtype)
                    for t, c in zip(tiles, channel_idx)])
