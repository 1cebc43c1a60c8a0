"""Device meshes: a (data, canvas) grid of ``torch.device``\\ s.

The counterpart of the JAX package's ``parallel/mesh.py``. The
stitcher's two parallel axes:
- 'data'   -- batch parallelism: registration pairs, flatfield stacks,
  tile correction (:mod:`.sharded_ops`);
- 'canvas' -- spatial parallelism: the fused canvas is cut into Y bands,
  one per device of the canvas axis (:mod:`.sharded_fuse`).

A device list may repeat a device: ``[torch.device('cpu')] * 8`` is the
port's counterpart of the 8 virtual XLA host devices the JAX tests run
on, and ``[cuda:0, cuda:0]`` bands one card twice. In a multi-process
run (:func:`~.distributed.make_pod_mesh`) each row of the grid belongs
to one process; ``processes`` says which, and a process works only on
the rows it owns.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

AXIS_DATA = 'data'
AXIS_CANVAS = 'canvas'


class Mesh:
    """``grid[r][c]``: the device at data row ``r``, canvas column ``c``;
    ``processes[r][c]``: the rank that owns it, and ``process`` this
    process's rank (0 and all zeros in a single-process run)."""

    axis_names = (AXIS_DATA, AXIS_CANVAS)

    def __init__(self, grid: Sequence[Sequence[torch.device]],
                 processes: Optional[Sequence[Sequence[int]]] = None,
                 process: int = 0):
        self.grid: Tuple[Tuple[torch.device, ...], ...] = tuple(
            tuple(_indexed(d) for d in row) for row in grid)
        n_data, n_canvas = len(self.grid), len(self.grid[0])
        if n_data < 1 or n_canvas < 1 or any(len(r) != n_canvas
                                             for r in self.grid):
            raise ValueError("a mesh is a non-empty rectangular grid")
        self.processes = tuple(
            tuple(int(p) for p in row)
            for row in (processes if processes is not None
                        else [[0] * n_canvas] * n_data))
        self.process = int(process)
        #: {axis name: size}, as the JAX mesh's ``shape``
        self.shape = {AXIS_DATA: n_data, AXIS_CANVAS: n_canvas}

    @property
    def devices(self) -> List[torch.device]:
        """Every device of the grid, row by row (repeats kept)."""
        return [d for row in self.grid for d in row]

    def row(self, r: int) -> List[torch.device]:
        """The devices of data row ``r``: one per canvas band."""
        return list(self.grid[r])

    def column(self, c: int) -> List[torch.device]:
        """The devices of canvas column ``c``: one per data slice."""
        return [row[c] for row in self.grid]

    def local_row(self) -> int:
        """The first data row this process owns; its devices fuse the
        bands (one replica, where the JAX package keeps one a row)."""
        for r, owners in enumerate(self.processes):
            if all(p == self.process for p in owners):
                return r
        raise ValueError(f"process {self.process} owns no row of the mesh")

    def __repr__(self) -> str:
        return (f"Mesh({self.shape[AXIS_DATA]}x{self.shape[AXIS_CANVAS]}, "
                f"{[[str(d) for d in row] for row in self.grid]})")


def _indexed(device) -> torch.device:
    """``device`` with its index: 'cuda' names the current card, and a
    tensor's device always carries one."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


def available_devices() -> List[torch.device]:
    """Every CUDA card of this process, in index order."""
    if not torch.cuda.is_available():
        return []
    return [torch.device('cuda', i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, canvas) mesh.

    ``shape`` is (n_data, n_canvas); the default puts every device on
    the canvas axis (fusion is the bandwidth-bound stage). ``devices``
    defaults to every CUDA card; it may repeat a device."""
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else available_devices())]
    n = len(devices)
    if shape is None:
        if n == 0:
            raise ValueError("no devices for a mesh: torch.cuda finds no "
                             "card; pass devices=")
        shape = (1, n)
    needed = shape[0] * shape[1]
    if needed > n:
        raise ValueError(f"mesh shape {shape} needs {needed} devices, "
                         f"only {n} available")
    d, c = shape
    return Mesh([devices[r * c:(r + 1) * c] for r in range(d)])


def default_mesh_shape(n: int) -> Tuple[int, int]:
    """Split devices 2 x n/2 when possible so both axes are exercised."""
    if n % 2 == 0 and n > 1:
        return (2, n // 2)
    return (1, n)
