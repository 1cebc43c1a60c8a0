"""Several processes over ``torch.distributed``: process groups, the pod
mesh and work-sharded stitching.

The counterpart of the JAX package's ``parallel/distributed.py``. Every
process runs the same program; :func:`initialize` joins them in a
process group:

- the barrier and all control traffic ride a **gloo** group in every
  case (the counterpart of JAX's coordination service, which lives off
  the device): ``monitored_barrier`` gives the pre-merge barrier its
  deadline;
- device tensors ride **NCCL** where every process has a card of its
  own. Where processes share a card (a one-card host), they ride gloo
  through pinned host copies. The choice is printed, never made
  silently.

Recipe, one process per card (``torchrun --nproc-per-node N`` sets the
environment; elsewhere pass the coordinator, count and rank)::

    from image_stitcher_tpu_torch.parallel import distributed as dist
    dist.initialize()                  # env:// under torchrun
    pipe = dist.stitch_distributed(params, EngineOptions(
        output_folder=shared))         # work_shard = (rank, world)

Each process stitches the (timepoint, region) units it owns (round
robin) into one shared output tree, the processes meet at the pre-merge
barrier, and process 0 runs the merges. A single process needs no
initialisation: its pod mesh is the local one and its shard (0, 1).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from .mesh import AXIS_CANVAS, AXIS_DATA, Mesh, available_devices

#: how long the rendezvous and a collective may wait
TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass
class Cluster:
    """What :func:`initialize` set up for this process."""
    rank: int
    world: int
    #: this process's device: its own card, or the CPU
    device: torch.device
    #: 'nccl' or 'gloo': what device tensors ride
    device_backend: str
    #: the gloo group of control traffic (the default group)
    control: object
    #: the group of device tensors (NCCL), or the control group
    data: object


#: set by :func:`initialize`: the process group is process-wide in
#: torch.distributed, and so is this record of it
_cluster: Optional[Cluster] = None


def _local_world(world: int) -> int:
    """Processes on this host: torchrun's LOCAL_WORLD_SIZE, else every
    process (a coordinator address without torchrun: one host)."""
    return int(os.environ.get('LOCAL_WORLD_SIZE', world))


def _local_rank(rank: int) -> int:
    return int(os.environ.get('LOCAL_RANK', rank))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               platform: Optional[str] = None) -> Cluster:
    """Join the process group; returns this process's :class:`Cluster`.

    ``coordinator_address`` ('host:port') with ``num_processes`` and
    ``process_id`` rendezvous over ``tcp://``; without it, ``env://``
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, as torchrun sets them).
    A process takes the card ``LOCAL_RANK % device_count``; without a
    card it raises, as the port's entry points do. ``platform='cpu'``
    pins the CPU (the tests ask for it)."""
    global _cluster
    if platform not in (None, 'cpu', 'cuda'):
        raise ValueError(f"platform must be 'cpu' or 'cuda', not {platform!r}")
    if platform != 'cpu' and not torch.cuda.is_available():
        raise RuntimeError("distributed.initialize(): torch.cuda."
                           "is_available() is false; pass platform='cpu' "
                           "to run on the CPU")
    if coordinator_address is None:
        tdist.init_process_group('gloo', init_method='env://',
                                 timeout=TIMEOUT)
    else:
        tdist.init_process_group(
            'gloo', init_method=f'tcp://{coordinator_address}',
            world_size=int(num_processes), rank=int(process_id),
            timeout=TIMEOUT)
    rank, world = tdist.get_rank(), tdist.get_world_size()
    control = tdist.group.WORLD
    if platform == 'cpu':
        device, backend, why = torch.device('cpu'), 'gloo', 'the CPU'
    else:
        count = torch.cuda.device_count()
        device = torch.device('cuda', _local_rank(rank) % count)
        torch.cuda.set_device(device)
        if _local_world(world) <= count:
            backend, why = 'nccl', f'one card a process ({count} cards)'
        else:
            backend = 'gloo'
            why = (f"{_local_world(world)} processes share {count} "
                   f"card(s): device tensors go through pinned host copies")
    data = (tdist.new_group(backend='nccl', timeout=TIMEOUT)
            if backend == 'nccl' else control)
    _cluster = Cluster(rank, world, device, backend, control, data)
    print(f"distributed: rank {rank}/{world} on {device}; control over gloo, "
          f"device tensors over {backend} ({why})", flush=True)
    return _cluster


def shutdown() -> None:
    """Leave the process group (the NCCL group with it)."""
    global _cluster
    if tdist.is_initialized():
        tdist.destroy_process_group()
    _cluster = None


def control_group():
    """The gloo group of control traffic and the pre-merge barrier: the
    one :func:`initialize` made, or the default group when it is gloo."""
    if _cluster is not None:
        return _cluster.control
    if tdist.get_backend() == 'gloo':
        return tdist.group.WORLD
    raise RuntimeError("the pre-merge barrier rides a gloo group, and the "
                       f"default group is {tdist.get_backend()}: join "
                       "through distributed.initialize()")


def rank_and_world() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return 0, 1


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``: pinned and made on a side stream of its card
    for a CUDA tensor (synchronised before it returns)."""
    if t.device.type != 'cuda':
        return t.detach().clone()
    host = torch.empty(tuple(t.shape), dtype=t.dtype, pin_memory=True)
    side = torch.cuda.Stream(t.device)
    side.wait_stream(torch.cuda.current_stream(t.device))
    with torch.cuda.stream(side):
        host.copy_(t, non_blocking=True)
    t.record_stream(side)
    side.synchronize()
    return host


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the processes, in place: over NCCL for a card
    tensor when every process has its own card, else over gloo."""
    c = _cluster
    if c is None:
        raise RuntimeError("distributed.initialize() has not run")
    if t.device.type == 'cuda' and c.device_backend == 'nccl':
        tdist.all_reduce(t, group=c.data)
        return t
    host = _to_host(t)
    tdist.all_reduce(host, group=c.control)
    t.copy_(host)
    return t


def all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    """Every process's ``t`` (one shape on all), in rank order, on
    ``t``'s device."""
    c = _cluster
    if c is None:
        raise RuntimeError("distributed.initialize() has not run")
    # both move bytes of any dtype (neither has uint16 or bool of its own)
    if t.device.type == 'cuda' and c.device_backend == 'nccl':
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(c.world)]
        tdist.all_gather([_bytes(o) for o in out], _bytes(t), group=c.data)
        return out
    host = _to_host(t.contiguous())
    out = [torch.empty_like(host) for _ in range(c.world)]
    tdist.all_gather([_bytes(o) for o in out], _bytes(host), group=c.control)
    return [o.to(t.device) for o in out]


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A flat uint8 view of a contiguous tensor's storage."""
    return t.reshape(-1).view(torch.uint8)


def make_pod_mesh(local_shape: Optional[Tuple[int, int]] = None,
                  local_devices: Optional[Sequence] = None) -> Mesh:
    """The global (data, canvas) mesh over every process's devices.

    Rows of the grid are processes, columns each process's local devices
    (``local_devices``: by default this process's device after
    :func:`initialize`, else every CUDA card), so a band's
    fusion never leaves its process. ``local_shape=(d, c)`` splits each
    process's devices over both axes (data = processes * d). The grid
    comes from every process's device list, gathered over the control
    group; without a process group it is the local (1, n) mesh."""
    c = _cluster
    if local_devices is None:
        local_devices = ([c.device] if c is not None
                         else available_devices())
    own = [torch.device(d) for d in local_devices]
    if not own:
        raise ValueError("no local devices for the pod mesh: torch.cuda "
                         "finds no card; pass local_devices=")
    rank, world = rank_and_world()
    if world > 1:
        lists: List = [None] * world
        tdist.all_gather_object(lists, [str(d) for d in own])
    else:
        lists = [[str(d) for d in own]]
    per_proc = len(own)
    if any(len(lst) != per_proc for lst in lists):
        raise ValueError(f"processes hold different device counts: "
                         f"{[len(lst) for lst in lists]}")
    d, cols = (1, per_proc) if local_shape is None else local_shape
    if d * cols != per_proc:
        raise ValueError(f"local_shape {local_shape} != {per_proc} "
                         "devices per process")
    grid, owners = [], []
    for r, lst in enumerate(lists):
        for k in range(d):
            grid.append([torch.device(x) for x in lst[k * cols:(k + 1) * cols]])
            owners.append([r] * cols)
    return Mesh(grid, owners, process=rank)


def replicate_to_mesh(mesh: Mesh, *arrays) -> Tuple[torch.Tensor, ...]:
    """Process 0's host arrays on every process (broadcast over the
    control group), as host tensors for :meth:`~.sharded_fuse.
    ShardedCanvas.fuse_batch`; every process passes arrays of one shape
    and dtype. Without a process group, the arrays as tensors."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a)).clone()
        if rank_and_world()[1] > 1:
            tdist.broadcast(_bytes(t), src=0, group=control_group())
        out.append(t)
    return tuple(out)


def stitch_distributed(params, options=None, reporter=None, device=None,
                       state=None):
    """Run one stitching job cooperatively across every process of the
    group: each stitches the (timepoint, region) units it owns
    (deterministic round robin) into ONE shared output tree; all meet at
    the pre-merge barrier, then process 0 runs the merges. Returns this
    process's pipeline. ``device`` defaults to this process's device
    (:class:`Cluster`), or CUDA; ``state`` (a ``CarriedState``) is
    passed to every process's pipeline."""
    from ..models.pipeline import StitchPipeline
    from ..params import EngineOptions

    opts = (dataclasses.replace(options) if options is not None
            else EngineOptions())
    if opts.output_folder is None:
        # deterministic: the processes' timestamps differ
        opts.output_folder = params.input_folder + "_stitched_distributed"
    opts.work_shard = rank_and_world()
    if device is None and _cluster is not None:
        device = _cluster.device
    pipe = StitchPipeline(params, opts, reporter, device=device, state=state)
    pipe.run()
    return pipe


# ---------------------------------------------------------------------------
# Multi-process validation: `python -m image_stitcher_tpu_torch.parallel.
# distributed <process_id> <num_processes> <port> [devices] [cuda|cpu]`
# (localhost), or under `torchrun` with no arguments or only [cuda|cpu]
# (env://, one card a process); the card unless 'cpu' is given -- every process joins the group, sums over the processes, and
# fuses one replicated batch through a ShardedCanvas over the pod mesh,
# its bands gathered from every process and held byte-equal to one plain
# fuse_overwrite.
# ---------------------------------------------------------------------------

def _worker_main(process_id: Optional[int], num_processes: Optional[int],
                 port: Optional[int], devices_per_process: int = 2,
                 platform: str = 'cuda') -> None:
    """One validation process; ``port`` None joins through env://."""
    from ..ops.fuse import fuse_overwrite, padded_canvas_shape
    from .sharded_fuse import ShardedCanvas

    c = initialize(None if port is None else f"localhost:{port}",
                   num_processes=num_processes, process_id=process_id,
                   platform=platform)
    process_id, num_processes = c.rank, c.world
    mesh = make_pod_mesh(local_devices=[c.device] * devices_per_process)
    if (mesh.shape[AXIS_DATA], mesh.shape[AXIS_CANVAS]) != (
            num_processes, devices_per_process):
        raise RuntimeError(f"pod mesh {mesh}")

    # 1. a sum over the processes, of a tensor on this process's device
    x = torch.full((8,), float(process_id + 1), device=c.device)
    all_reduce(x)
    expect = sum(range(1, num_processes + 1))
    if not bool((x == expect).all()):
        raise RuntimeError(f"all_reduce gave {x.tolist()}, not {expect}")

    # 2. banded fusion over the pod mesh against the plain version
    rng = np.random.default_rng(0)
    H = W = 64
    th = tw = 16
    nb = 6
    tiles = rng.integers(0, 60000, (nb, th, tw), np.uint16)
    info = np.stack([np.zeros(nb, int), np.zeros(nb, int),
                     rng.integers(0, H - th, nb),
                     rng.integers(0, W - tw, nb)], 1).astype(np.int32)
    crops = np.zeros((nb, 4), np.int32)
    valid = np.ones((nb,), bool)
    tiles_t, info_t, crops_t, valid_t = replicate_to_mesh(
        mesh, tiles, info, crops, valid)
    canvas = ShardedCanvas(mesh, 1, 1, H, W, th, tw, np.uint16)
    canvas.fuse_batch(tiles_t.pin_memory() if c.device.type == 'cuda'
                      else tiles_t, info_t, crops_t, valid_t)
    fused = canvas.finalize()
    gathered = all_gather(fused)
    ref = torch.zeros(padded_canvas_shape(1, 1, H, W, th, tw),
                      dtype=torch.uint16)
    ref = fuse_overwrite(ref, torch.from_numpy(tiles), torch.from_numpy(info),
                         torch.from_numpy(crops),
                         torch.from_numpy(valid))[:, :, :H, :W]
    for r, g in enumerate(gathered):
        if not torch.equal(g.cpu(), ref):
            raise RuntimeError(f"process {r}'s bands differ from the plain "
                               "fuse_overwrite")
    print(f"distributed worker {process_id}/{num_processes} OK "
          f"({len(mesh.devices)} mesh devices, device tensors over "
          f"{c.device_backend})", flush=True)
    shutdown()


def run_localhost_validation(num_processes: int = 2, port: int = 0,
                             devices_per_process: int = 2,
                             timeout: float = 240.0,
                             platform: str = 'cuda') -> None:
    """Start ``num_processes`` local workers in one group over localhost,
    all at once, and check the whole story (group, sum, banded fusion
    gathered and held to the plain version) on the card, or on the CPU
    with ``platform='cpu'``. Raises on any failure or timeout; a worker
    that outlives ``timeout`` is killed."""
    import socket
    import subprocess
    import sys
    if port == 0:
        with socket.socket() as s:
            s.bind(('localhost', 0))
            port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'image_stitcher_tpu_torch.parallel.distributed',
         str(i), str(num_processes), str(port), str(devices_per_process),
         platform],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=root)
        for i in range(num_processes)]
    failures = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            failures.append(f"worker timed out:\n{out.decode()[-2000:]}")
            continue
        if p.returncode != 0:
            failures.append(f"worker rc={p.returncode}:\n"
                            f"{out.decode()[-2000:]}")
    if failures:
        raise RuntimeError("multi-process validation failed:\n"
                           + "\n---\n".join(failures))


if __name__ == '__main__':
    import sys
    if len(sys.argv) <= 2:     # under torchrun
        _worker_main(None, None, None, devices_per_process=1,
                     platform=sys.argv[1] if len(sys.argv) == 2 else 'cuda')
    else:
        _worker_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                     int(sys.argv[4]) if len(sys.argv) > 4 else 2,
                     sys.argv[5] if len(sys.argv) > 5 else 'cuda')
