"""Overwrite placement: the hand-written CUDA kernel and its dispatch.

Replaces the TPU kernel ``image_stitcher_tpu/ops/pallas_fuse.py::
fuse_overwrite_pallas`` (Pallas body ``_fuse_kernel``), with and without
the fused flatfield. The kernel is ``csrc/fuse_overwrite.cu``; its plain
PyTorch version is :func:`image_stitcher_tpu_torch.ops.fuse.fuse_overwrite`.

Bound: memory. With the flatfield a pixel moves about 8 B (2 B of u16
tile, 4 B of f32 reciprocal, 2 B written), about 34 MB per 2048^2 tile;
there is no arithmetic to speak of. The kernel reads each tile pixel at
most once and writes each canvas pixel at most once per batch: a pixel
that a later tile of the batch covers is neither read nor written, which
is how the kernel keeps later-tile-wins without ordering its blocks (see
the source note in the .cu file).

Dispatch is by the canvas's device, and only by it: a CPU tensor takes
the plain version; a CUDA tensor launches the kernel or raises (a build
or launch failure is never answered by falling back to the plain
version).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import native
from . import fuse as plain

_P = ctypes.c_void_p
_I = ctypes.c_int


def _kernel():
    lib = native.load('fuse_overwrite')
    fn = lib.fuse_overwrite_launch
    if fn.argtypes is None:
        fn.argtypes = [_I, _I, _P, _I, _I, _I, _P, _I, _I, _I,
                       _P, _P, _P, _P, _P]
        fn.restype = _I
        lib.fuse_overwrite_error_string.argtypes = [_I]
        lib.fuse_overwrite_error_string.restype = ctypes.c_char_p
        lib.fuse_overwrite_max_batch.argtypes = []
        lib.fuse_overwrite_max_batch.restype = _I
    return lib


def fuse_overwrite(canvas: torch.Tensor, tiles: torch.Tensor,
                   info: torch.Tensor, crops: torch.Tensor,
                   valid: torch.Tensor,
                   ff_recip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Place a batch of tiles into ``canvas`` in place; returns it.

    canvas (C, Z, Hp, Wp) uint8/uint16, padded as
    :func:`~image_stitcher_tpu_torch.ops.fuse.padded_canvas_shape`;
    tiles (N, th, tw) of the same dtype and device; info (N, 4) int32
    [c, z, y, x], crops (N, 4) int32 [top, bottom, left, right] and
    valid (N,) bool on the host; ff_recip (C_ff, th, tw) float32
    reciprocal flatfields on the canvas device, indexed by info[:, 0].

    On CUDA the launch goes on the current stream, does not synchronize
    and allocates nothing on the device."""
    if canvas.device.type == 'cpu':
        return plain.fuse_overwrite(canvas, tiles, info, crops, valid,
                                    ff_recip)
    if canvas.device.type != 'cuda':
        raise ValueError(f"no fusion kernel for device {canvas.device}")
    plain.check_batch(canvas, tiles, info, crops, valid, ff_recip)
    lib = _kernel()
    n, th, tw = tiles.shape
    if n > lib.fuse_overwrite_max_batch():
        raise ValueError(f"batch of {n} tiles exceeds the kernel's "
                         f"{lib.fuse_overwrite_max_batch()}")
    info_h = info.contiguous()
    crops_h = crops.contiguous()
    valid_h = valid.to(torch.uint8).contiguous()
    _, Z, Hp, Wp = canvas.shape
    rc = lib.fuse_overwrite_launch(
        canvas.device.index if canvas.device.index is not None
        else torch.cuda.current_device(),
        canvas.element_size(), canvas.data_ptr(), Z, Hp, Wp,
        tiles.data_ptr(), n, th, tw,
        info_h.data_ptr(), crops_h.data_ptr(), valid_h.data_ptr(),
        ff_recip.data_ptr() if ff_recip is not None else None,
        torch.cuda.current_stream(canvas.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            "fuse_overwrite kernel launch failed: "
            f"{lib.fuse_overwrite_error_string(rc).decode()} (cudaError {rc})")
    fuse_overwrite.launches += 1
    return canvas


#: kernel launches since the count was last set to 0 (CUDA path only)
fuse_overwrite.launches = 0
