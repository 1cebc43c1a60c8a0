"""Fusion kernels written by hand in CUDA, and their dispatch.

- :func:`fuse_overwrite` replaces the TPU kernel ``image_stitcher_tpu/
  ops/pallas_fuse.py::fuse_overwrite_pallas`` (Pallas body
  ``_fuse_kernel``), with and without the fused flatfield; kernel
  ``csrc/fuse_overwrite.cu``. Bound: memory, each written pixel's tile
  read and canvas write (2 + 2 B in u16) plus each used f32 field once
  (it stays in L2 while the batch's tiles read it): ~117 MB, ~0.035 ms
  at 3.35 TB/s, for ten 2048^2 u16 tiles into the main path's band. A
  warp copies one tile row: it subtracts the later tiles' windows from
  the row once, so a pixel that a later tile covers is neither read nor
  written (later-tile-wins without ordering the blocks), and copies the
  uncovered spans with 16-byte loads and 16-byte canvas stores.
- :func:`fuse_feather` replaces ``fuse_feather_pallas`` (Pallas body
  ``_feather_kernel``), and :func:`finalize_feather` is its epilogue;
  kernels ``csrc/fuse_feather.cu``. Bound: memory, 16 B per weighted
  canvas pixel (acc and wsum read and written), each window's tile
  pixels and each used field once: ~0.47 GB, ~0.14 ms for the same
  batch. Each canvas pixel has one owning thread (4 columns x 2 rows a
  thread, float4 sums) that adds its tiles in batch order with rounded
  products and sums and a ramp table, so the float sums are the plain
  version's, bit for bit.

The kernels take any canvas pitch and tile width; 16-byte canvas traffic
needs rows that start 16-byte aligned, which both callers give them (the
band fuser's single-plane bands, ``models/streaming.py::
band_canvas_shape``, and the in-RAM path's whole (C, Z, Hp, Wp) canvases,
``models/pipeline.py::StitchPipeline.stitch_region``, pad the row to a
multiple of 8 elements). Other pitches take the same kernels with scalar
loads or stores where a vector would straddle an alignment. Element
offsets are 64-bit; extents are C ints, and :func:`check_extents` refuses
a canvas beyond what a kernel's grid covers.

The plain PyTorch versions are the functions of the same names in
:mod:`image_stitcher_tpu_torch.ops.fuse`; the source notes in the .cu
files give each design. Dispatch is by the device, and only by it: CPU
tensors take the plain version; CUDA tensors launch the kernel or raise
(a build or launch failure is never answered by falling back to the
plain version).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import native
from . import fuse as plain

_P = ctypes.c_void_p
_I = ctypes.c_int

#: tiles one launch takes (``kMaxBatch`` in both .cu files)
MAX_BATCH = 64

#: what the kernels index: extents are C ints (element offsets are 64-bit),
#: the feather grid's y dimension covers at most 65535 blocks of 16 rows,
#: and the finalize grid's z dimension 65535 (c, z) planes
INT_MAX = 2 ** 31 - 1
FEATHER_MAX_ROWS = 65535 * 16
MAX_PLANES = 65535


def check_extents(shape, max_rows: int = INT_MAX,
                  max_planes: int = INT_MAX) -> None:
    """Raise if a (C, Z, Hp, Wp) canvas exceeds what a kernel indexes."""
    C, Z, Hp, Wp = (int(v) for v in shape)
    if max(C, Z, Wp) > INT_MAX or Hp > max_rows or C * Z > max_planes:
        raise ValueError(f"canvas {tuple(shape)} exceeds the kernel's "
                         f"extents: at most {max_planes} (c, z) planes, "
                         f"{max_rows} rows and {INT_MAX} columns")


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


#: the kernels' dtype codes (``DType`` in ``csrc/sample_types.h``)
DTYPE_CODES = {torch.uint8: 0, torch.int8: 1, torch.uint16: 2,
               torch.int16: 3, torch.int32: 4, torch.uint32: 5,
               torch.float32: 6}


def _spans(n: int):
    """[lo, hi) runs of at most MAX_BATCH tiles covering a batch of n."""
    return [(lo, min(n, lo + MAX_BATCH)) for lo in range(0, n, MAX_BATCH)]


def fuse_overwrite(canvas: torch.Tensor, tiles: torch.Tensor,
                   info: torch.Tensor, crops: torch.Tensor,
                   valid: torch.Tensor,
                   ff_recip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Place a batch of tiles into ``canvas`` in place; returns it.

    canvas (C, Z, Hp, Wp) of ``ops/fuse.py::FUSE_DTYPES``, padded as
    :func:`~image_stitcher_tpu_torch.ops.fuse.padded_canvas_shape`;
    tiles (N, th, tw) of the same dtype and device; info (N, 4) int32
    [c, z, y, x], crops (N, 4) int32 [top, bottom, left, right] and
    valid (N,) bool on the host; ff_recip (C_ff, th, tw) float32
    reciprocal flatfields on the canvas device, indexed by info[:, 0].

    A batch of more than MAX_BATCH tiles is placed by consecutive calls
    of at most MAX_BATCH tiles in batch order: a later call overwrites
    what an earlier one wrote, so later tiles still win, byte for byte
    as in one call. On CUDA each launch goes on the current stream, does
    not synchronize and allocates nothing on the device."""
    for lo, hi in _spans(tiles.shape[0]):
        _fuse_overwrite(canvas, tiles[lo:hi], info[lo:hi], crops[lo:hi],
                        valid[lo:hi], ff_recip)
    return canvas


def _fuse_overwrite(canvas, tiles, info, crops, valid, ff_recip):
    if canvas.device.type == 'cpu':
        return plain.fuse_overwrite(canvas, tiles, info, crops, valid,
                                    ff_recip)
    if canvas.device.type != 'cuda':
        raise ValueError(f"no fusion kernel for device {canvas.device}")
    plain.check_batch(canvas, tiles, info, crops, valid, ff_recip)
    check_extents(canvas.shape)
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
        DTYPE_CODES[canvas.dtype], canvas.data_ptr(), Z, Hp, Wp,
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


def _feather_kernel():
    lib = native.load('fuse_feather')
    fn = lib.fuse_feather_launch
    if fn.argtypes is None:
        fn.argtypes = [_I, _I, _P, _P, _I, _I, _I, _P, _I, _I, _I,
                       _P, _P, _P, _P, _I, _P]
        fn.restype = _I
        fin = lib.finalize_feather_launch
        fin.argtypes = [_I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
        fin.restype = _I
        lib.fuse_feather_error_string.argtypes = [_I]
        lib.fuse_feather_error_string.restype = ctypes.c_char_p
        lib.fuse_feather_max_batch.argtypes = []
        lib.fuse_feather_max_batch.restype = _I
    return lib


def _device_index(t: torch.Tensor) -> int:
    return (t.device.index if t.device.index is not None
            else torch.cuda.current_device())


def fuse_feather(acc: torch.Tensor, wsum: torch.Tensor, tiles: torch.Tensor,
                 info: torch.Tensor, crops: torch.Tensor, valid: torch.Tensor,
                 ff_recip: Optional[torch.Tensor] = None,
                 blend_px: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accumulate a batch of tiles into ``acc``/``wsum`` in place:
    acc += ramp * tile, wsum += ramp over each valid tile's crop window,
    in batch order; returns (acc, wsum).

    acc, wsum (C, Z, Hp, Wp) float32, padded as
    :func:`~image_stitcher_tpu_torch.ops.fuse.padded_canvas_shape`;
    tiles (N, th, tw) of ``ops/fuse.py::FUSE_DTYPES`` (not uint32) on
    their device; info, crops, valid and ff_recip as for
    :func:`fuse_overwrite`, ``blend_px`` the ramp length. A batch of
    more than MAX_BATCH tiles is accumulated by consecutive calls of at
    most MAX_BATCH tiles in batch order, so each pixel adds its tiles in
    the order of one call, bit for bit. On CUDA
    each launch goes on the current stream, does not synchronize and
    allocates nothing on the device; a run of tiles without a valid,
    non-empty window launches nothing."""
    for lo, hi in _spans(tiles.shape[0]):
        _fuse_feather(acc, wsum, tiles[lo:hi], info[lo:hi], crops[lo:hi],
                      valid[lo:hi], ff_recip, blend_px)
    return acc, wsum


def _fuse_feather(acc, wsum, tiles, info, crops, valid, ff_recip, blend_px):
    if acc.device.type == 'cpu':
        return plain.fuse_feather(acc, wsum, tiles, info, crops, valid,
                                  ff_recip, blend_px)
    if acc.device.type != 'cuda':
        raise ValueError(f"no fusion kernel for device {acc.device}")
    plain.check_feather_batch(acc, wsum, tiles, info, crops, valid, ff_recip,
                              blend_px)
    check_extents(acc.shape, max_rows=FEATHER_MAX_ROWS)
    lib = _feather_kernel()
    n, th, tw = tiles.shape
    if n > lib.fuse_feather_max_batch():
        raise ValueError(f"batch of {n} tiles exceeds the kernel's "
                         f"{lib.fuse_feather_max_batch()}")
    info_h = info.contiguous()
    crops_h = crops.contiguous()
    windows = [plain.crop_window(c, th, tw) for c in crops_h.tolist()]
    if not any(ok and r1 > r0 and s1 > s0
               for ok, (r0, r1, s0, s1) in zip(valid.tolist(), windows)):
        return acc, wsum
    valid_h = valid.to(torch.uint8).contiguous()
    _, Z, Hp, Wp = acc.shape
    rc = lib.fuse_feather_launch(
        _device_index(acc), DTYPE_CODES[tiles.dtype], acc.data_ptr(),
        wsum.data_ptr(), Z, Hp, Wp, tiles.data_ptr(), n, th, tw,
        info_h.data_ptr(), crops_h.data_ptr(), valid_h.data_ptr(),
        ff_recip.data_ptr() if ff_recip is not None else None, blend_px,
        torch.cuda.current_stream(acc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            "fuse_feather kernel launch failed: "
            f"{lib.fuse_feather_error_string(rc).decode()} (cudaError {rc})")
    fuse_feather.launches += 1
    return acc, wsum


#: kernel launches since the count was last set to 0 (CUDA path only)
fuse_feather.launches = 0


def finalize_feather(acc: torch.Tensor, wsum: torch.Tensor,
                     out_dtype: torch.dtype,
                     rows: Optional[Tuple[int, int]] = None,
                     cols: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """round(acc / wsum) as ``out_dtype`` over the window [rows) x [cols)
    of the last two axes (the whole plane where None): a new dense
    (C, Z, r1 - r0, s1 - s0) tensor on the canvases' device.

    On CUDA the launch goes on the current stream and does not
    synchronize; the output is allocated with ``torch.empty``."""
    if acc.dim() != 4 or acc.shape != wsum.shape:
        raise ValueError(f"acc and wsum must be one (C, Z, Hp, Wp) shape, "
                         f"got {tuple(acc.shape)} and {tuple(wsum.shape)}")
    C, Z, Hp, Wp = acc.shape
    r0, r1 = rows if rows is not None else (0, Hp)
    s0, s1 = cols if cols is not None else (0, Wp)
    if not (0 <= r0 <= r1 <= Hp and 0 <= s0 <= s1 <= Wp):
        raise ValueError(f"window rows {(r0, r1)} x cols {(s0, s1)} is not "
                         f"inside the canvas {tuple(acc.shape)}")
    plain.check_dtype(out_dtype)
    plain.check_clip_bounds(out_dtype)
    if acc.device.type == 'cpu':
        return plain.finalize_feather(acc[..., r0:r1, s0:s1],
                                      wsum[..., r0:r1, s0:s1], out_dtype)
    if acc.device.type != 'cuda':
        raise ValueError(f"no finalize kernel for device {acc.device}")
    if (acc.dtype != torch.float32 or wsum.dtype != torch.float32
            or acc.device != wsum.device or not acc.is_contiguous()
            or not wsum.is_contiguous()):
        raise ValueError("acc and wsum must be contiguous float32 on one "
                         "device")
    check_extents(acc.shape, max_planes=MAX_PLANES)
    lib = _feather_kernel()
    out = torch.empty((C, Z, r1 - r0, s1 - s0), dtype=out_dtype,
                      device=acc.device)
    rc = lib.finalize_feather_launch(
        _device_index(acc), DTYPE_CODES[out_dtype], acc.data_ptr(),
        wsum.data_ptr(), out.data_ptr(), C * Z, Hp, Wp, r0, r1 - r0, s0,
        s1 - s0, torch.cuda.current_stream(acc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            "finalize_feather kernel launch failed: "
            f"{lib.fuse_feather_error_string(rc).decode()} (cudaError {rc})")
    finalize_feather.launches += 1
    return out


#: kernel launches since the count was last set to 0 (CUDA path only)
finalize_feather.launches = 0
