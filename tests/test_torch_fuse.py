"""The port's fusion ops against the JAX package's, on the same inputs.

The plain PyTorch versions (image_stitcher_tpu_torch/ops/fuse.py) must be
byte-identical to the JAX XLA ops and to the Pallas kernel (run in
interpret mode, as tests/test_pallas_fuse.py runs it); the CUDA kernel
itself runs only on a card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_stitcher_tpu.ops import fuse as jfuse
from image_stitcher_tpu.ops.pallas_fuse import (fuse_overwrite_pallas,
                                                pallas_padded_canvas_shape)
from image_stitcher_tpu_torch.ops import cuda_fuse
from image_stitcher_tpu_torch.ops import fuse as tfuse

TORCH = {np.uint8: torch.uint8, np.uint16: torch.uint16}
SHAPES = [(32, 32), (37, 53), (100, 120)]


def _batch(seed, dtype, th, tw, n=9, C=2, Z=2, H=150, W=170):
    """Seeded batch with overlapping tiles, crops (some larger than half
    the tile, some negative), a duplicate placement and invalid entries."""
    rng = np.random.default_rng(seed)
    hi = np.iinfo(dtype).max
    tiles = rng.integers(0, hi + 1, (n, th, tw)).astype(dtype)
    info = np.stack([rng.integers(0, C, n), rng.integers(0, Z, n),
                     rng.integers(0, H, n), rng.integers(0, W, n)],
                    axis=1).astype(np.int32)
    info[3] = info[2]                       # full overlap: later one wins
    crops = rng.integers(-2, max(th, tw) // 2 + 3, (n, 4)).astype(np.int32)
    crops[0] = 0
    valid = rng.random(n) > 0.25
    valid[[2, 3]] = True
    ff = (1.0 / rng.uniform(0.5, 1.5, (C, th, tw))).astype(np.float32)
    canvas = rng.integers(0, hi + 1, tfuse.padded_canvas_shape(
        C, Z, H, W, th, tw)).astype(dtype)
    return canvas, tiles, info, crops, valid, ff


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_apply_flatfield_matches_jax(dtype, shape):
    _, tiles, info, _, _, ff = _batch(1, dtype, *shape)
    want = np.asarray(jfuse.apply_flatfield(
        jnp.asarray(tiles), jnp.asarray(ff), jnp.asarray(info[:, 0]),
        jnp.dtype(dtype)))
    t_tiles, t_ff, t_c = _t(tiles, ff, info[:, 0])
    got = tfuse.apply_flatfield(t_tiles, t_ff, t_c, TORCH[dtype]).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_fuse_overwrite_matches_jax(dtype, shape):
    canvas, tiles, info, crops, valid, _ = _batch(2, dtype, *shape)
    want = np.asarray(jfuse.fuse_overwrite(
        jnp.asarray(canvas), jnp.asarray(tiles), jnp.asarray(info),
        jnp.asarray(crops), jnp.asarray(valid)))
    t_canvas, t_tiles, t_info, t_crops, t_valid = _t(canvas, tiles, info,
                                                     crops, valid)
    got = tfuse.fuse_overwrite(t_canvas, t_tiles, t_info, t_crops, t_valid)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape", [(32, 32), (37, 53)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_fused_flatfield_overwrite_matches_pallas(dtype, shape):
    """The kernel's contract (placement with ff_recip fused) against the
    TPU kernel it replaces, in interpret mode."""
    th, tw = shape
    C, Z, H, W = 2, 2, 150, 170
    canvas, tiles, info, crops, valid, ff = _batch(3, dtype, th, tw,
                                                   C=C, Z=Z, H=H, W=W)
    pshape = pallas_padded_canvas_shape(C, Z, H, W, th, tw, dtype)
    pcanvas = np.zeros(pshape, dtype)
    pcanvas[:, :, :H, :W] = canvas[:, :, :H, :W]
    want = np.asarray(fuse_overwrite_pallas(
        jnp.asarray(pcanvas), jnp.asarray(tiles), jnp.asarray(info),
        jnp.asarray(crops), jnp.asarray(valid), ff_recip=jnp.asarray(ff),
        interpret=True))[:, :, :H, :W]
    t_canvas, t_tiles, t_info, t_crops, t_valid, t_ff = _t(
        canvas, tiles, info, crops, valid, ff)
    got = cuda_fuse.fuse_overwrite(t_canvas, t_tiles, t_info, t_crops,
                                   t_valid, ff_recip=t_ff)
    np.testing.assert_array_equal(got.numpy()[:, :, :H, :W], want)


def test_cpu_tensors_take_the_plain_version():
    canvas, tiles, info, crops, valid, ff = _batch(4, np.uint16, 37, 53)
    a = _t(canvas, tiles, info, crops, valid, ff)
    b = _t(canvas.copy(), tiles, info, crops, valid, ff)
    before = cuda_fuse.fuse_overwrite.launches
    got = cuda_fuse.fuse_overwrite(a[0], *a[1:5], ff_recip=a[5])
    want = tfuse.fuse_overwrite(b[0], *b[1:5], ff_recip=b[5])
    assert got is a[0]
    assert torch.equal(got, want)
    assert cuda_fuse.fuse_overwrite.launches == before


@pytest.mark.parametrize("bad", ["outside", "dtype", "meta_dtype", "ff_shape",
                                 "ff_channel"])
def test_batches_the_kernel_does_not_take_raise(bad):
    canvas, tiles, info, crops, valid, ff = _batch(5, np.uint16, 32, 32)
    if bad == "outside":
        info[2, 2] = canvas.shape[2] - 31       # tile overhangs the apron
        valid[2] = True
    elif bad == "dtype":
        canvas = canvas.astype(np.int16)
        tiles = tiles.astype(np.int16)
    elif bad == "meta_dtype":
        info = info.astype(np.int64)
    elif bad == "ff_shape":
        ff = ff[:, :16]
    elif bad == "ff_channel":
        ff = ff[:1]
        info[2, 0] = 1
        valid[2] = True
    args = _t(canvas, tiles, info, crops, valid, ff)
    with pytest.raises((ValueError, TypeError)):
        cuda_fuse.fuse_overwrite(*args[:5], ff_recip=args[5])
