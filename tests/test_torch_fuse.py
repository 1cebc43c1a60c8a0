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


@pytest.mark.parametrize("n", [65, 128])
@pytest.mark.parametrize("mode", ["overwrite", "feather"])
def test_batches_over_64_tiles_split_in_order(n, mode):
    """A batch larger than one launch takes (64 tiles) is placed in runs
    of at most 64 in batch order: equal to one plain call over the whole
    batch, byte for byte (overwrite; and to the JAX op) or bit for bit
    (feather). The tiles crowd a small canvas, so runs overlap."""
    canvas, tiles, info, crops, valid, ff = _batch(10 + n, np.uint16, 24, 20,
                                                   n=n, H=60, W=50)
    a = _t(canvas, tiles, info, crops, valid, ff)
    b = _t(canvas.copy(), tiles, info, crops, valid, ff)
    if mode == "overwrite":
        got = cuda_fuse.fuse_overwrite(a[0], *a[1:5], ff_recip=a[5])
        want = tfuse.fuse_overwrite(b[0], *b[1:5], ff_recip=b[5])
        assert torch.equal(got, want)
        jax_want = np.asarray(jfuse.fuse_overwrite(
            jnp.asarray(canvas), jnp.asarray(tiles), jnp.asarray(info),
            jnp.asarray(crops), jnp.asarray(valid)))
        c = _t(canvas.copy())[0]
        np.testing.assert_array_equal(
            cuda_fuse.fuse_overwrite(c, *a[1:5]).numpy(), jax_want)
        return
    shape = tfuse.padded_canvas_shape(2, 2, 60, 50, 24, 20)
    gen = torch.Generator().manual_seed(n)
    acc = torch.rand(shape, generator=gen) * 1000
    wsum = torch.rand(shape, generator=gen)
    got = cuda_fuse.fuse_feather(acc.clone(), wsum.clone(), *a[1:5],
                                 ff_recip=a[5], blend_px=6)
    want = tfuse.fuse_feather(acc.clone(), wsum.clone(), *b[1:5],
                              ff_recip=b[5], blend_px=6)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("bad", ["outside", "dtype", "meta_dtype", "ff_shape",
                                 "ff_channel"])
def test_batches_the_kernel_does_not_take_raise(bad):
    canvas, tiles, info, crops, valid, ff = _batch(5, np.uint16, 32, 32)
    if bad == "outside":
        info[2, 2] = canvas.shape[2] - 31       # tile overhangs the apron
        valid[2] = True
    elif bad == "dtype":     # float16: no tile dtype the port fuses
        canvas = (canvas >> 6).astype(np.float16)
        tiles = (tiles >> 6).astype(np.float16)
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
