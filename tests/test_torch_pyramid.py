"""The port's pyramid steps against the JAX package's.

``ops/pyramid.py`` of the port runs the steps on torch tensors (the
in-RAM path runs them on the card, here on the CPU); the JAX package
jits them. Each level must be byte-equal, for uint8, uint16 and float32
canvases, odd and even extents, both modes; the NumPy host step the
band fuser folds bands with must equal the JAX package's host step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_stitcher_tpu.ops import pyramid as jpyr
from image_stitcher_tpu.ops.host_fuse import host_downsample as jhost
from image_stitcher_tpu_torch.models import streaming
from image_stitcher_tpu_torch.ops import pyramid as tpyr

SHAPES = [(2, 64, 96), (3, 67, 91), (1, 2, 5, 33)]


def _array(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        # wide magnitudes: the 2x2 sum's order shows in the last bit
        return (rng.standard_normal(shape)
                * rng.uniform(1, 1e4, shape)).astype(np.float32)
    return rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)


@pytest.mark.parametrize("mode", ["nearest", "mean"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32],
                         ids=lambda d: np.dtype(d).name)
def test_downsample_matches_jax(dtype, shape, mode):
    x = _array(dtype, shape, seed=len(shape) + shape[-1])
    want = np.asarray(jpyr.downsample(jnp.asarray(x), mode))
    got = tpyr.downsample(torch.from_numpy(x), mode)
    assert got.is_contiguous()
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["nearest", "mean"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_levels_match_jax(dtype, mode):
    """Five levels, level from level, of a (C, Z, H, W) canvas view with
    odd extents (the in-RAM path pyramids the cropped canvas view)."""
    x = _array(dtype, (2, 2, 203, 171), seed=3)
    padded = torch.zeros((2, 2, 211, 176), dtype=torch.from_numpy(x).dtype)
    padded[:, :, :203, :171] = torch.from_numpy(x)
    view = padded[:, :, :203, :171]
    want = list(jpyr.iter_levels(jnp.asarray(x), 5, mode))
    got = list(tpyr.iter_levels(view, 5, mode))
    assert [tuple(g.shape) for g in got] == \
        tpyr.level_shapes(x.shape, 5) == jpyr.level_shapes(x.shape, 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.contiguous().numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", ["nearest", "mean"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_host_step_matches_jax_host_step(dtype, mode):
    x = _array(dtype, (61, 90), seed=4)
    np.testing.assert_array_equal(tpyr.host_downsample(x, mode),
                                  jhost(x, mode))
    # the band fuser still finds it where it always did
    assert streaming.host_downsample is tpyr.host_downsample


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="downsample mode"):
        tpyr.downsample(torch.zeros((4, 4), dtype=torch.uint8), 'max')
    with pytest.raises(ValueError, match="downsample mode"):
        tpyr.host_downsample(np.zeros((4, 4), np.uint8), 'max')
