"""float16 tiles: the port's plain fusion ops (the CPU route of the CUDA
kernels' wrappers) and host steps against the JAX package's XLA ops and
NumPy host steps, and float16 TIFF tiles against the JAX ``read_image``.

Inputs are seeded NumPy float16 arrays with negatives, zeros of both
signs, subnormals and values near 65504 that a field above 1 carries
past the largest float16 (to +-inf); overwrite batches carry NaN tiles.
The bars: bit-equal, compared as uint16 views with NaN facing NaN (the
conversions round a NaN's payload each their own way); feathered output
within 1 float16 ulp (XLA on the CPU contracts ``acc + ramp * tile``
into a fused multiply-add, the port rounds the product first: the
float32 sums differ by a few float32 ulps, and the float16 rounding can
straddle).

The JAX package reads float16 TIFFs through imageio's tifffile (OpenCV
reads none): uncompressed, deflate, LZW and PackBits, Predictor 3 in
strips, one or three samples, either byte order, strips or tiles. The
port reads those to the same bits and raises naming ROADMAP item 6
where imageio gives no pixels: Predictor 2 (it sums the differences as
floats), Predictor 3 in tiles (it raises), four samples a pixel (it
keeps the alpha) and separate planes (it gives them plane by plane).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import max_lsb
from torch_tile_files import tiff_bytes
from image_stitcher_tpu.io.acquisition import read_image as jax_read_image
from image_stitcher_tpu.ops import fuse as jfuse
from image_stitcher_tpu.ops import host_fuse as jhost
from image_stitcher_tpu.ops import pyramid as jpyramid
from image_stitcher_tpu_torch.io.acquisition import read_image
from image_stitcher_tpu_torch.io.readers import (device_dtype, subpixel_shift,
                                                 torch_dtype)
from image_stitcher_tpu_torch.io.tiff import decode_tiff
from image_stitcher_tpu_torch.ops import cuda_fuse
from image_stitcher_tpu_torch.ops import fuse as tfuse
from image_stitcher_tpu_torch.ops import host_fuse as thost
from image_stitcher_tpu_torch.ops import pyramid as tpyramid

F16 = np.float16
#: odd tile sizes, so no row is a whole number of 16-byte vectors
C, Z, H, W, TH, TW, N = 2, 2, 61, 83, 23, 37, 12
BLEND = 8       # a power of two: XLA's divide by it is exact (see dtypes)


def f16_values(rng, shape, nan: bool = False) -> np.ndarray:
    """float16 values of every kind: a signed range with fractions, zeros
    of both signs, subnormals, values near the largest float16 (65504),
    and with ``nan`` a few NaNs."""
    v = rng.uniform(-300.0, 3000.0, shape).astype(F16)
    flat = v.reshape(-1)
    k = flat.size
    pick = rng.permutation(k)
    special = np.concatenate([
        [0.0, -0.0],
        rng.uniform(-6e-5, 6e-5, 16),            # subnormals (< 6.1e-5)
        rng.uniform(60000.0, 65504.0, 16),       # near the top
        -rng.uniform(60000.0, 65504.0, 8)]).astype(F16)
    flat[pick[:special.size]] = special
    if nan:
        flat[pick[special.size:special.size + 6]] = np.nan
    return v


def assert_f16_equal(got, want, ulps: int = 0):
    """float16 arrays equal as uint16 views (NaN facing NaN), or within
    ``ulps`` float16 ulps."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == F16 and got.shape == want.shape
    assert max_lsb(want, got) <= ulps
    if ulps == 0:
        nan = np.isnan(want)
        assert np.array_equal(got.view(np.uint16)[~nan],
                              want.view(np.uint16)[~nan])


def _batch(seed, nan=False):
    rng = np.random.default_rng(seed)
    tiles = f16_values(rng, (N, TH, TW), nan)
    info = np.stack([rng.integers(0, C, N), rng.integers(0, Z, N),
                     rng.integers(0, H, N), rng.integers(0, W, N)],
                    axis=1).astype(np.int32)
    crops = rng.integers(0, 6, (N, 4)).astype(np.int32)
    valid = rng.random(N) > 0.15
    # a field above 1 carries the values near 65504 to +-inf
    ff = rng.uniform(0.6, 1.5, (C, TH, TW)).astype(np.float32)
    return tiles, info, crops, valid, ff


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_float16_is_a_fused_storage_dtype():
    assert torch_dtype('float16') == torch.float16
    assert device_dtype(np.float16) == torch.float16
    assert torch.float16 in tfuse.FUSE_DTYPES
    assert cuda_fuse.DTYPE_CODES[torch.float16] == 7


def test_apply_flatfield_matches_xla():
    tiles, info, _, _, ff = _batch(1, nan=True)
    want = np.asarray(jfuse.apply_flatfield(jnp.asarray(tiles),
                                            jnp.asarray(ff), info[:, 0],
                                            out_dtype=F16))
    got = tfuse.apply_flatfield(torch.from_numpy(tiles), torch.from_numpy(ff),
                                torch.from_numpy(info[:, 0]), torch.float16)
    assert_f16_equal(got.numpy(), want)
    # the field's product passed 65504 (inf, unclipped), and reached the
    # subnormals
    assert np.isinf(want).any() and np.isnan(want).any()
    tiny = np.abs(want[np.isfinite(want)])
    assert ((tiny > 0) & (tiny < 6.1e-5)).any()


@pytest.mark.parametrize("with_ff", [False, True], ids=['plain', 'field'])
def test_fuse_overwrite_matches_xla(with_ff):
    """Later tile wins over odd-sized tiles and crop windows, NaN tiles
    among them; with the field the tiles are corrected first (the JAX
    band fuser's apply_flatfield, then the placement)."""
    tiles, info, crops, valid, ff = _batch(2, nan=True)
    canvas = f16_values(np.random.default_rng(3),
                        tfuse.padded_canvas_shape(C, Z, H, W, TH, TW))
    jt = jnp.asarray(tiles)
    if with_ff:
        jt = jfuse.apply_flatfield(jt, jnp.asarray(ff), info[:, 0],
                                   out_dtype=F16)
    want = np.asarray(jfuse.fuse_overwrite(jnp.asarray(canvas), jt,
                                           *map(jnp.asarray,
                                                (info, crops, valid))))
    got = cuda_fuse.fuse_overwrite(*_t(canvas, tiles, info, crops, valid),
                                   torch.from_numpy(ff) if with_ff else None)
    assert_f16_equal(got.numpy(), want)
    if not with_ff:     # a copy: every bit, NaN payloads too
        assert np.array_equal(got.numpy().view(np.uint16),
                              want.view(np.uint16))
    assert np.isnan(want).any()


def _zero_weight_infinities(tiles, info, crops, valid, shape):
    """The canvas pixels where some tile of the batch holds +-inf with a
    zero feather weight: outside its crop window, or in an invalid slot."""
    out = np.zeros(shape, bool)
    for i in range(tiles.shape[0]):
        c, z, y, x = info[i]
        r0, r1, s0, s1 = tfuse.crop_window(crops[i], TH, TW)
        off = np.isinf(tiles[i])
        if valid[i]:
            off[r0:r1, s0:s1] = False
        out[c, z, y:y + TH, x:x + TW] |= off
    return out


@pytest.mark.parametrize("with_ff", [False, True], ids=['plain', 'field'])
def test_fuse_feather_and_finalize_match_xla(with_ff):
    """wsum equal; the finished canvas within 1 float16 ulp of the JAX
    chain (fuse_feather then finalize_feather), and the finish of one
    (acc, wsum) pair bit-equal to XLA's (a float32 quotient rounded to
    float16, +-inf past 65504).

    A fault of the reference the port does not copy: the XLA op weights
    each tile's whole extent, with 0 outside its crop window and in an
    invalid slot, and 0 * inf is NaN; so where the field carries a tile
    past 65504 outside its window, the JAX sum is NaN. The port adds the
    window's terms only, and gives the weighted mean there."""
    tiles, info, crops, valid, ff = _batch(4)
    shape = tfuse.padded_canvas_shape(C, Z, H, W, TH, TW)
    jt = jnp.asarray(tiles)
    if with_ff:
        jt = jfuse.apply_flatfield(jt, jnp.asarray(ff), info[:, 0],
                                   out_dtype=F16)
    j_acc, j_wsum = jfuse.fuse_feather(jnp.zeros(shape, jnp.float32),
                                       jnp.zeros(shape, jnp.float32), jt,
                                       *map(jnp.asarray, (info, crops, valid)),
                                       blend_px=BLEND)
    want = np.asarray(jfuse.finalize_feather(j_acc, j_wsum, out_dtype=F16))
    acc, wsum = cuda_fuse.fuse_feather(
        torch.zeros(shape), torch.zeros(shape),
        *_t(tiles, info, crops, valid),
        ff_recip=torch.from_numpy(ff) if with_ff else None, blend_px=BLEND)
    np.testing.assert_array_equal(wsum.numpy(), np.asarray(j_wsum))
    poisoned = _zero_weight_infinities(np.asarray(jt), info, crops, valid,
                                       shape)
    assert poisoned.any() == with_ff
    assert np.array_equal(np.isnan(np.asarray(j_acc)),
                          np.isnan(acc.numpy()) | poisoned)
    got = cuda_fuse.finalize_feather(acc, wsum, torch.float16)
    assert_f16_equal(got.numpy()[~poisoned], want[~poisoned], ulps=1)
    same = np.asarray(jfuse.finalize_feather(jnp.asarray(acc.numpy()),
                                             jnp.asarray(wsum.numpy()),
                                             out_dtype=F16))
    assert_f16_equal(got.numpy(), same)
    window = cuda_fuse.finalize_feather(acc, wsum, torch.float16, (3, 50),
                                        (5, 77))
    assert_f16_equal(window.numpy(), same[..., 3:50, 5:77])
    assert np.isinf(same).any() == with_ff


@pytest.mark.parametrize("mode", ['nearest', 'mean'])
def test_downsample_matches_xla_and_the_jax_host_step(mode):
    """The device step against XLA (the mean: float32 sums in XLA's order,
    one rounding to float16), the host step against the JAX band
    writer's NumPy step, on odd extents."""
    x = f16_values(np.random.default_rng(5), (3, 37, 53), nan=True)
    jfn = (jpyramid.downsample_nearest if mode == 'nearest'
           else jpyramid.downsample_mean)
    want = np.asarray(jfn(jnp.asarray(x)))
    assert_f16_equal(tpyramid.downsample(torch.from_numpy(x), mode).numpy(),
                     want)
    host = tpyramid.host_downsample(x, mode)
    assert_f16_equal(host, jhost.host_downsample(x, mode))
    assert_f16_equal(host, want)


def test_host_correction_and_finish_match_the_jax_host_fuser():
    """The host fuser's steps (``fusion_device='host'``): the field's
    product promoted to float32 and cast, and the feathered finish, each
    as the JAX host fuser's NumPy step, bit for bit."""
    tiles, _, _, _, ff = _batch(6, nan=True)
    for c in range(C):
        assert_f16_equal(thost.correct_tile(tiles[c], ff, c, F16),
                         jhost.correct_tile(tiles[c], ff, c, F16))
    rng = np.random.default_rng(7)
    acc = (rng.standard_normal((2, 31, 45)) * 4e4).astype(np.float32)
    wsum = rng.uniform(0.0, 1.0, acc.shape).astype(np.float32)
    wsum[wsum < 0.2] = 0.0
    want = jhost.finalize_feather_host(acc, wsum, F16)
    assert np.isinf(want).any()
    assert_f16_equal(thost.finalize_feather_host(acc, wsum, F16), want)


def test_subpixel_shift_refuses_float16_as_opencv_does():
    import cv2
    img = f16_values(np.random.default_rng(8), (16, 16))
    with pytest.raises(cv2.error):
        cv2.warpAffine(img, np.float64([[1, 0, 0.3], [0, 1, 0.2]]),
                       (16, 16), flags=cv2.INTER_LINEAR,
                       borderMode=cv2.BORDER_REPLICATE)
    with pytest.raises(TypeError, match='float16'):
        subpixel_shift(img, 0.2, 0.3)


# ------------------------------------------------------------ tile input

#: (compression, Predictor) the JAX reader takes for float16
CODECS = [(1, 1), (5, 1), (8, 1), (32946, 1), (32773, 1), (5, 3), (8, 3),
          (32773, 3)]


def _jax_read(path):
    with warnings.catch_warnings():     # imageio's vendored tifffile
        warnings.simplefilter('ignore')
        return jax_read_image(path)


def _write(tmp_path, data, name="A1_0_0_ch.tiff"):
    path = str(tmp_path / name)
    with open(path, 'wb') as f:
        f.write(data)
    return path


def _layouts():
    for comp, pred in CODECS:
        for layout in ('strips', 'tiles'):
            if pred == 3 and layout == 'tiles':
                continue
            yield comp, pred, layout


@pytest.mark.parametrize("spp", [1, 3])
@pytest.mark.parametrize("byteorder", ['<', '>'], ids=['II', 'MM'])
@pytest.mark.parametrize("comp,pred,layout", list(_layouts()))
def test_float16_tiff_reads_as_jax(tmp_path, comp, pred, layout, byteorder,
                                   spp):
    """Every layout the JAX reader takes: the same float16 samples, bit
    for bit (NaN and infinities included), as the source; the plain
    decoders equal the C ones."""
    rng = np.random.default_rng(comp + pred + spp)
    img = f16_values(rng, (29, 45) if spp == 1 else (29, 45, 3), nan=True)
    img.reshape(-1)[:2] = [np.inf, -np.inf]
    kw = (dict(tile=(16, 16)) if layout == 'tiles'
          else dict(rows_per_strip=4))
    data = tiff_bytes(img, comp, pred, byteorder=byteorder, **kw)
    path = _write(tmp_path, data)
    want = _jax_read(path)
    got = read_image(path)
    assert got.dtype == want.dtype == F16 and got.shape == want.shape
    assert np.array_equal(got.view(np.uint16), want.view(np.uint16))
    assert np.array_equal(got.view(np.uint16), img.view(np.uint16))
    assert decode_tiff(data, plain=True).tobytes() == \
        decode_tiff(data).tobytes()


@pytest.mark.parametrize("what", ['predictor2', 'predictor2_tiles',
                                  'predictor3_tiles', 'alpha', 'planar'])
def test_float16_layouts_without_pixels_raise_naming_item_6(tmp_path, what):
    """Where the JAX reader gives no pixels (wrong values, an error, an
    alpha or a plane-first array), the port raises naming item 6."""
    rng = np.random.default_rng(9)
    spp = {'alpha': 4, 'planar': 3}.get(what, 1)
    img = f16_values(rng, (20, 24) if spp == 1 else (20, 24, spp))
    kw = dict(tile=(16, 16)) if what.endswith('tiles') else {}
    if what == 'alpha':
        kw['extra_samples'] = [2]
    if what == 'planar':
        kw['planar'] = 2
    pred = 3 if what == 'predictor3_tiles' else (2 if 'predictor2' in what
                                                 else 1)
    path = _write(tmp_path, tiff_bytes(img, 8, pred, **kw))
    try:
        jax = _jax_read(path)
    except NotImplementedError:
        assert what == 'predictor3_tiles'
    else:
        assert jax.shape != img.shape[:2] + (3,) * (spp > 1) or not \
            np.array_equal(jax.view(np.uint16), img.view(np.uint16))
    with pytest.raises(NotImplementedError, match='item 6'):
        read_image(path)
