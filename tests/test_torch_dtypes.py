"""Tile sample types beyond uint8/uint16: the port's plain fusion ops (the
CPU route of the CUDA kernels' wrappers) against the JAX package's XLA ops
(``image_stitcher_tpu/ops/fuse.py``, ``ops/pyramid.py``: its bar on the
CPU) per dtype, the conversions pinned where float32 meets 32- and 64-bit
types, the refusals, and the fault of the reference's Pallas kernels that
the port does not copy.

Inputs are seeded NumPy arrays handed to both packages. Overwrite, the
field, the finish and the pyramid are exact. The feathered sums carry a
stated bar (:func:`_assert_feather_sums`): XLA contracts ``acc + ramp *
tile`` into a fused multiply-add on the CPU, where the port rounds the
product first.
"""

import glob

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import write_synthetic_acquisition
from torch_helpers import assert_outputs_equal, small_disk_probe  # noqa: F401
from image_stitcher_tpu import EngineOptions as JaxOptions
from image_stitcher_tpu import stitch as jax_stitch
from image_stitcher_tpu.ops import fuse as jfuse
from image_stitcher_tpu.ops import pyramid as jpyramid
from image_stitcher_tpu.ops.pallas_fuse import (fuse_feather_pallas,
                                                fuse_overwrite_pallas,
                                                pallas_padded_canvas_shape)
import image_stitcher_tpu_torch as port
from image_stitcher_tpu_torch.io.readers import device_dtype, torch_dtype
from image_stitcher_tpu_torch.io.zarr_store import read_array
from image_stitcher_tpu_torch.ops import cuda_fuse
from image_stitcher_tpu_torch.ops import fuse as tfuse
from image_stitcher_tpu_torch.ops import pyramid as tpyramid

DTYPES = ['uint8', 'int8', 'uint16', 'int16', 'int32', 'uint32', 'float32',
          'float64']
C, Z, H, W, TH, TW, N = 2, 2, 70, 90, 24, 32, 10
#: a power of two, as the default 64: XLA on the CPU divides the ramp's
#: distance by a constant blend_px as a multiply by its reciprocal, which
#: is exact only there; the port divides
BLEND = 8
#: (dtype, with the field): uint32 takes no field and no feathering
#: (test_uint32_field_or_feather_raises_as_jax)
WITH_FF = [(d, ff) for d in DTYPES for ff in (False, True)
           if not (ff and d == 'uint32')]


def _tiles(rng, dtype, n=N, th=TH, tw=TW):
    """Values over the dtype's range (integers: up to its bounds, so the
    field's product clips; floats: a signed range with fractions)."""
    dtype = np.dtype(dtype)
    if dtype.kind == 'f':
        return rng.uniform(-50.0, 300.0, (n, th, tw)).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, (n, th, tw), dtype=dtype,
                        endpoint=True)


def _batch(seed, dtype):
    rng = np.random.default_rng(seed)
    tiles = _tiles(rng, dtype)
    info = np.stack([rng.integers(0, C, N), rng.integers(0, Z, N),
                     rng.integers(0, H, N), rng.integers(0, W, N)],
                    axis=1).astype(np.int32)
    crops = rng.integers(0, 5, (N, 4)).astype(np.int32)
    valid = rng.random(N) > 0.15
    ff = (1.0 / rng.uniform(0.55, 1.6, (C, TH, TW))).astype(np.float32)
    return tiles, info, crops, valid, ff


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _device_tiles(tiles):
    """The tiles as the device paths hold them (float64 through float32,
    as the JAX package's device arrays with 64-bit types off)."""
    return torch.from_numpy(tiles).to(device_dtype(tiles.dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_flatfield_matches_xla(dtype):
    tiles, info, _, _, ff = _batch(1, dtype)
    t = _device_tiles(tiles)
    if dtype == 'uint32':
        with pytest.raises(OverflowError):
            jfuse.apply_flatfield(tiles, ff, info[:, 0], out_dtype=dtype)
        with pytest.raises(OverflowError, match='uint32'):
            tfuse.apply_flatfield(t, torch.from_numpy(ff),
                                  torch.from_numpy(info[:, 0]), t.dtype)
        return
    want = np.asarray(jfuse.apply_flatfield(jnp.asarray(tiles),
                                            jnp.asarray(ff), info[:, 0],
                                            out_dtype=dtype))
    got = tfuse.apply_flatfield(t, torch.from_numpy(ff),
                                torch.from_numpy(info[:, 0]), t.dtype)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    if np.dtype(dtype).kind in 'iu':   # the product reached both bounds
        info_ = np.iinfo(dtype)
        assert (want == info_.max).any() and (
            info_.min == 0 or (want == info_.min).any())


@pytest.mark.parametrize("dtype,with_ff", WITH_FF)
def test_fuse_overwrite_matches_xla(dtype, with_ff):
    """Each wrapper's CPU route (the plain version) on the device paths'
    dtype equals the XLA op (with the field: apply_flatfield, then the
    placement, as the JAX band fuser runs them); a float64 canvas is
    refused, on the CPU as on the card (float64 tiles are fused as
    float32)."""
    tiles, info, crops, valid, ff = _batch(2, dtype)
    rng = np.random.default_rng(3)
    canvas = _tiles(rng, dtype, C * Z, H + TH, W + TW).reshape(
        tfuse.padded_canvas_shape(C, Z, H, W, TH, TW))
    jt = jnp.asarray(tiles)
    if with_ff:
        jt = jfuse.apply_flatfield(jt, jnp.asarray(ff), info[:, 0],
                                   out_dtype=dtype)
    want = np.asarray(jfuse.fuse_overwrite(jnp.asarray(canvas), jt,
                                           jnp.asarray(info),
                                           jnp.asarray(crops),
                                           jnp.asarray(valid)))
    ffr = torch.from_numpy(ff) if with_ff else None
    meta = _t(info, crops, valid)
    got = cuda_fuse.fuse_overwrite(_device_tiles(canvas).contiguous(),
                                   _device_tiles(tiles), *meta, ffr)
    np.testing.assert_array_equal(got.numpy(), want)
    if dtype == 'float64':
        with pytest.raises(TypeError, match='float64 tiles are fused as '
                                            'float32'):
            cuda_fuse.fuse_overwrite(torch.from_numpy(canvas),
                                     torch.from_numpy(tiles), *meta, ffr)


def _assert_feather_sums(got_acc, want_acc, abs_acc, terms):
    """|port - XLA| <= terms * 2^-23 * sum|ramp * tile|: each term's
    product, rounded by the port and fused by XLA, differs by at most
    half an ulp of itself, and each sum rounds both the same way."""
    room = terms * 2.0 ** -23 * abs_acc + 1e-30
    assert (np.abs(got_acc.astype(np.float64) - want_acc) <= room).all()


@pytest.mark.parametrize("dtype,with_ff",
                         [c for c in WITH_FF if c[0] != 'uint32'])
def test_fuse_feather_and_finalize_match_xla(dtype, with_ff):
    """wsum equal, acc within the FMA bar, and the finish of one (acc,
    wsum) pair equal to XLA's: round half to even, clip and cast with
    saturation for integers, a cast for floats."""
    tiles, info, crops, valid, ff = _batch(4, dtype)
    shape = tfuse.padded_canvas_shape(C, Z, H, W, TH, TW)
    jt = jnp.asarray(tiles)
    if with_ff:
        jt = jfuse.apply_flatfield(jt, jnp.asarray(ff), info[:, 0],
                                   out_dtype=dtype)
    j_acc, j_wsum = jfuse.fuse_feather(jnp.zeros(shape, jnp.float32),
                                       jnp.zeros(shape, jnp.float32), jt,
                                       jnp.asarray(info),
                                       jnp.asarray(crops),
                                       jnp.asarray(valid), blend_px=BLEND)
    ffr = torch.from_numpy(ff) if with_ff else None
    meta = _t(info, crops, valid)
    acc, wsum = cuda_fuse.fuse_feather(
        torch.zeros(shape), torch.zeros(shape), _device_tiles(tiles), *meta,
        ff_recip=ffr, blend_px=BLEND)
    np.testing.assert_array_equal(wsum.numpy(), np.asarray(j_wsum))
    abs_acc, _ = cuda_fuse.fuse_feather(
        torch.zeros(shape), torch.zeros(shape),
        torch.from_numpy(np.abs(np.asarray(jt, np.float32))), *meta,
        blend_px=BLEND)
    _assert_feather_sums(acc.numpy(), np.asarray(j_acc, np.float64),
                         abs_acc.numpy().astype(np.float64), N)
    out_dtype = device_dtype(dtype)
    want = np.asarray(jfuse.finalize_feather(jnp.asarray(acc.numpy()),
                                             jnp.asarray(wsum.numpy()),
                                             out_dtype=dtype))
    got = cuda_fuse.finalize_feather(acc, wsum, out_dtype)
    np.testing.assert_array_equal(got.numpy(), want)
    if dtype == 'float64':      # float64 is fused as float32 only
        with pytest.raises(TypeError, match='float64 tiles are fused as '
                                            'float32'):
            cuda_fuse.fuse_feather(torch.zeros(shape), torch.zeros(shape),
                                   torch.from_numpy(tiles), *meta,
                                   ff_recip=ffr, blend_px=BLEND)
        with pytest.raises(TypeError, match='float64 tiles are fused as '
                                            'float32'):
            cuda_fuse.finalize_feather(acc, wsum, torch.float64)


@pytest.mark.parametrize("mode", ['nearest', 'mean'])
@pytest.mark.parametrize("dtype", DTYPES)
def test_downsample_matches_xla(dtype, mode):
    """The device pyramid step (32-bit integers' means summed in f32 and
    saturated, as XLA does, not NumPy's exact mean); the host step as the
    JAX band writer's NumPy step."""
    x = _tiles(np.random.default_rng(5), dtype, 3, 37, 52)
    jfn = (jpyramid.downsample_nearest if mode == 'nearest'
           else jpyramid.downsample_mean)
    want = np.asarray(jfn(jnp.asarray(x)))
    got = tpyramid.downsample(_device_tiles(x), mode)
    np.testing.assert_array_equal(got.numpy(), want)
    host = tpyramid.host_downsample(x, mode)
    assert host.dtype == x.dtype
    np.testing.assert_array_equal(host, tpyramid.host_downsample_plain(
        x, mode))


def test_int32_top_bound_saturates_as_xla():
    """int32's upper bound is 2147483648.0 as a float32: XLA's convert on
    the CPU saturates it (and beyond) to 2147483647 where torch's plain
    cast would wrap; the port's field, finish and mean give XLA's
    numbers."""
    big = np.array([[[2147483647, 2147483520, -2147483648, 1000]]],
                   np.int32)
    ff = np.array([[[1.0, 1.5, 1.5, 1.0]]], np.float32)
    want = np.asarray(jfuse.apply_flatfield(jnp.asarray(big),
                                            jnp.asarray(ff),
                                            np.zeros(1, np.int32),
                                            out_dtype=np.int32))
    np.testing.assert_array_equal(want, [[[2147483647, 2147483647,
                                           -2147483648, 1000]]])
    got = tfuse.apply_flatfield(torch.from_numpy(big), torch.from_numpy(ff),
                                torch.zeros(1, dtype=torch.int32),
                                torch.int32)
    np.testing.assert_array_equal(got.numpy(), want)
    acc = np.array([[[[2.2e9, -2.2e9, 2147483648.0, 0.0]]]], np.float32)
    wsum = np.array([[[[1.0, 1.0, 1.0, 0.0]]]], np.float32)
    want = np.asarray(jfuse.finalize_feather(jnp.asarray(acc),
                                             jnp.asarray(wsum),
                                             out_dtype=np.int32))
    np.testing.assert_array_equal(want, [[[[2147483647, -2147483648,
                                            2147483647, 0]]]])
    got = tfuse.finalize_feather(torch.from_numpy(acc),
                                 torch.from_numpy(wsum), torch.int32)
    np.testing.assert_array_equal(got.numpy(), want)
    top = np.full((1, 2, 2), 2147483647, np.int32)
    np.testing.assert_array_equal(
        tpyramid.downsample_mean(torch.from_numpy(top)).numpy(),
        np.asarray(jpyramid.downsample_mean(jnp.asarray(top))))


def test_uint32_field_or_feather_raises_as_jax():
    """The JAX package's jitted clips take iinfo(uint32).max as a 32-bit
    argument, which overflows: no field and no feathered finish for
    uint32 tiles on its device paths. The port raises the same error."""
    tiles, info, crops, valid, ff = _batch(6, 'uint32')
    with pytest.raises(OverflowError):
        jfuse.finalize_feather(jnp.ones((1, 1, 2, 2), jnp.float32),
                               jnp.ones((1, 1, 2, 2), jnp.float32),
                               out_dtype=np.uint32)
    with pytest.raises(OverflowError, match='uint32'):
        tfuse.finalize_feather(torch.ones(1, 1, 2, 2),
                               torch.ones(1, 1, 2, 2), torch.uint32)
    shape = tfuse.padded_canvas_shape(C, Z, H, W, TH, TW)
    t = _t(tiles, info, crops, valid, ff)
    with pytest.raises(OverflowError, match='uint32'):
        cuda_fuse.fuse_overwrite(torch.zeros(shape, dtype=torch.uint32),
                                 *t[:4], ff_recip=t[4])
    with pytest.raises(OverflowError, match='uint32'):
        cuda_fuse.fuse_feather(torch.zeros(shape), torch.zeros(shape),
                               *t[:4], ff_recip=t[4])
    with pytest.raises(OverflowError, match='uint32'):
        cuda_fuse.finalize_feather(torch.zeros(shape), torch.zeros(shape),
                                   torch.uint32)


@pytest.mark.parametrize("dtype", ['float16', 'int64', 'uint64', 'bool'])
def test_dtype_outside_scope_raises_type_error_naming_it(tmp_path, dtype):
    with pytest.raises(TypeError, match=dtype):
        torch_dtype(dtype)
    if dtype != 'float16':
        return
    # a float16 TIFF acquisition: the tiles read, the fusion refuses them
    from torch_tile_files import tiff_bytes
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=1, tile_w=64,
                                tile_h=48, overlap=16, seed=1)
    for path in glob.glob(acq + "/0/*.tiff"):
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        with open(path, 'wb') as f:
            f.write(tiff_bytes((img / 65535.0).astype(np.float16)))
    with pytest.raises(TypeError, match='float16'):
        port.stitch(acq, device=torch.device('cpu'),
                    options=port.EngineOptions(
                        output_folder=str(tmp_path / "out")))


@pytest.mark.parametrize("fusion", ['device', 'host'])
@pytest.mark.parametrize("streaming", ['on', 'off'], ids=['bands', 'inram'])
def test_float64_values_as_the_jax_package_writes_them(tmp_path, fusion,
                                                       streaming):
    """Pinned: with 64-bit types off, the JAX package's device paths hold
    float64 tiles as float32 (its arrays are float32), so the written
    '<f8' levels are float32 values widened, while its host fuser keeps
    every float64 bit. The port writes the same trees."""
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(acq, grid_cols=3, grid_rows=2, tile_w=64,
                                tile_h=48, overlap=16, dtype=np.float64,
                                seed=2)
    rng = np.random.default_rng(0)
    for path in sorted(glob.glob(acq + "/0/*.tiff")):
        # values float32 does not hold
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        img = img + rng.random(img.shape) * 1e-6
        assert cv2.imwrite(path, img, [int(cv2.IMWRITE_TIFF_COMPRESSION), 1])
    opts = dict(compressor_cname=None, chunks=(1, 1, 1, 32, 32),
                device_band_multiple=1, streaming=streaming,
                fusion_device=fusion)
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    jpipe = jax_stitch(acq, use_registration=True,
                       options=JaxOptions(output_folder=jax_out, **opts))
    level0 = read_array(glob.glob(jax_out + "/*/*.ome.zarr/0")[0])
    assert level0.dtype == np.float64
    rounded = np.array_equal(level0, level0.astype(np.float32))
    assert rounded == (fusion == 'device')
    port.stitch(acq, use_registration=True, device=torch.device('cpu'),
                state=port.state_from_reference(shifts=jpipe.shifts),
                options=port.EngineOptions(output_folder=out, **opts))
    assert_outputs_equal(jax_out, out)


@pytest.mark.parametrize("kernel", ['overwrite', 'overwrite_ff', 'feather'])
def test_reference_pallas_kernels_truncate_float_tiles(kernel):
    """A fault of the reference the port does not copy: the Pallas kernels
    move tile values through int32 (``pallas_fuse.py`` ``chunk.astype(
    jnp.int32)`` and the int32 ``pltpu.roll``), so float32 tiles lose
    their fractions; in interpret mode they differ from the XLA ops,
    which the JAX package runs on the CPU and calls the same semantics.
    The port follows the XLA ops."""
    rng = np.random.default_rng(7)
    c, z, h, w, th, tw, n = 1, 1, 96, 80, 32, 32, 6
    tiles = (rng.random((n, th, tw)) * 100).astype(np.float32)
    info = np.stack([np.zeros(n), np.zeros(n), rng.integers(0, h, n),
                     rng.integers(0, w, n)], axis=1).astype(np.int32)
    crops = np.zeros((n, 4), np.int32)
    valid = np.ones(n, bool)
    ff = (1.0 / rng.uniform(0.6, 1.4, (c, th, tw))).astype(np.float32)
    shape = tfuse.padded_canvas_shape(c, z, h, w, th, tw)
    pshape = pallas_padded_canvas_shape(c, z, h, w, th, tw, np.float32)
    jargs = [jnp.asarray(a) for a in (tiles, info, crops, valid)]
    targs = _t(tiles, info, crops, valid)
    if kernel == 'feather':
        want, _ = jfuse.fuse_feather(jnp.zeros(shape, jnp.float32),
                                     jnp.zeros(shape, jnp.float32), *jargs,
                                     blend_px=8)
        pallas, _ = fuse_feather_pallas(jnp.zeros(pshape, jnp.float32),
                                        jnp.zeros(pshape, jnp.float32),
                                        *jargs, blend_px=8, interpret=True)
        got, _ = cuda_fuse.fuse_feather(torch.zeros(shape),
                                        torch.zeros(shape), *targs,
                                        blend_px=8)
        abs_acc = got.numpy().astype(np.float64)    # the tiles are >= 0
        _assert_feather_sums(got.numpy(), np.asarray(want, np.float64),
                             abs_acc, n)
    else:
        ffj = jnp.asarray(ff) if kernel == 'overwrite_ff' else None
        jt = (jfuse.apply_flatfield(jargs[0], ffj, info[:, 0],
                                    out_dtype=jnp.float32)
              if ffj is not None else jargs[0])
        want = jfuse.fuse_overwrite(jnp.zeros(shape, jnp.float32), jt,
                                    *jargs[1:])
        pallas = fuse_overwrite_pallas(jnp.zeros(pshape, jnp.float32),
                                       *jargs, ff_recip=ffj, interpret=True)
        got = cuda_fuse.fuse_overwrite(
            torch.zeros(shape), *targs,
            torch.from_numpy(ff) if ffj is not None else None)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = np.asarray(want)[:, :, :h, :w]
    pallas = np.asarray(pallas)[:, :, :h, :w]
    off = np.abs(pallas.astype(np.float64) - want)
    covered = want != 0
    assert (off[covered] > 0).mean() > 0.9      # the fractions are lost
    assert off.max() < (1.0 if kernel == 'overwrite' else 4.0)


@pytest.mark.parametrize("shuffle", [0, 1, 2])
@pytest.mark.parametrize("cname", ['lz4', 'zstd'])
@pytest.mark.parametrize("dtype", ['int8', 'int32', 'float32', 'float64'])
def test_blosc_chunks_of_sample_types_as_tensorstore(tmp_path, dtype, cname,
                                                     shuffle):
    """Chunks of 1-, 4- and 8-byte samples, byte or bit shuffled or not:
    the port's frame of a chunk decodes to it in the port and in
    tensorstore, tensorstore's in the port; lz4 frames are tensorstore's
    byte for byte (liblz4's rules)."""
    import os
    from image_stitcher_tpu.io.zarr_store import (create_zarr_array,
                                                  open_zarr_array)
    from image_stitcher_tpu_torch.io import blosc
    rng = np.random.default_rng(shuffle)
    smooth = np.cumsum(rng.integers(-3, 4, (96, 160)), axis=1)
    chunk = (smooth * (0.37 if dtype.startswith('float') else 1)
             ).astype(dtype)
    shape = (1, 1, 1) + chunk.shape
    path = str(tmp_path / "ts")
    create_zarr_array(path, shape, shape, dtype, cname=cname, clevel=5,
                      shuffle=shuffle).write(chunk.reshape(shape)).result()
    with open(os.path.join(path, *'00000'), 'rb') as f:
        want = f.read()
    frame = bytes(blosc.compress(chunk, chunk.itemsize, 5, shuffle, cname))
    if cname == 'lz4':
        assert frame == want
    assert blosc.decompress(want).tobytes() == chunk.tobytes()
    with open(os.path.join(path, *'00000'), 'wb') as f:
        f.write(frame)
    np.testing.assert_array_equal(
        np.asarray(open_zarr_array(path).read().result()),
        chunk.reshape(shape))


@pytest.mark.parametrize("dtype", ['int16', 'float32'])
def test_jpeg_ome_tiff_refuses_as_jax(tmp_path, dtype):
    """JPEG OME-TIFF tiles are 8-bit: both packages refuse other sample
    types with ``ValueError``."""
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=1, tile_w=64,
                                tile_h=48, overlap=16, dtype=np.dtype(dtype),
                                seed=3)
    kw = dict(output_format='.ome.tiff')
    with pytest.raises(ValueError):
        jax_stitch(acq, options=JaxOptions(output_folder=str(tmp_path / "j"),
                                           tiff_compression='jpeg'), **kw)
    with pytest.raises(ValueError):
        port.stitch(acq, device=torch.device('cpu'),
                    options=port.EngineOptions(
                        output_folder=str(tmp_path / "p"),
                        tiff_compression='jpeg'), **kw)
