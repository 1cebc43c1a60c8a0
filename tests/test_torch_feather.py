"""The port's feathered fusion against the JAX package's, on the same inputs.

The plain PyTorch versions (``image_stitcher_tpu_torch/ops/fuse.py``:
``feather_ramp``, ``fuse_feather``, ``finalize_feather``) against the
JAX XLA ops and against the Pallas kernel they stand in for, run in
interpret mode as ``tests/test_pallas_fuse.py`` runs it. Tolerances:
``acc``/``wsum`` within rtol 1e-6, because XLA may contract the
multiply-add into one FMA where the port rounds the product first; the
finalized pixels within 1 LSB, the bar the JAX backends hold each other
to (``tests/test_backend_fuzz.py``). The band test holds the feather
band fuser to one unbanded plain fuse, exactly. The CUDA kernels run
only on a card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import write_synthetic_acquisition
from image_stitcher_tpu.ops import fuse as jfuse
from image_stitcher_tpu.ops.pallas_fuse import (fuse_feather_pallas,
                                                pallas_padded_canvas_shape)
from image_stitcher_tpu_torch.io.acquisition import scan_acquisition
from image_stitcher_tpu_torch.io.omezarr import MultiscaleWriter
from image_stitcher_tpu_torch.io.readers import TileJob, load_tile_plane
from image_stitcher_tpu_torch.io.zarr_store import read_array
from image_stitcher_tpu_torch.models.streaming import DeviceStreamingFuser
from image_stitcher_tpu_torch.ops import cuda_fuse
from image_stitcher_tpu_torch.ops import fuse as tfuse

TORCH = {np.uint8: torch.uint8, np.uint16: torch.uint16}
BLEND = 12


def _batch(seed, dtype, th, tw, n=9, C=2, Z=2, H=150, W=170):
    """Seeded feather batch: overlapping tiles, crops (some past half the
    tile, some negative, one all zero), a duplicate placement and invalid
    padding entries pinned to 0 as the loader pins them."""
    rng = np.random.default_rng(seed)
    hi = np.iinfo(dtype).max
    tiles = rng.integers(0, hi + 1, (n, th, tw)).astype(dtype)
    info = np.stack([rng.integers(0, C, n), rng.integers(0, Z, n),
                     rng.integers(0, H, n), rng.integers(0, W, n)],
                    axis=1).astype(np.int32)
    info[3] = info[2]                       # duplicate: both terms add
    crops = rng.integers(-2, max(th, tw) // 2 + 3, (n, 4)).astype(np.int32)
    crops[0] = 0
    valid = np.ones(n, bool)
    valid[-2:] = False
    info[-2:] = 0
    ff = (1.0 / rng.uniform(0.5, 1.5, (C, th, tw))).astype(np.float32)
    return tiles, info, crops, valid, ff, (C, Z, H, W)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _port(tiles, info, crops, valid, ff, dims, th, tw):
    C, Z, H, W = dims
    shape = tfuse.padded_canvas_shape(C, Z, H, W, th, tw)
    acc = torch.zeros(shape, dtype=torch.float32)
    wsum = torch.zeros(shape, dtype=torch.float32)
    t_tiles, t_info, t_crops, t_valid = _t(tiles, info, crops, valid)
    tfuse.fuse_feather(acc, wsum, t_tiles, t_info, t_crops, t_valid,
                       ff_recip=None if ff is None else _t(ff)[0],
                       blend_px=BLEND)
    out = tfuse.finalize_feather(acc, wsum, TORCH[tiles.dtype.type])
    return acc.numpy(), wsum.numpy(), out.numpy()


def _assert_close(port, want, H, W):
    acc, wsum, out = port
    w_acc, w_wsum, w_out = want
    np.testing.assert_allclose(acc[..., :H, :W], w_acc[..., :H, :W],
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(wsum[..., :H, :W], w_wsum[..., :H, :W],
                               rtol=1e-6, atol=0)
    diff = np.abs(out[..., :H, :W].astype(np.int64)
                  - w_out[..., :H, :W].astype(np.int64))
    assert diff.max() <= 1
    # the covered pixels are the same ones
    np.testing.assert_array_equal(wsum[..., :H, :W] > 0,
                                  w_wsum[..., :H, :W] > 0)


@pytest.mark.parametrize("crops", [(0, 0, 0, 0), (3, 5, 0, 17),
                                   (-2, 40, -1, 0), (20, 20, 30, 30)],
                         ids=lambda c: "_".join(map(str, c)))
def test_feather_ramp_matches_jax(crops):
    th, tw = 37, 53
    want = np.asarray(jfuse._feather_ramp(
        jnp.asarray(crops, jnp.int32), th, tw, jnp.asarray(True), BLEND))
    got = tfuse.feather_ramp(crops, th, tw, BLEND).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("with_ff", [False, True], ids=["noff", "ff"])
@pytest.mark.parametrize("shape", [(32, 32), (37, 53)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_fuse_feather_matches_xla(dtype, with_ff, shape):
    th, tw = shape
    tiles, info, crops, valid, ff, dims = _batch(21, dtype, th, tw)
    C, Z, H, W = dims
    jt = jnp.asarray(tiles)
    if with_ff:
        jt = jfuse.apply_flatfield(jt, jnp.asarray(ff),
                                   jnp.asarray(info[:, 0]), jnp.dtype(dtype))
    shp = jfuse.padded_canvas_shape(C, Z, H, W, th, tw)
    acc, wsum = jfuse.fuse_feather(
        jnp.zeros(shp, jnp.float32), jnp.zeros(shp, jnp.float32), jt,
        jnp.asarray(info), jnp.asarray(crops), jnp.asarray(valid),
        blend_px=BLEND)
    want = (np.asarray(acc), np.asarray(wsum),
            np.asarray(jfuse.finalize_feather(acc, wsum, jnp.dtype(dtype))))
    got = _port(tiles, info, crops, valid, ff if with_ff else None, dims,
                th, tw)
    _assert_close(got, want, H, W)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("with_ff", [False, True], ids=["noff", "ff"])
@pytest.mark.parametrize("shape", [(32, 32), (37, 53)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_fuse_feather_matches_pallas(dtype, with_ff, shape):
    """The kernel's contract (feather with ff_recip fused) against the TPU
    kernel it replaces, in interpret mode. Crops are >= 0, as the
    pipeline makes them: the Pallas kernel zero-pads an unaligned tile
    and folds the pad into the bottom/right crops, so a negative crop
    there would weight padding rows that the XLA op never covers."""
    th, tw = shape
    tiles, info, crops, valid, ff, dims = _batch(22, dtype, th, tw, n=7,
                                                 C=1, Z=1, H=90, W=110)
    crops = np.maximum(crops, 0)
    C, Z, H, W = dims
    pshp = pallas_padded_canvas_shape(C, Z, H, W, th, tw, dtype)
    acc, wsum = fuse_feather_pallas(
        jnp.zeros(pshp, jnp.float32), jnp.zeros(pshp, jnp.float32),
        jnp.asarray(tiles), jnp.asarray(info), jnp.asarray(crops),
        jnp.asarray(valid), ff_recip=jnp.asarray(ff) if with_ff else None,
        blend_px=BLEND, interpret=True)
    want = (np.asarray(acc), np.asarray(wsum),
            np.asarray(jfuse.finalize_feather(acc, wsum, jnp.dtype(dtype))))
    got = _port(tiles, info, crops, valid, ff if with_ff else None, dims,
                th, tw)
    _assert_close(got, want, H, W)


def test_cpu_tensors_take_the_plain_versions():
    tiles, info, crops, valid, ff, dims = _batch(23, np.uint16, 37, 53)
    shape = tfuse.padded_canvas_shape(*dims, 37, 53)
    pairs = [(torch.zeros(shape), torch.zeros(shape)) for _ in range(2)]
    args = _t(tiles, info, crops, valid, ff)
    before = (cuda_fuse.fuse_feather.launches,
              cuda_fuse.finalize_feather.launches)
    got = cuda_fuse.fuse_feather(*pairs[0], *args[:4], ff_recip=args[4],
                                 blend_px=BLEND)
    want = tfuse.fuse_feather(*pairs[1], *args[:4], ff_recip=args[4],
                              blend_px=BLEND)
    assert got[0] is pairs[0][0] and got[1] is pairs[0][1]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    out = cuda_fuse.finalize_feather(*got, torch.uint16, (5, 120), (3, 160))
    full = tfuse.finalize_feather(*want, torch.uint16)
    assert out.shape == (2, 2, 115, 157)
    assert torch.equal(out, full[..., 5:120, 3:160])
    assert (cuda_fuse.fuse_feather.launches,
            cuda_fuse.finalize_feather.launches) == before


@pytest.mark.parametrize("bad", ["acc_dtype", "wsum_shape", "blend_px",
                                 "outside", "tile_dtype"])
def test_feather_batches_the_kernel_does_not_take_raise(bad):
    tiles, info, crops, valid, ff, dims = _batch(24, np.uint16, 32, 32)
    shape = tfuse.padded_canvas_shape(*dims, 32, 32)
    acc, wsum = torch.zeros(shape), torch.zeros(shape)
    blend = BLEND
    if bad == "acc_dtype":
        acc = acc.double()
    elif bad == "wsum_shape":
        wsum = wsum[:1].contiguous()
    elif bad == "blend_px":
        blend = 0
    elif bad == "outside":
        info[2, 3] = shape[3] - 16
    elif bad == "tile_dtype":
        tiles = tiles.astype(np.int16)
    args = _t(tiles, info, crops, valid)
    with pytest.raises((ValueError, TypeError)):
        cuda_fuse.fuse_feather(acc, wsum, *args, blend_px=blend)


def test_band_fuser_equals_one_unbanded_fuse(tmp_path):
    """The feather band fuser on the CPU, with bands narrower than a tile
    (tiles straddle up to three bands) and subpixel residuals, writes
    exactly what one plain fuse into an unbanded canvas gives."""
    acq_dir = str(tmp_path / "acq")
    channels = ["Fluorescence 488 nm Ex", "Fluorescence 561 nm Ex"]
    write_synthetic_acquisition(acq_dir, grid_cols=3, grid_rows=3,
                                tile_w=48, tile_h=40, overlap=12, seed=5,
                                channels=channels)
    acq = scan_acquisition(acq_dir)
    th, tw = acq.input_height, acq.input_width
    rng = np.random.default_rng(6)
    jobs = []
    for k, rec in enumerate(sorted(acq.tiles.values(),
                                   key=lambda r: r.filepath)):
        crops = (0, 0, 0, 0) if k % 3 else tuple(
            int(v) for v in rng.integers(0, 9, 4))
        fy, fx = ((0.0, 0.0) if k % 4 == 0
                  else tuple(float(v) for v in rng.uniform(-1, 1, 2)))
        jobs.append(TileJob(rec.filepath, -1,
                            acq.monochrome_channels.index(rec.channel), 0,
                            int(rng.integers(0, 90)), int(rng.integers(0, 100)),
                            crops, fy, fx))
    height, width = 90 + th, 100 + tw
    ff = (1.0 / rng.uniform(0.7, 1.3, (2, th, tw))).astype(np.float32)
    writer = MultiscaleWriter(str(tmp_path / "out.ome.zarr"),
                              (1, 2, 1, height, width), 1, np.uint16,
                              (1, 1, 1, 16, 32), "A1_t0", 1.0, 1.0,
                              channels, [0xFFFFFF, 0xFF00FF])
    fuser = DeviceStreamingFuser(writer, height, width, th, tw, np.uint16,
                                 1, chunk_rows=16, batch_size=3,
                                 reader_threads=2, ff_recip=ff,
                                 blend_method='feather', blend_px=BLEND,
                                 device=torch.device('cpu'))
    fuser.run(jobs)
    got = read_array(str(tmp_path / "out.ome.zarr" / "0"))

    shape = tfuse.padded_canvas_shape(2, 1, height, width, th, tw)
    acc, wsum = torch.zeros(shape), torch.zeros(shape)
    for job in jobs:
        tiles = torch.from_numpy(load_tile_plane(job).copy())[None]
        info = torch.tensor([[job.channel_idx, 0, job.y, job.x]],
                            dtype=torch.int32)
        tfuse.fuse_feather(acc, wsum, tiles, info,
                           torch.tensor([job.crops], dtype=torch.int32),
                           torch.tensor([True]), ff_recip=torch.from_numpy(ff),
                           blend_px=BLEND)
    want = tfuse.finalize_feather(acc, wsum, torch.uint16).numpy()
    assert fuser.batches > len(jobs) // 3
    np.testing.assert_array_equal(got[0, :, :, :, :],
                                  want[:, :, :height, :width])
