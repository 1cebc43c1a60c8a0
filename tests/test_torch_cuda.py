"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: the kernels have no CPU mode, so these skip without a
card. Every tile dtype the kernels take (uint32 without the field and
feathering, which the JAX package refuses it; float64 tiles reach them
as float32). Feathered sums must be bit-equal: the kernel keeps the plain
version's order and rounding. The file imports neither jax nor the JAX package, so it also runs
on a CUDA host that has neither:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from image_stitcher_tpu_torch.ops import cuda_fuse
from image_stitcher_tpu_torch.ops import fuse as plain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device('cuda')


#: every tile dtype the kernels take; uint32 takes no field and no
#: feathering (the JAX package's clip bound overflows for it)
DTYPES = [np.uint8, np.int8, np.uint16, np.int16, np.int32, np.uint32,
          np.float16, np.float32]
FF_DTYPES = [d for d in DTYPES if d != np.uint32]
#: the feathered dtypes beyond the main path's uint16 and uint8
OTHER_FF_DTYPES = [d for d in FF_DTYPES if d not in (np.uint8, np.uint16)]


def _values(rng, dtype, shape):
    """Samples over an integer type's range (the field's product clips at
    both bounds), floats with fractions and signs (float16 past 65504
    too: +inf)."""
    dtype = np.dtype(dtype)
    if dtype.kind == 'f':
        return rng.uniform(-300.0, 70000.0, shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, int(info.max) + 1, shape).astype(dtype)


def _equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal dtype and bits (NumPy compares every dtype torch stores)."""
    return got.dtype == want.dtype and np.array_equal(got.cpu().numpy(),
                                                      want.numpy())


def _batch(seed, dtype, th, tw, n=12, C=2, Z=2, H=300, W=340):
    """Overlapping tiles, crops (some past half the tile, some negative),
    a duplicate placement and invalid entries."""
    rng = np.random.default_rng(seed)
    tiles = _values(rng, dtype, (n, th, tw))
    info = np.stack([rng.integers(0, C, n), rng.integers(0, Z, n),
                     rng.integers(0, H, n), rng.integers(0, W, n)],
                    axis=1).astype(np.int32)
    info[3] = info[2]
    crops = rng.integers(-2, max(th, tw) // 2 + 3, (n, 4)).astype(np.int32)
    valid = rng.random(n) > 0.25
    valid[[2, 3]] = True
    ff = (1.0 / rng.uniform(0.5, 1.5, (C, th, tw))).astype(np.float32)
    canvas = _values(rng, dtype, plain.padded_canvas_shape(
        C, Z, H, W, th, tw))
    return [torch.from_numpy(a) for a in (canvas, tiles, info, crops,
                                          valid, ff)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,with_ff",
                         [(d, False) for d in DTYPES]
                         + [(d, True) for d in FF_DTYPES])
@pytest.mark.parametrize("shape", [(100, 120), (37, 1100)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernel_matches_plain(cuda_device, dtype, with_ff, shape):
    canvas, tiles, info, crops, valid, ff = _batch(6, dtype, *shape)
    before = cuda_fuse.fuse_overwrite.launches
    got = cuda_fuse.fuse_overwrite(
        canvas.to(cuda_device), tiles.to(cuda_device), info, crops, valid,
        ff_recip=ff.to(cuda_device) if with_ff else None)
    torch.cuda.synchronize()
    assert cuda_fuse.fuse_overwrite.launches == before + 1
    want = plain.fuse_overwrite(canvas, tiles, info, crops, valid,
                                ff_recip=ff if with_ff else None)
    assert _equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [65, 128])
def test_batches_over_64_tiles_launch_in_order(cuda_device, n):
    """A batch larger than kMaxBatch launches in runs of at most 64 tiles,
    in order: byte-equal (overwrite) and bit-equal (feather) to the plain
    version over the whole batch."""
    canvas, tiles, info, crops, valid, ff = _batch(20 + n, np.uint16, 24, 20,
                                                   n=n, H=60, W=50)
    before = cuda_fuse.fuse_overwrite.launches
    got = cuda_fuse.fuse_overwrite(canvas.to(cuda_device),
                                   tiles.to(cuda_device), info, crops, valid,
                                   ff_recip=ff.to(cuda_device))
    torch.cuda.synchronize()
    assert cuda_fuse.fuse_overwrite.launches == before + -(-n // 64)
    want = plain.fuse_overwrite(canvas.clone(), tiles, info, crops, valid,
                                ff_recip=ff)
    assert torch.equal(got.cpu(), want)
    shape = plain.padded_canvas_shape(2, 2, 60, 50, 24, 20)
    gen = torch.Generator().manual_seed(n)
    acc = torch.rand(shape, generator=gen) * 1000
    wsum = torch.rand(shape, generator=gen)
    got = cuda_fuse.fuse_feather(acc.to(cuda_device), wsum.to(cuda_device),
                                 tiles.to(cuda_device), info, crops, valid,
                                 ff_recip=ff.to(cuda_device), blend_px=6)
    torch.cuda.synchronize()
    want = plain.fuse_feather(acc, wsum, tiles, info, crops, valid,
                              ff_recip=ff, blend_px=6)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
def test_kernel_refuses_a_tile_outside_the_canvas(cuda_device):
    canvas, tiles, info, crops, valid, ff = _batch(7, np.uint16, 32, 32)
    info[2, 3] = canvas.shape[3] - 16
    with pytest.raises(ValueError):
        cuda_fuse.fuse_overwrite(canvas.to(cuda_device),
                                 tiles.to(cuda_device), info, crops, valid)


@pytest.mark.cuda
def test_kernels_refuse_float64(cuda_device):
    """float64 tiles reach the kernels as float32: a float64 batch on the
    card raises and launches nothing."""
    canvas, tiles, info, crops, valid, _ = _batch(9, np.float32, 32, 32)
    canvas, tiles = (t.double().to(cuda_device) for t in (canvas, tiles))
    launches = (cuda_fuse.fuse_overwrite.launches,
                cuda_fuse.fuse_feather.launches,
                cuda_fuse.finalize_feather.launches)
    acc = torch.zeros(canvas.shape, device=cuda_device)
    with pytest.raises(TypeError, match='float64'):
        cuda_fuse.fuse_overwrite(canvas, tiles, info, crops, valid)
    with pytest.raises(TypeError, match='float64'):
        cuda_fuse.fuse_feather(acc, acc.clone(), tiles, info, crops, valid)
    with pytest.raises(TypeError, match='float64'):
        cuda_fuse.finalize_feather(acc, acc.clone(), torch.float64)
    assert launches == (cuda_fuse.fuse_overwrite.launches,
                        cuda_fuse.fuse_feather.launches,
                        cuda_fuse.finalize_feather.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FF_DTYPES)
@pytest.mark.parametrize("with_ff", [False, True])
@pytest.mark.parametrize("shape", [(100, 120), (37, 1100)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_feather_kernel_matches_plain(cuda_device, dtype, with_ff, shape):
    _, tiles, info, crops, valid, ff = _batch(8, dtype, *shape)
    # keep most windows non-empty on the short tile
    crops[:, :2] = torch.clamp(crops[:, :2], max=shape[0] // 3)
    C, Z, Hp, Wp = plain.padded_canvas_shape(2, 2, 300, 340, *shape)
    gen = torch.Generator().manual_seed(9)
    acc = torch.rand((C, Z, Hp, Wp), generator=gen) * 1000
    wsum = torch.rand((C, Z, Hp, Wp), generator=gen)
    before = cuda_fuse.fuse_feather.launches
    got = cuda_fuse.fuse_feather(
        acc.to(cuda_device), wsum.to(cuda_device), tiles.to(cuda_device),
        info, crops, valid, ff_recip=ff.to(cuda_device) if with_ff else None,
        blend_px=24)
    torch.cuda.synchronize()
    assert cuda_fuse.fuse_feather.launches == before + 1
    want = plain.fuse_feather(acc, wsum, tiles, info, crops, valid,
                              ff_recip=ff if with_ff else None, blend_px=24)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8, torch.uint16,
                                   torch.int16, torch.int32, torch.float16,
                                   torch.float32])
def test_finalize_kernel_matches_plain(cuda_device, dtype):
    gen = torch.Generator().manual_seed(10)
    # past both bounds of every integer type (int32: 2^31 saturates)
    acc = (torch.rand((2, 1, 90, 130), generator=gen) * 2 - 0.5) * (
        2.0 ** 32 if dtype == torch.int32 else 70000)
    wsum = torch.rand((2, 1, 90, 130), generator=gen) * 2 - 0.5
    acc[0, 0, :3] = 0.5 * torch.arange(130)   # ties round half to even
    wsum[0, 0, :3] = 1.0
    before = cuda_fuse.finalize_feather.launches
    got = cuda_fuse.finalize_feather(acc.to(cuda_device),
                                     wsum.to(cuda_device), dtype,
                                     (7, 80), (11, 129))
    torch.cuda.synchronize()
    assert cuda_fuse.finalize_feather.launches == before + 1
    want = plain.finalize_feather(acc[..., 7:80, 11:129],
                                  wsum[..., 7:80, 11:129], dtype)
    assert got.shape == (2, 1, 73, 118)
    assert _equal(got, want)


def _residue_batch(seed, dtype, th, tw, pitch_residue, n=16, C=2, H=120,
                   W=260):
    """A batch that walks every residue mod 8: tile k has its x origin at
    8m + k % 8 and crops of (k + side) % 8 (+ 8 on some tiles) on each
    side; the canvas row length is 8j + ``pitch_residue`` elements (the
    one-tile apron, then padded). One entry is invalid padding."""
    rng = np.random.default_rng(seed)
    tiles = _values(rng, dtype, (n, th, tw))
    k = np.arange(n)
    x = 8 * rng.integers(0, W // 8, n) + k % 8
    info = np.stack([k % C, np.zeros(n, int), rng.integers(0, H, n), x],
                    axis=1).astype(np.int32)
    crops = np.stack([(k + side) % 8 + 8 * (k % 3 == side % 3)
                      for side in range(4)], axis=1).astype(np.int32)
    valid = np.ones(n, bool)
    valid[5] = False
    ff = (1.0 / rng.uniform(0.5, 1.5, (C, th, tw))).astype(np.float32)
    _, _, Hp, Wp = plain.padded_canvas_shape(C, 1, H, W, th, tw)
    Wp = -(-Wp // 8) * 8 + pitch_residue
    canvas = _values(rng, dtype, (C, 1, Hp, Wp))
    return [torch.from_numpy(a) for a in (canvas, tiles, info, crops, valid,
                                          ff)]


def _split_batch(dtype, th=24, tw=200):
    """Tile 0 is cut into three spans on its middle rows by two later
    windows (tiles 1 and 2); tile 3 is placed exactly on tile 4 (the
    later one wins everywhere)."""
    rng = np.random.default_rng(21)
    tiles = _values(rng, dtype, (5, th, tw))
    info = np.array([[0, 0, 10, 13], [0, 0, 16, 53], [0, 0, 4, 101],
                     [0, 0, 40, 7], [0, 0, 40, 7]], np.int32)
    # tiles 1 and 2: windows 40 and 33 columns wide, inside tile 0's rows
    crops = np.array([[1, 2, 3, 5], [0, 8, 0, tw - 40], [6, 0, 2, tw - 35],
                      [0, 0, 0, 0], [1, 1, 1, 1]], np.int32)
    valid = np.ones(5, bool)
    ff = (1.0 / rng.uniform(0.5, 1.5, (1, th, tw))).astype(np.float32)
    canvas = _values(rng, dtype, plain.padded_canvas_shape(
        1, 1, 80, 320, th, tw))
    return [torch.from_numpy(a) for a in (canvas, tiles, info, crops, valid,
                                          ff)]


def _overwrite_equal(dev, canvas, tiles, info, crops, valid, ff):
    got = cuda_fuse.fuse_overwrite(canvas.to(dev), tiles.to(dev), info,
                                   crops, valid,
                                   None if ff is None else ff.to(dev))
    torch.cuda.synchronize()
    want = plain.fuse_overwrite(canvas.clone(), tiles, info, crops, valid, ff)
    assert _equal(got, want)


def _feather_equal(dev, shape, tiles, info, crops, valid, ff, blend_px):
    gen = torch.Generator().manual_seed(12)
    acc = torch.rand(shape, generator=gen) * 1000
    wsum = torch.rand(shape, generator=gen)
    got = cuda_fuse.fuse_feather(acc.to(dev), wsum.to(dev), tiles.to(dev),
                                 info, crops, valid,
                                 None if ff is None else ff.to(dev), blend_px)
    torch.cuda.synchronize()
    want = plain.fuse_feather(acc, wsum, tiles, info, crops, valid, ff,
                              blend_px)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("pitch_residue", range(8))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tw", [72, 70, 77], ids=lambda w: f"tw{w}")
def test_kernel_every_pitch_origin_and_crop_residue(cuda_device,
                                                    pitch_residue, dtype,
                                                    tw):
    canvas, tiles, info, crops, valid, ff = _residue_batch(
        30 + pitch_residue, dtype, 40, tw, pitch_residue)
    assert canvas.shape[3] % 8 == pitch_residue
    with_ff = pitch_residue % 2 == 0 and dtype != np.uint32
    _overwrite_equal(cuda_device, canvas, tiles, info, crops, valid,
                     ff if with_ff else None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,with_ff",
                         [(d, False) for d in DTYPES]
                         + [(d, True) for d in FF_DTYPES])
def test_kernel_split_spans_and_duplicate(cuda_device, dtype, with_ff):
    canvas, tiles, info, crops, valid, ff = _split_batch(dtype)
    _overwrite_equal(cuda_device, canvas, tiles, info, crops, valid,
                     ff if with_ff else None)


@pytest.mark.cuda
@pytest.mark.parametrize("pitch_residue", range(8))
@pytest.mark.parametrize("blend_px", [1, 24, 64, 3000])
@pytest.mark.parametrize("tw", [72, 70, 77], ids=lambda w: f"tw{w}")
@pytest.mark.parametrize("dtype", [None] + OTHER_FF_DTYPES,
                         ids=lambda d: 'u16_u8' if d is None
                         else np.dtype(d).name)
def test_feather_kernel_every_pitch_origin_and_crop_residue(
        cuda_device, pitch_residue, blend_px, tw, dtype):
    # 3000 is longer than half of every window and than the ramp table;
    # None: the main path's uint16 at residues 0-3 and uint8 at 4-7
    if dtype is None:
        dtype = np.uint16 if pitch_residue < 4 else np.uint8
    canvas, tiles, info, crops, valid, ff = _residue_batch(
        40 + pitch_residue, dtype, 40, tw, pitch_residue)
    _feather_equal(cuda_device, canvas.shape, tiles, info, crops, valid,
                   ff if pitch_residue % 2 == 0 else None, blend_px)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", FF_DTYPES)
@pytest.mark.parametrize("blend_px", [1, 24, 64, 150])
def test_feather_kernel_split_windows_and_duplicate(cuda_device, dtype,
                                                    blend_px):
    # 150 is longer than half of every window here
    canvas, tiles, info, crops, valid, ff = _split_batch(dtype)
    _feather_equal(cuda_device, canvas.shape, tiles, info, crops, valid, ff,
                   blend_px)


def _well_batches(seed, dtype, tile=256, grid=3, overlap=26, C=3, Z=2,
                  batch=10):
    """A well as the in-RAM path fuses it: grid x grid tiles of every
    (c, z) plane on one (C, Z, Hp, Wp) canvas (one-tile apron below and
    right, rows padded to 8), crops halving each overlap, jobs in a
    seeded order cut into batches of ``batch`` with a padded tail."""
    rng = np.random.default_rng(seed)
    hi = np.iinfo(dtype).max
    step = tile - overlap
    side = step * (grid - 1) + tile
    shape = (C, Z, side + tile, -(-(side + tile) // 8) * 8)
    jobs = []
    for c in range(C):
        for z in range(Z):
            for r in range(grid):
                for q in range(grid):
                    crops = [overlap // 2 if r else 0,
                             overlap // 2 if r < grid - 1 else 0,
                             overlap // 2 if q else 0,
                             overlap // 2 if q < grid - 1 else 0]
                    jobs.append(([c, z, r * step, q * step], crops))
    order = rng.permutation(len(jobs))
    out = []
    for b0 in range(0, len(jobs), batch):
        chunk = [jobs[k] for k in order[b0:b0 + batch]]
        n = len(chunk)
        info = np.zeros((batch, 4), np.int32)
        crops = np.zeros((batch, 4), np.int32)
        valid = np.zeros(batch, bool)
        info[:n] = [j[0] for j in chunk]
        crops[:n] = [j[1] for j in chunk]
        valid[:n] = True
        tiles = rng.integers(0, hi + 1, (batch, tile, tile)).astype(dtype)
        out.append([torch.from_numpy(a) for a in (tiles, info, crops,
                                                  valid)])
    ff = torch.from_numpy((1.0 / rng.uniform(0.6, 1.4, (C, tile, tile)))
                          .astype(np.float32))
    return shape, out, ff


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_kernels_on_a_well_canvas(cuda_device, dtype):
    """Every kernel on a whole (3, 2, Hp, Wp) well canvas with a 3-plane
    field, real channel and z indices, against the plain versions: the
    overwrite canvas and the finalized feather canvas byte-equal, the
    feather sums bit-equal."""
    shape, batches, ff = _well_batches(50, dtype)
    tdtype = torch.from_numpy(np.zeros(1, dtype)).dtype
    got = torch.zeros(shape, dtype=tdtype, device=cuda_device)
    want = torch.zeros(shape, dtype=tdtype)
    acc = torch.zeros(shape, device=cuda_device)
    wsum = torch.zeros(shape, device=cuda_device)
    acc_p = torch.zeros(shape)
    wsum_p = torch.zeros(shape)
    d_ff = ff.to(cuda_device)
    for tiles, info, crops, valid in batches:
        d_tiles = tiles.to(cuda_device)
        cuda_fuse.fuse_overwrite(got, d_tiles, info, crops, valid, d_ff)
        plain.fuse_overwrite(want, tiles, info, crops, valid, ff)
        cuda_fuse.fuse_feather(acc, wsum, d_tiles, info, crops, valid, d_ff,
                               blend_px=64)
        plain.fuse_feather(acc_p, wsum_p, tiles, info, crops, valid, ff,
                           blend_px=64)
    h, w = shape[2] - 256, shape[3] - 256 - (shape[3] - 256) % 8
    fin = cuda_fuse.finalize_feather(acc, wsum, tdtype, (0, h), (0, w))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(acc.cpu(), acc_p) and torch.equal(wsum.cpu(), wsum_p)
    assert torch.equal(fin.cpu(), plain.finalize_feather(
        acc_p[..., :h, :w], wsum_p[..., :h, :w], tdtype))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [7, 80])
def test_device_flatfield_solver_matches_host(cuda_device, n):
    """The ADMM solver on the card against the NumPy solver on the same
    padded stack, within 1e-4: its DCT products must not run in TF32."""
    from image_stitcher_tpu_torch.ops import flatfield as ff_ops
    rng = np.random.default_rng(n)
    yy, xx = np.mgrid[0:96, 0:96] / 95.0
    vignette = 1.0 - 0.3 * ((yy - 0.5) ** 2 + (xx - 0.5) ** 2)
    stack = (rng.uniform(500, 4000, (n, 96, 96)) * vignette).astype(
        np.float32)
    stack = ff_ops.pad_stack_cycled(stack, 80)
    got = ff_ops.fit_flatfield_stack(torch.from_numpy(stack).to(cuda_device))
    assert got.device.type == 'cuda' and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(),
                               ff_ops.fit_flatfield_stack_np(stack),
                               rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_merge_fold_on_the_card_equals_the_cpu_fold(cuda_device, tmp_path):
    """The merges' band copy and fold (models/merge.py) on the card write
    the arrays the CPU fold writes: level 0 copied, levels 1-3 the 2x2
    mean, at two T indexes, bands of 128 rows over 8 levels' worth of
    alignment; the card's upload, fold and copies are timed."""
    from types import SimpleNamespace
    from image_stitcher_tpu_torch import EngineOptions
    from image_stitcher_tpu_torch.io.omezarr import MultiscaleWriter
    from image_stitcher_tpu_torch.io.zarr_store import open_array, read_array
    from image_stitcher_tpu_torch.models import merge
    rng = np.random.default_rng(3)
    vol = rng.integers(0, 65536, (1, 2, 1, 700, 530), dtype=np.uint16)
    meta = (1.0, 1.0, ['a', 'b'], [0xFF, 0xFF00])
    src = MultiscaleWriter(str(tmp_path / 'src'), vol.shape, 1, np.uint16,
                           (1, 1, 1, 128, 128), 'src', *meta)
    src.write_level(0, vol)
    src.close()
    got = {}
    for dev in (cuda_device, torch.device('cpu')):
        pipe = SimpleNamespace(device=dev, merge_stats=merge.MergeStats(),
                               options=EngineOptions(chunks=(1, 1, 1, 128,
                                                             128)))
        out = str(tmp_path / dev.type)
        writer = MultiscaleWriter(out, (2, 2, 1, 700, 530), 4, np.uint16,
                                  (1, 1, 1, 128, 128), 'm', *meta,
                                  cname='lz4')
        for ti in (0, 1):
            merge._stream_volume_banded(
                pipe, writer, [(ti, open_array(str(tmp_path / 'src' / '0')))],
                4)
        writer.close()
        got[dev.type] = [read_array(f"{out}/{k}") for k in range(4)]
        if dev.type == 'cuda':
            stats = pipe.merge_stats.as_dict()
            assert stats['h2d_ms'] > 0 and stats['fold_ms'] > 0
            assert stats['bands'] == 12
    for a, b in zip(got['cuda'], got['cpu']):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got['cuda'][0][1], vol[0])


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: a launch on cuda:1 from a thread "
                    "on cuda:0 cannot be made on one card")
    return torch.device('cuda', 0), torch.device('cuda', 1)


@pytest.mark.cuda
def test_launches_on_another_card_leave_the_current_device(two_cards):
    """Every launch wrapper gives the calling thread its device back: a
    launch on a band of cuda:1 from a thread on cuda:0 leaves cuda:0
    current (an allocation on torch.device('cuda') lands there)."""
    here, there = two_cards
    canvas, tiles, info, crops, valid, ff = _batch(30, np.uint16, 24, 20,
                                                   H=60, W=50)
    shape = plain.padded_canvas_shape(2, 2, 60, 50, 24, 20)
    with torch.cuda.device(here):
        cuda_fuse.fuse_overwrite(canvas.to(there), tiles.to(there), info,
                                 crops, valid, ff_recip=ff.to(there))
        assert torch.cuda.current_device() == here.index
        acc = torch.zeros(shape, device=there)
        wsum = torch.zeros(shape, device=there)
        cuda_fuse.fuse_feather(acc, wsum, tiles.to(there), info, crops,
                               valid, ff_recip=ff.to(there), blend_px=6)
        assert torch.cuda.current_device() == here.index
        cuda_fuse.finalize_feather(acc, wsum, torch.uint16)
        assert torch.cuda.current_device() == here.index
        assert torch.empty(1, device='cuda').device == here
        torch.cuda.synchronize(there)


@pytest.mark.cuda
@pytest.mark.parametrize("blend", ['overwrite', 'feather'])
def test_sharded_canvas_on_the_card_matches_plain(cuda_device, blend):
    """A ShardedCanvas over two bands of the card (a repeated device, or
    two cards where the host has them), straddling tiles, the field fused
    in: its bands stream back equal to one plain unbanded canvas."""
    from image_stitcher_tpu_torch.parallel.mesh import make_mesh
    from image_stitcher_tpu_torch.parallel.sharded_fuse import ShardedCanvas
    n_cards = torch.cuda.device_count()
    devices = ([torch.device('cuda', 0), torch.device('cuda', 1)]
               if n_cards >= 2 else [torch.device('cuda', 0)] * 2)
    C, Z, H, W, th, tw = 2, 2, 300, 340, 64, 48
    _, tiles, info, crops, valid, ff = _batch(31, np.uint16, th, tw, n=24,
                                              H=H - th, W=W - tw)
    canvas = ShardedCanvas(make_mesh((1, 2), devices), C, Z, H, W, th, tw,
                           np.uint16, blend_method=blend, blend_px=12,
                           ff_recip=ff.numpy())
    canvas.fuse_batch(tiles.pin_memory(), info, crops, valid)
    got = torch.ones((C, Z, H, W), dtype=torch.uint16)
    for c, z, r0, host, event in canvas.iter_bands(piece_rows=64):
        event.synchronize()
        got[c, z, r0:r0 + host.shape[0]] = host
    shape = plain.padded_canvas_shape(C, Z, H, W, th, tw)
    if blend == 'feather':
        acc, wsum = plain.fuse_feather(torch.zeros(shape), torch.zeros(shape),
                                       tiles, info, crops, valid, ff_recip=ff,
                                       blend_px=12)
        want = plain.finalize_feather(acc, wsum, torch.uint16)
    else:
        want = plain.fuse_overwrite(torch.zeros(shape, dtype=torch.uint16),
                                    tiles, info, crops, valid, ff_recip=ff)
    assert torch.equal(got, want[:, :, :H, :W])
    assert all(b['launches'] == 1 for b in canvas.band_stats())
