"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: the kernels have no CPU mode, so these skip without a
card. Feathered sums must be bit-equal: the kernel keeps the plain
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


def _batch(seed, dtype, th, tw, n=12, C=2, Z=2, H=300, W=340):
    """Overlapping tiles, crops (some past half the tile, some negative),
    a duplicate placement and invalid entries."""
    rng = np.random.default_rng(seed)
    hi = np.iinfo(dtype).max
    tiles = rng.integers(0, hi + 1, (n, th, tw)).astype(dtype)
    info = np.stack([rng.integers(0, C, n), rng.integers(0, Z, n),
                     rng.integers(0, H, n), rng.integers(0, W, n)],
                    axis=1).astype(np.int32)
    info[3] = info[2]
    crops = rng.integers(-2, max(th, tw) // 2 + 3, (n, 4)).astype(np.int32)
    valid = rng.random(n) > 0.25
    valid[[2, 3]] = True
    ff = (1.0 / rng.uniform(0.5, 1.5, (C, th, tw))).astype(np.float32)
    canvas = rng.integers(0, hi + 1, plain.padded_canvas_shape(
        C, Z, H, W, th, tw)).astype(dtype)
    return [torch.from_numpy(a) for a in (canvas, tiles, info, crops,
                                          valid, ff)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("with_ff", [False, True])
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
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_kernel_refuses_a_tile_outside_the_canvas(cuda_device):
    canvas, tiles, info, crops, valid, ff = _batch(7, np.uint16, 32, 32)
    info[2, 3] = canvas.shape[3] - 16
    with pytest.raises(ValueError):
        cuda_fuse.fuse_overwrite(canvas.to(cuda_device),
                                 tiles.to(cuda_device), info, crops, valid)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
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
@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16])
def test_finalize_kernel_matches_plain(cuda_device, dtype):
    gen = torch.Generator().manual_seed(10)
    acc = torch.rand((2, 1, 90, 130), generator=gen) * 70000
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
    assert torch.equal(got.cpu(), want)


def _residue_batch(seed, dtype, th, tw, pitch_residue, n=16, C=2, H=120,
                   W=260):
    """A batch that walks every residue mod 8: tile k has its x origin at
    8m + k % 8 and crops of (k + side) % 8 (+ 8 on some tiles) on each
    side; the canvas row length is 8j + ``pitch_residue`` elements (the
    one-tile apron, then padded). One entry is invalid padding."""
    rng = np.random.default_rng(seed)
    hi = np.iinfo(dtype).max
    tiles = rng.integers(0, hi + 1, (n, th, tw)).astype(dtype)
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
    canvas = rng.integers(0, hi + 1, (C, 1, Hp, Wp)).astype(dtype)
    return [torch.from_numpy(a) for a in (canvas, tiles, info, crops, valid,
                                          ff)]


def _split_batch(dtype, th=24, tw=200):
    """Tile 0 is cut into three spans on its middle rows by two later
    windows (tiles 1 and 2); tile 3 is placed exactly on tile 4 (the
    later one wins everywhere)."""
    rng = np.random.default_rng(21)
    hi = np.iinfo(dtype).max
    tiles = rng.integers(0, hi + 1, (5, th, tw)).astype(dtype)
    info = np.array([[0, 0, 10, 13], [0, 0, 16, 53], [0, 0, 4, 101],
                     [0, 0, 40, 7], [0, 0, 40, 7]], np.int32)
    # tiles 1 and 2: windows 40 and 33 columns wide, inside tile 0's rows
    crops = np.array([[1, 2, 3, 5], [0, 8, 0, tw - 40], [6, 0, 2, tw - 35],
                      [0, 0, 0, 0], [1, 1, 1, 1]], np.int32)
    valid = np.ones(5, bool)
    ff = (1.0 / rng.uniform(0.5, 1.5, (1, th, tw))).astype(np.float32)
    canvas = rng.integers(0, hi + 1, plain.padded_canvas_shape(
        1, 1, 80, 320, th, tw)).astype(dtype)
    return [torch.from_numpy(a) for a in (canvas, tiles, info, crops, valid,
                                          ff)]


def _overwrite_equal(dev, canvas, tiles, info, crops, valid, ff):
    got = cuda_fuse.fuse_overwrite(canvas.to(dev), tiles.to(dev), info,
                                   crops, valid,
                                   None if ff is None else ff.to(dev))
    torch.cuda.synchronize()
    want = plain.fuse_overwrite(canvas.clone(), tiles, info, crops, valid, ff)
    assert torch.equal(got.cpu(), want)


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
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("tw", [72, 70, 77], ids=lambda w: f"tw{w}")
def test_kernel_every_pitch_origin_and_crop_residue(cuda_device,
                                                    pitch_residue, dtype,
                                                    tw):
    canvas, tiles, info, crops, valid, ff = _residue_batch(
        30 + pitch_residue, dtype, 40, tw, pitch_residue)
    assert canvas.shape[3] % 8 == pitch_residue
    _overwrite_equal(cuda_device, canvas, tiles, info, crops, valid,
                     ff if pitch_residue % 2 == 0 else None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("with_ff", [False, True])
def test_kernel_split_spans_and_duplicate(cuda_device, dtype, with_ff):
    canvas, tiles, info, crops, valid, ff = _split_batch(dtype)
    _overwrite_equal(cuda_device, canvas, tiles, info, crops, valid,
                     ff if with_ff else None)


@pytest.mark.cuda
@pytest.mark.parametrize("pitch_residue", range(8))
@pytest.mark.parametrize("blend_px", [1, 24, 64, 3000])
@pytest.mark.parametrize("tw", [72, 70, 77], ids=lambda w: f"tw{w}")
def test_feather_kernel_every_pitch_origin_and_crop_residue(
        cuda_device, pitch_residue, blend_px, tw):
    # 3000 is longer than half of every window and than the ramp table
    dtype = np.uint16 if pitch_residue < 4 else np.uint8
    canvas, tiles, info, crops, valid, ff = _residue_batch(
        40 + pitch_residue, dtype, 40, tw, pitch_residue)
    _feather_equal(cuda_device, canvas.shape, tiles, info, crops, valid,
                   ff if pitch_residue % 2 == 0 else None, blend_px)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
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
