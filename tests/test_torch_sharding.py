"""The port's device meshes and sharded ops against the JAX package's.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's counterpart is a mesh over ``[torch.device('cpu')] * 8``,
where the fusion wrappers take their plain versions (the CUDA kernels
run on a card: ``tests/test_torch_cuda.py``). The same seeded batches,
with tiles that straddle band edges, go through the JAX ``ShardedCanvas``
(by its XLA route and by its Pallas route in interpret mode, as
``tests/test_sharding.py::test_sharded_pallas_*`` run it) and the
port's. Bars: overwrite byte-equal; feather bit-equal to one unbanded
plain canvas of the port, and different from the JAX canvas only where
the two packages' unbanded feathers differ, by at most 1 LSB (the bar
of ``tests/test_torch_feather.py``: XLA may contract a multiply-add into
one FMA where the port rounds the product first); the sharded phase
correlation within 1 / upsample_factor of the JAX one (the bar of
``tests/test_torch_registration.py``); the sharded flatfield apply
byte-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_stitcher_tpu.parallel import mesh as jmesh
from image_stitcher_tpu.parallel import sharded_fuse as jsharded
from image_stitcher_tpu.parallel import sharded_ops as jops
from image_stitcher_tpu_torch.ops import fuse as tfuse
from image_stitcher_tpu_torch.parallel import mesh as tmesh
from image_stitcher_tpu_torch.parallel import sharded_fuse as tsharded
from image_stitcher_tpu_torch.parallel import sharded_ops as tops

CPU8 = [torch.device('cpu')] * 8
TORCH = {np.uint8: torch.uint8, np.uint16: torch.uint16}
C, Z, H, W, TH, TW = 2, 2, 100, 80, 32, 32
BLEND = 12


def test_make_mesh_matches_jax():
    for shape in [(2, 4), (1, 8), (1, 3), (4, 2), (8, 1)]:
        j = jmesh.make_mesh(shape, jax.devices()[:shape[0] * shape[1]])
        t = tmesh.make_mesh(shape, CPU8)
        assert dict(j.shape) == t.shape == {'data': shape[0],
                                            'canvas': shape[1]}
        assert len(t.row(0)) == shape[1] and len(t.column(0)) == shape[0]
    assert tmesh.make_mesh(None, CPU8).shape == dict(jmesh.make_mesh().shape)
    for n in range(1, 10):
        assert tmesh.default_mesh_shape(n) == jmesh.default_mesh_shape(n)
    with pytest.raises(ValueError) as jerr:
        jmesh.make_mesh((3, 4))
    with pytest.raises(ValueError) as terr:
        tmesh.make_mesh((3, 4), CPU8)
    assert str(terr.value) == str(jerr.value)


def test_band_local_origin_matches_jax():
    y = np.arange(-40, 140, dtype=np.int32)
    for band, th, start in [(13, 32, 0), (13, 32, 26), (34, 32, 68),
                            (25, 16, 75), (100, 32, 0)]:
        jy, jhit = jsharded.band_local_origin(jnp.asarray(y), band, th, start)
        ty, thit = tsharded.band_local_origin(y, band, th, start)
        np.testing.assert_array_equal(ty, np.asarray(jy))
        np.testing.assert_array_equal(thit, np.asarray(jhit))
        # every intersecting tile's band-local extent fits the band canvas
        assert (ty[thit] > 0).all() and (ty[thit] + th <= band + 2 * th).all()
        sy, shit = tsharded.band_local_origin(int(y[50]), band, th, start)
        assert (int(sy), bool(shit)) == (int(ty[50]), bool(thit[50]))


def _problem(seed, dtype, n=24):
    """A batch as ``tests/test_sharding.py::_random_problem`` makes it:
    rows up to H - 8, so tiles straddle every band edge; small crops and
    ~10 % invalid entries."""
    rng = np.random.default_rng(seed)
    hi = np.iinfo(dtype).max
    tiles = rng.integers(0, hi, (n, TH, TW)).astype(dtype)
    info = np.stack([rng.integers(0, C, n), rng.integers(0, Z, n),
                     rng.integers(0, H - 8, n), rng.integers(0, W - 8, n)],
                    axis=1).astype(np.int32)
    crops = rng.integers(0, 5, (n, 4)).astype(np.int32)
    valid = rng.random(n) > 0.1
    return tiles, info, crops, valid


def _jax_canvas(mesh_shape, dtype, ff, blend, route, batches):
    mesh = jmesh.make_mesh(mesh_shape,
                           jax.devices()[:mesh_shape[0] * mesh_shape[1]])
    kw = dict(device_kernel='pallas', pallas_interpret=True) \
        if route == 'pallas' else {}
    canvas = jsharded.ShardedCanvas(mesh, C, Z, H, W, TH, TW, dtype,
                                    blend_method=blend, blend_px=BLEND,
                                    ff_recip=ff, **kw)
    assert canvas.use_pallas == (route == 'pallas')
    for b in batches:
        canvas.fuse_batch(*(jnp.asarray(a) for a in b))
    return np.asarray(canvas.finalize())


def _port_canvas(mesh_shape, dtype, ff, blend, batches, band=None):
    mesh = tmesh.make_mesh(mesh_shape, CPU8)
    canvas = tsharded.ShardedCanvas(mesh, C, Z, H, W, TH, TW, dtype,
                                    blend_method=blend, blend_px=BLEND,
                                    ff_recip=ff, band=band)
    for b in batches:
        canvas.fuse_batch(torch.from_numpy(b[0]), *b[1:])
    return canvas


def _port_unbanded(dtype, ff, blend, batches):
    """One plain (C, Z, H + th, W + tw) canvas of the port."""
    shape = tfuse.padded_canvas_shape(C, Z, H, W, TH, TW)
    ff_t = None if ff is None else torch.from_numpy(ff)
    if blend == 'feather':
        acc = torch.zeros(shape)
        wsum = torch.zeros(shape)
    else:
        canvas = torch.zeros(shape, dtype=TORCH[dtype])
    for tiles, info, crops, valid in batches:
        meta = (torch.from_numpy(tiles), torch.from_numpy(info),
                torch.from_numpy(crops), torch.from_numpy(valid))
        if blend == 'feather':
            tfuse.fuse_feather(acc, wsum, *meta, ff_recip=ff_t,
                               blend_px=BLEND)
        else:
            tfuse.fuse_overwrite(canvas, *meta, ff_recip=ff_t)
    if blend == 'feather':
        return tfuse.finalize_feather(acc, wsum, TORCH[dtype])[
            :, :, :H, :W].numpy()
    return canvas[:, :, :H, :W].numpy()


def _jax_unbanded_feather(dtype, ff, batches):
    """The JAX package's unbanded XLA feather of the same batches."""
    from image_stitcher_tpu.ops import fuse as jfuse
    shape = jfuse.padded_canvas_shape(C, Z, H, W, TH, TW)
    acc = jnp.zeros(shape, jnp.float32)
    wsum = jnp.zeros(shape, jnp.float32)
    for tiles, info, crops, valid in batches:
        t = jnp.asarray(tiles)
        if ff is not None:
            t = jfuse.apply_flatfield(t, jnp.asarray(ff),
                                      jnp.asarray(info[:, 0]), dtype)
        acc, wsum = jfuse.fuse_feather(acc, wsum, t, jnp.asarray(info),
                                       jnp.asarray(crops), jnp.asarray(valid),
                                       blend_px=BLEND)
    return np.asarray(jfuse.finalize_feather(acc, wsum, dtype))[:, :, :H, :W]


@pytest.mark.parametrize("route", ['xla', 'pallas'])
@pytest.mark.parametrize("blend", ['overwrite', 'feather'])
@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (1, 3)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_canvas_matches_jax(mesh_shape, blend, route):
    """Three batches into one canvas, u16 with the field and u8 without:
    the port's finalized canvas against the JAX ShardedCanvas's, and its
    streamed bands against its own finalize."""
    for k, (dtype, with_ff) in enumerate([(np.uint16, True),
                                          (np.uint8, False)]):
        rng = np.random.default_rng(100 + k)
        ff = ((rng.random((C, TH, TW)) * 0.8 + 0.6).astype(np.float32)
              if with_ff else None)
        batches = [_problem(10 * k + s, dtype) for s in range(3)]
        if blend == 'feather':
            for b in batches:     # one z plane, as the JAX feather tests
                b[1][:, 1] = 0
        want = _jax_canvas(mesh_shape, dtype, ff, blend, route, batches)
        got = _port_canvas(mesh_shape, dtype, ff, blend,
                           batches).finalize().numpy()
        assert got.shape == want.shape == (C, Z, H, W)
        if blend == 'overwrite':
            np.testing.assert_array_equal(got, want)
        else:
            # sharding adds no difference on either side: the port's bands
            # are its unbanded canvas bit for bit, and differ from the JAX
            # ShardedCanvas exactly where the two unbanded ops differ
            np.testing.assert_array_equal(
                got, _port_unbanded(dtype, ff, blend, batches))
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
            np.testing.assert_array_equal(
                got != want, got != _jax_unbanded_feather(dtype, ff, batches))
        for piece_rows in (None, 8):
            canvas = _port_canvas(mesh_shape, dtype, ff, blend, batches)
            np.testing.assert_array_equal(
                _streamed(canvas, piece_rows, dtype), got)


def _streamed(canvas, piece_rows, dtype):
    """The canvas reassembled from :meth:`iter_bands`'s pieces, which come
    band by band in row order, each (c, z) plane's rows cut at the bands
    and at every multiple of ``piece_rows``."""
    out = np.full((C, Z, H, W), 1, dtype)
    starts = []
    for c, z, r0, host, event in canvas.iter_bands(piece_rows=piece_rows):
        assert event is None and host.shape[1] == W
        r1 = r0 + host.shape[0]
        band = [b for b in canvas.bands if b.start <= r0 < b.start + b.rows]
        assert len(band) == 1 and r1 <= band[0].start + band[0].rows
        if piece_rows:
            assert (r1 - 1) // piece_rows == r0 // piece_rows
        starts.append(band[0].start)
        out[c, z, r0:r1] = host.numpy()
    assert starts == sorted(starts)
    return out


@pytest.mark.parametrize("band", [None, 32, 64])
def test_taller_bands_leave_trailing_devices_empty(band):
    """Bands rounded up (the pipeline rounds to the writer's band rows)
    leave the last devices of (1, 8) without rows: they hold nothing and
    launch nothing, and the canvas is unchanged."""
    batches = [_problem(s, np.uint16) for s in range(2)]
    canvas = _port_canvas((1, 8), np.uint16, None, 'overwrite', batches,
                          band=band)
    want = _port_unbanded(np.uint16, None, 'overwrite', batches)
    n = 8 if band is None else -(-H // band)
    assert len(canvas.bands) == n
    assert canvas.bands[-1].rows == H - (n - 1) * canvas.band
    assert sum(b['launches'] > 0 for b in canvas.band_stats()) <= n
    np.testing.assert_array_equal(canvas.finalize().numpy(), want)
    with pytest.raises(ValueError, match="do not cover"):
        tsharded.ShardedCanvas(tmesh.make_mesh((1, 8), CPU8), C, Z, H, W,
                               TH, TW, np.uint16, band=12)


def test_sharded_phasecorr_matches_jax(rng):
    uf = 10
    jm = jmesh.make_mesh((4, 2), jax.devices())
    tm = tmesh.make_mesh((4, 2), CPU8)
    a = rng.random((8, 48, 64)).astype(np.float32)
    b = np.roll(a, (3, -2), axis=(1, 2))
    want = np.asarray(jops.sharded_phase_cross_correlation(
        jm, jnp.asarray(a), jnp.asarray(b), uf))
    got = tops.sharded_phase_cross_correlation(tm, a, b, uf)
    assert got.shape == (8, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1.0 / uf)
    np.testing.assert_allclose(got.numpy(), np.tile([[-3, 2]], (8, 1)),
                               atol=0.1)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_sharded_flatfield_apply_matches_jax(rng, dtype):
    jm = jmesh.make_mesh((4, 2), jax.devices())
    tm = tmesh.make_mesh((4, 2), CPU8)
    tiles = rng.integers(0, np.iinfo(dtype).max, (12, 16, 16)).astype(dtype)
    ff = (rng.random((3, 16, 16)) * 1.2 + 0.4).astype(np.float32)
    cidx = rng.integers(0, 3, 12).astype(np.int32)
    want = np.asarray(jops.sharded_apply_flatfield(
        jm, jnp.asarray(tiles), jnp.asarray(ff), jnp.asarray(cidx),
        jnp.dtype(dtype)))
    got = tops.sharded_apply_flatfield(tm, tiles, ff, cidx, TORCH[dtype])
    np.testing.assert_array_equal(got.numpy(), want)
