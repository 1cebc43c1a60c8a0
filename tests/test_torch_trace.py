"""The port's spans (``utils/profiling.py``), on the CPU.

A 2x2 two-channel acquisition with subpixel jitter is stitched once with
tracing on (global registration, subpixel placement, feathered bands on
the band fuser, a flatfield, blosc zstd-1): every tile is loaded once
(one band), the tiles with a fractional residual are warped once, each
channel is solved once, the encoders see the raw bytes of every stored
chunk and the writes its bytes on disk, each band's folds sit inside its
write, and the counters kept in every run (``StageTimers``, the band
fuser's ``stats``) are the sums of their spans. The host band fuser's
wall and on-core stage sums are the sums of theirs too. With tracing off
nothing is recorded.
"""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from fixtures import write_synthetic_acquisition
from torch_helpers import small_disk_probe  # noqa: F401
import image_stitcher_tpu_torch as port
from image_stitcher_tpu_torch.utils import profiling

CHANNELS = ["Fluorescence 488 nm Ex", "Fluorescence 561 nm Ex"]
BAND_FUSER_STATS = {'fuse': ('band.fuse',),
                    'readback_wait': ('band.readback_wait',),
                    'write': ('band.write',),
                    'close': ('band.close',)}


@pytest.fixture(autouse=True)
def tracing_off():
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()


def _stitch(root, **options):
    acq = str(root / "acq")
    if not os.path.isdir(acq):
        write_synthetic_acquisition(
            acq, grid_cols=2, grid_rows=2, tile_w=96, tile_h=96, overlap=32,
            channels=CHANNELS, regions=["A1"], seed=31, jitter=3,
            acq_params_overrides={"pixel_binning": 2})
    out = str(root / f"out{len(os.listdir(root))}")
    # one band: chunks taller than the canvas
    opts = port.EngineOptions(
        output_folder=out, streaming='on', compressor_cname='zstd',
        compressor_clevel=1, chunks=(1, 1, 1, 256, 256),
        registration_scope='global', subpixel_placement=True,
        blend_method='feather', feather_px=24,
        registration_device_threshold=4, **options)
    pipe = port.stitch(acq, use_registration=True, apply_flatfield=True,
                       device=torch.device('cpu'), options=opts)
    return pipe, out


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    root = tmp_path_factory.mktemp("trace")
    profiling.drain()
    profiling.enable()
    try:
        pipe, out = _stitch(root)
    finally:
        profiling.disable()
    return pipe, profiling.drain(), out, root


@pytest.fixture(scope="module")
def host_traced(traced):
    """The same stitch on the host band fuser, two band threads."""
    _, _, _, root = traced
    profiling.drain()
    profiling.enable()
    try:
        pipe, _ = _stitch(root, fusion_device='host', host_fusion_threads=2)
    finally:
        profiling.disable()
    return pipe, profiling.drain()


def _named(spans, name):
    return [s for s in spans if s.name == name]


def _chunk_files(out):
    """(array dir, its .zarray, the sizes of its stored chunk files)."""
    for d, _, names in os.walk(out):
        if '.zarray' not in names:
            continue
        with open(os.path.join(d, '.zarray')) as f:
            meta = json.load(f)
        sizes = [os.path.getsize(os.path.join(dd, n))
                 for dd, _, fs in os.walk(d) for n in fs
                 if not n.startswith('.')]
        yield d, meta, sizes


def test_off_returns_the_shared_null_context_and_records_nothing(traced):
    _, _, _, root = traced
    assert profiling.span('tile.load') is profiling.span('chunk.encode', 9)
    with profiling.span('tile.load') as s:
        assert s is None
    assert profiling.carry(len) is len
    pipe, _ = _stitch(root)
    assert pipe.timers.as_dict()['stream_fuse_save'] > 0
    assert profiling.drain() == []


def test_one_tile_load_per_tile(traced):
    pipe, spans, _, _ = traced
    jobs = pipe._build_jobs(0, 'A1')
    loads = _named(spans, 'tile.load')
    assert len(jobs) == 8 and len(loads) == len(jobs)
    assert all(s.nbytes == 96 * 96 * 2 for s in loads)
    assert {s.thread.rsplit('_', 1)[0] for s in loads} == {'tile-load'}
    builds = {s.id for s in _named(spans, 'batch.build')}
    assert builds and all(s.parent in builds for s in loads)


def test_one_tile_warp_per_tile_with_a_fraction(traced):
    pipe, spans, _, _ = traced
    fractional = [j for j in pipe._build_jobs(0, 'A1') if j.fy or j.fx]
    warps = _named(spans, 'tile.warp')
    assert fractional and len(warps) == len(fractional)
    loads = {s.id for s in _named(spans, 'tile.load')}
    assert all(s.parent in loads for s in warps)


def test_one_fit_solve_per_channel(traced):
    _, spans, _, _ = traced
    assert len(_named(spans, 'fit.solve')) == len(CHANNELS)
    assert len(_named(spans, 'fit.load')) == len(CHANNELS)
    fit = _named(spans, 'flatfield_fit')
    assert len(fit) == 1 and fit[0].thread.startswith('flatfield-fit')
    assert {s.parent for s in _named(spans, 'fit.solve')} == {fit[0].id}


def test_encoders_see_the_raw_bytes_of_every_stored_chunk(traced):
    _, spans, out, _ = traced
    raw = sum(len(sizes) * int(np.prod(meta['chunks']))
              * np.dtype(meta['dtype']).itemsize
              for _, meta, sizes in _chunk_files(out))
    encodes = _named(spans, 'chunk.encode')
    assert raw > 0 and sum(s.nbytes for s in encodes) == raw


def test_chunk_writes_are_the_bytes_on_disk(traced):
    _, spans, out, _ = traced
    on_disk = sum(sum(sizes) for _, _, sizes in _chunk_files(out))
    writes = _named(spans, 'chunk.write')
    assert len(writes) == len(_named(spans, 'chunk.encode'))
    assert on_disk > 0 and sum(s.nbytes for s in writes) == on_disk


def test_each_fold_of_a_band_is_a_span():
    """The band writers fold a band's levels while they write them: one
    ``band.fold`` a level past the first, of the level it folds, inside
    the span that consumes the levels."""
    from image_stitcher_tpu_torch.models.streaming import band_levels
    band = np.arange(64 * 48, dtype=np.uint16).reshape(64, 48)
    profiling.enable()
    try:
        with profiling.span('band.write'):
            levels = list(band_levels(band, 4, 'mean'))
    finally:
        profiling.disable()
    spans = profiling.drain()
    (write,) = _named(spans, 'band.write')
    folds = _named(spans, 'band.fold')
    assert [lv.shape for lv in levels] == [(64, 48), (32, 24), (16, 12),
                                           (8, 6)]
    assert [s.nbytes for s in folds] == [lv.nbytes for lv in levels[:-1]]
    assert all(s.parent == write.id and write.start <= s.start
               and s.end <= write.end for s in folds)


def test_every_parent_resolves(traced):
    _, spans, _, _ = traced
    ids = {s.id for s in spans}
    assert len(ids) == len(spans)
    assert all(s.parent == 0 or s.parent in ids for s in spans)
    # pool work hangs under the span that submitted it
    assert all(s.parent for s in _named(spans, 'chunk.encode'))
    for s in spans:
        assert s.start <= s.end and s.cpu_s >= 0 and s.tid > 0


def test_stage_timer_totals_are_the_sums_of_their_spans(traced):
    pipe, spans, _, _ = traced
    totals = pipe.timers.as_dict()
    assert {'scan', 'flatfield_fit', 'registration',
            'stream_fuse_save'} <= set(totals)
    for name, total in totals.items():
        stage = _named(spans, name)
        assert len(stage) == pipe.timers.counts[name]
        assert sum(s.end - s.start for s in stage) == pytest.approx(
            total, rel=1e-12, abs=1e-15)


def test_band_fuser_stats_are_the_sums_of_their_spans(traced):
    pipe, spans, _, _ = traced
    (stats,) = pipe.fuse_stats.values()
    for key, names in BAND_FUSER_STATS.items():
        parts = [s for s in spans if s.name in names]
        assert parts, key
        assert stats[key] == pytest.approx(
            sum(s.end - s.start for s in parts), rel=1e-12, abs=1e-15)


def test_host_fuser_stages_are_the_sums_of_their_spans(host_traced):
    """Each stage's wall and on-core seconds, kept in every run, are the
    sums of its ``band.<stage>`` spans over the band threads."""
    pipe, spans = host_traced
    (stats,) = pipe.fuse_stats.values()
    stages = ('gate', 'fill', 'decode', 'place', 'finalize', 'pyramid',
              'write', 'close')
    assert stats['bands'] > 0 and set(stats['cpu']) == set(stages)
    for key in stages:
        parts = _named(spans, 'band.' + key)
        assert parts, key
        assert stats[key] == pytest.approx(
            sum(s.end - s.start for s in parts), rel=1e-12, abs=1e-15)
        assert stats['cpu'][key] == pytest.approx(
            sum(s.cpu_s for s in parts), rel=1e-12, abs=1e-15)
    decodes = {s.id for s in _named(spans, 'band.decode')}
    warps = _named(spans, 'tile.warp')
    assert warps and all(s.parent in decodes for s in warps)


def test_drain_keeps_every_span_of_busy_threads():
    """Threads record while another drains: no span is lost or handed
    out twice."""
    threads, each = 24, 400
    got = []
    go = threading.Event()

    def work():
        go.wait(10)
        for _ in range(each):
            with profiling.span('tile.load'):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        profiling.enable()
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        go.set()
        while any(t.is_alive() for t in pool):
            got.extend(profiling.drain())
        for t in pool:
            t.join(10)
            assert not t.is_alive()
    finally:
        profiling.disable()
        sys.setswitchinterval(old)
    got.extend(profiling.drain())
    assert len(got) == threads * each
    assert len({s.id for s in got}) == len(got)
