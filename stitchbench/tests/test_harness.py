"""CPU tests of the benchmark's harness: discovery by name, the naming
rules, the generator, the byte counts, the metric readers, the reference
on a hand-built acquisition, and the import checks."""

import ast
import copy
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from stitchbench import acquisition, reference, registry, roofline, run

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def test_discovery_of_new_files(tmp_path):
    """A configuration, traffic mix, metric and cell added as files and
    entries alone are found by name."""
    root = tmp_path / 'checkout'
    shutil.copytree(HERE, root / 'stitchbench',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    bench = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
    sb = root / 'stitchbench'
    cfg = json.load(open(sb / 'configs' / 'squid_zstd1.json'))
    cfg['options']['compressor_cname'] = 'lz4'
    (sb / 'configs' / 'squid_lz4.json').write_text(json.dumps(cfg))
    mix = json.load(open(sb / 'traffic' / 'plate.json'))
    mix['regions'] = ['A1']
    (sb / 'traffic' / 'one_well.json').write_text(json.dumps(mix))
    (sb / 'metrics' / 'passes.count.py').write_text(
        "def read(record):\n    return float(len(record['passes']))\n")
    (sb / 'checks' / 'squid_lz4.one_well.json').write_text(
        json.dumps({'level_max_lsb': 3}))
    bench['configs'].append({'name': 'squid_lz4', 'source': 'x',
                             'file': 'stitchbench/configs/squid_lz4.json',
                             'reduced': [], 'why': 'lz4'})
    bench['workloads'].append({'name': 'squid_lz4.one_well',
                               'config': 'squid_lz4', 'traffic': 'one_well',
                               'chips': 1, 'why': 'one well'})
    bench['per_layer'].append({'name': 'passes.count', 'unit': 'passes',
                               'better': 'higher', 'source': 'host_clock',
                               'layer': 'harness', 'moves': 'setup_s',
                               'workloads': ['squid_lz4.one_well']})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    reg = registry.Registry(str(root), str(sb))
    w = reg.workload('squid_lz4.one_well')
    assert reg.config(w['config'])['options']['compressor_cname'] == 'lz4'
    assert reg.traffic(w['traffic'])['regions'] == ['A1']
    assert reg.limits(w['name']) == {'level_max_lsb': 3}
    names = [m['name'] for m in reg.per_layer(w['name'])]
    assert names == ['passes.count']
    assert reg.reader('passes.count')({'passes': [{}, {}]}) == 2.0
    # a metric with a list of cells is reported in those alone
    assert {m['name'] for m in reg.end_to_end(w['name'])} == {
        'host_peak_gib', 'setup_s'}
    assert 'device_peak_gib' in {
        m['name'] for m in reg.end_to_end('max_quality.region')}
    with pytest.raises(KeyError):
        reg.workload('squid_lz4.absent')


def test_benchmark_names_and_units():
    bench = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
    names = [m['name'] for m in bench['end_to_end'] + bench['per_layer']]
    names += [w['name'] for w in bench['workloads']]
    names += [c['name'] for c in bench['configs']]
    names += [w['traffic'] for w in bench['workloads']]
    names += [k for c in bench['configs'] for k in c['reduced']]
    for name in names:
        assert registry.check_name(name) == name
    assert len(set(names[:len(bench['end_to_end']) + len(bench['per_layer'])
                         ])) == len(bench['end_to_end']) + len(
        bench['per_layer'])
    for m in bench['end_to_end'] + bench['per_layer']:
        assert registry.check_unit(m['unit']) == m['unit']
        assert m['better'] in ('lower', 'higher')
    for bad in ('a b', 'a,b', 'a/b', '.x', '-x', 'x' * 65, 'µs', ''):
        with pytest.raises(ValueError):
            registry.check_name(bad)
    for bad in ('tokens per second', 'µs', 'x' * 17, ''):
        with pytest.raises(ValueError):
            registry.check_unit(bad)
    for unit in ('tiles/s', '%', 'GiB', 's'):
        registry.check_unit(unit)


def test_every_cell_has_its_files():
    reg = registry.Registry()
    for w in reg.bench['workloads']:
        assert reg.config(w['config'])['options']
        assert reg.traffic(w['traffic'])['grid'] >= 2
        limits = reg.limits(w['name'])
        want = {'field_rel_gap', 'level_max_lsb', 'level_off_ppm',
                'meta_faults'}
        if reg.config(w['config'])['options']['registration_scope'] \
                == 'global':
            want |= {'pair_corr_gap', 'position_gap_px'}
        assert set(limits) == want
        for m in reg.per_layer(w['name']):
            assert callable(reg.reader(m['name']))


TINY = {"regions": ["A1", "B1"], "grid": 2, "tile": 128, "overlap_px": 16,
        "jitter_px": 2, "subpixel": True,
        "channels": ["Fluorescence 405 nm Ex", "Fluorescence 561 nm Ex"],
        "content": {"bits": 12, "dark_offset": 100, "read_noise": 2.0,
                    "background": 60, "vignette": 0.35,
                    "sigma_px": [3.0, 7.0], "peak": [300, 2500],
                    "cover": [0.04, 0.36]}}


def _tiles(folder):
    tdir = os.path.join(folder, '0')
    return {n: open(os.path.join(tdir, n), 'rb').read()
            for n in sorted(os.listdir(tdir))}


def test_generator_is_seeded_and_keeps_the_work(tmp_path):
    a = acquisition.write_acquisition(str(tmp_path / 'a'), TINY, 2 ** 33 + 5)
    b = acquisition.write_acquisition(str(tmp_path / 'b'), TINY, 2 ** 33 + 5)
    c = acquisition.write_acquisition(str(tmp_path / 'c'), TINY, 7)
    ta, tb, tc = (_tiles(str(tmp_path / x)) for x in 'abc')
    assert ta == tb
    assert ta.keys() == tc.keys() and ta != tc
    assert len([n for n in ta if n.endswith('.tiff')]) == 2 * 4 * 2
    # every seed does the same work: the same nuclei in every region and
    # channel, the same coverages in another order
    assert a['nuclei'] == c['nuclei']
    assert len(set(a['nuclei'].values())) == 1
    for key in a['cover']:
        assert sorted(a['cover'][key]) == pytest.approx(
            sorted(c['cover'][key]))
        assert sorted(a['cover'][key]) == pytest.approx(
            sorted(a['cover'][('A1', TINY['channels'][0])]))
    assert any(list(a['cover'][k]) != list(c['cover'][k]) for k in a['cover'])
    assert a['bytes'] == c['bytes']
    # origins: the ideal grid moved by at most the jitter, fractions of
    # 0.3-0.7 px except the first tile on each axis
    for region, o in a['origins'].items():
        step = 128 - 16
        for k in range(4):
            r, col = divmod(k, 2)
            dy = o[k, 0] - (acquisition.MARGIN + r * step)
            dx = o[k, 1] - (acquisition.MARGIN + col * step)
            assert abs(dy) <= 3 and abs(dx) <= 3
        for axis in (0, 1):
            rel = o[:, axis] - o[:, axis].min()
            frac = rel - np.floor(rel)
            assert ((frac == 0) | ((frac > 0.29) & (frac < 0.71))).all()
            assert (frac == 0).sum() >= 1


@pytest.mark.parametrize('cover, bright_range', [(0.05, (0.01, 0.2)),
                                                  (0.3, (0.1, 0.7))])
def test_generator_content_statistics(tmp_path, cover, bright_range):
    traffic = copy.deepcopy(TINY)
    traffic.update(tile=256, overlap_px=26, regions=['A1'], jitter_px=0,
                   subpixel=False, grid=3)
    traffic['content']['cover'] = [cover, cover]
    acquisition.write_acquisition(str(tmp_path), traffic, 11)
    tiles = [reference.read_tile(os.path.join(tmp_path, '0', n))
             for n in sorted(os.listdir(tmp_path / '0'))
             if n.endswith('.tiff')]
    stack = np.stack(tiles).astype(np.float64)
    assert stack.min() >= 0 and stack.max() <= 4095
    # the dark offset under the background, read noise around it
    assert 100 < np.percentile(stack, 5) < 100 + 60
    # vignetting: the background's corners dimmer than its centre by
    # about 35 % (the median of 18 tiles finds the background)
    if cover < 0.1:
        bg = np.median(stack, axis=0)
        centre = bg[96:160, 96:160].mean() - 100
        corner = bg[:24, :24].mean() - 100
        assert 0.5 < corner / centre < 0.85
    # nuclei: bright pixels cover a share of the field
    bright = (stack > 100 + 60 * 1.5).mean()
    assert bright_range[0] < bright < bright_range[1]


def test_roofline_byte_counts():
    # two 4x4 tiles overlapping by 2 columns on one plane, one invalid
    info = [(0, 0, 0, 0), (0, 0, 0, 2), (1, 0, 0, 0)]
    crops = [(0, 0, 0, 0), (0, 0, 0, 0), (0, 0, 0, 0)]
    valid = [True, True, False]
    assert roofline.union_area([(0, 4, 0, 4), (0, 4, 2, 6)]) == 24
    assert roofline.union_area([(0, 2, 0, 2), (5, 6, 5, 7)]) == 6
    assert roofline.union_area([(0, 4, 0, 4), (1, 2, 1, 2)]) == 16
    # overwrite: 24 canvas px written (2 B) and 24 tile px read, one field
    assert roofline.overwrite_bytes(info, crops, valid, 4, 4, 2, True) == \
        2 * 2 * 24 + 4 * 4 * 4
    assert roofline.overwrite_bytes(info, crops, valid, 4, 4, 2, False) == 96
    # crops shrink the windows: 1 px off the right of the first tile
    assert roofline.overwrite_bytes(info, [(0, 0, 0, 1), (0, 0, 0, 0),
                                           (0, 0, 0, 0)], valid, 4, 4, 2,
                                    False) == 96
    # feather: acc + wsum read and written over the union (16 B), each
    # tile's window read once
    assert roofline.feather_bytes(info, crops, valid, 4, 4, 2, True) == \
        16 * 24 + 2 * 32 + 64
    assert roofline.finalize_bytes(3, (4, 10), (0, 5), 2) == 3 * 6 * 5 * 10
    assert roofline.peak_bytes_per_s('NVIDIA H100 80GB HBM3') == 3.35e12
    assert roofline.peak_bytes_per_s('cpu') is None


RECORD = {
    'window_s': 10.0,
    'tiles': 48,
    'passes': [
        {'seconds': 4.0, 'timers': {'flatfield_fit': 1.0, 'registration': 0.5,
                                    'fuse': 0.8, 'save': 2.0},
         'fuse_stats': {'A1_t0': {'batches': 3}}},
        {'seconds': 6.0, 'timers': {'flatfield_fit': 1.5,
                                    'registration': 0.25,
                                    'stream_fuse_save': 3.0},
         'fuse_stats': {'A1_t0': {'fuse': 2.0, 'readback_wait': 0.1,
                                  'write': 1.0, 'close': 0.2},
                        'B1_t0': {'fuse': 1.0, 'readback_wait': 0.1,
                                  'write': 0.5, 'close': 0.2}}}],
    'device': {'busy_s': 0.4, 'window_s': 10.0},
    'kernels': {'fuse_overwrite': {'bytes': 3.35e9, 'seconds': 0.002,
                                   'calls': 12},
                'fuse_feather': {'bytes': 1e9, 'seconds': None, 'calls': 4}},
    'peak_bytes_per_s': 3.35e12,
}


@pytest.mark.parametrize('name, want', [
    ('fit.share', 25.0), ('registration.share', 7.5),
    ('ram_fuse.share', 8.0), ('ram_save.share', 20.0),
    ('band_fuse.share', 30.0), ('band_write.share', 15.0),
    ('fuse_overwrite_roofline', 50.0), ('fuse_feather_roofline', None),
    ('finalize_feather_roofline', None), ('device.idle', 96.0),
    ('tiles_per_s.window', 4.8)])
def test_metric_arithmetic(name, want):
    got = registry.Registry().reader(name)(RECORD)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)


def test_metric_readers_find_nothing_to_read():
    empty = {'window_s': 5.0, 'passes': [{'seconds': 5.0, 'timers': {},
                                          'fuse_stats': {}}],
             'device': {'busy_s': None, 'window_s': 5.0}, 'kernels': {},
             'peak_bytes_per_s': None}
    reg = registry.Registry()
    for m in reg.bench['per_layer']:
        assert reg.reader(m['name'])(empty) is None


def _hand_built(folder, gt, tile, step):
    """A 2x2 acquisition cut from ``gt`` at ``step`` px, 1 um a pixel."""
    os.makedirs(os.path.join(folder, '0'))
    with open(os.path.join(folder, 'acquisition parameters.json'), 'w') as f:
        json.dump(acquisition.ACQ_PARAMS, f)
    header = acquisition.tiff_header(tile, tile)
    rows = ["region,fov,z_level,x (mm),y (mm),z (um)"]
    for r in range(2):
        for c in range(2):
            fov = r * 2 + c
            body = np.ascontiguousarray(
                gt[r * step:r * step + tile, c * step:c * step + tile])
            with open(os.path.join(folder, '0',
                                   acquisition.tile_name('A1', fov, 'BF')),
                      'wb') as f:
                f.write(header + body.tobytes())
            rows.append(f"A1,{fov},0,{c * step / 1000},{r * step / 1000},0")
    with open(os.path.join(folder, '0', 'coordinates.csv'), 'w') as f:
        f.write("\n".join(rows) + "\n")


def test_reference_on_a_hand_built_acquisition(tmp_path):
    """Tiles cut from one image at a known step: the centre shifts are the
    step, and the canvas is the image back. (The grid model's height
    counts each vertical step as frame - v_shift, as Squid's stitcher
    does: 64 + 80 rows, the last 32 never written.)"""
    tile, step = 64, 48
    gt = np.random.default_rng(3).integers(200, 4000, (112, 112)).astype(
        np.uint16)
    _hand_built(str(tmp_path), gt, tile, step)
    config = registry.Registry().config('squid_zstd1')
    config = copy.deepcopy(config)
    config['stitch']['apply_flatfield'] = False
    out = reference.run(str(tmp_path), config)
    assert out['registration'] == {'h_shift': [0, -16], 'v_shift': [-16, 0]}
    levels = out['regions']['A1']['levels']
    assert len(levels) == 1
    assert levels[0].shape == (1, 144, 112)
    assert np.array_equal(levels[0][0, :112].numpy(), gt.astype(np.int32))
    assert not levels[0][0, 112:].any()
    meta = out['regions']['A1']['meta']
    assert meta['arrays'][0]['shape'] == [1, 1, 1, 144, 112]
    assert meta['arrays'][0]['chunks'] == [1, 1, 1, 144, 112]
    assert meta['arrays'][0]['compressor']['cname'] == 'zstd'
    assert meta['datasets'][0]['coordinateTransformations'][0]['scale'] == \
        [1, 1, 1.5, 1.0, 1.0]


def test_reference_flatfield_and_feather_pieces():
    # a flat stack fits a flat field
    stack = np.full((6, 96, 96), 500.0) + np.random.default_rng(1).normal(
        0, 1, (6, 96, 96))
    field = reference.basic_fit(stack)
    assert field.mean() == pytest.approx(1.0)
    assert np.abs(field - 1).max() < 0.01
    # area weights of each output cell sum to 1
    m = reference.area_matrix(205, 96)
    assert np.allclose(m.sum(axis=1), 1.0, atol=2e-3)
    # a 0.5 px shift averages neighbours; borders replicate
    img = torch.tensor([[0, 10, 20, 30]], dtype=torch.int32)
    out = reference.shift_subpixel(img, 0.0, 0.5, torch.float64)
    assert out.tolist() == [[0, 5, 15, 25]]
    ramp = reference.feather_ramp(4, 6, 2, 'cpu')
    assert ramp[0].tolist() == [0.5, 0.5, 0.5, 0.5, 0.5, 0.5]
    assert ramp[1].tolist() == [0.5, 1, 1, 1, 1, 0.5]


def test_phase_correlation_finds_a_subpixel_shift():
    moved, base = _fourier_moved((2.3, -1.7))
    shift, peak = reference.phase_correlation(moved, base, 10)
    assert shift.tolist() == pytest.approx([2.3, -1.7])
    assert 0 < peak <= 1.0 + 1e-9


def _fourier_moved(shift, n=64, seed=0):
    base = np.random.default_rng(seed).normal(size=(n, n))
    fy = np.fft.fftfreq(n)[:, None]
    fx = np.fft.fftfreq(n)[None, :]
    moved = np.real(np.fft.ifft2(np.fft.fft2(base) * np.exp(
        -2j * np.pi * (fy * shift[0] + fx * shift[1]))))
    return moved, base


def test_a_pairs_answer_is_judged_by_its_correlation_gap():
    """The reference's own answer lies no way below its best; a 0.1 px
    neighbour a little; an answer a pixel off far more; the control's
    bfloat16 correlation lands on the same shift here, its peak near."""
    moved, base = _fourier_moved((2.3, -1.7))
    pc = reference.PairCorrelation(moved, base, 10)
    assert pc.value_at(pc.shift) == pytest.approx(pc.best, rel=1e-12)
    assert pc.gap(pc.shift) == pytest.approx(0.0, abs=1e-12)
    near = pc.gap(pc.shift + np.array([0.1, 0.0]))
    far = pc.gap(pc.shift + np.array([1.0, 0.0]))
    assert 0 < near < far
    low = reference.PairCorrelation(moved, base, 10, 'bfloat16')
    assert low.shift.tolist() == pytest.approx([2.3, -1.7])
    assert low.peak == pytest.approx(pc.peak, rel=0.05)


def test_global_registration_takes_and_judges_the_programs_answers(
        tmp_path):
    """Tiles cut from one image: the reference's own answers solve the
    step; the program's answers, one moved by 0.1 px, are taken and that
    pair reads a gap, and a pair left unanswered reads 1."""
    tile, step = 64, 48
    gt = np.random.default_rng(5).integers(200, 4000, (112, 112)).astype(
        np.uint16)
    _hand_built(str(tmp_path), gt, tile, step)
    acq = reference.scan(str(tmp_path))
    opts = dict(registry.Registry().config('max_quality')['options'],
                registration_margin=0.0)
    own = reference.global_registration(acq, 'A1', opts)
    want = np.array([[0, 0], [0, step], [step, 0], [step, step]], float)
    assert np.abs(own['positions'] - want).max() < 1e-6
    assert own['gaps'] == []
    answers = dict(own['own'])
    key = ((0, 0), (0, 1))
    answers[key] = (answers[key][0] + 0.1, answers[key][1])
    got = reference.global_registration(acq, 'A1', opts, answers)
    assert got['answers'] == answers
    gaps = dict(zip(own['own'], got['gaps']))
    assert gaps[key] > 0
    assert all(abs(g) < 1e-12 for k, g in gaps.items() if k != key)
    assert np.abs(got['positions'] - want).max() > 0.01
    del answers[key]
    assert max(reference.global_registration(acq, 'A1', opts,
                                             answers)['gaps']) == 1.0


def test_import_check(monkeypatch):
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, 'image_stitcher_tpu_torch_x', sys)
    monkeypatch.setitem(sys.modules, 'jaxfoo', sys)
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, 'image_stitcher_tpu.ops', sys)
    assert run.banned_modules() == ['image_stitcher_tpu']
    monkeypatch.setitem(sys.modules, 'jax', sys)
    assert run.banned_modules() == ['image_stitcher_tpu', 'jax']


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split('.')[0]


def test_sources_import_no_jax_and_the_yardstick_none_of_the_port():
    for dirpath, _, files in os.walk(HERE):
        for name in files:
            if not name.endswith('.py'):
                continue
            mods = set(_imports(os.path.join(dirpath, name)))
            assert not mods & {'jax', 'jaxlib', 'flax', 'image_stitcher_tpu',
                               'bench', 'chip_smoke', 'kernel_times'}, name
    # the yardstick: generator, reference, comparison, decoder, bytes
    for name in ('acquisition.py', 'reference.py', 'check.py', 'unblosc.py',
                 'roofline.py', 'registry.py'):
        mods = set(_imports(os.path.join(HERE, name)))
        assert 'image_stitcher_tpu_torch' not in mods, name
