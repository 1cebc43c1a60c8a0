"""The port's tools (``image_stitcher_tpu_torch/tools/``) against the JAX
package's, on the CPU.

- ``update_coordinates`` and ``convert_to_coordinate_acquisition`` run
  on copies of the same folders (mtimes set with ``os.utime``) write
  byte-equal ``coordinates.csv`` files (pandas' typing reproduced by
  ``utils/csvtable.py``: int, float with blanks, text, bool columns) and
  the same renamed files, and refuse what the JAX tools refuse, with the
  same messages.
- ``utils/csvtable`` reads and writes seeded tables as pandas does.
- ``ashlar_export`` writes the JAX tool's per-tile OME-TIFFs, byte-equal
  once the ``uuid4`` IDs of the OME-XML are masked, and the same ASHLAR
  command.
- ``doctor`` prints its five sections on this host, says there is no
  card, and exits 0 as the JAX doctor does.
- ``save_bench`` and ``config_bench`` at a tiny size give rows with the
  JAX tools' JSON keys; ``config_bench``'s acquisition has the JAX
  fixture's layout and ``coordinates.csv`` bytes.
"""

import json
import os
import re
import shutil

import numpy as np
import pandas as pd
import pytest

from fixtures import write_synthetic_acquisition
from torch_helpers import small_disk_probe, tree_files  # noqa: F401
from image_stitcher_tpu.tools import ashlar_export as jax_ashlar
from image_stitcher_tpu.tools import config_bench as jax_config_bench
from image_stitcher_tpu.tools import convert_to_coordinate_acquisition as \
    jax_convert
from image_stitcher_tpu.tools import save_bench as jax_save_bench
from image_stitcher_tpu.tools import update_coordinates as jax_update
from image_stitcher_tpu_torch.tools import (ashlar_export, config_bench,
                                            convert_to_coordinate_acquisition,
                                            doctor, save_bench,
                                            update_coordinates)
from image_stitcher_tpu_torch.utils import csvtable

convert = convert_to_coordinate_acquisition


def _files(root):
    out = {}
    for rel in tree_files(root):
        with open(os.path.join(root, rel), 'rb') as f:
            out[rel] = f.read()
    return out


def _tiff(path, value=0):
    from image_stitcher_tpu_torch.io.fast_tiff import write_tiff_fast
    write_tiff_fast(path, np.full((8, 8), value, np.uint16))


# ------------------------------------------------------------ csvtable

@pytest.mark.parametrize("seed", range(3))
def test_csvtable_reads_and_writes_as_pandas(tmp_path, seed):
    rng = np.random.default_rng(seed)
    n = 7
    cols = {
        'ints': [str(int(v)) for v in rng.integers(-50, 50, n)],
        'ints_blank': [str(int(v)) if rng.random() > 0.3 else ''
                       for v in rng.integers(0, 9, n)],
        'floats': [repr(float(v)) for v in rng.normal(0, 1e3, n)],
        'sci': [f"{v:.3e}" for v in rng.random(n) * 1e-6],
        'text': [f"A{int(v)}" if rng.random() > 0.2 else 'NA'
                 for v in rng.integers(0, 9, n)],
        'quoted': ['a,b', 'c"d', 'e', 'f g', 'h', 'i', 'j'],
        'bools': ['True' if v else 'False' for v in rng.random(n) > 0.5],
        'empty': [''] * n,
        'mixed': ['1', '2.5', 'x', '', '3', '4', '5'],
    }
    path = str(tmp_path / 'in.csv')
    import csv
    with open(path, 'w', newline='') as f:
        w = csv.writer(f, lineterminator='\n')
        w.writerow(list(cols))
        for i in range(n):
            w.writerow([cols[k][i] for k in cols])
    df = pd.read_csv(path)
    table = csvtable.read_csv(path)
    assert list(table) == list(df.columns)
    df.to_csv(str(tmp_path / 'pandas.csv'), index=False)
    csvtable.write_csv(str(tmp_path / 'port.csv'), table)
    assert open(str(tmp_path / 'port.csv'), 'rb').read() \
        == open(str(tmp_path / 'pandas.csv'), 'rb').read()


# -------------------------------------------------- update_coordinates

def _old_format_folder(root, variant):
    """Two timepoint folders in the old format: images named
    ``{region}_{fov}_{z}_{channel...}`` (fov and region as the tool
    derives them), a coordinates.csv without region/fov, mtimes set out
    of name order."""
    rng = np.random.default_rng(5)
    for t in range(2):
        d = os.path.join(root, str(t))
        os.makedirs(d)
        names = [f"R{r}_{fov}_{z}_Fluorescence_488_nm_Ex.tiff"
                 for r in (1, 2) for fov in range(3) for z in range(2)]
        order = rng.permutation(len(names))
        for rank, i in enumerate(order):
            path = os.path.join(d, names[i])
            _tiff(path, rank)
            os.utime(path, (1e9 + rank, 1e9 + rank))
        n = len(names)
        rows = {'z_level': [str(i % 2) for i in range(n)],
                'x (mm)': [repr(float(v)) for v in rng.normal(10, 3, n)],
                'y (mm)': [repr(float(v)) for v in rng.normal(20, 3, n)],
                'z (um)': [f"{v:.1f}" for v in rng.normal(5, 1, n)]}
        if variant == 'time_text':
            rows['time'] = [f"2024-01-0{t + 1} 10:00:{i:02d}.5"
                            for i in range(n)]
        elif variant == 'time_float_blank':
            rows['time'] = [repr(1.7e9 + i * 0.25) if i % 4 else ''
                            for i in range(n)]
            rows['z (um)'][2] = ''
        rows['extra'] = ['ignored'] * n
        with open(os.path.join(d, 'coordinates.csv'), 'w') as f:
            f.write(','.join(rows) + '\n')
            for i in range(n):
                f.write(','.join(rows[k][i] for k in rows) + '\n')


def _twin_copies(tmp_path, build, *args):
    src = str(tmp_path / 'src')
    build(src, *args)
    dirs = {}
    for name in ('jax', 'port'):
        dirs[name] = str(tmp_path / name / 'acq')
        shutil.copytree(src, dirs[name])
        for rel in tree_files(src):    # the mtimes the order rests on
            st = os.stat(os.path.join(src, rel))
            os.utime(os.path.join(dirs[name], rel),
                     ns=(st.st_atime_ns, st.st_mtime_ns))
    return dirs


@pytest.mark.parametrize("variant", ['plain', 'time_text',
                                     'time_float_blank'])
def test_update_coordinates_equals_jax(tmp_path, variant, capsys):
    dirs = _twin_copies(tmp_path, _old_format_folder, variant)
    assert jax_update.main([dirs['jax']]) == 0
    assert update_coordinates.main([dirs['port']]) == 0
    got, want = _files(dirs['port']), _files(dirs['jax'])
    assert got == want
    header = want[os.path.join('0', 'coordinates.csv')].split(b'\n')[0]
    assert header.startswith(b'region,fov,z_level,x (mm)')
    assert (b'time' in header) == (variant != 'plain')


def test_update_coordinates_refusals_equal_jax(tmp_path, capsys):
    dirs = _twin_copies(tmp_path, _old_format_folder, 'plain')
    for name in dirs:    # one image too many: the counts disagree
        _tiff(os.path.join(dirs[name], '0',
                           'R9_0_0_Fluorescence_488_nm_Ex.tiff'))
    errors = {}
    for name, mod in (('jax', jax_update), ('port', update_coordinates)):
        with pytest.raises(ValueError) as err:
            mod.process_folder(os.path.join(dirs[name], '0'))
        errors[name] = str(err.value).replace(dirs[name], '<acq>')
    assert errors['port'] == errors['jax'] and 'counts' in errors['port']
    assert _files(dirs['port']) == _files(dirs['jax'])
    missing = str(tmp_path / 'nope')
    assert update_coordinates.main([missing]) == jax_update.main([missing]) \
        == 1
    assert update_coordinates.get_image_info('A_B_3_0_ch.tiff') \
        == jax_update.get_image_info('A_B_3_0_ch.tiff')
    with pytest.raises(ValueError):
        update_coordinates.get_image_info('A_B_ch.tiff')


# ------------------------------------------ convert_to_coordinate_acquisition

def _grid_acquisition(root, blank_row=False):
    """Numbered timepoints of an (i, j) grid acquisition: 2x3 at t0, a
    truncated 2x2 at t1, two z levels, two channels."""
    os.makedirs(root)
    for t, cols in ((0, 3), (1, 2)):
        d = os.path.join(root, str(t))
        os.makedirs(d)
        lines = ['i,j,z_level,x (mm),y (mm),z (um)']
        for i in range(2):
            for j in range(cols):
                for k in range(2):
                    lines.append(f"{i},{j},{k},{j * 0.9},{i * 0.9 + 0.05},"
                                 f"{k * 1.5}")
                    for ch in ('Fluorescence_488_nm_Ex', 'BF_LED'):
                        _tiff(os.path.join(d, f"B3_{i}_{j}_{k}_{ch}.tiff"),
                              i * 10 + j)
        if blank_row and t == 1:
            lines.append(',,,,,')
        with open(os.path.join(d, 'coordinates.csv'), 'w') as f:
            f.write('\n'.join(lines) + '\n')


@pytest.mark.parametrize("region", [None, 'C7'], ids=['files', 'given'])
def test_convert_equals_jax(tmp_path, region, capsys):
    dirs = _twin_copies(tmp_path, _grid_acquisition)
    argv = [] if region is None else ['--region', region]
    assert jax_convert.main([dirs['jax']] + argv) == 0
    assert convert.main([dirs['port']] + argv) == 0
    for suffix in ('', '_old'):
        got, want = _files(dirs['port'] + suffix), _files(dirs['jax'] + suffix)
        assert got == want
    names = sorted(os.listdir(os.path.join(dirs['port'], '1')))
    assert f"{region or 'B3'}_4_1_BF_LED.tiff" in names
    # a second run refuses (the backup exists), as the JAX tool does
    out = {}
    for name, mod in (('jax', jax_convert), ('port', convert)):
        capsys.readouterr()
        assert mod.main([dirs[name]]) == 1
        out[name] = capsys.readouterr().out.replace(dirs[name], '<acq>')
    assert out['port'] == out['jax'] and 'already converted' in out['port']


@pytest.mark.parametrize("case", ['backup_exists', 'no_subdirs', 'no_csv',
                                  'blank_row'])
def test_convert_refusals_equal_jax(tmp_path, case, capsys):
    dirs = _twin_copies(tmp_path, _grid_acquisition, case == 'blank_row')
    for d in dirs.values():
        if case == 'backup_exists':
            os.makedirs(d + '_old')
        elif case == 'no_subdirs':
            for t in ('0', '1'):
                shutil.rmtree(os.path.join(d, t))
        elif case == 'no_csv':
            os.unlink(os.path.join(d, '1', 'coordinates.csv'))
    out = {}
    for name, mod in (('jax', jax_convert), ('port', convert)):
        capsys.readouterr()
        assert mod.main([dirs[name]]) == 1
        out[name] = capsys.readouterr().out.replace(dirs[name], '<acq>')
    assert out['port'] == out['jax'] and out['port'].count('Error:') == 1
    for suffix in ('', '_old'):
        assert _files(dirs['port'] + suffix) == _files(dirs['jax'] + suffix)


# ------------------------------------------------------------ ashlar_export

UUID = re.compile(rb'[0-9a-f]{8}-[0-9a-f]{4}-4[0-9a-f]{3}-[89ab][0-9a-f]{3}-'
                  rb'[0-9a-f]{12}')


def test_ashlar_export_equals_jax_with_uuids_masked(tmp_path, capsys):
    acq = str(tmp_path / 'acq')
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=2, tile_w=64,
                                tile_h=48, overlap=12, seed=4,
                                channels=["Fluorescence 488 nm Ex",
                                          "Fluorescence 561 nm Ex"],
                                acq_params_overrides={"pixel_binning": 2})
    files, cmds = {}, {}
    for name, mod in (('jax', jax_ashlar), ('port', ashlar_export)):
        conv = mod.AshlarConverter(acq)
        out = conv.run(str(tmp_path / name))
        files[name] = {rel: UUID.sub(b'<uuid>', data)
                       for rel, data in _files(out).items()}
        inputs = sorted(os.path.join(out, f) for f in os.listdir(out))
        cmds[name] = [c.replace(out, '<out>') for c in
                      mod.build_ashlar_command(conv, inputs, 'o.ome.tif',
                                               align_channel=
                                               'Fluorescence 561 nm Ex')]
        raw = _files(out)
        assert len(UUID.findall(next(iter(raw.values())))) >= 6
    assert len(files['port']) == 8 and files['port'] == files['jax']
    assert cmds['port'] == cmds['jax']
    assert '--align-channel' in cmds['port']
    # uuid4 is never seeded: two exports differ in their IDs only
    again = ashlar_export.AshlarConverter(acq).run(str(tmp_path / 'again'))
    first = _files(str(tmp_path / 'port'))
    second = _files(again)
    assert first != second
    assert {k: UUID.sub(b'<uuid>', v) for k, v in second.items()} \
        == files['port']


def test_ashlar_main_without_the_binary_prints_the_command(tmp_path, capsys,
                                                           monkeypatch):
    acq = str(tmp_path / 'acq')
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=1, tile_w=32,
                                tile_h=32, overlap=8, seed=2)
    monkeypatch.setattr(shutil, 'which', lambda name: None)
    assert ashlar_export.main([acq, '-o', str(tmp_path / 'o.ome.tif')]) == 0
    out = capsys.readouterr().out
    assert 'ashlar binary not found' in out and '--tile-size 32' in out


# ------------------------------------------------------------------ doctor

def test_doctor_sections_on_this_host(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(doctor, 'DISK_MB', 8)
    assert doctor.main(['--output-dir', str(tmp_path)]) == 0
    out = capsys.readouterr().out
    titles = re.findall(r'^\[(\w+)\]$', out, re.M)
    assert titles == ['Device', 'Placement', 'Native', 'Disk', 'Caches']
    assert all(line.startswith(('[', '  ')) for line in out.splitlines())
    assert 'torch.cuda: NOT AVAILABLE' in out and '--device cpu' in out
    assert 'kernels: not built (no card)' in out
    assert re.search(r'host placement rate .*: [0-9.]+ GB/s', out)
    assert "'auto' fuses on the card" in out
    for lib in doctor.HOST_SYMBOLS:
        assert re.search(rf'^  {lib}: OK \(', out, re.M), lib
    assert 'ccitt_decode' in out and 'bmp_rle_decode' in out
    assert re.search(r'^  lzma: OK \(', out, re.M)
    assert 'MISSING' not in out
    assert re.search(r'disk write .*: \d+ MB/s \(8 MB', out)
    assert 'direct-IO probe:' in out
    assert re.search(r'built libraries: \d+ under ', out)
    assert doctor.main(['--skip-device', '--output-dir', str(tmp_path)]) \
        == 0
    assert 'device checks: skipped' in capsys.readouterr().out


# ------------------------------------------------------------ the benches

def test_save_bench_rows_have_the_jax_keys(capsys):
    rows = save_bench.measure(96, 1, 2, [64], list(save_bench.WRITERS))
    want = jax_save_bench.measure(96, 1, 1, [64], ['zlib_chunks'])
    assert [r['writer'] for r in rows] == list(save_bench.WRITERS)
    assert {tuple(sorted(r)) for r in rows} == {tuple(sorted(want[0]))}
    assert all(r['files'] >= 1 and r['mb'] >= 0 and r['size'] == 96
               for r in rows)
    assert save_bench.main(['--sizes', '64', '--z', '1', '--channels', '1',
                            '--chunks', '64', '--writers', 'v2_raw',
                            '--json']) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed[0]['writer'] == 'v2_raw'


def test_config_bench_rows_have_the_jax_keys(tmp_path, monkeypatch):
    """Both benches at a tiny size (the JAX tool's fixture shrunk the
    same way) give rows with the same keys."""
    real = jax_config_bench._fixtures()

    def tiny(folder, **kw):
        kw.update(tile_w=64, tile_h=64, overlap=kw['overlap'] * 64 // 1024)
        kw['num_z'] = min(kw.get('num_z', 1), 2)
        if kw.get('regions'):
            kw['regions'] = kw['regions'][:3]
        return real(folder, **kw)

    monkeypatch.setattr(jax_config_bench, '_fixtures', lambda: tiny)
    for name, port_fn, jax_fn, kw in (
            ('z20', config_bench.bench_z20, jax_config_bench.bench_z20,
             dict(tile=64, num_z=2)),
            ('hcs96', config_bench.bench_hcs96, jax_config_bench.bench_hcs96,
             dict(tile=64, wells=3))):
        got = port_fn(str(tmp_path / f'p{name}'), 1, device='cpu', **kw)
        want = jax_fn(str(tmp_path / f'j{name}'), 1)
        assert sorted(got) == sorted(want), name
        assert got['seconds'] > 0 and 'fuse' in got['stages']
    assert 'merge' in got['stages']


def test_config_bench_acquisition_has_the_fixture_layout(tmp_path):
    """Same file names, parameters and coordinates.csv bytes as the JAX
    fixture for the same grid, tile, overlap, z, jitter and seed; the
    tiles are uncompressed TIFFs that OpenCV reads."""
    import cv2
    kw = dict(grid_cols=3, grid_rows=2, tile_w=64, tile_h=48, overlap=10,
              num_z=2, jitter=2, seed=5, regions=['A1', 'B2'], timepoints=2)
    config_bench.write_acquisition(str(tmp_path / 'port'), **kw)
    write_synthetic_acquisition(str(tmp_path / 'jax'), **kw)
    got, want = tree_files(str(tmp_path / 'port')), \
        tree_files(str(tmp_path / 'jax'))
    assert got == want
    for rel in want:
        if rel.endswith(('.csv', '.json')):
            assert open(os.path.join(str(tmp_path / 'port'), rel),
                        'rb').read() == \
                open(os.path.join(str(tmp_path / 'jax'), rel), 'rb').read()
    tile = cv2.imread(os.path.join(str(tmp_path / 'port'), want[0])
                      if want[0].endswith('.tiff') else
                      os.path.join(str(tmp_path / 'port'), want[-1]),
                      cv2.IMREAD_UNCHANGED)
    assert tile.shape == (48, 64) and tile.dtype == np.uint16 and tile.std()


def test_scan_reads_coordinates_as_pandas(tmp_path):
    """Stage coordinates with 17 significant digits (what pandas'
    ``to_csv`` writes for a computed float) read to the JAX scan's
    doubles: pandas' parser rounds some of them off the nearest double
    ('0.30000000000000004' -> 0.3)."""
    from image_stitcher_tpu.io.acquisition import scan_acquisition as jscan
    from image_stitcher_tpu_torch.io.acquisition import scan_acquisition
    acq = str(tmp_path / 'acq')
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=2, tile_w=32,
                                tile_h=32, overlap=8, seed=1)
    path = os.path.join(acq, '0', 'coordinates.csv')
    xs = ['0.30000000000000004', '0.9500000000000001', '12.345678901234567',
          '1e-05']
    ys = ['0.0', '0.30000000000000004', '7.000000000000001', '2.5']
    lines = open(path).read().splitlines()
    head = lines[0].split(',')
    xi, yi = head.index('x (mm)'), head.index('y (mm)')
    for n, line in enumerate(lines[1:]):
        cells = line.split(',')
        cells[xi], cells[yi] = xs[n], ys[n]
        lines[n + 1] = ','.join(cells)
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    got, want = scan_acquisition(acq), jscan(acq)
    assert sorted(got.tiles) == sorted(want.tiles)
    for key, rec in want.tiles.items():
        assert (repr(got.tiles[key].x), repr(got.tiles[key].y)) \
            == (repr(float(rec.x)), repr(float(rec.y)))
    assert repr(got.tiles[sorted(got.tiles)[0]].x) == '0.3'
