"""The port stands alone: it loads and runs, the main path at default
options (blosc-lz4 chunks through its own C codec, read back by its own
reader), the maximum-quality path (global registration, subpixel
placement, feathering), the in-RAM path (whole canvases, the device
flatfield solver, the registration report and debug images), OME-TIFF
output in bands and in RAM from the host fuser (``io/tiffwriter.py``,
``io/ometiff.py``, ``ops/host_fuse.py`` and ``csrc/hostops.c``),
acquisitions stored as PNG and as LZW-compressed TIFF (its own
decoders), and a two-well, two-timepoint run stopped, resumed with both
merges and its plate reopened with ``open_stitched``, zstd and zlib
chunks (bit-shuffled, zarr v3) written and read back, and JPEG tiles read
and JPEG OME-TIFF tiles written (its own codec), with jax, pandas,
tensorstore, numcodecs, blosc, zstandard, OpenCV, PIL, imageio and the JAX
package all unimportable, as on a CUDA host that has none of them. The
editions, their CLIs, the GUI and the tools import and run with PyQt5 and
napari unimportable too, in every process they start (a
``sitecustomize`` installs the refusal): the thread and process
editions, the GUI through its stand-ins, ``process_cli``, ``zarr_cli``
and the doctor as subprocesses, the coordinate tools, the ASHLAR export
and both benches; the parallel modules, a mesh run and a two-process
gloo group. No C source includes a compression library's header
(zlib, zstd, libjpeg) or links one."""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import cv2
import numpy as np

from fixtures import write_synthetic_acquisition

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = REPO / "image_stitcher_tpu_torch"
BLOCKED = ("jax", "jaxlib", "pandas", "tensorstore", "numcodecs", "blosc",
           "zstandard", "cv2", "PIL", "imageio", "image_stitcher_tpu")

CHILD = textwrap.dedent("""
    import importlib.abc, sys
    BLOCKED = {blocked!r}

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split('.')[0] in BLOCKED:
                raise ImportError(f"{{name}} is not available here")
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, {repo!r})
    import torch
    import image_stitcher_tpu_torch as port
    from image_stitcher_tpu_torch.io.zarr_store import read_array
    pipe = port.stitch({acq!r}, use_registration=True, apply_flatfield=True,
                       device=torch.device('cpu'),
                       options=port.EngineOptions(chunks=(1, 1, 1, 32, 32),
                                                  output_folder={out!r}))
    import json
    level0 = {out!r} + '/0_stitched/A1_stitched.ome.zarr/0'
    with open(level0 + '/.zarray') as f:
        compressor = json.load(f)['compressor']
    assert compressor['id'] == 'blosc' and compressor['cname'] == 'lz4', \
        compressor
    level0 = read_array(level0)
    assert level0.shape[:3] == (1, 1, 1) and level0.any(), level0.shape
    loaded = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
    assert not loaded, loaded
    print('ISOLATED-OK', pipe.shifts.h_shift, pipe.shifts.v_shift)
    # the maximum-quality path: all pairs through the batched phase
    # correlation, the global solve, the subpixel warp and feathering
    pipe = port.stitch({acq!r}, use_registration=True, apply_flatfield=True,
                       device=torch.device('cpu'),
                       options=port.EngineOptions(
                           chunks=(1, 1, 1, 32, 32),
                           output_folder={out!r} + '_quality',
                           registration_scope='global',
                           subpixel_placement=True, blend_method='feather',
                           registration_device_threshold=1))
    level0 = read_array({out!r} + '_quality/0_stitched/A1_stitched.ome.zarr/0')
    assert level0.shape[:3] == (1, 1, 1) and level0.any(), level0.shape
    assert pipe.device_pairs > 0 and pipe.global_positions_float['A1']
    assert any(j.fy or j.fx for j in pipe._build_jobs(0, 'A1'))
    loaded = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
    assert not loaded, loaded
    print('QUALITY-OK', len(pipe.global_positions['A1']))
    # the in-RAM path: whole canvases, the pyramid built from them, the
    # device flatfield solver, the report and the debug PNGs
    import json, os
    out = {out!r} + '_inram'
    pipe = port.stitch({acq!r}, use_registration=True, apply_flatfield=True,
                       device=torch.device('cpu'),
                       options=port.EngineOptions(
                           chunks=(1, 1, 1, 32, 32), output_folder=out,
                           streaming='off', flatfield_device='device',
                           registration_report=True, debug_visuals=True))
    level0 = read_array(out + '/0_stitched/A1_stitched.ome.zarr/0')
    assert level0.shape[:3] == (1, 1, 1) and level0.any(), level0.shape
    assert 'fuse' in pipe.timers.as_dict(), pipe.timers.as_dict()
    with open(out + '/registration_report.json') as f:
        assert json.load(f)['regions']['A1']['scope'] == 'center'
    pngs = sorted(n for n in os.listdir(out) if n.endswith('.png'))
    assert pngs == ['horizontal.png', 'vertical.png'], pngs
    loaded = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
    assert not loaded, loaded
    print('INRAM-OK', pipe.shifts.h_shift, pipe.shifts.v_shift)
    # OME-TIFF output in bands and in RAM, fused by the host fuser
    # (csrc/hostops.c) with the gated fit, read back by io/tiff.py
    from image_stitcher_tpu_torch.io.tiff import read_pages
    for streaming in ('on', 'off'):
        out = {out!r} + '_tiff_' + streaming
        pipe = port.stitch({acq!r}, output_format='.ome.tiff',
                           use_registration=True, apply_flatfield=True,
                           device=torch.device('cpu'),
                           options=port.EngineOptions(
                               streaming=streaming, fusion_device='host',
                               output_folder=out))
        with open(out + '/0_stitched/A1_stitched.ome.tiff', 'rb') as f:
            pages = read_pages(f.read())
        assert pages[0][1][0].shape == (144, 112), pages[0][1][0].shape
        assert pages[0][1][0].any() and 'OME' in pages[0][0]
    used = [m for m in ('io.tiffwriter', 'io.ometiff', 'ops.host_fuse')
            if 'image_stitcher_tpu_torch.' + m in sys.modules]
    assert len(used) == 3, used
    loaded = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
    assert not loaded, loaded
    print('TIFF-HOST-OK', len(pages))
    # tiles stored as PNG and as LZW + predictor TIFF, decoded in C
    for fmt, folder in (('png', {acq!r} + '_png'), ('lzw', {acq!r} + '_lzw')):
        pipe = port.stitch(folder, use_registration=True,
                           device=torch.device('cpu'),
                           options=port.EngineOptions(
                               chunks=(1, 1, 1, 32, 32),
                               output_folder={out!r} + '_' + fmt))
        level0 = read_array({out!r} + '_' + fmt
                            + '/0_stitched/A1_stitched.ome.zarr/0')
        assert level0.shape[:3] == (1, 1, 1) and level0.any(), level0.shape
        loaded = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
        assert not loaded, loaded
        print('INPUT-OK', fmt, pipe.shifts.h_shift, pipe.shifts.v_shift)
    # two wells, two timepoints: a run stopped after its first unit, then
    # resumed with both merges, the complete plate opened and read
    import threading
    stop = threading.Event()
    rep = port.ProgressReporter(status=lambda m, s=False: stop.set()
                                if m.startswith('Completed region') else None)
    out = {out!r} + '_plate'
    kw = dict(use_registration=True, apply_flatfield=True,
              merge_timepoints=True, merge_hcs_regions=True,
              device=torch.device('cpu'))
    opts = dict(chunks=(1, 1, 1, 32, 32), output_folder=out,
                pipelined_save=False)
    try:
        port.stitch({acq!r} + '_plate', reporter=rep, stop_event=stop,
                    options=port.EngineOptions(**opts), **kw)
        raise AssertionError('the run was not stopped')
    except port.StitchCancelled:
        pass
    pipe = port.stitch({acq!r} + '_plate', resume=True,
                       options=port.EngineOptions(**opts), **kw)
    assert pipe.resumed and 'flatfield_fit' not in pipe.timers.as_dict()
    listing = port.list_outputs(out)
    assert len(listing['regions']) == 4, listing
    img = port.open_stitched(listing['hcs'][0] + '/B/2/0')
    plate = img.read(0)
    assert plate.shape[:3] == (2, 1, 1) and plate.any(), plate.shape
    assert (img.level(0)[1, 0, 0, 3:9, 5:11] == plate[1, 0, 0, 3:9, 5:11]).all()
    loaded = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
    assert not loaded, loaded
    print('MERGE-OK', img.num_levels, plate.shape)
    # the other blosc codecs: zstd-1 (the reference's production setting)
    # and zlib with bit shuffle, v2 and v3, written and read back
    for cname, shuffle, fmt in (('zstd', 1, 2), ('zlib', 2, 3)):
        out = {out!r} + '_' + cname
        port.stitch({acq!r}, use_registration=True,
                    device=torch.device('cpu'),
                    options=port.EngineOptions(
                        chunks=(1, 1, 1, 32, 32), output_folder=out,
                        compressor_cname=cname, compressor_clevel=1,
                        compressor_shuffle=shuffle, zarr_format=fmt))
        level0 = read_array(out + '/0_stitched/A1_stitched.ome.zarr/0')
        assert level0.shape[:3] == (1, 1, 1) and level0.any(), level0.shape
    loaded = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
    assert not loaded, loaded
    print('CODECS-OK')
    # JPEG tiles (OpenCV's .jpg) read through the port's C codec, written
    # as JPEG OME-TIFF tiles and read back
    out = {out!r} + '_jpeg'
    port.stitch({acq!r} + '_jpg', output_format='.ome.tiff',
                use_registration=True, device=torch.device('cpu'),
                options=port.EngineOptions(output_folder=out,
                                           tiff_compression='jpeg'))
    with open(out + '/0_stitched/A1_stitched.ome.tiff', 'rb') as f:
        pages = read_pages(f.read())
    assert pages[0][1][0].shape == (144, 112), pages[0][1][0].shape
    assert pages[0][1][0].any()
    assert 'image_stitcher_tpu_torch.io.jpeg' in sys.modules
    loaded = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
    assert not loaded, loaded
    print('JPEG-OK', len(pages))
""")


def test_port_runs_without_jax_pandas_tensorstore_cv2(tmp_path):
    acq = str(tmp_path / "acq")
    kw = dict(grid_cols=2, grid_rows=2, tile_w=64, tile_h=64, overlap=16,
              seed=2, acq_params_overrides={"pixel_binning": 2})
    write_synthetic_acquisition(acq, **kw)
    write_synthetic_acquisition(acq + '_png', ext='png', **kw)
    write_synthetic_acquisition(acq + '_lzw', **kw)
    write_synthetic_acquisition(acq + '_plate', regions=['A1', 'B2'],
                                timepoints=2, **kw)
    write_synthetic_acquisition(acq + '_jpg', ext='jpg', dtype=np.uint8,
                                **kw)
    tdir = os.path.join(acq + '_lzw', '0')
    for name in os.listdir(tdir):      # OpenCV's default: LZW, Predictor 2
        if name.endswith('.tiff'):
            path = os.path.join(tdir, name)
            assert cv2.imwrite(path, cv2.imread(path, cv2.IMREAD_UNCHANGED))
    code = CHILD.format(blocked=BLOCKED, repo=str(REPO), acq=acq,
                        out=str(tmp_path / "out"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ISOLATED-OK (0, -16) (-16, 0)" in proc.stdout
    assert "QUALITY-OK 4" in proc.stdout
    assert "INRAM-OK (0, -16) (-16, 0)" in proc.stdout
    assert "TIFF-HOST-OK 2" in proc.stdout
    assert "INPUT-OK png (0, -16) (-16, 0)" in proc.stdout
    assert "INPUT-OK lzw (0, -16) (-16, 0)" in proc.stdout
    assert "MERGE-OK 1 (2, 1, 1, 144, 112)" in proc.stdout
    assert "CODECS-OK" in proc.stdout
    assert "JPEG-OK 2" in proc.stdout


def test_package_sources_import_none_of_the_blocked_modules():
    for path in PACKAGE.rglob("*.py"):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in BLOCKED, (path, name)


def test_no_compression_library_is_included_or_linked():
    """The codecs are the repo's own C and the stdlib's zlib module: no
    source in csrc/ includes zlib's, zstd's or libjpeg's header, and the
    native builder links none of those libraries."""
    import re
    include = re.compile(r'#\s*include\s*[<"](zlib|zstd|jpeglib|turbojpeg)'
                         r'\.h[>"]')
    link = re.compile(r"(?<![\w-])-l(z|zstd|jpeg|turbojpeg)\b")
    texts = [p.read_text() for p in (PACKAGE / "csrc").iterdir()]
    texts.append((PACKAGE / "native" / "__init__.py").read_text())
    assert len(texts) > 5
    assert include.search('#include <zstd.h>') and link.search("'-lz'")
    assert include.search('#include <jpeglib.h>') and link.search("-ljpeg")
    for text in texts:
        assert not include.search(text) and not link.search(text)


#: the front ends' optional modules, absent on the card's host too
FRONT_BLOCKED = BLOCKED + ("PyQt5", "napari")

SITECUSTOMIZE = textwrap.dedent("""
    import importlib.abc, sys
    BLOCKED = {blocked!r}

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split('.')[0] in BLOCKED:
                raise ImportError(f"{{name}} is not available here")
            return None

    sys.meta_path.insert(0, Refuse())
""")

FRONT_CHILD = textwrap.dedent("""
    import os, queue, sys, time
    sys.path.insert(0, {repo!r})
    BLOCKED = {blocked!r}
    import image_stitcher_tpu_torch as port
    from image_stitcher_tpu_torch import gui, process_cli, qt_compat, zarr_cli
    from image_stitcher_tpu_torch.models import editions
    from image_stitcher_tpu_torch.tools import (
        ashlar_export, config_bench, convert_to_coordinate_acquisition,
        doctor, save_bench, update_coordinates)
    from image_stitcher_tpu_torch.utils import csvtable
    assert not qt_compat.HAVE_QT
    acq = {acq!r}
    params = port.StitchingParameters(input_folder=acq, use_registration=True)
    thread = editions.StitcherThread(
        params, port.EngineOptions(output_folder=acq + '_thread'),
        device='cpu')
    thread.start(); thread.join(120)
    assert thread.error is None and os.path.isdir(thread.result_path)
    proc = editions.StitcherProcess(
        params, options=port.EngineOptions(output_folder=acq + '_proc'),
        device='cpu')
    proc.start(); proc.join(120)
    assert proc.exitcode == 0, proc.exitcode
    kind, (path, dtype) = proc.complete_queue.get(timeout=10)
    assert kind == 'complete' and os.path.isdir(path), path
    window = gui.StitchingGUI(device='cpu')
    window.input_folder = acq
    window.start_stitching()
    t0 = time.time()
    while window.stitcher.is_alive() and time.time() - t0 < 120:
        window.poll_queues(); time.sleep(0.05)
    window.poll_queues()
    assert 'Complete' in window.status_label.text(), window.status_label.text()
    assert gui.main() == 1
    print('EDITIONS-OK')
    # the tools: coordinates rewritten, a grid acquisition converted, an
    # ASHLAR export, both benches at a tiny size
    old = acq + '_old_format/0'
    os.makedirs(old)
    from image_stitcher_tpu_torch.io.fast_tiff import write_tiff_fast
    import numpy as np
    for k in range(2):
        write_tiff_fast(os.path.join(old, f'R_{{k}}_0_ch.tiff'),
                        np.zeros((4, 4), np.uint16))
    with open(os.path.join(old, 'coordinates.csv'), 'w') as f:
        f.write('x (mm),y (mm)\\n1.5,2\\n3.25,4\\n')
    update_coordinates.process_folder(old)
    assert open(os.path.join(old, 'coordinates.csv')).read().startswith(
        'region,fov,x (mm),y (mm)')
    grid = acq + '_grid'
    os.makedirs(grid + '/0')
    write_tiff_fast(grid + '/0/B3_0_1_0_ch.tiff', np.ones((4, 4), np.uint16))
    with open(grid + '/0/coordinates.csv', 'w') as f:
        f.write('i,j,z_level,x (mm),y (mm),z (um)\\n0,1,0,0.9,0,0\\n')
    assert convert_to_coordinate_acquisition.convert(grid) == 1
    assert os.listdir(grid + '/0') != [] and os.path.isdir(grid + '_old')
    out = ashlar_export.AshlarConverter(acq).run(acq + '_ashlar')
    assert len(os.listdir(out)) == 4
    rows = save_bench.measure(64, 1, 1, [64], list(save_bench.WRITERS))
    assert len(rows) == len(save_bench.WRITERS), rows
    z20 = config_bench.bench_z20(acq + '_bench', 1, tile=64, num_z=2,
                                 device='cpu')
    assert z20['seconds'] > 0
    loaded = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
    assert not loaded, loaded
    print('TOOLS-OK', len(rows))
""")


def _seed_probe_cache(home, folder):
    """A fresh disk-probe entry for ``folder``'s device in ``home``, so no
    process of the test writes the probe's files."""
    import json
    import time
    cache = os.path.join(home, '.cache', 'image_stitcher_tpu_torch')
    os.makedirs(cache, exist_ok=True)
    key = f"dev{os.stat(folder).st_dev}-cpu{os.cpu_count()}"
    with open(os.path.join(cache, 'directio.json'), 'w') as f:
        json.dump({key: {"ts": time.time(), "buffered_mbps": 500.0,
                         "direct_mbps": 100.0}}, f)


def test_front_ends_and_tools_run_without_pyqt5_napari_jax(tmp_path):
    acq = str(tmp_path / "acq")
    kw = dict(grid_cols=2, grid_rows=2, tile_w=64, tile_h=64, overlap=16,
              seed=2, acq_params_overrides={"pixel_binning": 2})
    write_synthetic_acquisition(acq, **kw)
    write_synthetic_acquisition(acq + '_cli', **kw)
    write_synthetic_acquisition(acq + '_zcli', **kw)
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        SITECUSTOMIZE.format(blocked=FRONT_BLOCKED))
    home = str(tmp_path / "home")
    _seed_probe_cache(home, str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=f"{site}{os.pathsep}{REPO}", HOME=home,
               TMPDIR=str(tmp_path))
    code = FRONT_CHILD.format(blocked=FRONT_BLOCKED, repo=str(REPO), acq=acq)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "EDITIONS-OK" in proc.stdout
    assert "TOOLS-OK 10" in proc.stdout
    for module, argv, want in (
            ("process_cli", ["-i", acq + '_cli', "-r", "--device", "cpu"],
             "Complete:"),
            ("zarr_cli", ["-i", acq + '_zcli', "--device", "cpu"],
             "Complete:"),
            ("tools.doctor", ["--output-dir", str(tmp_path)],
             "[Device]")):
        run = subprocess.run(
            [sys.executable, "-m", f"image_stitcher_tpu_torch.{module}",
             *argv], capture_output=True, text=True, timeout=300, env=env,
            cwd=str(tmp_path))
        assert run.returncode == 0, (module, run.stderr[-3000:])
        assert want in run.stdout, (module, run.stdout[-2000:])
        if module == "tools.doctor":
            assert "torch.cuda: NOT AVAILABLE" in run.stdout
            assert run.stdout.index("[Caches]") > run.stdout.index("[Disk]")
    assert [d for d in os.listdir(tmp_path) if d.startswith('acq_cli_stitched_')]


PARALLEL_CHILD = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    BLOCKED = {blocked!r}
    import torch
    import image_stitcher_tpu_torch as port
    from image_stitcher_tpu_torch.io.zarr_store import read_array
    from image_stitcher_tpu_torch.parallel import (distributed, mesh,
                                                   sharded_fuse, sharded_ops)
    cpu = torch.device('cpu')
    pipe = port.stitch({acq!r}, use_registration=True, device=[cpu] * 4,
                       options=port.EngineOptions(
                           mesh_shape=(2, 2), chunks=(1, 1, 1, 32, 32),
                           output_folder={out!r}))
    level0 = read_array({out!r} + '/0_stitched/A1_stitched.ome.zarr/0')
    assert level0.shape[:3] == (1, 1, 1) and level0.any(), level0.shape
    assert len(pipe.fuse_stats['A1_t0']['bands']) == 2
    shifts = sharded_ops.sharded_phase_cross_correlation(
        mesh.make_mesh((2, 1), [cpu] * 2), torch.rand(4, 16, 16),
        torch.rand(4, 16, 16))
    assert shifts.shape == (4, 2)
    # two processes in one gloo group: a sum over them, a ShardedCanvas
    # over the pod mesh gathered and held to the plain fuse_overwrite
    distributed.run_localhost_validation(num_processes=2,
                                         devices_per_process=2, timeout=120,
                                         platform='cpu')
    loaded = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)
    assert not loaded, loaded
    print('PARALLEL-OK', tuple(level0.shape))
""")


def test_parallel_runs_without_jax(tmp_path):
    """The parallel modules, a mesh run and a two-process gloo run, with
    jax and the JAX package unimportable in every process (the workers
    inherit the ``sitecustomize`` refusal)."""
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=2, tile_w=64,
                                tile_h=64, overlap=16, seed=2,
                                acq_params_overrides={"pixel_binning": 2})
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        SITECUSTOMIZE.format(blocked=BLOCKED))
    home = str(tmp_path / "home")
    _seed_probe_cache(home, str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=f"{site}{os.pathsep}{REPO}", HOME=home,
               TMPDIR=str(tmp_path))
    code = PARALLEL_CHILD.format(repo=str(REPO), blocked=BLOCKED, acq=acq,
                                 out=str(tmp_path / "out"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    assert "PARALLEL-OK (1, 1, 1, 144, 112)" in proc.stdout
