"""The port stands alone: it loads and runs, the main path at default
options (blosc-lz4 chunks through its own C codec, read back by its own
reader), the maximum-quality path (global registration, subpixel
placement, feathering), the in-RAM path (whole canvases, the device
flatfield solver, the registration report and debug images), OME-TIFF
output in bands and in RAM from the host fuser (``io/tiffwriter.py``,
``io/ometiff.py``, ``ops/host_fuse.py`` and ``csrc/hostops.c``),
acquisitions stored as PNG and as LZW-compressed TIFF (its own
decoders), and a two-well, two-timepoint run stopped, resumed with both
merges and its plate reopened with ``open_stitched``, and zstd and zlib
chunks (bit-shuffled, zarr v3) written and read back, with jax, pandas,
tensorstore, numcodecs, blosc, zstandard, OpenCV, PIL, imageio and the JAX
package all unimportable, as on a CUDA host that has none of them. No C
source includes a compression library's header or links one."""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import cv2

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
    source in csrc/ includes zlib's or zstd's header, and the native
    builder links neither library."""
    import re
    include = re.compile(r'#\s*include\s*[<"](zlib|zstd)\.h[>"]')
    link = re.compile(r"(?<![\w-])-l(z|zstd)\b")
    texts = [p.read_text() for p in (PACKAGE / "csrc").iterdir()]
    texts.append((PACKAGE / "native" / "__init__.py").read_text())
    assert len(texts) > 5
    assert include.search('#include <zstd.h>') and link.search("'-lz'")
    for text in texts:
        assert not include.search(text) and not link.search(text)
