"""The port stands alone: it loads and runs, the main path, the
maximum-quality path (global registration, subpixel placement,
feathering) and the in-RAM path (whole canvases, the device flatfield
solver, the registration report and debug images), with jax, pandas,
tensorstore, OpenCV, imageio and the JAX package all unimportable, as on
a CUDA host that has none of them."""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

from fixtures import write_synthetic_acquisition

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = REPO / "image_stitcher_tpu_torch"
BLOCKED = ("jax", "jaxlib", "pandas", "tensorstore", "cv2", "imageio",
           "image_stitcher_tpu")

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
    level0 = read_array({out!r} + '/0_stitched/A1_stitched.ome.zarr/0')
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
""")


def test_port_runs_without_jax_pandas_tensorstore_cv2(tmp_path):
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=2, tile_w=64,
                                tile_h=64, overlap=16, seed=2,
                                acq_params_overrides={"pixel_binning": 2})
    code = CHILD.format(blocked=BLOCKED, repo=str(REPO), acq=acq,
                        out=str(tmp_path / "out"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ISOLATED-OK (0, -16) (-16, 0)" in proc.stdout
    assert "QUALITY-OK 4" in proc.stdout
    assert "INRAM-OK (0, -16) (-16, 0)" in proc.stdout


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
