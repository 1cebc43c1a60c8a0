"""The port's output access (``api.py``) and inspection helpers
(``utils/inspect.py``) against the JAX package's, on the same trees:
JAX-written and port-written runs with both merges, zarr v2 (NGFF 0.4)
and v3 (NGFF 0.5)."""

import json
import os
import pathlib
import shutil

import cv2
import numpy as np
import pytest
import torch

from fixtures import write_synthetic_acquisition
from torch_helpers import small_disk_probe  # noqa: F401
import image_stitcher_tpu as jax_pkg
from image_stitcher_tpu.utils import inspect as jax_inspect
import image_stitcher_tpu_torch as port
from image_stitcher_tpu_torch.utils import inspect

CPU = torch.device('cpu')
CHANNELS = ["Fluorescence 405 nm Ex", "Fluorescence 488 nm Ex"]


@pytest.fixture(scope="module", params=[2, 3], ids=['v2', 'v3'])
def runs(request, tmp_path_factory):
    """{'jax': output folder, 'port': output folder} of one acquisition
    stitched with both merges by each package."""
    fmt = request.param
    root = tmp_path_factory.mktemp(f"api_v{fmt}")
    outs = {}
    for name, pkg in (('jax', jax_pkg), ('port', port)):
        acq = str(root / f'acq_{name}')
        write_synthetic_acquisition(acq, grid_cols=2, grid_rows=2, tile_w=64,
                                    tile_h=64, overlap=16, channels=CHANNELS,
                                    regions=['A1', 'B2'], timepoints=2,
                                    seed=3)
        kw = dict(device=CPU) if pkg is port else {}
        outs[name] = str(root / f'{name}_out')
        pkg.stitch(acq, use_registration=True, merge_timepoints=True,
                   merge_hcs_regions=True, **kw,
                   options=pkg.EngineOptions(
                       output_folder=outs[name], zarr_format=fmt,
                       chunks=(1, 1, 1, 32, 32)))
    return outs


def _rel(listing, out):
    return {k: [os.path.relpath(p, out) for p in v]
            for k, v in listing.items()}


def test_list_outputs_equals_the_jax_listing(runs):
    want = _rel(jax_pkg.list_outputs(runs['jax']), runs['jax'])
    for out in runs.values():   # the port's listing of either tree
        assert _rel(port.list_outputs(out), out) == want
    assert want['hcs'] == ['hcs_timepoints/complete_hcs.ome.zarr']
    assert len(want['regions']) == 4
    assert port.list_outputs(runs['port'] + '_missing') == {
        'regions': [], 'time_series': [], 'hcs': []}


IMAGES = ['0_stitched/A1_stitched.ome.zarr', '1_stitched/B2_stitched.ome.zarr',
          'hcs_timepoints/complete_hcs.ome.zarr/A/1/0',
          'hcs_timepoints/complete_hcs.ome.zarr/B/2/0']


@pytest.mark.parametrize("image", IMAGES)
def test_open_stitched_equals_the_jax_handle(runs, image):
    for out in runs.values():
        path = os.path.join(out, image)
        want = jax_pkg.open_stitched(path)
        got = port.open_stitched(path)
        assert got.attrs == want.attrs
        assert got.num_levels == want.num_levels
        assert got.channel_names == want.channel_names == CHANNELS
        assert got.pixel_size_um == want.pixel_size_um
        for n in range(want.num_levels):
            full = want.read(n)
            np.testing.assert_array_equal(got.read(n), full)
            lv = got.level(n)
            assert lv.shape == full.shape and lv.dtype == full.dtype
            win = (slice(None), 1, 0, slice(5, 40), slice(17, 50))
            np.testing.assert_array_equal(
                lv[win], np.asarray(want.level(n)[win].read().result()))


def test_inspect_tree_and_format_equal_the_jax_functions(runs):
    for out in runs.values():
        for rel in ('0_stitched/A1_stitched.ome.zarr',
                    'hcs_timepoints/complete_hcs.ome.zarr'):
            path = os.path.join(out, rel)
            assert inspect.zarr_tree(path) == jax_inspect.zarr_tree(path)
            assert (inspect.format_zarr_tree(path)
                    == jax_inspect.format_zarr_tree(path))


def test_compare_stores_equals_the_jax_report(runs, tmp_path):
    rel = 'hcs_timepoints/complete_hcs.ome.zarr'
    a, b = (os.path.join(runs[k], rel) for k in ('jax', 'port'))
    want = jax_inspect.compare_stores(a, b, band_rows=16)
    assert inspect.compare_stores(a, b, band_rows=16) == want
    assert want['equal'] and len(want['arrays']) == 2
    # another region (a shape mismatch), and a copy with two level-0
    # chunk (v2) or shard (v3) files swapped (a content mismatch)
    a = os.path.join(runs['port'], '0_stitched', 'A1_stitched.ome.zarr')
    b = os.path.join(runs['port'], rel, 'A', '1', '0')
    c = str(tmp_path / 'swapped.ome.zarr')
    shutil.copytree(a, c)
    level0 = os.path.join(c, '0')
    files = sorted(os.path.join(d, n) for d, _, names in os.walk(level0)
                   for n in names if n[0].isdigit())
    first, second = (pathlib.Path(f).read_bytes() for f in files[:2])
    for f, body in zip(files[:2], (second, first)):
        pathlib.Path(f).write_bytes(body)
    for other in (b, c):
        want = jax_inspect.compare_stores(a, other, band_rows=16)
        got = inspect.compare_stores(a, other, band_rows=16)
        assert got == want and not got['equal']
    assert got['arrays']['0']['mismatched'] > 0


def test_inspect_main(runs, capsys):
    path = os.path.join(runs['port'], '0_stitched', 'A1_stitched.ome.zarr')
    assert inspect.main([path]) == 0
    text = capsys.readouterr().out
    assert text.strip() == inspect.format_zarr_tree(path)
    assert inspect.main([path, '--json']) == 0
    assert json.loads(capsys.readouterr().out) == inspect.zarr_tree(path)
    other = os.path.join(runs['jax'], '0_stitched', 'A1_stitched.ome.zarr')
    assert inspect.main([path, '--compare', other]) == 0
    assert 'stores identical' in capsys.readouterr().out


@pytest.mark.parametrize("shape", [(3, 1, 40, 56), (2, 2, 33, 17),
                                   (2, 4, 1, 24, 40)],
                         ids=['3ch', '2ch', '5d'])
def test_save_debug_slice_pixels_equal_the_jax_png(tmp_path, shape):
    rng = np.random.default_rng(len(shape))
    canvas = rng.integers(0, 60000, shape, dtype=np.uint16)
    got = inspect.save_debug_slice(canvas, str(tmp_path / 'port.png'))
    want = jax_inspect.save_debug_slice(canvas, str(tmp_path / 'jax.png'))
    assert got and want
    np.testing.assert_array_equal(cv2.imread(got, cv2.IMREAD_UNCHANGED),
                                  cv2.imread(want, cv2.IMREAD_UNCHANGED))
