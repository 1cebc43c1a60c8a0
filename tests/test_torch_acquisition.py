"""The port's acquisition scan and OME-Zarr writer against the JAX
package's: same tiles, keys, order and positions (exact), and the same
zarr metadata and chunk bytes for raw chunks."""

import json
import os

import cv2
import numpy as np
import pandas as pd
import pytest

from fixtures import DEFAULT_ACQ_PARAMS, write_synthetic_acquisition
from torch_helpers import small_disk_probe  # noqa: F401
from image_stitcher_tpu.io.acquisition import scan_acquisition as jscan
from image_stitcher_tpu.io.omezarr import MultiscaleWriter as JWriter
from image_stitcher_tpu.io.zarr_store import open_zarr_array
from image_stitcher_tpu_torch.io.acquisition import scan_acquisition as tscan
from image_stitcher_tpu_torch.io.omezarr import MultiscaleWriter as TWriter
from image_stitcher_tpu_torch.io.zarr_store import read_array

FIELDS = ('input_folder', 'timepoints', 'acquisition_params', 'pixel_size_um',
          'pixel_binning', 'regions', 'channel_names', 'monochrome_channels',
          'monochrome_colors', 'num_t', 'num_z', 'num_c',
          'num_fovs_per_region', 'input_height', 'input_width', 'dtype',
          'rgb_channels')


def _assert_same_scan(folder):
    a, b = jscan(folder), tscan(folder)
    for name in FIELDS:
        assert getattr(b, name) == getattr(a, name), name
    assert list(b.tiles) == list(a.tiles)       # order drives ff sampling
    for key, rec in a.tiles.items():
        got = b.tiles[key]
        assert (got.filepath, got.channel, got.z_level, got.region,
                got.fov_idx, got.t) == (rec.filepath, rec.channel,
                                        rec.z_level, rec.region,
                                        rec.fov_idx, rec.t)
        # floats compared bit for bit: keys quantize positions to 0.1 um
        assert (got.x, got.y, got.z) == (rec.x, rec.y, rec.z)
    for rec in a.tiles.values():
        assert (b.find_tile(rec.t, rec.region, rec.x, rec.y, rec.channel,
                            rec.z_level).filepath == rec.filepath)
    return a, b


@pytest.mark.parametrize("layout", ["grid", "multi", "numeric_regions"])
def test_scan_matches_jax_mono(tmp_path, layout):
    kw = dict(grid_cols=3, grid_rows=2, tile_w=48, tile_h=40, overlap=8,
              seed=4)
    if layout == "multi":
        kw.update(regions=["A1", "B12"], timepoints=2, num_z=2,
                  channels=["Fluorescence 488 nm Ex",
                            "Fluorescence 638 nm Ex"])
    elif layout == "numeric_regions":
        kw.update(regions=["0", "7"])
    folder = str(tmp_path / layout)
    write_synthetic_acquisition(folder, **kw)
    a, _ = _assert_same_scan(folder)
    assert len(a.tiles) > 0


def test_scan_matches_jax_fractional_positions(tmp_path):
    """Positions that are not short decimals: the csv module's float()
    and pandas' parser must agree to the last bit."""
    folder = str(tmp_path / "frac")
    write_synthetic_acquisition(folder, grid_cols=3, grid_rows=3, tile_w=32,
                                tile_h=32, overlap=8, seed=6)
    csv_path = os.path.join(folder, "0", "coordinates.csv")
    df = pd.read_csv(csv_path)
    rng = np.random.default_rng(0)
    df["x (mm)"] = df["x (mm)"] + rng.random(len(df)) * 1e-3 + 12.3456789
    df["y (mm)"] = df["y (mm)"] * 1.000123 + 45.678901234
    df.to_csv(csv_path, index=False, float_format="%.12f")
    _assert_same_scan(folder)


def test_scan_matches_jax_rgb(tmp_path):
    folder = str(tmp_path / "rgb")
    os.makedirs(os.path.join(folder, "0"))
    with open(os.path.join(folder, "acquisition parameters.json"), "w") as f:
        json.dump(DEFAULT_ACQ_PARAMS, f)
    rng = np.random.default_rng(5)
    rows = []
    for fov in range(4):
        tile = rng.integers(0, 255, (40, 48, 3), dtype=np.uint8)
        assert cv2.imwrite(
            os.path.join(folder, "0", f"A1_{fov}_0_BF_LED_matrix_full.tiff"),
            tile, [int(cv2.IMWRITE_TIFF_COMPRESSION), 1])
        rows.append({"region": "A1", "fov": fov, "z_level": 0,
                     "x (mm)": (fov % 2) * 0.04, "y (mm)": (fov // 2) * 0.032,
                     "z (um)": 0.0})
    pd.DataFrame(rows).to_csv(os.path.join(folder, "0", "coordinates.csv"),
                              index=False)
    _, b = _assert_same_scan(folder)
    assert b.rgb_channels == ["BF LED matrix full"]
    assert b.num_c == 3


def test_zarr_metadata_and_chunks_match_jax(tmp_path):
    """Group and level metadata equal to the JAX writer's with raw chunks
    (compressor_cname=None), and every chunk file byte-identical after
    the same band writes."""
    base = (1, 2, 1, 150, 100)
    args = (3, np.uint16, (1, 1, 1, 64, 64), "A1_t0", 1.5, 0.75,
            ["Fluorescence 488 nm Ex", "Fluorescence 561 nm Ex"],
            [0x00FF00, 0xFFCF00])
    jw = JWriter(str(tmp_path / "jax.ome.zarr"), base, *args, cname=None,
                 clevel=0, shuffle=0)
    tw = TWriter(str(tmp_path / "port.ome.zarr"), base, *args)
    rng = np.random.default_rng(7)
    for c in range(2):
        for band0, rows in ((0, 64), (64, 64), (128, 22)):
            level = rng.integers(0, 65535, (rows, 100), dtype=np.uint16)
            for lv in range(3):
                if lv:
                    level = np.ascontiguousarray(level[::2, ::2][
                        :level.shape[0] // 2, :level.shape[1] // 2])
                b = band0 >> lv
                sel = (slice(0, 1), slice(c, c + 1), slice(0, 1),
                       slice(b, b + level.shape[0]), slice(0, level.shape[1]))
                for w in (jw, tw):
                    w.write_level(lv, level[None, None, None], sel=sel)
    jw.close()
    tw.close()
    jroot, troot = str(tmp_path / "jax.ome.zarr"), str(tmp_path / "port.ome.zarr")
    jfiles, tfiles = [], []
    for root, out in ((jroot, jfiles), (troot, tfiles)):
        for d, _, names in os.walk(root):
            out.extend(os.path.relpath(os.path.join(d, n), root)
                       for n in names)
    assert sorted(jfiles) == sorted(tfiles)
    for rel in jfiles:
        with open(os.path.join(jroot, rel), "rb") as f:
            jb = f.read()
        with open(os.path.join(troot, rel), "rb") as f:
            tb = f.read()
        if os.path.basename(rel).startswith("."):
            assert json.loads(tb) == json.loads(jb), rel
        else:
            assert tb == jb, rel
    for lv in range(3):
        want = np.asarray(open_zarr_array(os.path.join(jroot, str(lv)))
                          .read().result())
        np.testing.assert_array_equal(read_array(os.path.join(troot, str(lv))),
                                      want)
