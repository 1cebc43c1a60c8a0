"""RGB (brightfield) acquisitions through the port, the twin of the JAX
package's ``tests/test_rgb_e2e.py``: the same PNG RGB tiles stitched by
both packages on the port's in-RAM and band paths. The scan expands the
channel into three planes (R, G, B) with the same names and OMERO
colours; the port's fitted flatfields (one per plane) are within the
device-solver tolerance of ``test_torch_flatfield.py`` (1e-4) of the JAX
package's; with the JAX run's fields carried in, the trees are equal."""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from fixtures import DEFAULT_ACQ_PARAMS
from torch_helpers import assert_outputs_equal, small_disk_probe  # noqa: F401
from image_stitcher_tpu import EngineOptions as JaxOptions
from image_stitcher_tpu import stitch as jax_stitch
import image_stitcher_tpu_torch as port

CPU = torch.device('cpu')
CHANNEL = "BF LED matrix full"
PLANES = [f"{CHANNEL}_R", f"{CHANNEL}_G", f"{CHANNEL}_B"]


def write_rgb_acquisition(folder, grid=3, tile=64, overlap=16):
    """Brightfield RGB tiles as PNG (as ``tests/test_rgb_e2e.py`` writes
    them), with a vignette so the flatfield fit has something to find."""
    os.makedirs(os.path.join(folder, "0"), exist_ok=True)
    with open(os.path.join(folder, "acquisition parameters.json"), "w") as f:
        json.dump(DEFAULT_ACQ_PARAMS, f)
    rng = np.random.default_rng(5)
    step = tile - overlap
    size = step * (grid - 1) + tile
    gt = rng.integers(40, 215, (size, size, 3)).astype(np.float32)
    yy, xx = np.mgrid[:tile, :tile] / (tile - 1) - 0.5
    vignette = (1 - 0.6 * (yy ** 2 + xx ** 2))[..., None]
    lines = ["region,fov,z_level,x (mm),y (mm),z (um)"]
    for r in range(grid):
        for c in range(grid):
            fov = r * grid + c
            y0, x0 = r * step, c * step
            t = np.clip(gt[y0:y0 + tile, x0:x0 + tile] * vignette, 0, 255)
            assert cv2.imwrite(os.path.join(
                folder, "0", f"A1_{fov}_0_BF_LED_matrix_full.png"),
                t.astype(np.uint8)[:, :, ::-1])     # cv2 writes BGR
            lines.append(f"A1,{fov},0,{x0 / 1000.0},{y0 / 1000.0},0.0")
    with open(os.path.join(folder, "0", "coordinates.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return folder


@pytest.mark.parametrize("streaming", ['off', 'on'], ids=['inram', 'band'])
def test_rgb_stitch_matches_jax(tmp_path, streaming):
    acq = write_rgb_acquisition(str(tmp_path / "acq"))
    opts = dict(streaming=streaming, chunks=(1, 1, 1, 32, 32))
    jpipe = jax_stitch(acq, apply_flatfield=True, options=JaxOptions(
        fusion_device='device', output_folder=str(tmp_path / "jax"), **opts))
    # the port's own fit: one field per plane, near the JAX package's
    own = port.stitch(acq, apply_flatfield=True, device=CPU,
                      options=port.EngineOptions(
                          output_folder=str(tmp_path / "own"), **opts))
    assert own.acq.monochrome_channels == PLANES
    assert own.acq.rgb_channels == [CHANNEL]
    assert own.acq.monochrome_colors == jpipe.acq.monochrome_colors
    assert sorted(own.flatfields) == sorted(jpipe.flatfields) == [0, 1, 2]
    for c in range(3):
        np.testing.assert_allclose(own.flatfields[c], jpipe.flatfields[c],
                                   rtol=0, atol=1e-4)
    # with the JAX run's fields: the same tree, colours included
    pipe = port.stitch(acq, apply_flatfield=True, device=CPU,
                       state=port.state_from_reference(
                           flatfields=jpipe.flatfields),
                       options=port.EngineOptions(
                           output_folder=str(tmp_path / "port"), **opts))
    assert ('stream_fuse_save' in pipe.timers.as_dict()) == (streaming == 'on')
    assert_outputs_equal(str(tmp_path / "jax"), str(tmp_path / "port"))
    with open(tmp_path / "port" / "0_stitched" / "A1_stitched.ome.zarr"
              / ".zattrs") as f:
        omero = json.load(f)["omero"]["channels"]
    assert [c["label"] for c in omero] == PLANES
    assert [c["color"] for c in omero] == ["FF0000", "00FF00", "0000FF"]
