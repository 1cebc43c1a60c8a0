"""The port's CLI flags for the options the in-RAM slice runs, each with
the JAX CLI's choices and default, driven end to end on the CPU."""

import json
import os

import pytest

from fixtures import write_synthetic_acquisition
from image_stitcher_tpu.cli import create_options as jax_create_options
from image_stitcher_tpu.cli import parse_args as jax_parse_args
from image_stitcher_tpu_torch.cli import create_options, main, parse_args
from image_stitcher_tpu_torch.io.zarr_store import read_array


def _acquisition(tmp_path, regions=("A1",)):
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=2, tile_w=64,
                                tile_h=64, overlap=16, seed=3,
                                regions=list(regions),
                                acq_params_overrides={"pixel_binning": 2})
    return acq


def _output(tmp_path):
    outs = [d for d in os.listdir(tmp_path) if d.startswith('acq_stitched_')]
    assert len(outs) == 1
    return tmp_path / outs[0]


@pytest.mark.parametrize("flags", [
    [], ['--flatfield-device', 'device'], ['--streaming', 'off'],
    ['--streaming', 'on'], ['--registration-report'],
    ['--continue-on-error']], ids=lambda f: ' '.join(f) or 'defaults')
def test_flags_match_the_jax_cli(flags):
    got = create_options(parse_args(['-i', 'x'] + flags))
    want = jax_create_options(jax_parse_args(['-i', 'x'] + flags))
    for name in ('flatfield_device', 'streaming', 'registration_report',
                 'continue_on_error'):
        assert getattr(got, name) == getattr(want, name), name


def test_flatfield_device_flag(tmp_path):
    acq = _acquisition(tmp_path)
    assert main(['-i', acq, '-ff', '--flatfield-device', 'device',
                 '--chunk-size', '64', '--device', 'cpu']) == 0
    level0 = read_array(str(_output(tmp_path) / '0_stitched'
                            / 'A1_stitched.ome.zarr' / '0'))
    assert level0.shape[:3] == (1, 1, 1) and level0.any()


@pytest.mark.parametrize("mode", ["off", "on"])
def test_streaming_flag(tmp_path, mode):
    acq = _acquisition(tmp_path)
    assert main(['-i', acq, '-r', '--streaming', mode, '--chunk-size', '64',
                 '--device', 'cpu']) == 0
    level0 = read_array(str(_output(tmp_path) / '0_stitched'
                            / 'A1_stitched.ome.zarr' / '0'))
    assert level0.shape == (1, 1, 1, 144, 112)


def test_registration_report_flag(tmp_path):
    acq = _acquisition(tmp_path)
    assert main(['-i', acq, '-r', '--registration-scope', 'all-pairs',
                 '--registration-report', '--chunk-size', '64',
                 '--device', 'cpu']) == 0
    with open(_output(tmp_path) / "registration_report.json") as f:
        rep = json.load(f)
    assert rep["regions"]["A1"]["scope"] == "all-pairs"
    assert len(rep["regions"]["A1"]["pairs"]) == 4


@pytest.mark.parametrize("keep_going", [False, True])
def test_continue_on_error_flag(tmp_path, keep_going):
    """A well whose tile cannot be read fails the run, or with the flag is
    reported and skipped while the other well is written."""
    acq = _acquisition(tmp_path, regions=("A1", "B2"))
    bad = sorted(f for f in os.listdir(os.path.join(acq, '0'))
                 if f.startswith('B2_'))[0]
    with open(os.path.join(acq, '0', bad), 'wb') as f:
        f.write(b'not an image')
    flags = ['--continue-on-error'] if keep_going else []
    rc = main(['-i', acq, '--chunk-size', '64', '--device', 'cpu'] + flags)
    assert rc == (0 if keep_going else 1)
    if keep_going:
        written = sorted(os.listdir(_output(tmp_path) / '0_stitched'))
        assert 'A1_stitched.ome.zarr' in written
        assert not os.path.exists(_output(tmp_path) / '0_stitched'
                                  / 'B2_stitched.ome.zarr' / '0' / '.zarray')
