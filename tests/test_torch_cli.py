"""The port's CLI: every flag of the JAX CLI with its choices and
default, the ones the port runs driven end to end on the CPU, the ones it
does not run yet raising ``NotImplementedError`` naming their ROADMAP
item."""

import json
import os

import pytest

from fixtures import write_synthetic_acquisition
from torch_helpers import assert_outputs_equal, small_disk_probe  # noqa: F401
from image_stitcher_tpu.cli import create_options as jax_create_options
from image_stitcher_tpu.cli import create_params as jax_create_params
from image_stitcher_tpu.cli import main as jax_main
from image_stitcher_tpu.cli import parse_args as jax_parse_args
from image_stitcher_tpu_torch.cli import (create_options, create_params, main,
                                          parse_args)
from image_stitcher_tpu_torch.io.zarr_store import read_array
from image_stitcher_tpu_torch.models.pipeline import StitchPipeline


def _acquisition(tmp_path, regions=("A1",), name="acq"):
    acq = str(tmp_path / name)
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=2, tile_w=64,
                                tile_h=64, overlap=16, seed=3,
                                regions=list(regions),
                                acq_params_overrides={"pixel_binning": 2})
    return acq


def _output(tmp_path, name="acq"):
    outs = [d for d in os.listdir(tmp_path)
            if d.startswith(f'{name}_stitched_')]
    assert len(outs) == 1
    return tmp_path / outs[0]


OPTION_FIELDS = ('flatfield_device', 'streaming', 'registration_report',
                 'continue_on_error', 'fusion_device', 'zarr_format',
                 'tiff_compression', 'tiff_jpeg_quality', 'fusion_batch',
                 'chunks', 'blend_method', 'registration_scope')
PARAM_FIELDS = ('output_format', 'merge_timepoints', 'merge_hcs_regions',
                'apply_flatfield', 'use_registration', 'scan_pattern',
                'dynamic_registration')


@pytest.mark.parametrize("flags", [
    [], ['--flatfield-device', 'device'], ['--streaming', 'off'],
    ['--streaming', 'on'], ['--registration-report'],
    ['--continue-on-error'], ['-f', '.ome.tiff'], ['-f', '.ome.zarr'],
    ['-mt'], ['-mw'], ['--merge-timepoints', '--merge-hcs-regions'],
    ['--fusion-device', 'host'], ['--fusion-device', 'device'],
    ['--zarr-format', '3'], ['--tiff-compression', 'raw'],
    ['--tiff-compression', 'jpeg', '--tiff-jpeg-quality', '40'],
    ['--resume']], ids=lambda f: ' '.join(f) or 'defaults')
def test_flags_match_the_jax_cli(flags):
    args = parse_args(['-i', 'x'] + flags)
    jargs = jax_parse_args(['-i', 'x'] + flags)
    got, want = create_options(args), jax_create_options(jargs)
    for name in OPTION_FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    got, want = create_params(args), jax_create_params(jargs)
    for name in PARAM_FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    assert args.resume == jargs.resume


@pytest.mark.parametrize("flags,item", [
    (['-f', '.ome.tiff'], "item 10"), (['-mt'], "item 11"),
    (['-mw'], "item 11"), (['--fusion-device', 'host'], "item 8"),
    (['--resume'], "item 12")], ids=lambda v: v if isinstance(v, str)
    else ' '.join(v))
def test_unported_flags_raise_naming_their_item(tmp_path, capsys, flags,
                                                item):
    acq = _acquisition(tmp_path)
    args = parse_args(['-i', acq, '--device', 'cpu'] + flags)
    with pytest.raises(NotImplementedError, match=item):
        StitchPipeline(create_params(args), create_options(args),
                       resume=args.resume, device=args.device)
    assert main(['-i', acq, '--device', 'cpu'] + flags) == 1
    assert item in capsys.readouterr().err


def test_zarr_format_3_matches_the_jax_cli(tmp_path):
    """``--zarr-format 3`` (sharded v3, NGFF 0.5): the JAX CLI's tree."""
    jax_acq = _acquisition(tmp_path, name="jax")
    port_acq = _acquisition(tmp_path, name="port")
    flags = ['-r', '--zarr-format', '3', '--chunk-size', '32',
             '--fusion-device', 'device']
    assert jax_main(['-i', jax_acq] + flags) == 0
    assert main(['-i', port_acq, '--device', 'cpu'] + flags) == 0
    assert_outputs_equal(str(_output(tmp_path, "jax")),
                         str(_output(tmp_path, "port")))
    with open(_output(tmp_path, "port") / '0_stitched'
              / 'A1_stitched.ome.zarr' / '0' / 'zarr.json') as f:
        assert json.load(f)['zarr_format'] == 3


def test_tiff_options_are_checked_as_the_jax_cli_checks_them(tmp_path,
                                                            capsys):
    """--tiff-jpeg-quality outside [1, 100] fails the run in both CLIs;
    inside it, with zarr output, both runs go ahead."""
    acq = _acquisition(tmp_path)
    assert main(['-i', acq, '--device', 'cpu', '--tiff-jpeg-quality',
                 '0']) == 1
    assert "tiff_jpeg_quality" in capsys.readouterr().err
    assert main(['-i', acq, '--device', 'cpu', '--chunk-size', '64',
                 '--tiff-compression', 'raw', '--tiff-jpeg-quality',
                 '100']) == 0


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
