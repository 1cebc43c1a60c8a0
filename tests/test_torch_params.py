"""The port's option checks against the JAX package's, and the options
they now let through.

``EngineOptions.validate()`` of both packages on the same option sets:
the same exception class, or none (chunks over several planes, which the
port refused naming ROADMAP item 20 before it wrote them, included).
``fusion_batch`` above the kernels' 64 tiles stitches the tree
the JAX package writes; ``validate_plan`` reports the JAX package's write
plan line."""

import pytest
import torch

from fixtures import write_synthetic_acquisition
from torch_helpers import assert_outputs_equal, small_disk_probe  # noqa: F401
from image_stitcher_tpu import EngineOptions as JaxOptions
from image_stitcher_tpu import stitch as jax_stitch
from image_stitcher_tpu.utils.progress import ProgressReporter as JaxReporter
import image_stitcher_tpu_torch as port

CPU = torch.device('cpu')

# (options, exception class of both validate()s, or None)
TABLE = [
    (dict(tiff_compression='lzw'), ValueError),
    (dict(tiff_compression='raw'), None),
    (dict(tiff_compression='jpeg'), None),
    (dict(tiff_jpeg_quality=0), ValueError),
    (dict(tiff_jpeg_quality=101), ValueError),
    (dict(tiff_jpeg_quality=1), None),
    (dict(tiff_jpeg_quality=100), None),
    (dict(fusion_batch=65), None),
    (dict(fusion_batch=128), None),
    (dict(fusion_batch=1000), None),
    (dict(chunks=(1, 1, 1, 64)), ValueError),
    (dict(chunks=(2, 1, 1, 64, 64)), None),
    (dict(chunks=(1, 3, 1, 64, 64)), None),
    (dict(chunks=(1, 1, 2, 64, 64)), None),
    (dict(validate_plan=True), None),
]


def _outcome(options):
    try:
        options.validate()
    except Exception as e:  # the class is what is compared
        return e
    return None


@pytest.mark.parametrize("opts,want", TABLE,
                         ids=[f"{next(iter(o))}={next(iter(o.values()))}"
                              for o, _ in TABLE])
def test_validate_raises_what_the_jax_package_raises(opts, want):
    jax_e = _outcome(JaxOptions(**opts))
    port_e = _outcome(port.EngineOptions(**opts))
    assert type(jax_e) is type(port_e) and (
        want is None and jax_e is None or isinstance(jax_e, want))


@pytest.mark.parametrize("blend", ["overwrite", "feather"])
@pytest.mark.parametrize("streaming", ["off", "on"], ids=["inram", "band"])
def test_fusion_batch_over_64_tiles_stitches_the_jax_tree(tmp_path, blend,
                                                          streaming):
    """A 9 x 8 grid on one canvas plane (one band): one batch of 72 tiles
    (two runs of the kernels' 64) writes what the JAX package writes."""
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(acq, grid_cols=8, grid_rows=9, tile_w=16,
                                tile_h=16, overlap=4, seed=31)
    opts = dict(fusion_batch=100, blend_method=blend, streaming=streaming,
                compressor_cname=None, chunks=(1, 1, 1, 32, 32))
    jax_stitch(acq, options=JaxOptions(fusion_device='device',
                                       output_folder=str(tmp_path / "jax"),
                                       **opts))
    pipe = port.stitch(acq, device=CPU, options=port.EngineOptions(
        output_folder=str(tmp_path / "port"), **opts))
    assert len(pipe._build_jobs(0, 'A1')) == 72
    assert [s['batches'] for s in pipe.fuse_stats.values()] == [1]
    assert_outputs_equal(str(tmp_path / "jax"), str(tmp_path / "port"))


@pytest.mark.parametrize("overlap", [0, 8], ids=["disjoint", "overlapping"])
def test_plan_validation_reports_the_jax_line(tmp_path, overlap):
    """validate_plan=True on the in-RAM path: the status line of the JAX
    package's ``summarize_plan``, for a plan whose tiles abut and for one
    whose tiles overlap."""
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(acq, grid_cols=3, grid_rows=2, tile_w=32,
                                tile_h=32, overlap=overlap, seed=8)
    lines = {}
    for name, run, opts in (
            ("jax", jax_stitch, JaxOptions(fusion_device='device',
                                           streaming='off',
                                           validate_plan=True,
                                           output_folder=str(tmp_path / "j"))),
            ("port", port.stitch, port.EngineOptions(
                streaming='off', validate_plan=True,
                output_folder=str(tmp_path / "p")))):
        seen = []
        reporter = (port.ProgressReporter if name == "port" else JaxReporter)(
            status=lambda msg, is_saving=False: seen.append(msg))
        kw = dict(device=CPU) if name == "port" else {}
        run(acq, options=opts, reporter=reporter, **kw)
        lines[name] = [m for m in seen if m.startswith("write plan:")]
    assert lines["port"] == lines["jax"] and len(lines["jax"]) == 1
    assert ("disjoint" in lines["jax"][0]) == (overlap == 0)
