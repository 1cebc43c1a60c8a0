"""The port's run manifest and resume against the JAX package's.

The cases of ``tests/test_resume.py`` (all but the process edition and
OME-TIFF output, which the port does not carry yet), each run on the
port on the CPU; then the port's manifest and ``flatfields.npz`` held
equal to a JAX run's, the port reading a JAX run's folder to the state
``state_from_reference`` gives, and an interrupted and resumed run
writing the tree of an uninterrupted one, merges included, without
refitting or re-fusing a completed unit.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from fixtures import write_synthetic_acquisition
from torch_helpers import (assert_trees_equal, small_disk_probe,  # noqa: F401
                           tree_files, zarr_groups)
import image_stitcher_tpu as jax_pkg
import image_stitcher_tpu_torch as port
from image_stitcher_tpu_torch import (EngineOptions, StitchingParameters,
                                      state_from_reference)
from image_stitcher_tpu_torch.models.pipeline import StitchPipeline
from image_stitcher_tpu_torch.utils.manifest import (RunManifest,
                                                     find_resumable)
from image_stitcher_tpu_torch.utils.progress import (ProgressReporter,
                                                     StitchCancelled)

CPU = torch.device('cpu')


def make_acq(tmp_path, regions=("A1", "A2"), timepoints=2, name="acq"):
    acq_dir = str(tmp_path / name)
    write_synthetic_acquisition(acq_dir, grid_cols=2, grid_rows=2,
                                tile_w=64, tile_h=64, overlap=16,
                                regions=list(regions), timepoints=timepoints)
    return acq_dir


def stop_after(n):
    """(stop event, reporter) that sets the event at the n-th completed
    unit."""
    stop = threading.Event()
    count = [0]

    def on_status(msg, is_saving=False):
        if msg.startswith("Completed region"):
            count[0] += 1
            if count[0] == n:
                stop.set()

    return stop, ProgressReporter(status=on_status)


def pipeline(params, options=None, reporter=None, **kw):
    return StitchPipeline(params, options or EngineOptions(), reporter,
                          device=CPU, **kw)


def test_manifest_round_trip(tmp_path):
    from image_stitcher_tpu_torch.core.geometry import RegistrationShifts
    m = RunManifest(str(tmp_path / "out"))
    m.set_params({"a": 1})
    m.set_shifts(RegistrationShifts(h_shift=(1, -30), v_shift=(-31, 2),
                                    scan_pattern='S-Pattern'))
    m.save_flatfields({0: np.ones((4, 4), np.float32) * 1.5})
    m.mark_completed(0, "A1")
    m2 = RunManifest.load(str(tmp_path / "out"))
    assert m2.is_completed(0, "A1")
    assert not m2.is_completed(0, "A2")
    s = m2.get_shifts()
    assert s.h_shift == (1, -30) and s.scan_pattern == 'S-Pattern'
    ff = m2.load_flatfields()
    np.testing.assert_array_equal(ff[0], np.ones((4, 4)) * 1.5)


def test_resume_skips_completed(tmp_path):
    acq_dir = make_acq(tmp_path)
    stop, rep = stop_after(2)
    params = StitchingParameters(input_folder=acq_dir, use_registration=True)
    pipe = pipeline(params, reporter=rep, stop_event=stop)
    with pytest.raises(StitchCancelled):
        pipe.run()
    out = pipe.output_folder
    assert len(RunManifest.load(out).data["completed"]) == 2

    # resume: same params -> finds the folder, skips completed units
    assert find_resumable(acq_dir, params.to_dict(),
                          EngineOptions().output_fingerprint()) == out
    skipped = []
    rep2 = ProgressReporter(
        status=lambda msg, s=False: skipped.append(msg)
        if msg.startswith("Skipping") else None)
    params2 = StitchingParameters(input_folder=acq_dir, use_registration=True)
    pipe2 = pipeline(params2, reporter=rep2, resume=True)
    pipe2.run()
    assert pipe2.output_folder == out
    assert skipped == ["Skipping completed region A1 t0",
                       "Skipping completed region A2 t0"]
    assert len(RunManifest.load(out).data["completed"]) == 4
    assert 'registration' not in pipe2.timers.as_dict()
    assert pipe2.shifts.h_shift == pipe.shifts.h_shift
    for t in (0, 1):
        for r in ("A1", "A2"):
            assert os.path.isdir(os.path.join(
                out, f"{t}_stitched", f"{r}_stitched.ome.zarr"))


def test_resume_incompatible_params_starts_fresh(tmp_path):
    acq_dir = make_acq(tmp_path, regions=("A1",), timepoints=1)
    port.stitch(acq_dir, device=CPU)
    p = StitchingParameters(input_folder=acq_dir, apply_flatfield=True)
    assert find_resumable(acq_dir, p.to_dict()) is None
    assert not pipeline(p, resume=True).resumed


def test_resume_reuses_flatfields(tmp_path):
    acq_dir = make_acq(tmp_path, regions=("A1", "A2"), timepoints=1)
    stop, rep = stop_after(1)
    p = StitchingParameters(input_folder=acq_dir, apply_flatfield=True)
    pipe = pipeline(p, EngineOptions(pipelined_save=False), rep,
                    stop_event=stop)
    with pytest.raises(StitchCancelled):
        pipe.run()
    out = pipe.output_folder
    assert os.path.exists(os.path.join(out, "flatfields.npz"))

    pipe2 = pipeline(StitchingParameters(input_folder=acq_dir,
                                         apply_flatfield=True), resume=True)
    pipe2.run()
    assert pipe2.output_folder == out
    assert 'flatfield_fit' not in pipe2.timers.as_dict()
    np.testing.assert_array_equal(pipe2.flatfields[0], pipe.flatfields[0])


def test_finished_runs_are_not_resumed(tmp_path):
    acq_dir = make_acq(tmp_path, regions=("A1",), timepoints=1)
    pipe = pipeline(StitchingParameters(input_folder=acq_dir))
    pipe.run()
    pipe2 = pipeline(StitchingParameters(input_folder=acq_dir), resume=True)
    assert not pipe2.resumed
    assert pipe2.output_folder != pipe.output_folder


def test_continue_on_error(tmp_path, monkeypatch):
    acq_dir = make_acq(tmp_path, regions=("A1", "A2"), timepoints=1)
    errors = []
    rep = ProgressReporter(error=lambda m: errors.append(m))
    pipe = pipeline(StitchingParameters(input_folder=acq_dir),
                    EngineOptions(continue_on_error=True), rep)
    real = pipe.stitch_region

    def flaky(t, region):
        if region == "A1":
            raise RuntimeError("boom")
        return real(t, region)

    monkeypatch.setattr(pipe, "stitch_region", flaky)
    pipe.run()
    assert len(errors) == 1 and "boom" in errors[0]
    out = pipe.output_folder
    assert os.path.isdir(os.path.join(out, "0_stitched",
                                      "A2_stitched.ome.zarr"))
    assert not os.path.isdir(os.path.join(out, "0_stitched",
                                          "A1_stitched.ome.zarr"))
    assert RunManifest.load(out).data["completed"] == ["0/A2"]


def test_subpixel_global_resume(tmp_path):
    """Resume restores the float positions; toggling subpixel changes
    the output fingerprint and starts a fresh run."""
    acq_dir = make_acq(tmp_path, regions=("A1", "A2"), timepoints=1)
    stop, rep = stop_after(1)
    opts = EngineOptions(registration_scope='global',
                         subpixel_placement=True, pipelined_save=False)
    p = StitchingParameters(input_folder=acq_dir, use_registration=True)
    pipe = pipeline(p, opts, rep, stop_event=stop)
    with pytest.raises(StitchCancelled):
        pipe.run()
    floats = {r: dict(v) for r, v in pipe.global_positions_float.items()}

    p2 = StitchingParameters(input_folder=acq_dir, use_registration=True)
    pipe2 = pipeline(p2, EngineOptions(registration_scope='global',
                                       subpixel_placement=True), resume=True)
    pipe2.run()
    assert pipe2.resumed
    assert list(floats) == ['A1']
    for region, per in floats.items():
        assert pipe2.global_positions_float.get(region) == per
    # the second region's solve, made by the resumed run, is persisted
    m = RunManifest.load(pipe2.output_folder).data
    assert sorted(m['global_positions_float']) == ['A1', 'A2']

    pipe3 = pipeline(StitchingParameters(input_folder=acq_dir,
                                         use_registration=True),
                     EngineOptions(registration_scope='global',
                                   subpixel_placement=False), resume=True)
    assert not pipe3.resumed


def test_explicit_folder_resume_refuses_incompatible_settings(tmp_path):
    acq_dir = make_acq(tmp_path, regions=("A1", "A2"), timepoints=1)
    out = str(tmp_path / "pinned")
    stop, rep = stop_after(1)
    pipe = pipeline(StitchingParameters(input_folder=acq_dir),
                    EngineOptions(output_folder=out, pipelined_save=False),
                    rep, stop_event=stop)
    with pytest.raises(StitchCancelled):
        pipe.run()
    with pytest.raises(ValueError, match="refusing to resume"):
        pipeline(StitchingParameters(input_folder=acq_dir),
                 EngineOptions(output_folder=out, blend_method='feather'),
                 resume=True)
    pipe2 = pipeline(StitchingParameters(input_folder=acq_dir),
                     EngineOptions(output_folder=out, pipelined_save=False),
                     resume=True)
    pipe2.run()
    assert pipe2.resumed
    for r in ("A1", "A2"):
        assert os.path.isdir(os.path.join(out, "0_stitched",
                                          f"{r}_stitched.ome.zarr"))


# ------------------------------------------------ against the JAX package

SCOPES = [dict(), dict(registration_scope='global', subpixel_placement=True,
                       blend_method='feather')]


@pytest.mark.parametrize("extra", SCOPES, ids=['center', 'global'])
def test_manifest_and_sidecar_equal_the_jax_run(tmp_path, extra):
    """With the JAX run's fields, shifts and positions carried in, the
    port's manifest equals the JAX run's key by key (apart from the
    input path) and flatfields.npz holds equal arrays."""
    kw = dict(use_registration=True, apply_flatfield=True,
              merge_hcs_regions=True)
    opts = dict(chunks=(1, 1, 1, 32, 32), compressor_cname=None, **extra)
    jax_acq = make_acq(tmp_path, name="jax")
    jp = jax_pkg.stitch(jax_acq, options=jax_pkg.EngineOptions(
        output_folder=str(tmp_path / 'jax_out'), **opts), **kw)
    state = state_from_reference(jp.flatfields, jp.shifts,
                                 jp.global_positions or None,
                                 jp.global_positions_float or None)
    port_acq = make_acq(tmp_path, name="port")
    port.stitch(port_acq, device=CPU, state=state, options=EngineOptions(
        output_folder=str(tmp_path / 'port_out'), **opts), **kw)
    manifests = []
    for out in ('jax_out', 'port_out'):
        with open(tmp_path / out / '.stitch_manifest.json') as f:
            m = json.load(f)
        m['params'].pop('input_folder')
        manifests.append(m)
    assert manifests[1] == manifests[0]
    if extra:   # every region's solve, persisted as it was made
        assert sorted(manifests[1]['global_positions_float']) == ['A1', 'A2']
    with np.load(tmp_path / 'jax_out' / 'flatfields.npz') as want, \
            np.load(tmp_path / 'port_out' / 'flatfields.npz') as got:
        assert sorted(got.files) == sorted(want.files) == ['0']
        for k in want.files:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert tree_files(str(tmp_path / 'port_out')) == \
        tree_files(str(tmp_path / 'jax_out'))


def test_port_reads_a_jax_run_folder(tmp_path):
    """RunManifest.load on a JAX run's folder gives the shifts, global
    positions and fields that state_from_reference takes from the JAX
    pipeline; the port resumes that folder in place."""
    acq = make_acq(tmp_path, regions=("A1", "A2"), timepoints=1)
    stop = threading.Event()
    from image_stitcher_tpu.utils.progress import ProgressReporter as JaxRep
    rep = JaxRep(status=lambda m, s=False: stop.set()
                 if m.startswith("Completed region") else None)
    from image_stitcher_tpu.models.pipeline import \
        StitchPipeline as JaxPipeline
    from image_stitcher_tpu.utils.progress import \
        StitchCancelled as JaxCancelled
    opts = dict(registration_scope='global', pipelined_save=False,
                compressor_cname=None)
    jp = JaxPipeline(jax_pkg.StitchingParameters(
        input_folder=acq, use_registration=True, apply_flatfield=True),
        jax_pkg.EngineOptions(**opts), rep, stop_event=stop)
    with pytest.raises(JaxCancelled):
        jp.run()
    want = state_from_reference(jp.flatfields, jp.shifts,
                                {'A1': jp.global_positions['A1']},
                                {'A1': jp.global_positions_float['A1']})
    m = RunManifest.load(jp.output_folder)
    assert m.get_shifts() == want.shifts
    ints, floats = m.get_global_positions()
    assert ints == want.global_positions
    assert floats == want.global_positions_float
    fields = m.load_flatfields()
    assert sorted(fields) == sorted(want.flatfields)
    for k in fields:
        np.testing.assert_array_equal(fields[k], want.flatfields[k])

    skipped = []
    pipe = port.stitch(acq, use_registration=True, apply_flatfield=True,
                       device=CPU, resume=True,
                       reporter=ProgressReporter(
                           status=lambda msg, s=False: skipped.append(msg)
                           if msg.startswith("Skipping") else None),
                       options=EngineOptions(**opts))
    assert pipe.resumed and pipe.output_folder == jp.output_folder
    assert skipped == ["Skipping completed region A1 t0"]
    assert RunManifest.load(jp.output_folder).data["finished"]


@pytest.mark.parametrize("shuffle", [1, 2], ids=['zstd1', 'zstd1_bit'])
def test_port_resumes_a_jax_zstd_run_folder(tmp_path, shuffle):
    """A JAX run written with the reference's production compressor
    (blosc zstd, clevel 1; byte or bit shuffle), stopped after its first
    region: the port resumes it in place, skips that region, and the
    finished folder holds the tree of an uninterrupted JAX run."""
    acq = make_acq(tmp_path, regions=("A1", "A2"), timepoints=1)
    from image_stitcher_tpu.models.pipeline import \
        StitchPipeline as JaxPipeline
    from image_stitcher_tpu.utils.progress import \
        ProgressReporter as JaxRep
    from image_stitcher_tpu.utils.progress import \
        StitchCancelled as JaxCancelled
    opts = dict(compressor_cname='zstd', compressor_clevel=1,
                compressor_shuffle=shuffle, chunks=(1, 1, 1, 32, 32),
                pipelined_save=False)
    whole = jax_pkg.stitch(acq, use_registration=True, apply_flatfield=True,
                           options=jax_pkg.EngineOptions(
                               output_folder=str(tmp_path / 'whole'),
                               **opts))
    stop = threading.Event()
    rep = JaxRep(status=lambda m, s=False: stop.set()
                 if m.startswith("Completed region") else None)
    jp = JaxPipeline(jax_pkg.StitchingParameters(
        input_folder=acq, use_registration=True, apply_flatfield=True),
        jax_pkg.EngineOptions(output_folder=str(tmp_path / 'resumed'),
                              **opts), rep, stop_event=stop)
    with pytest.raises(JaxCancelled):
        jp.run()
    skipped = []
    pipe = port.stitch(acq, use_registration=True, apply_flatfield=True,
                       device=CPU, resume=True,
                       reporter=ProgressReporter(
                           status=lambda msg, s=False: skipped.append(msg)
                           if msg.startswith("Skipping") else None),
                       options=EngineOptions(
                           output_folder=str(tmp_path / 'resumed'), **opts))
    assert pipe.resumed and skipped == ["Skipping completed region A1 t0"]
    groups = zarr_groups(whole.output_folder)
    assert len(groups) == 2 and zarr_groups(pipe.output_folder) == groups
    for rel in groups:
        assert_trees_equal(os.path.join(whole.output_folder, rel),
                           os.path.join(pipe.output_folder, rel))


@pytest.mark.parametrize("streaming", ['on', 'off'],
                         ids=['band', 'inram'])
def test_resumed_run_writes_the_uninterrupted_tree(tmp_path, streaming):
    """A run stopped after its second unit and resumed writes the tree
    of an uninterrupted run (region stores and the complete plate), fits no
    flatfield and measures no shift again, and re-fuses no completed
    unit."""
    acq = make_acq(tmp_path, regions=("A1", "B2"), timepoints=2)
    opts = dict(chunks=(1, 1, 1, 32, 32), streaming=streaming)
    kw = dict(use_registration=True, apply_flatfield=True,
              merge_timepoints=True, merge_hcs_regions=True, device=CPU)
    whole = port.stitch(acq, options=EngineOptions(
        output_folder=str(tmp_path / 'whole'), **opts), **kw)
    stop, rep = stop_after(2)
    out = str(tmp_path / 'resumed')
    with pytest.raises(StitchCancelled):
        port.stitch(acq, reporter=rep, stop_event=stop, options=EngineOptions(
            output_folder=out, **opts), **kw)
    done = RunManifest.load(out).data['completed']
    assert done == ['0/A1', '0/B2'] and not os.path.exists(
        os.path.join(out, 'hcs_timepoints'))
    fused = []
    pipe = StitchPipeline(
        StitchingParameters(input_folder=acq, use_registration=True,
                            apply_flatfield=True, merge_timepoints=True,
                            merge_hcs_regions=True),
        EngineOptions(output_folder=out, **opts), device=CPU, resume=True)
    for name in ('stitch_region', '_stitch_and_save_streaming'):
        real = getattr(pipe, name)
        setattr(pipe, name, lambda t, r, real=real: fused.append(f"{t}/{r}")
                or real(t, r))
    pipe.run()
    assert fused == ['1/A1', '1/B2']
    timers = pipe.timers.as_dict()
    assert 'flatfield_fit' not in timers and 'registration' not in timers
    assert 'merge' in timers
    np.testing.assert_array_equal(pipe.flatfields[0], whole.flatfields[0])
    assert pipe.shifts == whole.shifts
    got = [g for g in zarr_groups(out)]
    assert got == zarr_groups(str(tmp_path / 'whole'))
    for rel in got:
        assert_trees_equal(os.path.join(str(tmp_path / 'whole'), rel),
                           os.path.join(out, rel))
    m = RunManifest.load(out).data
    assert m['finished'] and m['merges_done'] and len(m['completed']) == 4

    # a second resume of the finished pinned folder skips everything,
    # merges included
    msgs = []
    again = port.stitch(acq, resume=True, reporter=ProgressReporter(
        status=lambda msg, s=False: msgs.append(msg)),
        options=EngineOptions(output_folder=out, **opts), **kw)
    assert again.resumed
    assert "Merges already complete; skipping" in msgs
    assert sum(m.startswith("Skipping completed") for m in msgs) == 4
