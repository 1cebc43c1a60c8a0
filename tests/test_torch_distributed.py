"""Work shards and several processes: the port against the JAX package.

Mirrors ``tests/test_distributed.py``. Shards run one after the other in
one process (the barrier is then a no-op), or as two localhost processes
in one ``torch.distributed`` group over gloo on the CPU. Trees are held
to the JAX package's (``torch_helpers.assert_outputs_equal``) and to an
unsharded run. Every subprocess has a
``communicate(timeout=)``, so no test can hang the suite.
"""

import datetime
import os
import pathlib
import socket
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from fixtures import write_synthetic_acquisition
from torch_helpers import assert_outputs_equal, small_disk_probe  # noqa: F401
from image_stitcher_tpu import EngineOptions as JaxOptions
from image_stitcher_tpu import StitchingParameters as JaxParams
from image_stitcher_tpu.models.pipeline import StitchPipeline as JaxPipeline
import image_stitcher_tpu_torch as port
from image_stitcher_tpu_torch.models.pipeline import StitchPipeline
from image_stitcher_tpu_torch.parallel import distributed as dist

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device('cpu')
RECOVERY = ("pre-merge shard barrier failed (timeout {t}s) — a cooperating "
            "shard likely died before reaching the merge point. Recovery: "
            "re-run the dead shard with --resume into the same output "
            "folder (it skips its completed units), then re-run the "
            "coordinator shard with --resume to complete the merges.")


def _plate(path, seed, timepoints=2):
    write_synthetic_acquisition(str(path), grid_cols=2, grid_rows=2,
                                tile_w=64, tile_h=64, overlap=16,
                                regions=["B2", "C3"], timepoints=timepoints,
                                seed=seed)
    return str(path)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _run_workers(script: str, n: int = 2, timeout: float = 180.0):
    """Start ``n`` processes of ``script`` (argv[1] = rank) together;
    returns (return codes, outputs). A process that outlives ``timeout``
    is killed and fails the test."""
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, cwd=str(REPO))
             for i in range(n)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a worker hung past {timeout}s")
        outs.append(out.decode())
    return [p.returncode for p in procs], outs


def test_work_shard_validation_matches_jax(tmp_path):
    for bad in (dict(work_shard=(2, 2), output_folder=str(tmp_path)),
                dict(work_shard=(0, 0), output_folder=str(tmp_path)),
                dict(work_shard=(0, 2))):
        with pytest.raises(ValueError) as jerr:
            JaxOptions(**bad).validate()
        with pytest.raises(ValueError) as terr:
            port.EngineOptions(**bad).validate()
        assert str(terr.value) == str(jerr.value)
    port.EngineOptions(work_shard=(1, 2), output_folder='x').validate()


def test_work_sharded_pipeline_sequential(tmp_path):
    """Shard 1, then the coordinator shard 0, into one shared folder: the
    tree equals the JAX package's sharded tree and an unsharded run's;
    each shard keeps its own manifest and registration report."""
    acq = _plate(tmp_path / "acq", seed=11)
    kw = dict(input_folder=acq, use_registration=True,
              merge_hcs_regions=True, merge_timepoints=True)
    jax_out = str(tmp_path / "jax")
    jpipe = None
    for idx in (1, 0):
        jpipe = JaxPipeline(JaxParams(**kw), JaxOptions(
            output_folder=jax_out, work_shard=(idx, 2)))
        jpipe.run()
    shared = str(tmp_path / "port")
    logs = []
    rep = port.ProgressReporter(status=lambda m, s=False: logs.append(m))
    pipes = {}
    for idx in (1, 0):
        pipes[idx] = StitchPipeline(
            port.StitchingParameters(**kw), port.EngineOptions(
                output_folder=shared, work_shard=(idx, 2),
                registration_report=True),
            rep, device=CPU)
        pipes[idx].run()
        assert (pipes[idx].shifts.h_shift, pipes[idx].shifts.v_shift) == (
            tuple(jpipe.shifts.h_shift), tuple(jpipe.shifts.v_shift))
    assert ("merges are the coordinator shard's job; skipping on shard 1"
            in logs)
    assert len(pipes[0].saved_paths) == len(pipes[1].saved_paths) == 2
    for idx in (0, 1):
        for name in (".stitch_manifest.json", "registration_report"):
            suffix = f".shard{idx}" + (".json" if name[0] == 'r' else "")
            assert os.path.exists(os.path.join(shared, name + suffix))
    assert not os.path.exists(os.path.join(shared, ".stitch_manifest.json"))
    assert os.path.isdir(os.path.join(shared, "hcs_timepoints",
                                      "complete_hcs.ome.zarr"))
    assert_outputs_equal(jax_out, shared)
    whole = port.stitch(acq, use_registration=True, merge_hcs_regions=True,
                        merge_timepoints=True, device=CPU,
                        options=port.EngineOptions(
                            output_folder=str(tmp_path / "whole")))
    assert len(whole.saved_paths) == 4
    assert_outputs_equal(str(tmp_path / "whole"), shared)


def test_work_sharded_resume_skips_completed(tmp_path):
    """A restarted shard reloads ITS manifest and skips finished units."""
    acq = _plate(tmp_path / "acq", seed=13, timepoints=1)
    params = port.StitchingParameters(input_folder=acq)
    opts = port.EngineOptions(output_folder=str(tmp_path / "out"),
                              work_shard=(0, 2))
    first = StitchPipeline(params, opts, device=CPU)
    first.run()
    assert len(first.saved_paths) == 1
    logs = []
    rep = port.ProgressReporter(status=lambda m, s=False: logs.append(m))
    again = StitchPipeline(params, opts, rep, resume=True, device=CPU)
    again.run()
    assert again.resumed and not again.saved_paths
    assert any("Skipping completed region" in m for m in logs)


def test_port_resumes_a_jax_shard_folder(tmp_path):
    """The JAX package's shard 0 ran; the port resumes shard 0 (skipping
    its units) and runs shard 1: the folder's tree equals a JAX run of
    both shards."""
    acq = _plate(tmp_path / "acq", seed=14)
    kw = dict(input_folder=acq, use_registration=True)
    mixed = str(tmp_path / "mixed")
    jpipe = JaxPipeline(JaxParams(**kw), JaxOptions(output_folder=mixed,
                                                    work_shard=(0, 2)))
    jpipe.run()
    state = port.state_from_reference(shifts=jpipe.shifts)
    logs = []
    rep = port.ProgressReporter(status=lambda m, s=False: logs.append(m))
    resumed = StitchPipeline(port.StitchingParameters(**kw),
                             port.EngineOptions(output_folder=mixed,
                                                work_shard=(0, 2)),
                             rep, resume=True, device=CPU)
    resumed.run()
    assert resumed.resumed and not resumed.saved_paths
    assert sum("Skipping completed region" in m for m in logs) == 2
    StitchPipeline(port.StitchingParameters(**kw),
                   port.EngineOptions(output_folder=mixed,
                                      work_shard=(1, 2)),
                   device=CPU, state=state).run()
    jax_out = str(tmp_path / "jax")
    for idx in (0, 1):
        JaxPipeline(JaxParams(**kw), JaxOptions(
            output_folder=jax_out, work_shard=(idx, 2))).run()
    assert_outputs_equal(jax_out, mixed)


def test_two_process_localhost_validation():
    dist.run_localhost_validation(num_processes=2, devices_per_process=2,
                                  timeout=180, platform='cpu')


def test_torchrun_validation():
    """The same validation under torchrun: env:// rendezvous, each
    process's device from LOCAL_RANK (the CPU, asked for by name)."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m",
         "image_stitcher_tpu_torch.parallel.distributed", "cpu"],
        capture_output=True, text=True, timeout=180, cwd=str(REPO))
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:])
    for i in (0, 1):
        assert f"distributed worker {i}/2 OK" in proc.stdout


def test_stitch_distributed_two_processes(tmp_path):
    """Two processes in one gloo group stitch one shared tree; the
    coordinator merges the plate after the barrier; the tree equals a
    single-process run."""
    acq = _plate(tmp_path / "acq", seed=12, timepoints=1)
    out = str(tmp_path / "out")
    script = textwrap.dedent(f"""
        import sys, torch
        pid = int(sys.argv[1])
        from image_stitcher_tpu_torch.parallel import distributed as dist
        c = dist.initialize("localhost:{_free_port()}", num_processes=2,
                            process_id=pid, platform='cpu')
        import image_stitcher_tpu_torch as port
        p = port.StitchingParameters(input_folder={acq!r},
                                     use_registration=True,
                                     merge_hcs_regions=True)
        pipe = dist.stitch_distributed(
            p, port.EngineOptions(output_folder={out!r}))
        print("worker", pid, "units", len(pipe.saved_paths),
              "shard", pipe.options.work_shard, "on", pipe.device,
              flush=True)
    """)
    rcs, outs = _run_workers(script)
    assert rcs == [0, 0], outs
    for i in (0, 1):
        assert f"worker {i} units 1 shard ({i}, 2) on cpu" in outs[i]
        assert "device tensors over gloo" in outs[i]
    port.stitch(acq, use_registration=True, merge_hcs_regions=True,
                device=CPU, options=port.EngineOptions(
                    output_folder=str(tmp_path / "one")))
    assert_outputs_equal(str(tmp_path / "one"), out)


def test_shard_death_barrier_timeout_and_resume(tmp_path):
    """Process 1 dies right after its first unit lands. The coordinator
    must not deadlock in the pre-merge barrier: it fails within the
    timeout with the JAX package's recovery text. Re-running the dead
    shard with resume, then the coordinator with resume, completes the
    tree (every unit and the plate), equal to an uninterrupted run."""
    acq = _plate(tmp_path / "acq", seed=21)
    out = str(tmp_path / "out")
    timeout_s = 10.0
    script = textwrap.dedent(f"""
        import os, sys
        pid = int(sys.argv[1])
        from image_stitcher_tpu_torch.parallel import distributed as dist
        dist.initialize("localhost:{_free_port()}", num_processes=2,
                        process_id=pid, platform='cpu')
        import image_stitcher_tpu_torch as port
        from image_stitcher_tpu_torch.models.pipeline import StitchPipeline
        if pid == 1:
            orig = StitchPipeline.save_region
            def dying_save(self, *a, **k):
                orig(self, *a, **k)
                os._exit(42)   # dies right after its first unit is written
            StitchPipeline.save_region = dying_save
        p = port.StitchingParameters(input_folder={acq!r},
                                     use_registration=True,
                                     merge_hcs_regions=True)
        dist.stitch_distributed(p, port.EngineOptions(
            output_folder={out!r}, merge_barrier_timeout_s={timeout_s},
            pipelined_save=False))
        print("worker", pid, "done", flush=True)
    """)
    t0 = time.monotonic()
    rcs, outs = _run_workers(script, timeout=120)
    elapsed = time.monotonic() - t0
    assert rcs[1] == 42, outs[1]
    assert rcs[0] != 0, outs[0]
    assert RECOVERY.format(t=f"{timeout_s:.0f}") in outs[0], outs[0][-3000:]
    assert elapsed < 100
    params = port.StitchingParameters(input_folder=acq, use_registration=True,
                                      merge_hcs_regions=True)
    StitchPipeline(params, port.EngineOptions(
        output_folder=out, work_shard=(1, 2), pipelined_save=False),
        resume=True, device=CPU).run()
    logs = []
    rep = port.ProgressReporter(status=lambda m, s=False: logs.append(m))
    StitchPipeline(params, port.EngineOptions(
        output_folder=out, work_shard=(0, 2), pipelined_save=False),
        rep, resume=True, device=CPU).run()
    assert any("Skipping completed region" in m for m in logs)
    port.stitch(acq, use_registration=True, merge_hcs_regions=True,
                device=CPU, options=port.EngineOptions(
                    output_folder=str(tmp_path / "whole")))
    assert_outputs_equal(str(tmp_path / "whole"), out)


# ---------------------------------------------------------------- barrier

def _barrier_pipeline(tmp_path, timeout_s):
    acq = str(tmp_path / "barrier_acq")
    write_synthetic_acquisition(acq, grid_cols=1, grid_rows=1, tile_w=32,
                                tile_h=32, overlap=8)
    return StitchPipeline(port.StitchingParameters(input_folder=acq),
                          port.EngineOptions(
                              merge_barrier_timeout_s=timeout_s),
                          device=CPU)


def _fake_group(monkeypatch, **calls):
    tdist = torch.distributed
    monkeypatch.setattr(tdist, "is_initialized", lambda: True)
    monkeypatch.setattr(tdist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "control_group", lambda: "gloo-group")
    for name, fn in calls.items():
        monkeypatch.setattr(tdist, name, fn)


def test_shard_barrier_is_a_no_op_without_a_group(tmp_path):
    assert not torch.distributed.is_initialized()
    _barrier_pipeline(tmp_path, timeout_s=1.0)._shard_barrier()


def test_shard_barrier_is_timed_and_bounded(tmp_path, monkeypatch):
    """A timeout rides gloo's monitored_barrier; its failure (a rank that
    never arrives) raises the recovery error, not a hang."""
    seen = []

    def monitored(group=None, timeout=None, wait_all_ranks=False):
        seen.append((group, timeout))

    _fake_group(monkeypatch, monitored_barrier=monitored,
                barrier=lambda group=None: seen.append('untimed'))
    pipe = _barrier_pipeline(tmp_path, timeout_s=7.0)
    pipe._shard_barrier()
    assert seen == [("gloo-group", datetime.timedelta(seconds=7))]

    def never(group=None, timeout=None, wait_all_ranks=False):
        raise RuntimeError("Rank 1 failed to pass monitoredBarrier in "
                           f"{timeout}")

    monkeypatch.setattr(torch.distributed, "monitored_barrier", never)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        pipe._shard_barrier()
    assert time.monotonic() - t0 < 5
    assert str(err.value).startswith(RECOVERY.format(t="7"))
    assert "Rank 1 failed to pass monitoredBarrier" in str(err.value)


def test_shard_barrier_zero_timeout_keeps_untimed_path(tmp_path,
                                                       monkeypatch):
    seen = []
    _fake_group(monkeypatch,
                monitored_barrier=lambda **k: seen.append('timed'),
                barrier=lambda group=None: seen.append(group))
    _barrier_pipeline(tmp_path, timeout_s=0.0)._shard_barrier()
    assert seen == ["gloo-group"]


def test_pod_mesh_single_process_shape():
    """Without a process group the pod mesh is the local (1, n) grid:
    data across processes, canvas across this process's devices."""
    mesh = dist.make_pod_mesh(local_devices=[CPU] * 4)
    assert mesh.shape == {'data': 1, 'canvas': 4}
    assert mesh.local_row() == 0 and mesh.processes == ((0, 0, 0, 0),)
    mesh = dist.make_pod_mesh(local_shape=(2, 2), local_devices=[CPU] * 4)
    assert mesh.shape == {'data': 2, 'canvas': 2}
    with pytest.raises(ValueError):
        dist.make_pod_mesh(local_shape=(3, 5), local_devices=[CPU] * 4)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a host without a card")
@pytest.mark.parametrize("entry", ["initialize", "worker_cli"])
def test_distributed_entry_points_take_the_card_unless_asked(entry):
    """Without ``platform='cpu'`` the distributed entry points run on the
    card; with no card they raise rather than fall back to the CPU."""
    if entry == "initialize":
        with pytest.raises(RuntimeError, match="platform='cpu'"):
            dist.initialize(f"localhost:{_free_port()}", num_processes=1,
                            process_id=0)
        with pytest.raises(ValueError):
            dist.initialize(f"localhost:{_free_port()}", num_processes=1,
                            process_id=0, platform='tpu')
        assert not torch.distributed.is_initialized()
        return
    proc = subprocess.run(
        [sys.executable, "-m", "image_stitcher_tpu_torch.parallel.distributed",
         "0", "1", str(_free_port()), "1"],
        capture_output=True, text=True, timeout=120, cwd=str(REPO))
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in proc.stderr
