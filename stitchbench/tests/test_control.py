"""The output check's control and faults.

- The control, the reference computed in bfloat16 (one precision below
  the program's float32) and put in the program's place, must come out
  not correct under each cell's limits, while the program's own sound
  runs come out correct: on the CPU at 256^2 tiles, and (marked ``cuda``)
  on the card at the cell's own size on three seeds.
- A run whose timed path is broken underneath must report ``correct``
  false: the fusion step returning the canvas unchanged, half of each
  batch left out, one pixel altered where it is produced, and (with
  global registration) one pair's answer altered where it is produced.
  The run is driven on the CPU past the harness's look for a card.
"""

import copy
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from stitchbench import check, readings, registry, run

CELLS = ('squid_zstd1.plate', 'max_quality.region')


@pytest.fixture
def cuda_device():
    """The card, decided here and not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device('cuda')


def small(cell: str):
    """(config, traffic) of a cell cut to 256^2 tiles: 2 wells of the
    plate, or a 3x3 region streamed in bands."""
    reg = registry.Registry()
    w = reg.workload(cell)
    config = copy.deepcopy(reg.config(w['config']))
    traffic = copy.deepcopy(reg.traffic(w['traffic']))
    traffic.update(tile=256, overlap_px=26)
    if traffic['grid'] > 3:
        traffic['grid'] = 3
        config['options']['streaming'] = 'on'
    traffic['regions'] = traffic['regions'][:2]
    return config, traffic


@pytest.mark.parametrize('cell', CELLS)
def test_control_fails_and_the_program_passes_small(cell):
    config, traffic = small(cell)
    limits = registry.Registry().limits(cell)
    for item in readings.readings(cell, [2 ** 32 + 17, 23], 'cpu',
                                  traffic=traffic, config=config):
        ok, checks = check.judge(item['sound'], limits)
        assert ok, checks
        bad, checks = check.judge(item['control'], limits)
        assert not bad, checks


@pytest.mark.cuda
@pytest.mark.parametrize('cell', CELLS)
def test_control_fails_at_the_cells_size(cell, cuda_device):
    limits = registry.Registry().limits(cell)
    for item in readings.readings(cell, [101, 2 ** 31 + 102, 103],
                                  cuda_device):
        assert check.judge(item['sound'], limits)[0], item
        assert not check.judge(item['control'], limits)[0], item


def _unchanged(orig, name):
    def fn(canvas, *args, **kw):
        return canvas if name == 'fuse_overwrite' else (canvas, args[0])
    return fn


def _half(orig, name):
    def fn(a, *args, **kw):
        args = list(args)
        k = 2 if name == 'fuse_overwrite' else 3     # index of valid
        valid = args[k + 1].clone()
        n = int(valid.sum())
        idx = valid.nonzero().flatten()[n // 2:]
        valid[idx] = False
        args[k + 1] = valid
        return orig(a, *args, **kw)
    return fn


def _altered(orig, name):
    def fn(a, *args, **kw):
        out = orig(a, *args, **kw)
        # a pixel this batch wrote, of the canvas or of the band's sums
        plane = a[0, 0] if name == 'fuse_overwrite' else args[0][0, 0]
        written = plane.to(torch.float32) > 0
        idx = written.nonzero()
        if len(idx):
            r, c = (int(v) for v in idx[len(idx) // 2])
            if name == 'fuse_overwrite':  # uint16: no arithmetic in torch
                a[0, 0, r, c] = 4321
            else:
                a[0, 0, r, c] += 9000.0
        return out
    return fn


@pytest.mark.parametrize('fault', [_unchanged, _half, _altered])
@pytest.mark.parametrize('cell', CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch,
                                            capsys):
    from image_stitcher_tpu_torch.ops import cuda_fuse
    config, traffic = small(cell)
    name = ('fuse_overwrite' if config['options']['blend_method']
            == 'overwrite' else 'fuse_feather')
    monkeypatch.setattr(cuda_fuse, name, fault(getattr(cuda_fuse, name),
                                               name))
    reg = registry.Registry()
    w = reg.workload(cell)

    class Args:
        seed, seconds, trace = 5, 0.1, 0
    with tempfile.TemporaryDirectory() as work:
        rc = run.measure(Args, w, config, traffic, reg.limits(cell),
                         torch.device('cpu'), 'cpu', 'n/a', work, reg)
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result['correct'] is False, result['checks']
    assert list(result)[-1] == 'checks'


def _run_small(cell, capsys, seed=5, trace=0):
    config, traffic = small(cell)
    reg = registry.Registry()

    class Args:
        seconds = 0.1
    Args.seed, Args.trace = seed, trace
    with tempfile.TemporaryDirectory() as work:
        rc = run.measure(Args, reg.workload(cell), config, traffic,
                         reg.limits(cell), torch.device('cpu'), 'cpu', 'n/a',
                         work, reg)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_an_altered_pair_answer_is_not_correct(monkeypatch, capsys):
    """One pair's refined shift moved by 0.5 px where the program measures
    it, in every pass (the host twin at this size, the batched version on
    the card)."""
    from image_stitcher_tpu_torch.models import pipeline
    calls = []

    def host(orig):
        def fn(a, *args, **kw):
            shift, conf = orig(a, *args, **kw)
            key = np.asarray(a).tobytes()
            calls.append(key)
            return (shift + [0.5, 0.0] if key == calls[0] else shift), conf
        return fn

    def batch(orig):
        def fn(*args, **kw):
            shifts, peaks = orig(*args, **kw)
            calls.append(None)
            shifts[0, 0] += 0.5
            return shifts, peaks
        return fn
    for name, wrap in (('phase_cross_correlation_conf_np', host),
                       ('phase_cross_correlation_conf_batch', batch)):
        monkeypatch.setattr(pipeline, name, wrap(getattr(pipeline, name)))
    result = _run_small('max_quality.region', capsys)
    assert calls
    assert result['correct'] is False, result['checks']
    assert result['checks']['pair_corr_gap']['value'] > \
        result['checks']['pair_corr_gap']['limit']


def test_a_sound_run_is_correct(capsys):
    cell = CELLS[0]
    config, traffic = small(cell)
    reg = registry.Registry()

    class Args:
        seed, seconds, trace = 9, 0.1, 1
    with tempfile.TemporaryDirectory() as work:
        rc = run.measure(Args, reg.workload(cell), config, traffic,
                         reg.limits(cell), torch.device('cpu'), 'cpu', 'n/a',
                         work, reg)
        assert os.listdir(work)
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result['correct'] is True, result['checks']
    assert result['attempted'] > 0 and result['failed'] == 0
    assert set(result['metrics']) >= {'fit.share', 'registration.share',
                                      'ram_fuse.share', 'ram_save.share'}
