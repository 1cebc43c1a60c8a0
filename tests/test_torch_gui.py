"""Drive the port's GUI end to end through the headless stand-ins.

The JAX package's ``tests/test_gui_driven.py`` scenarios on the port's
``gui.StitchingGUI(device='cpu')``: folder pick, the registration probe
filling the channel and z fields, the format gating of the merges, a
start that spawns the real child-process edition, queue polling into
the progress bar to completion, the stop escalation, and the saving /
error bar states. Besides: the window on its default device ('cuda')
on this host without CUDA shows the child's error and never completes;
the run's tree equals the JAX GUI's run; ``main()`` without PyQt5
returns 1 as the JAX GUI's does; the viewer without napari reports in
a dialog. PyQt5 and napari are absent here and on the card's host, so
``qt_compat`` gives the stand-ins.
"""

import json
import os
import time

import pytest

from fixtures import write_synthetic_acquisition
from torch_helpers import assert_trees_equal
from image_stitcher_tpu import gui as jax_gui
from image_stitcher_tpu_torch import gui as gui_mod
from image_stitcher_tpu_torch import qt_compat
from image_stitcher_tpu_torch.gui import StitchingGUI


@pytest.fixture(scope="module")
def qapp():
    app = qt_compat.QApplication.instance()
    if app is None:
        app = qt_compat.QApplication([])
    return app


def _pump(gui, timeout=180.0):
    """Poll the child's queues as the 100 ms timer would, until the child
    exits."""
    t0 = time.time()
    while time.time() - t0 < timeout:
        gui.poll_queues()
        if gui.stitcher is not None and not gui.stitcher.is_alive():
            gui.poll_queues()
            return
        time.sleep(0.05)
    raise AssertionError("stitcher child did not finish in time")


def _acq(tmp_path, name="acq", grid=2):
    folder = str(tmp_path / name)
    write_synthetic_acquisition(folder, grid_cols=grid, grid_rows=grid,
                                tile_w=64, tile_h=64, overlap=16,
                                acq_params_overrides={"pixel_binning": 2})
    return folder


def test_stand_ins_are_in_use():
    assert not qt_compat.HAVE_QT
    assert qt_compat.QTimer is not None and gui_mod.QWidget is \
        qt_compat.QWidget


def test_gui_full_run(tmp_path, monkeypatch, qapp):
    acq_dir = _acq(tmp_path)
    gui = StitchingGUI(device='cpu')
    assert gui.device == 'cpu'

    # 1. folder pick through the real handler (the dialog patched)
    monkeypatch.setattr(gui_mod.QFileDialog, "getExistingDirectory",
                        staticmethod(lambda *a, **k: acq_dir))
    gui.select_input_folder()
    assert gui.input_folder == acq_dir
    assert acq_dir in gui.input_btn.text()

    # 2. registration toggle: the fields appear, the probe fills them
    assert not gui.reg_channel_combo.isVisible()
    gui.reg_checkbox.setChecked(True)
    assert gui.reg_channel_combo.isVisible()
    assert gui.reg_channel_combo.count() >= 1
    assert "Fluorescence" in gui.reg_channel_combo.currentText()
    assert gui.reg_z_spin.maximum() == 0

    # 3. format gating: TIFF disables the merges
    gui.mt_checkbox.setChecked(True)
    gui.format_combo.setCurrentText("OME-TIFF")
    assert not gui.mt_checkbox.isEnabled() and not gui.mt_checkbox.isChecked()
    gui.format_combo.setCurrentText("OME-ZARR")
    assert gui.mt_checkbox.isEnabled()

    # 4. start: spawns the real child-process edition on the CPU
    gui.start_stitching()
    assert gui.stitcher is not None and gui.stitcher.device == 'cpu'
    assert not gui.start_btn.isEnabled() and gui.stop_btn.isEnabled()
    assert gui.timer.isActive()

    # 5. poll to completion
    _pump(gui)
    assert gui.progress.value() == gui.progress.maximum() > 0
    assert gui.output_path.endswith("A1_stitched.ome.zarr")
    assert os.path.isdir(gui.output_path)
    assert gui.view_btn.isEnabled()
    assert "Complete" in gui.status_label.text()
    assert not gui.timer.isActive()
    assert gui.start_btn.isEnabled() and not gui.stop_btn.isEnabled()
    assert gui.stitcher.exitcode == 0


def _shared_disk_probe(tmp_path, monkeypatch):
    """One disk probe result for both GUIs' children. Each GUI runs with
    ``compressor_cname='auto'``, whose choice between raw and blosc-lz4
    chunks asks the output disk's write rate (``io/directio.py``), timed
    once per package in the spawned child and cached under HOME: on a
    loaded machine the two timings could fall on either side of the
    300 MB/s-a-core gate, and the two runs then stored different chunks.
    A HOME of the test's own, holding the same probe entry in both
    packages' caches, gives both children one measurement; the 'auto'
    choice itself still runs in each."""
    from image_stitcher_tpu.io import directio as jax_directio
    from image_stitcher_tpu_torch.io import directio
    home = tmp_path / "home"
    monkeypatch.setenv("HOME", str(home))
    entry = {"ts": time.time(), "buffered_mbps": 200.0,
             "direct_mbps": 200.0}
    for pkg, mod in (('image_stitcher_tpu', jax_directio),
                     ('image_stitcher_tpu_torch', directio)):
        cache = home / ".cache" / pkg
        cache.mkdir(parents=True)
        with open(cache / "directio.json", 'w') as f:
            json.dump({mod._cache_key(str(tmp_path)): entry}, f)


def test_gui_run_equals_the_jax_gui_run(tmp_path, qapp, monkeypatch):
    """The same clicks on both GUIs (registration on, channel and z from
    the probe): equal trees."""
    _shared_disk_probe(tmp_path, monkeypatch)
    paths = {}
    for name, mod, kw in (('jax', jax_gui, {}), ('port', gui_mod,
                                                {'device': 'cpu'})):
        acq_dir = _acq(tmp_path / name)
        gui = mod.StitchingGUI(**kw)
        gui.input_folder = acq_dir
        gui.reg_checkbox.setChecked(True)
        gui.ff_checkbox.setChecked(True)
        gui.start_stitching()
        _pump(gui)
        assert "Complete" in gui.status_label.text(), gui.status_label.text()
        paths[name] = gui.output_path
        with open(os.path.join(gui.output_path, '0', '.zarray')) as f:
            # the shared probe's slow disk: both runs chose blosc-lz4
            assert json.load(f)['compressor']['cname'] == 'lz4'
    assert_trees_equal(paths['jax'], paths['port'])


def test_gui_start_without_folder_warns(qapp):
    gui = StitchingGUI(device='cpu')
    qt_compat.QMessageBox.messages.clear()
    gui.start_stitching()
    assert gui.stitcher is None
    assert any(m[0] == 'warning' for m in qt_compat.QMessageBox.messages)


def test_gui_stop_escalation(tmp_path, qapp):
    """Stop -> request_stop -> join -> (terminate): the child exits, the
    window returns to its ready state."""
    acq_dir = _acq(tmp_path, grid=3)
    gui = StitchingGUI(device='cpu')
    gui.input_folder = acq_dir
    gui.start_stitching()
    gui.stop_stitching()
    assert not gui.stitcher.is_alive()
    assert gui.status_label.text() == "Stopped"
    assert gui.start_btn.isEnabled() and not gui.stop_btn.isEnabled()
    assert not gui.timer.isActive()


def test_gui_default_device_without_cuda_shows_the_error(tmp_path, qapp):
    """Left on 'cuda' on this host without CUDA, the child reports the
    error and exits 1; the window shows it and never completes."""
    acq_dir = _acq(tmp_path)
    gui = StitchingGUI()
    assert gui.device == 'cuda'
    gui.input_folder = acq_dir
    gui.start_stitching()
    _pump(gui)
    assert gui.stitcher.exitcode == 1
    assert gui.status_label.text().startswith("Error: ")
    assert "torch.cuda.is_available() is false" in gui.status_label.text()
    assert not gui.view_btn.isEnabled() and not gui._run_complete
    assert gui.progress.maximum() > 0


def test_error_and_stale_saving_restore_determinate_bar(qapp):
    """An 'error' after a saving phase, and a stale saving event drained
    with newer progress ticks, leave the bar determinate."""
    import queue

    class FakeStitcher:
        def __init__(self):
            self.progress_queue = queue.Queue()
            self.status_queue = queue.Queue()
            self.complete_queue = queue.Queue()

    gui = StitchingGUI(device='cpu')
    s = FakeStitcher()
    s.status_queue.put(('status', ('Saving...', True)))
    gui._drain_queues(s)
    assert gui.progress.maximum() == 0
    s.status_queue.put(('error', 'disk full'))
    gui._drain_queues(s)
    assert gui.progress.maximum() > 0
    assert "Error" in gui.status_label.text()
    s.progress_queue.put(('progress', (3, 10)))
    s.status_queue.put(('status', ('Saving...', True)))
    gui._drain_queues(s)
    assert gui.progress.maximum() == 10 and gui.progress.value() == 3
    s.status_queue.put(('status', ('Saving...', True)))
    gui._drain_queues(s)
    assert gui.progress.maximum() == 0


def test_main_without_pyqt5_returns_1_as_jax(capsys):
    assert gui_mod.main() == 1 == jax_gui.main()
    err = capsys.readouterr().err
    assert "PyQt5 not available" in err
    assert "python -m image_stitcher_tpu_torch.cli" in err


def test_viewer_without_napari_reports_in_a_dialog(qapp):
    gui = StitchingGUI(device='cpu')
    gui.output_path = '/nonexistent.ome.zarr'
    qt_compat.QMessageBox.messages.clear()
    gui.view_output()
    [msg] = qt_compat.QMessageBox.messages
    assert msg[0] == 'critical' and msg[1] == 'Viewer'
    assert 'napari' in msg[2]
    assert StitchingGUI._extract_wavelength('Fluorescence 488 nm Ex') == '488'
    assert StitchingGUI._extract_wavelength('BF_LED_matrix_G') == 'G'
