#!/usr/bin/env python3
"""PyQt5 stitching GUI with napari preview, for the port.

The counterpart of the JAX package's ``gui.py``. Functional parity with reference stitcher_gui.py:1-318 and
stitcher_process_gui.py:1-450: folder picker, flatfield/registration/
merge checkboxes, registration channel+z selectors populated by a
metadata probe (via the first-class scan_acquisition API instead of the
reference's throwaway pipeline objects, stitcher_process_gui.py:213-232),
output-format combo gating merges to zarr, progress bar driven by a
100 ms queue-polling timer, stop/terminate escalation, and napari
launch with per-channel colormaps.

PyQt5/napari are optional: without them the widgets come from the
headless stand-ins in qt_compat, so the full GUI logic constructs and
drives in tests anywhere; launching the real window (main()) still
requires PyQt5. The window starts the child-process edition on
``device`` ('cuda' by default; the CPU only when asked).
"""

from __future__ import annotations

import queue as queue_mod
import sys

from .qt_compat import (HAVE_QT, QApplication, QCheckBox, QComboBox,
                        QFileDialog, QHBoxLayout, QLabel, QMessageBox,
                        QProgressBar, QPushButton, QSpinBox, QTimer,
                        QVBoxLayout, QWidget)
from .params import EngineOptions, StitchingParameters

# Display colormaps per wavelength (reference stitcher_gui.py:11-20).
CHANNEL_COLORS_MAP = {
    '405': {'hex': 0x3300FF, 'name': 'blue'},
    '488': {'hex': 0x1FFF00, 'name': 'green'},
    '561': {'hex': 0xFFCF00, 'name': 'yellow'},
    '638': {'hex': 0xFF0000, 'name': 'red'},
    '730': {'hex': 0x770000, 'name': 'dark red'},
    'R': {'hex': 0xFF0000, 'name': 'red'},
    'G': {'hex': 0x1FFF00, 'name': 'green'},
    'B': {'hex': 0x3300FF, 'name': 'blue'},
}


class StitchingGUI(QWidget):
    """Main window: configuration panel + progress + viewer hook."""

    POLL_MS = 100  # queue polling period (reference stitcher_process_gui.py:46-49)

    def __init__(self, device='cuda'):
        super().__init__()
        self.device = device
        self.stitcher = None
        self.input_folder = None
        self.output_path = ''
        self._run_complete = False
        self.dtype = None
        self._build_ui()

    # ------------------------------------------------------------------ UI

    def _build_ui(self):
        layout = QVBoxLayout(self)

        self.input_btn = QPushButton("Select Input Folder")
        self.input_btn.clicked.connect(self.select_input_folder)
        layout.addWidget(self.input_btn)

        self.ff_checkbox = QCheckBox("Apply Flatfield Correction")
        layout.addWidget(self.ff_checkbox)

        self.reg_checkbox = QCheckBox("Use Registration")
        self.reg_checkbox.toggled.connect(self.use_registration_checked)
        layout.addWidget(self.reg_checkbox)

        reg_row = QHBoxLayout()
        self.reg_channel_label = QLabel("Registration channel:")
        self.reg_channel_combo = QComboBox()
        self.reg_z_label = QLabel("Z-level:")
        self.reg_z_spin = QSpinBox()
        for w in (self.reg_channel_label, self.reg_channel_combo,
                  self.reg_z_label, self.reg_z_spin):
            reg_row.addWidget(w)
            w.setVisible(False)
        layout.addLayout(reg_row)

        fmt_row = QHBoxLayout()
        fmt_row.addWidget(QLabel("Output format:"))
        self.format_combo = QComboBox()
        self.format_combo.addItems(["OME-ZARR", "OME-TIFF"])
        self.format_combo.currentTextChanged.connect(self.format_changed)
        fmt_row.addWidget(self.format_combo)
        layout.addLayout(fmt_row)

        self.mt_checkbox = QCheckBox("Merge Timepoints")
        self.mw_checkbox = QCheckBox("Merge HCS Regions (Wells)")
        layout.addWidget(self.mt_checkbox)
        layout.addWidget(self.mw_checkbox)

        self.start_btn = QPushButton("Start Stitching")
        self.start_btn.clicked.connect(self.start_stitching)
        layout.addWidget(self.start_btn)

        self.stop_btn = QPushButton("Stop")
        self.stop_btn.clicked.connect(self.stop_stitching)
        self.stop_btn.setEnabled(False)
        layout.addWidget(self.stop_btn)

        self.progress = QProgressBar()
        self._progress_total = 1  # last determinate total (tile count)
        layout.addWidget(self.progress)
        self.status_label = QLabel("Ready")
        layout.addWidget(self.status_label)

        self.view_btn = QPushButton("View Output in Napari")
        self.view_btn.clicked.connect(self.view_output)
        self.view_btn.setEnabled(False)
        layout.addWidget(self.view_btn)

        self.setWindowTitle("Image Stitcher (PyTorch + CUDA)")

        self.timer = QTimer(self)
        self.timer.timeout.connect(self.poll_queues)

    # ------------------------------------------------------------- handlers

    def select_input_folder(self):
        folder = QFileDialog.getExistingDirectory(self, "Select Input Folder")
        if folder:
            self.input_folder = folder
            self.input_btn.setText(f"Selected: {folder}")
            if self.reg_checkbox.isChecked():
                self._populate_registration_fields()

    def use_registration_checked(self, checked: bool):
        for w in (self.reg_channel_label, self.reg_channel_combo,
                  self.reg_z_label, self.reg_z_spin):
            w.setVisible(checked)
        if checked and self.input_folder:
            self._populate_registration_fields()

    def _populate_registration_fields(self):
        """Metadata probe via scan_acquisition (the introspection API)."""
        try:
            from .io.acquisition import scan_acquisition
            acq = scan_acquisition(self.input_folder)
            self.reg_channel_combo.clear()
            self.reg_channel_combo.addItems(acq.channel_names)
            self.reg_z_spin.setRange(0, acq.num_z - 1)
        except Exception as e:
            QMessageBox.warning(self, "Metadata", f"Could not scan: {e}")

    def format_changed(self, text: str):
        """Merges require zarr (reference stitcher_gui.py:254-260)."""
        is_zarr = text == "OME-ZARR"
        self.mt_checkbox.setEnabled(is_zarr)
        self.mw_checkbox.setEnabled(is_zarr)
        if not is_zarr:
            self.mt_checkbox.setChecked(False)
            self.mw_checkbox.setChecked(False)

    def _collect_params(self) -> StitchingParameters:
        fmt = '.ome.zarr' if self.format_combo.currentText() == "OME-ZARR" \
            else '.ome.tiff'
        return StitchingParameters(
            input_folder=self.input_folder,
            output_format=fmt,
            apply_flatfield=self.ff_checkbox.isChecked(),
            use_registration=self.reg_checkbox.isChecked(),
            registration_channel=self.reg_channel_combo.currentText(),
            registration_z_level=self.reg_z_spin.value(),
            merge_timepoints=self.mt_checkbox.isChecked(),
            merge_hcs_regions=self.mw_checkbox.isChecked(),
        )

    def start_stitching(self):
        if not self.input_folder:
            QMessageBox.warning(self, "Input", "Select an input folder first")
            return
        from .models.editions import StitcherProcess
        try:
            params = self._collect_params()
            params.validate()
        except Exception as e:
            QMessageBox.critical(self, "Parameters", str(e))
            return
        self.stitcher = StitcherProcess(params, options=EngineOptions(),
                                        device=self.device)
        self._run_complete = False
        self._error_seen = False
        self.stitcher.start()
        self.start_btn.setEnabled(False)
        self.stop_btn.setEnabled(True)
        self.status_label.setText("Stitching...")
        self.timer.start(self.POLL_MS)

    def poll_queues(self):
        """100 ms poll of the child's queues (reference
        stitcher_process_gui.py:58-94)."""
        s = self.stitcher
        if s is None:
            return
        self._drain_queues(s)
        if not s.is_alive():
            # final drain: the child can enqueue 'complete' and exit
            # between the drain above and the liveness check — without
            # this, a successful run's completion would be lost
            self._drain_queues(s)
            self.timer.stop()
            self.start_btn.setEnabled(True)
            self.stop_btn.setEnabled(False)
            if not self._run_complete and not getattr(self, '_error_seen',
                                                      False):
                # killed without a message (OOM/SIGKILL): without this
                # the label keeps claiming 'Saving...' over a busy
                # animation on a dead run
                self.status_label.setText(
                    "Error: stitching process exited unexpectedly")
                self._restore_determinate_bar()

    def _restore_determinate_bar(self):
        """Leave an indeterminate saving-phase bar determinate again
        (at its last known value) — errors and stops must not keep a
        busy animation running on a dead run."""
        if self.progress.maximum() == 0:
            self.progress.setMaximum(self._progress_total)

    def _drain_queues(self, s):
        saw_progress = False
        try:
            while True:
                kind, data = s.progress_queue.get_nowait()
                if kind == 'progress':
                    cur, total = data
                    # a progress tick restores determinate mode after a
                    # saving phase set the bar indeterminate
                    saw_progress = True
                    self._progress_total = max(total, 1)
                    self.progress.setMaximum(self._progress_total)
                    self.progress.setValue(cur)
        except queue_mod.Empty:
            pass
        try:
            while True:
                kind, data = s.status_queue.get_nowait()
                if kind == 'status':
                    self.status_label.setText(data[0])
                    if len(data) > 1 and data[1] and not saw_progress:
                        # saving phases report is_saving=True: show an
                        # indeterminate busy bar like the reference GUI
                        # (stitcher_process_gui.py:76-79). The two
                        # queues carry no global order, so a saving
                        # event drained alongside progress ticks is
                        # stale (the ticks are from the NEXT region) —
                        # don't flip a progressing bar back to busy.
                        self.progress.setMaximum(0)
                elif kind == 'error':
                    self._error_seen = True
                    self.status_label.setText(f"Error: {data}")
                    self._restore_determinate_bar()
        except queue_mod.Empty:
            pass
        try:
            kind, data = s.complete_queue.get_nowait()
            if kind == 'complete':
                self.output_path, self.dtype = data
                self._run_complete = True
                self.view_btn.setEnabled(True)
                # leave the bar determinate and full after an
                # indeterminate saving phase (reference saving_complete)
                self.progress.setMaximum(self._progress_total)
                self.progress.setValue(self._progress_total)
                self.status_label.setText(f"Complete: {self.output_path}")
        except queue_mod.Empty:
            pass

    def stop_stitching(self):
        """Stop -> join(timeout) -> terminate escalation (reference
        stitcher_process_gui.py:313-341). The wait is sliced so the
        window keeps repainting and shutdown messages keep draining
        instead of freezing for the full 10 s timeout.

        Re-entrancy: the timer stops and both buttons disable BEFORE
        the sliced wait, and the loop holds its own reference — events
        pumped mid-stop can neither restart a run into this method's
        terminate() nor re-enter it."""
        s = self.stitcher
        if s is None:
            return
        import time as _time
        self.timer.stop()
        self.start_btn.setEnabled(False)
        self.stop_btn.setEnabled(False)
        view_was_enabled = self.view_btn.isEnabled()
        self.view_btn.setEnabled(False)  # napari.run() would nest an
        #                                  event loop inside this wait
        s.request_stop()
        deadline = _time.monotonic() + 10.0
        while s.is_alive() and _time.monotonic() < deadline:
            s.join(timeout=0.1)
            self._drain_queues(s)
            # a drained 'complete' re-enables the View button; keep it
            # disabled until the wait ends or a queued click processed
            # by the next processEvents() would nest napari.run()
            # inside this loop — the exact hazard the pre-wait disable
            # guards against
            self.view_btn.setEnabled(False)
            app = QApplication.instance()
            if HAVE_QT and app is not None:
                app.processEvents()
        if s.is_alive():
            s.terminate()
        # final drain: the child can enqueue 'complete' and exit between
        # the last in-loop drain and the liveness check (or before the
        # wait loop ever ran) — without this a successful run's
        # completion would be reported as 'Stopped'
        self._drain_queues(s)
        self.start_btn.setEnabled(True)
        if self._run_complete:
            # the child completed during the wait (or before stop was
            # pressed): keep its 'Complete' status and viewer access
            # instead of claiming 'Stopped'. An explicit flag — a path
            # comparison would misread a re-run that completes into the
            # same output path as "nothing new happened".
            self.view_btn.setEnabled(True)
        else:
            self.view_btn.setEnabled(view_was_enabled)
            self.status_label.setText("Stopped")
            self._restore_determinate_bar()

    def view_output(self):
        """Open the result in napari: per-channel colormaps (named, or
        generated from the channel hex when napari has no colormap of
        that name) and dtype-derived contrast limits (reference
        stitcher_gui.py:262-312, stitcher_process_gui.py:389-419)."""
        try:
            import numpy as np

            import napari
            viewer = napari.Viewer()
            if self.output_path.endswith('.zarr'):
                viewer.open(self.output_path, plugin='napari-ome-zarr')
            else:
                viewer.open(self.output_path)
            for layer in viewer.layers:
                wavelength = self._extract_wavelength(layer.name)
                info = CHANNEL_COLORS_MAP.get(
                    wavelength, {'hex': 0xFFFFFF, 'name': 'gray'})
                layer.colormap = self._resolve_colormap(info)
                dt = getattr(getattr(layer, 'data', None), 'dtype', None)
                if dt is not None and np.issubdtype(dt, np.integer):
                    ii = np.iinfo(dt)
                    layer.contrast_limits = (ii.min, ii.max)
                elif dt is not None and np.issubdtype(dt, np.floating):
                    layer.contrast_limits = (0.0, 1.0)
            napari.run()
        except Exception as e:
            QMessageBox.critical(self, "Viewer", f"Could not open viewer: {e}")

    @staticmethod
    def _resolve_colormap(channel_info):
        """A napari-registered colormap by name, else a linear
        black->channel-color Colormap built from the hex (reference
        stitcher_process_gui.py:404-406 + generateColormap)."""
        try:
            from napari.utils.colormaps import AVAILABLE_COLORMAPS
            if channel_info['name'] in AVAILABLE_COLORMAPS:
                return AVAILABLE_COLORMAPS[channel_info['name']]
        except ImportError:
            pass
        h = channel_info['hex']
        r, g, b = (h >> 16) & 0xFF, (h >> 8) & 0xFF, h & 0xFF
        from napari.utils import Colormap
        return Colormap(colors=[[0.0, 0.0, 0.0, 1.0],
                                [r / 255.0, g / 255.0, b / 255.0, 1.0]],
                        name=channel_info['name'])

    @staticmethod
    def _extract_wavelength(name: str):
        """Channel-name -> wavelength key (reference stitcher_gui.py:294-303)."""
        if 'Fluorescence' in name:
            parts = name.split()
            for i, p in enumerate(parts):
                if p == 'Fluorescence' and i + 1 < len(parts):
                    return parts[i + 1]
        for color in ('R', 'G', 'B'):
            if f'_{color}' in name:
                return color
        return None


def main() -> int:
    if not HAVE_QT:
        print("PyQt5 not available; run the CLI instead:", file=sys.stderr)
        print("  python -m image_stitcher_tpu_torch.cli -i <folder>",
              file=sys.stderr)
        return 1
    app = QApplication(sys.argv)
    gui = StitchingGUI()
    gui.show()
    return app.exec_()


if __name__ == '__main__':
    sys.exit(main())
