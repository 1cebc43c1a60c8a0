"""Run manifest: checkpoint and resume for stitching runs.

The counterpart of the JAX package's ``utils/manifest.py``, in the same
format, so either package resumes the other's run folder. Every run
writes ``.stitch_manifest.json`` into its output folder: the parameters
and output-affecting options, the registration shifts (and the global
positions), the fitted flatfields (a ``flatfields.npz`` sidecar) and
the (timepoint, region) units completed so far, saved atomically after
each unit. :func:`find_resumable` finds the newest compatible unfinished
manifest, so an interrupted run goes on in place, skipping the finished
units and reusing the measured calibrations.
"""

from __future__ import annotations

import glob
import json
import os
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np

MANIFEST_NAME = ".stitch_manifest.json"
FLATFIELD_NAME = "flatfields.npz"


class RunManifest:
    def __init__(self, output_folder: str, suffix: str = ""):
        # ``suffix`` keeps apart the manifests of shards that share an
        # output folder
        self.path = os.path.join(output_folder, MANIFEST_NAME + suffix)
        self.output_folder = output_folder
        self.data: Dict = {
            "version": 1,
            "params": None,
            "shifts": None,
            "completed": [],
            "merges_done": False,
            "finished": False,
            "global_positions": None,
        }

    # ------------------------------------------------------------------ io

    def save(self) -> None:
        os.makedirs(self.output_folder, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.output_folder, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(self.data, f, indent=2)
        os.replace(tmp, self.path)  # atomic

    @classmethod
    def load(cls, output_folder: str,
             suffix: str = "") -> Optional["RunManifest"]:
        m = cls(output_folder, suffix=suffix)
        try:
            with open(m.path) as f:
                m.data = json.load(f)
            return m
        except Exception:
            return None

    # ------------------------------------------------------------- content

    def set_params(self, params_dict: Dict,
                   options_fingerprint: Optional[Dict] = None) -> None:
        self.data["params"] = params_dict
        if options_fingerprint is not None:
            self.data["engine_options"] = options_fingerprint

    def compatible_with(self, params_dict: Dict,
                        options_fingerprint: Optional[Dict] = None) -> bool:
        saved = dict(self.data.get("params") or {})
        if saved != dict(params_dict):
            return False
        if options_fingerprint is not None:
            saved_opts = self.data.get("engine_options")
            # a manifest without a fingerprint stays resumable
            if saved_opts is not None and saved_opts != options_fingerprint:
                return False
        return True

    def set_shifts(self, shifts) -> None:
        self.data["shifts"] = {
            "h_shift": list(shifts.h_shift),
            "v_shift": list(shifts.v_shift),
            "h_shift_rev": list(shifts.h_shift_rev),
            "h_shift_rev_odd": shifts.h_shift_rev_odd,
            "scan_pattern": shifts.scan_pattern,
        }

    def get_shifts(self):
        from ..core.geometry import RegistrationShifts
        s = self.data.get("shifts")
        if not s:
            return None
        return RegistrationShifts(
            h_shift=tuple(s["h_shift"]), v_shift=tuple(s["v_shift"]),
            h_shift_rev=tuple(s["h_shift_rev"]),
            h_shift_rev_odd=s["h_shift_rev_odd"],
            scan_pattern=s["scan_pattern"])

    def save_flatfields(self, flatfields: Dict[int, np.ndarray]) -> None:
        if not flatfields:
            return
        os.makedirs(self.output_folder, exist_ok=True)
        path = os.path.join(self.output_folder, FLATFIELD_NAME)
        # a temporary file, then a rename: a reader never sees half a zip
        fd, tmp = tempfile.mkstemp(dir=self.output_folder, suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                # uncompressed, as the JAX package stores them
                np.savez(f, **{str(k): v for k, v in flatfields.items()})
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def load_flatfields(self) -> Dict[int, np.ndarray]:
        path = os.path.join(self.output_folder, FLATFIELD_NAME)
        if not os.path.exists(path):
            return {}
        with np.load(path) as z:
            return {int(k): z[k] for k in z.files}

    def set_global_positions(self, positions: Dict,
                             positions_float: Optional[Dict] = None) -> None:
        """positions: {region: {(row, col): (y, x)}} -> JSON lists; the
        float positions (subpixel placement) are kept beside the ints."""
        self.data["global_positions"] = {
            region: [[r, c, y, x] for (r, c), (y, x) in per.items()]
            for region, per in positions.items()}
        if positions_float:
            self.data["global_positions_float"] = {
                region: [[r, c, y, x] for (r, c), (y, x) in per.items()]
                for region, per in positions_float.items()}

    def get_global_positions(self) -> Tuple[Dict, Dict]:
        """(int positions, float positions), keyed by region."""
        def parse(raw, cast):
            if not raw:
                return {}
            return {region: {(int(r), int(c)): (cast(y), cast(x))
                             for r, c, y, x in entries}
                    for region, entries in raw.items()}

        return (parse(self.data.get("global_positions"), int),
                parse(self.data.get("global_positions_float"), float))

    def mark_finished(self) -> None:
        self.data["finished"] = True
        self.save()

    def mark_completed(self, t, region: str) -> None:
        key = f"{t}/{region}"
        if key not in self.data["completed"]:
            self.data["completed"].append(key)
        self.save()

    def is_completed(self, t, region: str) -> bool:
        return f"{t}/{region}" in self.data["completed"]


def find_resumable(input_folder: str, params_dict: Dict,
                   options_fingerprint: Optional[Dict] = None) -> Optional[str]:
    """The newest output folder of this acquisition with a compatible,
    UNFINISHED manifest; None when a fresh run is needed (a finished run
    is never resumed)."""
    candidates = sorted(glob.glob(input_folder + "_stitched_*"), reverse=True)
    for folder in candidates:
        m = RunManifest.load(folder)
        if (m is not None
                and m.compatible_with(params_dict, options_fingerprint)
                and not m.data.get("finished")):
            return folder
    return None
