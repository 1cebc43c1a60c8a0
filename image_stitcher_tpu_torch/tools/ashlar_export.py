#!/usr/bin/env python3
"""Export an acquisition to per-tile OME-TIFFs and invoke ASHLAR.

The counterpart of the JAX package's ``tools/ashlar_export.py``, through
the port's acquisition scan and tile reader, ``core/geometry.py`` and
``io/tiffwriter.BigTiffWriter``. Parity with reference ashlar_stitcher.py:1-361: each tile becomes a
single-plane OME-TIFF carrying Plate/Well/WellSample + stage-position
OME-XML; then the external ``ashlar`` binary is invoked with
``--tile-size (W//16)*16`` and ``--maximum-shift`` derived from the
stage-geometry overlap estimate. The binary is optional — the export
step works standalone and the command is printed if ashlar is absent.
Every OME-XML ID is a fresh ``uuid.uuid4()``, as the JAX tool's.

Usage:
    python -m image_stitcher_tpu_torch.tools.ashlar_export <input_dir> [-o out.ome.tif] [--keep-temp]
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import subprocess
import sys
import tempfile
import uuid
from typing import List, Optional

import numpy as np

from ..core.geometry import overlap_estimate
from ..io.acquisition import Acquisition, read_image, scan_acquisition
from ..io.tiffwriter import BigTiffWriter


def tile_ome_xml(img: np.ndarray, metadata, pixel_size_um: float,
                 filename: str) -> str:
    """Per-tile OME-XML with Plate/Well/Plane position blocks
    (reference ashlar_stitcher.py:160-199)."""
    from xml.sax.saxutils import quoteattr as q
    x_pos_um = metadata.x * 1000
    y_pos_um = metadata.y * 1000
    z_pos_um = metadata.z
    # Row stays the letter, matching the reference emission verbatim
    # (ashlar_stitcher.py:153-167) — ashlar itself is the consumer
    row, col = metadata.region[0], metadata.region[1:]
    image_id = str(uuid.uuid4())
    return (
        '<?xml version="1.0" encoding="UTF-8"?>'
        '<OME xmlns="http://www.openmicroscopy.org/Schemas/OME/2016-06" '
        'xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance" '
        'xsi:schemaLocation="http://www.openmicroscopy.org/Schemas/OME/2016-06 '
        'http://www.openmicroscopy.org/Schemas/OME/2016-06/ome.xsd">'
        f'<Plate ID="Plate:{uuid.uuid4()}" Name="Plate_1">'
        f'<Well ID="Well:{uuid.uuid4()}" Column={q(col)} Row={q(row)}>'
        f'<WellSample ID="WellSample:{image_id}" Index="{metadata.fov_idx}">'
        f'<ImageRef ID="Image:{image_id}"/></WellSample></Well></Plate>'
        f'<Image ID="Image:{image_id}" '
        f'Name={q(f"{metadata.region}_{metadata.fov_idx}")}>'
        '<Pixels BigEndian="false" DimensionOrder="XYZCT" '
        f'ID="Pixels:{uuid.uuid4()}" Interleaved="false" '
        f'PhysicalSizeX="{pixel_size_um}" PhysicalSizeXUnit="um" '
        f'PhysicalSizeY="{pixel_size_um}" PhysicalSizeYUnit="um" '
        f'SignificantBits="{img.dtype.itemsize * 8}" '
        f'SizeC="1" SizeT="1" SizeX="{img.shape[1]}" SizeY="{img.shape[0]}" '
        f'SizeZ="1" Type="{img.dtype}">'
        f'<Channel ID="Channel:0" Name={q(metadata.channel)} SamplesPerPixel="1" />'
        '<TiffData FirstC="0" FirstT="0" FirstZ="0" IFD="0" PlaneCount="1">'
        f'<UUID FileName={q(filename)}>{image_id}</UUID></TiffData>'
        f'<Plane TheC="0" TheT="0" TheZ="0" PositionX="{x_pos_um}" '
        f'PositionY="{y_pos_um}" PositionZ="{z_pos_um}" /></Pixels></Image></OME>')


class AshlarConverter:
    """Convert an acquisition to ASHLAR-ready per-tile OME-TIFFs."""

    def __init__(self, input_folder: str):
        self.acq: Acquisition = scan_acquisition(input_folder)
        xs, ys = self.acq.region_positions(
            int(self.acq.timepoints[0]), self.acq.regions[0])
        dx_px = ((xs[1] - xs[0]) * 1000 / self.acq.pixel_size_um
                 if len(xs) > 1 else 0)
        dy_px = ((ys[1] - ys[0]) * 1000 / self.acq.pixel_size_um
                 if len(ys) > 1 else 0)
        self.max_x_overlap = overlap_estimate(self.acq.input_width, dx_px,
                                              self.acq.pixel_binning)
        self.max_y_overlap = overlap_estimate(self.acq.input_height, dy_px,
                                              self.acq.pixel_binning)
        self.max_shift = (max(self.max_x_overlap, self.max_y_overlap)
                          * self.acq.pixel_size_um)
        self.channel_names = self.acq.channel_names
        self.input_width = self.acq.input_width

    def run(self, temp_dir: Optional[str] = None) -> str:
        """Write one OME-TIFF per tile; returns the directory."""
        temp_dir = temp_dir or tempfile.mkdtemp(prefix='ashlar_export_')
        os.makedirs(temp_dir, exist_ok=True)
        for key, rec in self.acq.tiles.items():
            t, region, fov, z, channel = key
            img = read_image(rec.filepath)
            if img.ndim == 3:
                img = img[..., 0]
            # reference naming (ashlar_stitcher.py:238): the timepoint
            # prefix keeps multi-timepoint acquisitions from clobbering
            # each other's tiles
            fname = (f"{t:03d}_{region}_{fov:03d}_{z:03d}_"
                     f"{channel.replace(' ', '_')}.ome.tif")
            out_path = os.path.join(temp_dir, fname)
            xml = tile_ome_xml(img, rec, self.acq.pixel_size_um, fname)
            w = BigTiffWriter(out_path, compression='none')
            w.add_plane([img], description=xml)
            w.close()
        return temp_dir


def build_ashlar_command(converter: AshlarConverter, input_files: List[str],
                         output: str, filter_sigma: float = 0.0,
                         stitch_alpha: float = 0.01,
                         maximum_shift: Optional[float] = None,
                         align_channel: Optional[str] = None,
                         no_alignment: bool = False) -> List[str]:
    """Assemble the ashlar invocation (reference ashlar_stitcher.py:291-325)."""
    tile_size = (converter.input_width // 16) * 16
    cmd = ['ashlar', '--output', output, '--tile-size', str(tile_size),
           '--filter-sigma', str(filter_sigma),
           '--stitch-alpha', str(stitch_alpha)]
    if not no_alignment:
        max_shift = maximum_shift if maximum_shift is not None \
            else converter.max_shift
        cmd.extend(['--maximum-shift', str(max_shift)])
        if align_channel:
            try:
                idx = converter.channel_names.index(align_channel)
                cmd.extend(['--align-channel', str(idx)])
            except ValueError:
                print(f"Warning: Could not find channel {align_channel}")
    cmd.extend(input_files)
    return cmd


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Export acquisition to OME-TIFFs and stitch with ASHLAR")
    parser.add_argument('input_dir')
    parser.add_argument('--output', '-o', default='ashlar_output.ome.tif')
    parser.add_argument('--filter-sigma', type=float, default=0.0)
    parser.add_argument('--stitch-alpha', type=float, default=0.01)
    parser.add_argument('--maximum-shift', type=float, default=None)
    parser.add_argument('--align-channel', default=None)
    parser.add_argument('--no-alignment', action='store_true')
    parser.add_argument('--keep-temp', action='store_true')
    args = parser.parse_args(argv)

    temp_dir = None
    try:
        converter = AshlarConverter(args.input_dir)
        temp_dir = converter.run()
        input_files = sorted(glob.glob(os.path.join(temp_dir, "*.ome.tif")))
        if not input_files:
            raise RuntimeError("No OME-TIFF files produced")
        cmd = build_ashlar_command(converter, input_files, args.output,
                                   args.filter_sigma, args.stitch_alpha,
                                   args.maximum_shift, args.align_channel,
                                   args.no_alignment)
        if shutil.which('ashlar') is None:
            print("ashlar binary not found; export complete. Command:")
            print(' '.join(cmd))
            return 0
        print("Running ASHLAR command:", ' '.join(cmd))
        result = subprocess.run(cmd, capture_output=True, text=True)
        if result.stdout:
            print(result.stdout)
        if result.returncode != 0:
            print(result.stderr, file=sys.stderr)
        return result.returncode
    finally:
        if temp_dir and not args.keep_temp:
            shutil.rmtree(temp_dir, ignore_errors=True)


if __name__ == '__main__':
    sys.exit(main())
