#!/usr/bin/env python3
"""Rewrite old-format coordinates.csv files to the current Squid schema.

The counterpart of the JAX package's ``tools/update_coordinates.py``
(behavior parity with reference update_coordinates.py:1-137), without
pandas: derive (region, fov, z_level) per image from filenames, order
unique combinations by earliest file mtime, and rewrite coordinates.csv
with region/fov columns prepended to the original coordinate columns.
The file is read and written as pandas reads and writes it
(``utils/csvtable.py``), so its bytes are the JAX tool's.

Usage:
    python -m image_stitcher_tpu_torch.tools.update_coordinates <parent_folder>
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Tuple

from ..utils.csvtable import Column, read_csv, write_csv

IMAGE_EXTENSIONS = ('.tiff', '.bmp', '.jpg', '.png')


def get_image_info(filename: str) -> Dict:
    """Extract region, fov, z_level from an (old-format) image filename.

    z_level is the first all-digit part between underscores (excluding
    the first two and last parts); fov is the part right before it and
    region everything earlier (reference update_coordinates.py:7-34).
    """
    base_name = os.path.splitext(filename)[0]
    parts = base_name.split('_')
    z_level_index = None
    z_level = None
    for i, part in enumerate(parts[2:-1], 2):
        if part.isdigit():
            z_level_index = i
            z_level = int(part)
            break
    if z_level_index is None:
        raise ValueError(f"Could not find z_level in filename: {filename}")
    region = '_'.join(parts[:z_level_index - 1])
    fov = parts[z_level_index - 1]
    return {'region': region, 'fov': fov, 'z_level': z_level}


def process_folder(folder_path: str) -> Dict[str, Column]:
    """Rewrite one timepoint folder's coordinates.csv; returns its
    columns."""
    coords_path = os.path.join(folder_path, 'coordinates.csv')
    coords = read_csv(coords_path)
    n_rows = max((len(v) for _, v in coords.values()), default=0)

    image_files = [f for f in os.listdir(folder_path)
                   if f.lower().endswith(IMAGE_EXTENSIONS)]

    info_by_key: Dict[Tuple, Dict] = {}
    for img_file in image_files:
        try:
            path = os.path.join(folder_path, img_file)
            ts = os.path.getmtime(path)
            info = get_image_info(img_file)
            key = (info['region'], info['fov'], info['z_level'])
            if key not in info_by_key or ts < info_by_key[key]['timestamp']:
                info_by_key[key] = {'timestamp': ts, 'region': info['region'],
                                    'fov': info['fov'],
                                    'z_level': info['z_level']}
        except Exception as e:
            print(f"Error processing file {img_file}: {e}")

    ordered = sorted(info_by_key.values(), key=lambda x: x['timestamp'])
    # the rewrite pairs image-derived rows with csv rows POSITIONALLY
    # (mtime order vs acquisition order — the reference's contract);
    # a count mismatch would silently shift every later coordinate and
    # rewrite the file corrupted, so refuse instead
    if len(ordered) != n_rows:
        raise ValueError(
            f"{coords_path}: {n_rows} coordinate rows but "
            f"{len(ordered)} unique (region, fov, z) images — counts "
            "must match for the positional rewrite; fix the folder "
            "before updating")
    new: Dict[str, Column] = {
        'region': ('object', [i['region'] for i in ordered]),
        'fov': ('object', [i['fov'] for i in ordered]),
    }
    for col in ('z_level', 'x (mm)', 'y (mm)', 'z (um)', 'time'):
        if col in coords:
            new[col] = coords[col]
    write_csv(coords_path, new)
    print(f"Updated coordinates saved to: {coords_path}")
    return new


def process_parent_folder(parent_folder: str) -> None:
    subfolders = [e.path for e in os.scandir(parent_folder) if e.is_dir()]
    for folder in subfolders:
        print(f"\nProcessing folder: {os.path.basename(folder)}")
        process_folder(folder)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description='Update coordinates.csv files to match the format in '
                    'latest Squid software.')
    parser.add_argument('parent_folder',
                        help='Parent folder containing timepoint subfolders')
    args = parser.parse_args(argv)
    if not os.path.exists(args.parent_folder):
        print(f"Error: Folder '{args.parent_folder}' does not exist!")
        return 1
    process_parent_folder(args.parent_folder)
    return 0


if __name__ == '__main__':
    sys.exit(main())
