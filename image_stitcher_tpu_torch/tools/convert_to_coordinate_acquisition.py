#!/usr/bin/env python3
"""Convert flexible (i,j)-grid acquisitions to coordinate acquisitions.

The counterpart of the JAX package's
``tools/convert_to_coordinate_acquisition.py`` (behavior parity with
reference convert_to_coordinate_acquisition.py:1-133), without pandas:
back up the whole acquisition to ``{name}_old``, remap grid indices to
``fov = i * (max_j + 1) + j``, rewrite coordinates.csv to the
region/fov schema (the bytes pandas writes, ``utils/csvtable.py``), and
rename every tiff accordingly. It refuses an acquisition that is
already converted and never overwrites an existing backup.

Usage:
    python -m image_stitcher_tpu_torch.tools.convert_to_coordinate_acquisition <directory> [--region NAME]
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path
from typing import Dict, Optional

from ..utils.csvtable import Column, is_missing, read_csv, write_csv


def get_region_from_files(directory: Path) -> str:
    for file in directory.glob('*.tiff'):
        return file.name.split('_')[0]
    raise ValueError("No .tiff files found in directory")


def validate_directories(subdirs) -> bool:
    for subdir in subdirs:
        if not (subdir / 'coordinates.csv').exists():
            raise ValueError(f"coordinates.csv not found in {subdir}")
        if not any(subdir.glob('*.tiff')):
            raise ValueError(f"No .tiff files found in {subdir}")
    return True


def _fov_column(df: Dict[str, Column], max_j: int) -> Column:
    """``df['i'] * max_j + df['j']`` with pandas' dtype rule: int64 when
    both are, else float64 (missing cells stay missing)."""
    (ki, iv), (kj, jv) = df['i'], df['j']
    if ki == kj == 'int':
        return 'int', [i * max_j + j for i, j in zip(iv, jv)]
    return 'float', [float('nan') if is_missing(i) or is_missing(j)
                     else float(i) * max_j + float(j)
                     for i, j in zip(iv, jv)]


def process_directory(input_dir: Path, subdir: Path, region: str,
                      max_j: int, df: Dict[str, Column]) -> int:
    rows = zip(df['i'][1], df['j'][1], df['z_level'][1])
    position_map = {
        (int(i), int(j), int(z)): (int(i) * max_j + int(j), int(z))
        for i, j, z in rows
    }

    n = len(df['i'][1])
    new = {
        'region': ('object', [region] * n),
        'fov': _fov_column(df, max_j),
        'z_level': df['z_level'],
        'x (mm)': df['x (mm)'],
        'y (mm)': df['y (mm)'],
        'z (um)': df['z (um)'],
    }
    write_csv(str(subdir / 'coordinates.csv'), new)

    for file in subdir.glob('*.tiff'):
        file.unlink()

    old_subdir = input_dir.parent / f"{input_dir.name}_old" / subdir.name
    renamed = 0
    for file_path in old_subdir.glob('*.tiff'):
        try:
            parts = file_path.name.split('_')
            i, j, k = map(int, parts[1:4])
            channel_part = '_'.join(parts[4:])
            fov, k = position_map[(i, j, k)]
            new_name = f"{region}_{fov}_{k}_{channel_part}"
            shutil.copy2(file_path, subdir / new_name)
            renamed += 1
        except (ValueError, KeyError, OSError) as e:
            print(f"Error processing {file_path.name}: {e}")
    return renamed


def _max_j(df: Dict[str, Column]) -> int:
    values = [v for v in df['j'][1] if not is_missing(v)]
    return int(max(values)) + 1


def convert(directory: str, region: Optional[str] = None) -> int:
    input_dir = Path(directory)
    if not input_dir.exists():
        raise ValueError(f"Directory not found: {input_dir}")
    subdirs = sorted((d for d in input_dir.iterdir()
                      if d.is_dir() and d.name.isdigit()),
                     key=lambda x: int(x.name))
    if not subdirs:
        raise ValueError("No numbered subdirectories found")
    validate_directories(subdirs)

    # refuse to run if the coordinates are already in the converted
    # schema (an 'i'/'j'-less csv) — a second run used to destroy the
    # only backup of the original data before failing
    probe = read_csv(str(subdirs[0] / 'coordinates.csv'), nrows=1)
    if 'i' not in probe or 'j' not in probe:
        raise ValueError(
            f"{subdirs[0] / 'coordinates.csv'} has no i/j columns — this "
            "acquisition looks already converted; refusing to run")

    backup_dir = input_dir.parent / f"{input_dir.name}_old"
    if backup_dir.exists():
        # never delete an existing backup: it may hold the only copy of
        # the original grid-format data from a previous (failed) run
        raise ValueError(
            f"Backup directory already exists: {backup_dir}. Move it "
            "aside (or restore from it) before converting again.")
    print(f"Creating backup: {backup_dir}")
    shutil.copytree(input_dir, backup_dir)

    if region is None:
        region = get_region_from_files(subdirs[0])
        print(f"Using region: {region}")

    # one fov stride for the WHOLE acquisition: a truncated timepoint
    # must not renumber the same physical (i, j) tile differently
    # (each csv reads once; the table feeds the rewrite too)
    frames = {subdir: read_csv(str(subdir / 'coordinates.csv'))
              for subdir in subdirs}
    max_j = max(_max_j(df) for df in frames.values())

    total = 0
    for subdir in subdirs:
        count = process_directory(input_dir, subdir, region, max_j,
                                  frames[subdir])
        total += count
        print(f"Processed {count} files in {subdir.name}/")
    print(f"\nTotal files processed: {total}")
    return total


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('directory',
                        help='Parent directory containing numbered subdirectories')
    parser.add_argument('--region', type=str, default=None,
                        help='New region name (default: use existing region)')
    args = parser.parse_args(argv)
    try:
        convert(args.directory, args.region)
        return 0
    except Exception as e:
        print(f"Error: {e}")
        return 1


if __name__ == '__main__':
    sys.exit(main())
