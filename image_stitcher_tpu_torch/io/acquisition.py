"""Acquisition dataset model: scan, parse, index a Squid acquisition folder.

The counterpart of the JAX package's ``io/acquisition.py``, with the same
``Acquisition`` record, the same tile keys and the same tile order, but
without pandas: ``coordinates.csv`` is read with the :mod:`csv` module,
and the column typing pandas would apply is reproduced where it changes
a result (region names, see :func:`_region_names`). Tile order matters
beyond the index: the flatfield sampler shuffles paths in
``Acquisition.tiles`` order.

Layout expected on disk:

    input_folder/
      acquisition parameters.json
      0/                       # numeric timepoint dirs
        coordinates.csv        # region, fov, z_level, x (mm), y (mm), z (um)
        {region}_{fov}_{z}_{channel}.{bmp|tiff|tif|jpg|jpeg|png}
      1/
        ...

Tiles are decoded without OpenCV (:func:`read_image`): uncompressed
TIFF through the zero-copy fast path, compressed TIFF, PNG and BMP
through the port's own readers (C for LZW, PackBits, the TIFF predictor
and PNG filters; zlib for deflate), baseline JPEG through the port's own
C codec (``io/jpeg.py``).
"""

from __future__ import annotations

import csv
import json
import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.colors import get_channel_color
from .bmp import decode_bmp
from .fast_tiff import read_tiff_fast
from .jpeg import decode as decode_jpeg
from .png import decode_png
from .tiff import decode_tiff
from .tile_decode import DecodeError

# the bare 'tif' entry makes any filename *ending* in "tif" match, with
# or without a dot (as in the JAX package and its reference)
IMAGE_SUFFIXES = ('.bmp', '.tiff', 'tif', 'jpg', 'jpeg', 'png')

TileKey = Tuple[int, str, int, int, str]  # (t, region, fov, z_level, channel)


@dataclass(frozen=True)
class TileRecord:
    """One image tile joined with its stage coordinates."""
    filepath: str
    x: float          # stage x in mm
    y: float          # stage y in mm
    z: float          # stage z in um
    channel: str
    z_level: int
    region: str
    fov_idx: int
    t: int


@dataclass
class Acquisition:
    """Fully-indexed acquisition: tile index + optics + derived dims."""
    input_folder: str
    timepoints: List[str]
    acquisition_params: Dict
    pixel_size_um: float
    pixel_binning: int
    tiles: Dict[TileKey, TileRecord]
    regions: List[str]
    channel_names: List[str]
    monochrome_channels: List[str]
    monochrome_colors: List[int]
    num_t: int
    num_z: int
    num_c: int
    num_fovs_per_region: int
    input_height: int
    input_width: int
    dtype: np.dtype
    rgb_channels: List[str] = field(default_factory=list)

    @property
    def dz_um(self) -> float:
        return float(self.acquisition_params.get('dz(um)', 1.0))

    def region_tiles(self, t: int, region: str) -> Dict[TileKey, TileRecord]:
        """All tiles for one (timepoint, region), in index order."""
        t = int(t)
        data = {k: v for k, v in self.tiles.items() if k[0] == t and k[1] == region}
        if not data:
            raise ValueError(f"No data found for timepoint {t}, region {region}")
        return data

    def region_positions(self, t: int, region: str) -> Tuple[List[float], List[float]]:
        """Sorted unique stage x and y positions for a region."""
        data = self.region_tiles(t, region)
        xs = sorted({rec.x for rec in data.values()})
        ys = sorted({rec.y for rec in data.values()})
        return xs, ys

    @staticmethod
    def _quantize_mm(v: float) -> int:
        """Stage coordinate -> index key, quantized to 0.1 um."""
        return round(float(v) * 10000)

    def find_tile(self, t: int, region: str, x: float, y: float,
                  channel: str, z_level: int) -> Optional[TileRecord]:
        """Locate a tile by stage position, through a lazily-built index."""
        if getattr(self, '_pos_index', None) is None:
            object.__setattr__(self, '_pos_index', {
                (rec.t, rec.region, self._quantize_mm(rec.x),
                 self._quantize_mm(rec.y), rec.channel, rec.z_level): rec
                for rec in self.tiles.values()})
        return self._pos_index.get(
            (int(t), str(region), self._quantize_mm(x),
             self._quantize_mm(y), channel, z_level))

    def rows_and_columns(self) -> Tuple[List[str], List[str]]:
        """HCS well rows/columns from region names (row = name[0])."""
        rows = sorted({r[0] for r in self.regions})
        columns = sorted({r[1:] for r in self.regions})
        return rows, columns


def scan_timepoints(input_folder: str) -> List[str]:
    """Numeric subdirectories sorted as integers."""
    tps = [d for d in os.listdir(input_folder)
           if os.path.isdir(os.path.join(input_folder, d)) and d.isdigit()]
    tps.sort(key=int)
    return tps


def load_acquisition_params(input_folder: str) -> Dict:
    path = os.path.join(input_folder, 'acquisition parameters.json')
    with open(path, 'r') as f:
        return json.load(f)


def compute_pixel_size(acquisition_params: Dict) -> Tuple[float, int]:
    """Physical pixel size (um) from optics metadata, and the binning."""
    obj_mag = acquisition_params['objective']['magnification']
    obj_tube_lens_mm = acquisition_params['objective']['tube_lens_f_mm']
    sensor_pixel_size_um = acquisition_params['sensor_pixel_size_um']
    tube_lens_mm = acquisition_params['tube_lens_mm']
    pixel_binning = acquisition_params.get('pixel_binning', 1)
    obj_focal_length_mm = obj_tube_lens_mm / obj_mag
    actual_mag = tube_lens_mm / obj_focal_length_mm
    pixel_size_um = sensor_pixel_size_um / actual_mag
    return pixel_size_um, pixel_binning


def parse_tile_filename(filename: str) -> Optional[Tuple[str, int, int, str]]:
    """Parse ``{region}_{fov}_{z_level}_{channel}.{ext}`` -> components,
    or None for non-image and focus-camera files."""
    if not filename.endswith(IMAGE_SUFFIXES) or 'focus_camera' in filename:
        return None
    if filename.startswith('.'):
        return None
    parts = filename.split('_', 3)
    if len(parts) < 4:
        return None
    try:
        region, fov, z_level = parts[0], int(parts[1]), int(parts[2])
    except ValueError:
        return None
    channel = os.path.splitext(parts[3])[0]
    channel = channel.replace("_", " ").replace("full ", "full_")
    return region, fov, z_level, channel


#: the signatures :func:`read_image` dispatches on (cv2 picks its
#: decoder by signature too, whatever the file's suffix)
_TIFF_MAGIC = (b'II*\0', b'MM\0*', b'II+\0', b'MM\0+')
_PNG_MAGIC = b'\x89PNG\r\n\x1a\n'
_BMP_MAGIC = b'BM'
_JPEG_MAGIC = b'\xff\xd8\xff'


def read_image(filepath: str, prefer_mmap: bool = False,
               prefetch: bool = False) -> np.ndarray:
    """Read a tile as (H, W) or (H, W, 3) RGB, the array the JAX
    package's ``read_image`` returns for the same file.

    ``.tif``/``.tiff`` files first take the uncompressed fast path
    (``io/fast_tiff.py``), whose ``prefer_mmap`` array is paged lazily
    (``prefetch`` starts the kernel's readahead). Every other file, and a
    TIFF the fast path declines, is read whole and decoded by its
    signature, not its suffix: TIFF (``io/tiff.py``: LZW, deflate,
    PackBits, predictor, strips or tiles), PNG (``io/png.py``), BMP
    (``io/bmp.py``) or JPEG (``io/jpeg.py``: baseline and progressive,
    grey, YCbCr, RGB, CMYK or YCCK, the pixels of ``cv2.imread``,
    libjpeg-turbo's arithmetic, EXIF orientation ignored as
    ``IMREAD_UNCHANGED`` ignores it; arithmetic-coded, 12-bit, lossless
    and hierarchical streams raise :class:`NotImplementedError` naming
    ROADMAP item 19 (remainder)); a
    compressed tile cannot be paged lazily, so
    ``prefer_mmap`` and ``prefetch`` do not apply to it. Colour comes
    back in RGB order, and a 4-channel image drops its alpha, as the JAX
    package's BGR(A) -> RGB conversion of ``cv2.imread`` gives it.

    A file no decoder recognises raises :class:`ValueError` naming it: the JAX
    package hands such files to imageio, which the card's host lacks."""
    img = None
    if filepath.endswith(('.tif', '.tiff')):
        img = read_tiff_fast(filepath, use_mmap=prefer_mmap,
                             prefetch=prefetch)
    if img is None:
        with open(filepath, 'rb') as f:
            data = f.read()
        img = _decode(data, filepath)
    if img.ndim == 3 and img.shape[2] == 4:
        img = img[:, :, :3]  # RGBA -> RGB (drop alpha)
    return img


def _decode(data: bytes, filepath: str) -> np.ndarray:
    """A whole image file's pixels, by its signature."""
    head = data[:8]
    try:
        if head.startswith(_JPEG_MAGIC):
            return decode_jpeg(data)
        if head[:4] in _TIFF_MAGIC:
            return decode_tiff(data)
        if head == _PNG_MAGIC:
            return decode_png(data)
        if head.startswith(_BMP_MAGIC):
            return decode_bmp(data)
    except DecodeError as e:
        raise DecodeError(f"{filepath}: {e}") from None
    raise ValueError(f"{filepath}: not a TIFF, PNG, BMP or JPEG image (the "
                     "port reads no other tile format)")


def _num(cell: str) -> float:
    """A numeric csv cell as pandas reads it: an NA string (blank
    included) -> NaN, else pandas' C parser's double
    (``utils/csvtable.pandas_float``)."""
    from ..utils.csvtable import NA_VALUES, pandas_float
    return math.nan if cell.strip() == '' or cell in NA_VALUES \
        else pandas_float(cell)


def _region_names(cells: Sequence[str]) -> List[Optional[str]]:
    """Region cells as the strings the JAX scan compares against file
    names. pandas types the column (``utils/csvtable.typed_column``):
    all-integer cells become int64 ('05' -> '5'), numeric cells with a
    blank become float64 (integral values render as ints), anything else
    stays text; a blank is NaN and its rows are skipped (None here)."""
    from ..utils.csvtable import is_missing, typed_column
    _, values = typed_column(cells)
    out: List[Optional[str]] = []
    for v in values:
        if is_missing(v):
            out.append(None)
        elif isinstance(v, float) and v.is_integer():
            out.append(str(int(v)))
        else:
            out.append(str(v))
    return out


def _read_coordinates(path: str) -> Dict[Tuple[str, int, int], Dict]:
    """coordinates.csv -> {(region, fov, z_level): row}, first row wins.

    Rows with a blank or fractional fov/z_level, or a blank region, are
    skipped, as the JAX scan skips them."""
    with open(path, newline='') as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return {}
    regions = _region_names([r.get('region') or '' for r in rows])
    out: Dict[Tuple[str, int, int], Dict] = {}
    for r, region in zip(rows, regions):
        try:
            fov_f, z_f = _num(r['fov']), _num(r['z_level'])
            if region is None or fov_f != int(fov_f) or z_f != int(z_f):
                continue
        except (ValueError, TypeError, KeyError):
            continue
        out.setdefault((region, int(fov_f), int(z_f)), r)
    return out


def scan_acquisition(input_folder: str) -> Acquisition:
    """Scan and index an acquisition folder."""
    timepoints = scan_timepoints(input_folder)
    acquisition_params = load_acquisition_params(input_folder)
    pixel_size_um, pixel_binning = compute_pixel_size(acquisition_params)

    tiles: Dict[TileKey, TileRecord] = {}
    regions_set = set()
    channels_set = set()
    max_z = 0
    max_fov = 0

    for timepoint in timepoints:
        image_folder = os.path.join(input_folder, timepoint)
        try:
            coord_rows = _read_coordinates(
                os.path.join(image_folder, 'coordinates.csv'))
        except FileNotFoundError:
            continue
        parsed = sorted(
            (f, p) for f in os.listdir(image_folder)
            if (p := parse_tile_filename(f)) is not None
        )
        for fname, (region, fov, z_level, channel) in parsed:
            row = coord_rows.get((region, fov, z_level))
            if row is None:
                continue
            key: TileKey = (int(timepoint), region, fov, z_level, channel)
            tiles[key] = TileRecord(
                filepath=os.path.join(image_folder, fname),
                x=_num(row['x (mm)']), y=_num(row['y (mm)']),
                z=_num(row['z (um)']),
                channel=channel, z_level=z_level, region=region,
                fov_idx=fov, t=int(timepoint),
            )
            regions_set.add(region)
            channels_set.add(channel)
            max_z = max(max_z, z_level)
            max_fov = max(max_fov, fov)

    if not tiles:
        raise ValueError(f"No tiles found under {input_folder}")

    regions = sorted(regions_set)
    channel_names = sorted(channels_set)

    # the first tile is authoritative for the nominal tile extent
    first = tiles[next(iter(tiles))]
    first_image = read_image(first.filepath, prefer_mmap=True)
    dtype = first_image.dtype
    if first_image.ndim == 2:
        input_height, input_width = first_image.shape
    elif first_image.ndim == 3:
        input_height, input_width = first_image.shape[:2]
    else:
        raise ValueError(f"Unexpected image shape: {first_image.shape}")

    # RGB channels expand to three monochrome planes
    monochrome_channels: List[str] = []
    rgb_channels: List[str] = []
    for channel in channel_names:
        probe_key = (first.t, first.region, first.fov_idx, first.z_level, channel)
        rec = tiles.get(probe_key)
        if rec is None:  # degraded acquisitions: probe any tile of the channel
            rec = next((r for r in tiles.values() if r.channel == channel),
                       None)
        img = (read_image(rec.filepath, prefer_mmap=True)
               if rec is not None else None)
        if img is not None and img.ndim == 3 and img.shape[2] == 3:
            base = channel.split('_')[0]
            monochrome_channels.extend([f"{base}_R", f"{base}_G", f"{base}_B"])
            rgb_channels.append(channel)
        else:
            monochrome_channels.append(channel)

    return Acquisition(
        input_folder=input_folder,
        timepoints=timepoints,
        acquisition_params=acquisition_params,
        pixel_size_um=pixel_size_um,
        pixel_binning=pixel_binning,
        tiles=tiles,
        regions=regions,
        channel_names=channel_names,
        monochrome_channels=monochrome_channels,
        monochrome_colors=[get_channel_color(c) for c in monochrome_channels],
        num_t=len(timepoints),
        num_z=max_z + 1,
        num_c=len(monochrome_channels),
        num_fovs_per_region=max_fov + 1,
        input_height=int(input_height),
        input_width=int(input_width),
        dtype=np.dtype(dtype),
        rgb_channels=rgb_channels,
    )
