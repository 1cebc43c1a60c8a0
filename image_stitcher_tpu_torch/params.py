"""Stitching parameters: the JAX package's schema, for the port.

``StitchingParameters`` and ``EngineOptions`` keep the field names,
defaults and JSON round-trip of ``image_stitcher_tpu/params.py``, so a
``--params-json`` file written for either package works with both. What
differs is what the port runs: flatfield (fitted on the host or the
device), registration (center pair, all pairs, or the global position
solve with optional subpixel placement; reports and debug images),
overwrite or feathered fusion on CUDA or on the host, in bands or whole
canvases or banded over a mesh of devices (``mesh_shape``), OME-Zarr
v2 or v3 with raw or blosc chunks of any (T, C, Z, Y, X) extent or
pyramidal OME-TIFF (deflate, raw or JPEG tiles), the timepoint and HCS
merges, resuming a run from its manifest, and work shards
(``work_shard``) cooperating on one output folder: every option of the
JAX package's schema but its TPU kernel choice. What the port still refuses is tile input (some
TIFF, BMP and JPEG streams), which raises ``NotImplementedError`` naming
its ROADMAP item, instead of running something else in its place.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, fields
from datetime import datetime
from typing import Any, Dict, Optional, Tuple

VALID_OUTPUT_FORMATS = ('.ome.zarr', '.ome.tiff')
VALID_SCAN_PATTERNS = ('Unidirectional', 'S-Pattern')


def _available_cpus() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        return os.cpu_count() or 1


@dataclass
class StitchingParameters:
    """Parameters for one stitching run (same schema as the JAX package)."""

    input_folder: str
    output_format: str = '.ome.zarr'
    apply_flatfield: bool = False
    use_registration: bool = False
    registration_channel: str = ''  # empty -> first available channel
    registration_z_level: int = 0
    dynamic_registration: bool = False
    scan_pattern: str = 'Unidirectional'  # or 'S-Pattern'
    merge_timepoints: bool = False
    merge_hcs_regions: bool = False

    def __post_init__(self) -> None:
        self.input_folder = os.path.abspath(self.input_folder)

    def validate(self) -> None:
        """Raise ValueError on invalid parameters, NotImplementedError on
        valid ones the port does not run yet."""
        if not os.path.exists(self.input_folder):
            raise ValueError(f"Input folder does not exist: {self.input_folder}")
        if self.output_format not in VALID_OUTPUT_FORMATS:
            raise ValueError("Output format must be either .ome.zarr or .ome.tiff")
        if self.scan_pattern not in VALID_SCAN_PATTERNS:
            raise ValueError("Scan pattern must be either 'Unidirectional' or 'S-Pattern'")
        if self.use_registration and self.registration_z_level < 0:
            raise ValueError("Registration Z-level must be non-negative")

    @property
    def stitched_folder(self) -> str:
        """Timestamped output folder next to the input folder."""
        stamp = datetime.now().strftime('%Y-%m-%d_%H-%M-%S.%f')
        return os.path.join(self.input_folder + "_stitched_" + stamp)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> 'StitchingParameters':
        valid = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in valid})

    @classmethod
    def from_json(cls, json_path: str) -> 'StitchingParameters':
        with open(json_path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    def to_json(self, json_path: str) -> None:
        with open(json_path, 'w') as f:
            json.dump(self.to_dict(), f, indent=2)


@dataclass
class EngineOptions:
    """Engine knobs, same fields and meanings as the JAX package's
    (see ``image_stitcher_tpu/params.py`` for each field's history)."""

    chunks: Tuple[int, int, int, int, int] = (1, 1, 1, 2048, 2048)
    overlap_fudge: float = 1.05
    registration_margin: float = 0.25
    upsample_factor: int = 10
    flatfield_tiles_per_timepoint: int = 32
    flatfield_max_tiles: int = 48
    # blosc-lz4 clevel 5 with byte shuffle (the JAX package's default);
    # any cname of io/blosc.py's CNAMES (the production edition's zstd-1
    # among them), clevel 0-9, shuffle 0 none, 1 byte, 2 bit, -1 bit for
    # 1-byte types; None = raw chunks; 'auto' = lz4 only when the content
    # compresses and the output disk is slower than the cores' lz4
    compressor_cname: Optional[str] = 'lz4'
    compressor_clevel: int = 5
    compressor_shuffle: int = 1
    direct_io: str = 'auto'
    zarr_format: int = 2
    blend_method: str = 'overwrite'
    pyramid_downsample: str = 'nearest'
    registration_scope: str = 'center'
    subpixel_placement: bool = False
    flatfield_device: str = 'host'
    registration_device_threshold: int = 32
    registration_batch_pairs: int = 128
    # 'auto' and 'device' fuse on the pipeline's device (CUDA by default);
    # 'host' fuses on the CPU through csrc/hostops.c. 'auto' never picks
    # the host (the JAX package asks a link probe; the port runs on the
    # card unless told otherwise)
    fusion_device: str = 'auto'
    device_fusion_kernel: str = 'auto'
    host_fusion_threads: Optional[int] = None
    feather_px: int = 64
    tiff_compression: str = 'deflate'
    tiff_jpeg_quality: int = 85
    reader_threads: Optional[int] = None
    fusion_batch: int = 8
    debug_visuals: bool = False
    registration_report: bool = False
    mesh_shape: Optional[Tuple[int, int]] = None
    merge_barrier_timeout_s: float = 600.0
    # 'auto' streams canvases over the threshold in bands, 'on' every
    # canvas, 'off' none (each is fused whole on the device)
    streaming: str = 'auto'
    streaming_threshold_bytes: int = 256 << 20
    device_band_multiple: int = 4
    validate_plan: bool = False
    pipelined_save: bool = True
    overlap_prep: bool = True
    continue_on_error: bool = False
    output_folder: Optional[str] = None
    work_shard: Optional[Tuple[int, int]] = None

    # the fields that change the OUTPUT (not only its speed): a resumed
    # run must match them to keep one coherent tree (the JAX package's
    # list, so a manifest's fingerprint is the same in both packages)
    OUTPUT_AFFECTING = (
        'chunks', 'overlap_fudge', 'registration_margin', 'upsample_factor',
        'flatfield_tiles_per_timepoint', 'flatfield_max_tiles',
        'compressor_cname', 'compressor_clevel', 'compressor_shuffle',
        'blend_method', 'pyramid_downsample', 'registration_scope',
        'feather_px', 'subpixel_placement', 'zarr_format')

    def output_fingerprint(self) -> Dict[str, Any]:
        return {name: list(v) if isinstance((v := getattr(self, name)), tuple)
                else v
                for name in self.OUTPUT_AFFECTING}

    def write_band_rows(self) -> int:
        """Row granularity for band-streamed writes: the chunk rows."""
        return self.chunks[3]

    def resolved_reader_threads(self) -> int:
        if self.reader_threads is not None:
            return self.reader_threads
        return max(2, _available_cpus())

    def resolved_fusion_threads(self) -> int:
        """The host fuser's threads: never fewer than 4, since its band
        threads spend much of their life in waits that release the
        interpreter lock (the JAX package's rule)."""
        if self.host_fusion_threads is not None:
            return self.host_fusion_threads
        return max(4, _available_cpus())

    def validate(self) -> None:
        """Raise ValueError on invalid options, NotImplementedError on
        valid ones the port does not run yet."""
        if self.blend_method not in ('overwrite', 'feather'):
            raise ValueError("blend_method must be 'overwrite' or 'feather'")
        if self.pyramid_downsample not in ('nearest', 'mean'):
            raise ValueError("pyramid_downsample must be 'nearest' or 'mean'")
        if self.registration_scope not in ('center', 'all-pairs', 'global'):
            raise ValueError(
                "registration_scope must be 'center', 'all-pairs' or 'global'")
        if self.fusion_device not in ('auto', 'device', 'host'):
            raise ValueError("fusion_device must be 'auto', 'device' or 'host'")
        if self.direct_io not in ('auto', 'on', 'off'):
            raise ValueError("direct_io must be 'auto', 'on' or 'off'")
        if self.flatfield_device not in ('host', 'device'):
            raise ValueError("flatfield_device must be 'host' or 'device'")
        if self.zarr_format not in (2, 3):
            raise ValueError("zarr_format must be 2 (NGFF 0.4) or 3 (NGFF 0.5)")
        if self.device_fusion_kernel != 'auto':
            raise ValueError("device_fusion_kernel must be 'auto' (the CUDA "
                             "kernel); 'xla' and 'pallas' are TPU kernels")
        if self.streaming not in ('auto', 'on', 'off'):
            raise ValueError("streaming must be 'auto', 'on' or 'off'")
        if len(self.chunks) != 5:
            raise ValueError("chunks must be a 5-tuple (T,C,Z,Y,X)")
        if self.device_band_multiple < 1:
            raise ValueError("device_band_multiple must be >= 1")
        if self.fusion_batch < 1:
            raise ValueError("fusion_batch must be >= 1")
        if self.subpixel_placement and self.registration_scope != 'global':
            raise ValueError(
                "subpixel_placement requires registration_scope='global'")
        if self.feather_px < 1:
            raise ValueError("feather_px must be >= 1")
        if self.tiff_compression not in ('deflate', 'raw', 'jpeg'):
            raise ValueError(
                "tiff_compression must be 'deflate', 'raw' or 'jpeg'")
        if not 1 <= self.tiff_jpeg_quality <= 100:
            raise ValueError("tiff_jpeg_quality must be in [1, 100]")
        if self.compressor_cname not in (None, 'auto'):
            from .io.blosc import check_settings
            check_settings(self.compressor_cname, self.compressor_clevel,
                           self.compressor_shuffle)
        if self.work_shard is not None:
            idx, count = self.work_shard
            if not (count >= 1 and 0 <= idx < count):
                raise ValueError("work_shard must be (index, count) with "
                                 "0 <= index < count")
            if self.output_folder is None:
                raise ValueError("work_shard requires an explicit "
                                 "output_folder shared by all shards")
