"""OME-TIFF output path (pyramidal BigTIFF).

The counterpart of the JAX package's ``io/ometiff.py``: it adapts the
pipeline to ``io/tiffwriter.py``. Canvases that stream in bands go
through :class:`~image_stitcher_tpu_torch.io.tiffwriter.StreamingTiffWriter`
(``StitchPipeline._writer``); a canvas fused whole is written here from
the host levels ``StitchPipeline.save_region`` builds.
"""

from __future__ import annotations


def tiff_rgb_mode(acq) -> bool:
    """True when the acquisition writes true SamplesPerPixel=3 RGB
    pages (channels expanded to {ch}_R/_G/_B), matching the reference's
    production RGB TIFF path (stitcher_process.py:1429-1549)."""
    mono = list(acq.monochrome_channels)
    return (len(mono) == 3 and len(acq.rgb_channels) > 0
            and [m.rsplit('_', 1)[-1] for m in mono] == ['R', 'G', 'B'])


def region_position_um(acq, t, region: str):
    """Stage origin of a region, recorded per OME-XML Plane (mm->um)."""
    xs, ys = acq.region_positions(int(t), region)
    return (min(xs) * 1000.0, min(ys) * 1000.0) if xs and ys else None


def write_ome_tiff_region(pipeline, t, region: str, levels,
                          output_path: str) -> str:
    """Write one (timepoint, region) as pyramidal OME-TIFF from its
    (C, Z, h, w) levels on the host, level 0 first
    (``StitchPipeline.save_region`` builds them on the canvas's device
    and copies each once; the writer takes the whole list, ~1.33x the
    canvas, as the JAX package's in-RAM writer does)."""
    from .tiffwriter import write_ome_tiff_pyramid

    acq = pipeline.acq
    write_ome_tiff_pyramid(
        output_path, levels,
        image_name=f"{region}_t{t}",
        channel_names=list(acq.monochrome_channels),
        channel_colors=acq.monochrome_colors,
        pixel_size_um=acq.pixel_size_um,
        dz_um=acq.dz_um,
        rgb=tiff_rgb_mode(acq),
        position_um=region_position_um(acq, t, region),
        compression=pipeline.options.tiff_compression,
        jpeg_quality=pipeline.options.tiff_jpeg_quality)
    return output_path
