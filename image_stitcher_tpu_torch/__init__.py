"""image_stitcher_tpu_torch — the PyTorch + CUDA port of image_stitcher_tpu.

A second package beside the JAX one, for NVIDIA Hopper cards. It runs the
main stitching path end to end: scan a Squid acquisition, fit BaSiC
flatfields and measure center-pair registration shifts on the host,
place flatfield-corrected tiles into device-resident canvas bands with a
hand-written CUDA kernel (``csrc/fuse_overwrite.cu``), and stream the
bands into OME-Zarr (v2, or v3 with shards) with their pyramid, its
chunks blosc-lz4 by default, or any other blosc codec (zstd, zlib, lz4hc,
blosclz, snappy; hand-written C, ``csrc/blosc.c``), or raw, or into pyramidal OME-TIFF. ``fusion_device='host'`` fuses on
the CPU through the JAX package's host C (``csrc/hostops.c``). Every run
keeps a manifest it can be resumed from
(``resume=True``), and can merge its timepoints and HCS wells into
series and plates, their pyramids folded on the card. With
``mesh_shape`` a canvas is banded over several devices and streamed to
the writer band by band; with ``work_shard`` (``parallel/distributed.py``
over ``torch.distributed``) several processes share one run.
:func:`open_stitched` and :func:`list_outputs` reopen the results.

It imports torch and never jax, and nothing of ``image_stitcher_tpu``:
its host layer uses only the standard library, numpy, scipy and torch.
Options the port does not carry yet raise ``NotImplementedError``.
"""

from .api import StitchedImage, list_outputs, open_stitched
from .io.acquisition import Acquisition, scan_acquisition
from .params import EngineOptions, StitchingParameters
from .state import CarriedState, state_from_reference
from .utils.progress import ProgressReporter, StitchCancelled

__version__ = "0.1.0"


def stitch(input_folder: str, **kwargs):
    """Stitch an acquisition folder; returns the pipeline after the run.

    Keyword args are StitchingParameters fields, plus ``options``
    (EngineOptions), ``reporter``, ``stop_event``, ``resume`` (go on
    from the newest compatible unfinished run of this acquisition, or
    from ``options.output_folder``'s manifest), ``device`` (a
    torch.device, CUDA by default, or a sequence of them: the devices a
    ``mesh_shape`` run bands its canvases over) and ``state`` (a
    CarriedState; a resumed run's manifest wins over it)."""
    from .models.pipeline import StitchPipeline
    extra = {k: kwargs.pop(k) for k in ('options', 'reporter', 'stop_event',
                                        'resume', 'device', 'state')
             if k in kwargs}
    params = StitchingParameters(input_folder=input_folder, **kwargs)
    pipeline = StitchPipeline(params, **extra)
    pipeline.run()
    return pipeline


__all__ = [
    'Acquisition', 'CarriedState', 'EngineOptions', 'ProgressReporter',
    'StitchCancelled', 'StitchedImage', 'StitchingParameters',
    'list_outputs', 'open_stitched', 'scan_acquisition',
    'state_from_reference', 'stitch',
]
