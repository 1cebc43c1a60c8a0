"""image_stitcher_tpu_torch — the PyTorch + CUDA port of image_stitcher_tpu.

A second package beside the JAX one, for NVIDIA Hopper cards. It runs the
main stitching path end to end: scan a Squid acquisition, fit BaSiC
flatfields and measure center-pair registration shifts on the host,
place flatfield-corrected tiles into device-resident canvas bands with a
hand-written CUDA kernel (``csrc/fuse_overwrite.cu``), and stream the
bands into raw OME-Zarr v2 with their pyramid.

It imports torch and never jax, and nothing of ``image_stitcher_tpu``:
its host layer uses only the standard library, numpy, scipy and torch.
Options the port does not carry yet raise ``NotImplementedError``.
"""

from .io.acquisition import Acquisition, scan_acquisition
from .params import EngineOptions, StitchingParameters
from .state import CarriedState, state_from_reference
from .utils.progress import ProgressReporter, StitchCancelled

__version__ = "0.1.0"


def stitch(input_folder: str, **kwargs):
    """Stitch an acquisition folder; returns the pipeline after the run.

    Keyword args are StitchingParameters fields, plus ``options``
    (EngineOptions), ``reporter``, ``stop_event``, ``resume`` (not
    ported: raises), ``device`` (a torch.device, CUDA by default) and
    ``state`` (a CarriedState)."""
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
    'StitchCancelled', 'StitchingParameters', 'scan_acquisition',
    'state_from_reference', 'stitch',
]
