"""Several devices and several processes: the counterpart of the JAX
package's ``parallel/`` (its ``autotune.py`` aside: 'auto' fuses on the
card, ROADMAP §2).

- :mod:`.mesh`: a (data, canvas) grid of ``torch.device``\\ s;
- :mod:`.sharded_fuse`: a canvas banded in Y over the canvas axis, each
  band fused on its device by the CUDA kernels and streamed to the
  writer band by band;
- :mod:`.sharded_ops`: batch work split over the data axis;
- :mod:`.distributed`: ``torch.distributed`` process groups, the pod
  mesh and ``stitch_distributed`` (work shards over processes).
"""
