"""The port's blosc zlib frames (``csrc/codec_zlib.h``) on the twelve
probe cases: ``chip_smoke.compressible`` 1024^2 as u8, u16, f32 and i32
at shuffle 0, 1 and 2, at every clevel 0-9, byte-equal to tensorstore's
(its c-blosc links Chromium's zlib 1.3.1), the memcpyed flag included;
the plain frame (``io/zlib_plain.py``) equal to the C frame on a 64-row
cut at clevel 1 and 6. The rest of the zlib checks are in
``test_torch_zlib_frames.py``."""

import numpy as np
import pytest

from torch_blosc_frames import probe_arrays, tensorstore_frame
from image_stitcher_tpu_torch.io import blosc


@pytest.mark.parametrize("shuffle", [0, 1, 2])
@pytest.mark.parametrize("dtype", ['u8', 'u16', 'f32', 'i32'])
def test_probe_frames_equal_tensorstore(dtype, shuffle):
    """The twelve probe cases at every clevel, and the plain
    frame of a 64-row cut at clevel 1 and 6."""
    arr = probe_arrays()[dtype]
    for clevel in range(10):
        want = tensorstore_frame(arr, arr.itemsize, clevel, shuffle, 'zlib')
        assert bytes(blosc.compress(arr, arr.itemsize, clevel, shuffle,
                                    'zlib')) == want, clevel
    cut = np.ascontiguousarray(arr[:64])
    for clevel in (1, 6):
        assert blosc.compress_plain(cut, arr.itemsize, clevel, shuffle,
                                    'zlib') == bytes(blosc.compress(
                                        cut, arr.itemsize, clevel, shuffle,
                                        'zlib'))
