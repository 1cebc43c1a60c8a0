"""The plain version of the port's zstd encoder (``io/zstd_plain.py``)
byte-equal to its C (``csrc/codec_zstd.h``) at blosc clevel 6 to 9, the
levels of libzstd 1.5.7's optimal parser (btopt, btultra, btultra2) up to
16 KiB, on ``test_torch_zstd_libzstd.py``'s corpus: lengths 1-300 and
the block edges of at most 16 KiB + 1 of incompressible bytes, one
repeated byte, zeros, text and a 4-symbol alphabet. The C frames are
held to libzstd's there; here only the Python, which is slow at these
levels, so it runs in a file of its own beside them."""

import pytest

from image_stitcher_tpu_torch.io import blosc, zstd_plain
from test_torch_zstd_libzstd import LENGTHS, PLAIN_MAX, _kind


@pytest.mark.parametrize("kind", ['random', 'repeated', 'zeros', 'text',
                                  'alphabet4'])
def test_corpus_plain_frames_equal_c(kind):
    for n in LENGTHS:
        if n > PLAIN_MAX:
            continue
        data = _kind(kind, n)
        for clevel in (6, 7, 8, 9):
            assert zstd_plain.compress(data, clevel) == \
                blosc.stream_compress('zstd', data, clevel), (n, clevel)
