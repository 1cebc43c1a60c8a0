"""The port's snappy encoder (``csrc/codec_snappy.h``, plain version
``io/snappy_plain.py``: Google snappy 1.2's compressor) against
tensorstore's c-blosc, which calls snappy's C API.

- a corpus of streams: lengths 1-300 and the edges 14-17, 255-257,
  4095-4097, 16383-16385, 32767-32769, 65535-65537, 131072 and 262144 of
  zeros, one repeated byte, text, incompressible bytes and a 4-symbol
  alphabet, and blocks of ``chip_smoke.compressible`` byte-shuffled at
  type sizes 1, 2, 4 and 8: each input is the last block of a u8 chunk
  after two blocks of zeros (``torch_blosc_frames.framed``), so
  tensorstore's frame holds snappy's stream of exactly the input; the
  port's whole frame is tensorstore's, and the C and plain streams are
  the one in it;
- inputs whose matches fall in the 16 positions snappy probes after a
  literal starts, up to its ip_limit, and a ``hypothesis`` property on
  short random inputs;
- the first elements of the first stream of ``chip_smoke.compressible``
  1024^2 u16 unshuffled at clevel 5 (a 35-byte literal, a 4-byte copy at
  offset 20, then a 14301-byte literal);
- whole blosc frames of ``chip_smoke.compressible`` 1024^2 as u8, u16,
  f32 and i32 at shuffle 0, 1 and 2 and every clevel: byte-equal to
  tensorstore's, the memcpyed flag included (c-blosc clips snappy's
  room to the frame's, and snappy refuses a buffer under its worst
  case), and a frame of one u8 block always stored;
- the kept digests ``chip_smoke.py`` phase 12 holds the C encoder to on
  the card (``tests/torch_blosc_frames.npz``): matched by the C frames
  and streams, and by the plain streams.
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import chip_smoke
import torch_blosc_frames
from torch_blosc_frames import (EDGES, KINDS, framed, kind_bytes,
                                last_stream, probe_arrays, tensorstore_frame)
from image_stitcher_tpu_torch.io import blosc, snappy_plain

#: the inputs the plain version runs on in the corpus
PLAIN_MAX = 65537


def _clevel(n: int) -> int:
    """The lowest clevel whose u8 blocks hold n bytes (64, 128 or 256
    KiB)."""
    return 1 if n <= 65536 else 4 if n <= 131072 else 9


def check_stream(data: bytes, plain: bool = True) -> None:
    """The port's frame of ``framed(data)`` is tensorstore's, and its C
    (and plain) stream of ``data`` is the stream in it."""
    clevel = _clevel(len(data))
    chunk = np.frombuffer(bytes(2 * blosc.blosc_blocksize(
        clevel, 1, 1 << 20, 'snappy')) + data, np.uint8)
    want = tensorstore_frame(chunk, 1, clevel, 0, 'snappy')
    assert not want[2] & 0x02
    assert bytes(blosc.compress(chunk, 1, clevel, 0, 'snappy')) == want, \
        len(data)
    stream = last_stream(want)
    c = blosc.stream_compress('snappy', data)
    if len(stream) == len(data):
        # c-blosc stores a stream as long as its input (a longer one it
        # keeps)
        assert len(c) == len(data)
    else:
        assert c == stream, len(data)
    if plain:
        assert snappy_plain.compress(data) == c, len(data)
    assert blosc.stream_decompress('snappy', c, len(data)) == data


@pytest.mark.parametrize("kind", KINDS)
def test_corpus_streams_equal_tensorstore(kind):
    for n in tuple(range(1, 301)) + EDGES:
        check_stream(kind_bytes(kind, n), plain=n <= PLAIN_MAX)


@pytest.mark.parametrize("typesize", [1, 2, 4, 8])
def test_shuffled_texture_streams_equal_tensorstore(typesize):
    """Blocks of the bench's compressible content as c-blosc hands them
    to snappy: byte-shuffled, each of the typesize streams."""
    tex = chip_smoke.compressible(np.random.default_rng(typesize), 512)
    arr = {1: (tex >> 8).astype(np.uint8), 2: tex,
           4: tex.astype(np.uint32) * 3, 8: tex.astype(np.uint64) * 5}[
               typesize]
    raw = arr.tobytes()
    for bs in (32768, 65536, 131072, 262144):
        block = blosc.shuffle_plain(raw[:bs], typesize)
        n = bs // typesize
        for s in range(typesize):
            check_stream(block[s * n:(s + 1) * n], plain=s == 0)


def test_probe_near_ip_limit_equals_tensorstore():
    """Matches inside the 16 positions snappy probes after a literal
    starts, and just before and after its ip_limit (15 bytes before the
    fragment's end): a repeated word placed at every offset of inputs of
    15 to 64 bytes."""
    rng = np.random.default_rng(4)
    for n in range(15, 65):
        for at in range(0, n - 4):
            data = bytearray(rng.integers(0, 256, n, dtype=np.uint8))
            data[0:4] = data[at:at + 4] = b'WXYZ'
            check_stream(bytes(data))


@settings(max_examples=60, deadline=None, derandomize=True)
@given(st.binary(min_size=1, max_size=600), st.integers(1, 8))
def test_random_short_inputs_equal_tensorstore(data, period):
    """Random bytes, then the same bytes again with a period: literals,
    short and long copies in one fragment."""
    check_stream(data + data[::period] + data)


def test_first_elements_of_compressible_stream():
    """The first stream of ``chip_smoke.compressible`` 1024^2 u16,
    unshuffled, at clevel 5 opens with tensorstore's elements: a 35-byte
    literal, a 4-byte copy at offset 20, a 14301-byte literal."""
    tex = chip_smoke.compressible(np.random.default_rng(0), 1024)
    frame = bytes(blosc.compress(tex, 2, 5, 0, 'snappy'))
    assert frame == tensorstore_frame(tex, 2, 5, 0, 'snappy')
    pos = int.from_bytes(frame[16:20], 'little') + 4
    ip = pos
    while frame[ip] & 128:          # the varint length
        ip += 1
    ip += 1
    elements = []
    while len(elements) < 3:
        tag = frame[ip]
        if tag & 3 == 0:
            n = tag >> 2
            extra = n - 59 if n >= 60 else 0
            if extra:
                n = int.from_bytes(frame[ip + 1:ip + 1 + extra], 'little')
            elements.append(('literal', n + 1))
            ip += 1 + extra + n + 1
        elif tag & 3 == 1:
            elements.append(('copy', ((tag >> 2) & 7) + 4,
                             ((tag >> 5) << 8) | frame[ip + 1]))
            ip += 2
        else:
            elements.append(('copy', (tag >> 2) + 1,
                             int.from_bytes(frame[ip + 1:ip + 3], 'little')))
            ip += 3
    assert elements == [('literal', 35), ('copy', 4, 20), ('literal', 14301)]


@pytest.mark.parametrize("shuffle", [0, 1, 2])
@pytest.mark.parametrize("dtype", ['u8', 'u16', 'f32', 'i32'])
def test_probe_frames_equal_tensorstore(dtype, shuffle):
    arr = probe_arrays()[dtype]
    for clevel in range(10):
        want = tensorstore_frame(arr, arr.itemsize, clevel, shuffle,
                                 'snappy')
        assert bytes(blosc.compress(arr, arr.itemsize, clevel, shuffle,
                                    'snappy')) == want, clevel


def test_one_u8_block_is_stored():
    """A u8 chunk of one block: c-blosc gives snappy the frame's room,
    under snappy's worst case, so the frame is stored whole, as
    tensorstore's (plain version too)."""
    data = np.frombuffer(kind_bytes('text', 30000), np.uint8)
    for clevel in (1, 5, 9):
        frame = bytes(blosc.compress(data, 1, clevel, 0, 'snappy'))
        assert frame[2] & 0x02
        assert frame == tensorstore_frame(data, 1, clevel, 0, 'snappy')
        assert blosc.compress_plain(data, 1, clevel, 0, 'snappy') == frame


def test_kept_digests_match():
    """The kept file's snappy column: the C frames and streams, and the
    plain streams of the inputs up to 64 KiB + 1."""
    kept = torch_blosc_frames.load()
    cases = torch_blosc_frames.inputs()
    assert sorted(label for label, _ in cases) == sorted(kept)
    sha = torch_blosc_frames.sha
    for label, data in cases:
        digest, frames = kept[label]
        assert sha(data) == digest, label
        flen, fsha, slen, ssha = frames['snappy', 9]
        frame = bytes(blosc.compress(framed(data, 'snappy', 9), 1, 9, 0,
                                     'snappy'))
        assert (len(frame), sha(frame)) == (flen, fsha), label
        if slen is not None:
            stream = blosc.stream_compress('snappy', data)
            assert (len(stream), sha(stream)) == (slen, ssha), label
            if len(data) <= PLAIN_MAX:
                assert snappy_plain.compress(data) == stream, label
