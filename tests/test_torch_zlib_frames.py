"""The port's zlib encoder (``csrc/codec_zlib.h``, plain version
``io/zlib_plain.py``: deflate as Chromium's zlib 1.3.1 runs it in
``compress2``) against tensorstore's c-blosc, which links that zlib.

- a corpus of streams: lengths 1-300 at clevel 1, 4 and 9, and the edges
  14-17, 255-257, 4095-4097, 16383-16385, 32767-32769, 65535-65537,
  131072 and 262144 at every clevel 1-9 (where a u8 block holds them), of
  zeros, one repeated byte, text, incompressible bytes and a 4-symbol
  alphabet, and blocks of ``chip_smoke.compressible`` byte-shuffled at
  type sizes 1, 2, 4 and 8: each input is the last block of a u8 chunk
  after two blocks of zeros (``torch_blosc_frames.framed``), so
  tensorstore's frame holds the zlib stream of exactly the input; the
  port's whole frame is tensorstore's, and the C stream (and the plain
  one, on the shorter inputs) is the one in it;
- streams whose blocks end at 16383 symbols, that slide the window, that
  end in a stored block and that take the fixed code (each seen in
  tensorstore's streams, read back block by block);
- single-block chunks whose stream lies within 3 bytes of c-blosc's room
  (the chunk's size less 8 bytes), at every clevel: whole frames
  byte-equal to tensorstore's on both sides of the edge, memcpyed where
  its are;
- a ``hypothesis`` property on short random inputs at every clevel;
- (in ``test_torch_zlib_probe.py``, so the two files run side by side)
  whole blosc frames of ``chip_smoke.compressible`` 1024^2 as u8, u16,
  f32 and i32 at shuffle 0, 1 and 2 and every clevel 0-9;
- level 0's stored blocks, the stream headers' FLEVEL bytes and the
  adler32 trailer, read back by the stdlib's zlib;
- the kept digests ``chip_smoke.py`` phase 12 holds the C encoders to on
  the card (``tests/torch_blosc_frames.npz``): what
  ``torch_blosc_frames.make`` writes here, matched by the C frames and
  streams and by the plain streams of the short inputs.
"""

import zlib

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import chip_smoke
import torch_blosc_frames
from torch_blosc_frames import (EDGES, KINDS, framed, kind_bytes,
                                last_stream, tensorstore_frame)
from image_stitcher_tpu_torch.io import blosc, zlib_plain

#: the inputs the plain version runs on in the corpus
PLAIN_MAX = 4097


def zlib_stream(data: bytes, clevel: int, plain: bool = True):
    """The C stream of ``data``, checked against tensorstore's (in the
    port's frame of ``framed(data)``, which must be tensorstore's) and
    against the plain version's; tensorstore's stream, or None where
    c-blosc stored the input."""
    chunk = framed(data, 'zlib', clevel)
    want = tensorstore_frame(chunk, 1, clevel, 0, 'zlib')
    assert not want[2] & 0x02
    assert bytes(blosc.compress(chunk, 1, clevel, 0, 'zlib')) == want, \
        (len(data), clevel)
    stream = last_stream(want)
    c = blosc.stream_compress('zlib', data, clevel)
    assert zlib.decompress(c) == data
    if plain:
        assert zlib_plain.compress(data, clevel) == c, (len(data), clevel)
    if len(stream) == len(data):
        # compress2 failed (or filled the room exactly): stored
        assert len(c) >= len(data)
        return None
    assert c == stream, (len(data), clevel)
    return stream


def block_types(stream: bytes):
    """[(block type, symbols)] of a zlib stream's deflate blocks (0
    stored, 1 fixed code, 2 dynamic codes), read bit by bit."""
    data = np.unpackbits(np.frombuffer(stream[2:], np.uint8),
                         bitorder='little')
    pos = 0

    def bits(n):
        nonlocal pos
        v = int(sum(int(b) << i for i, b in enumerate(data[pos:pos + n])))
        pos += n
        return v

    def code(lengths):
        count = np.bincount([v for v in lengths if v], minlength=16)
        first, table, c = [0] * 17, {}, 0
        for b in range(1, 16):
            c = (c + count[b - 1]) << 1
            first[b] = c
        for sym, v in enumerate(lengths):
            if v:
                table[v, first[v]] = sym
                first[v] += 1
        return table

    def decode(table):
        c = n = 0
        while (n, c) not in table:
            c = (c << 1) | bits(1)
            n += 1
        return table[n, c]

    lext = [0] * 8 + [1] * 4 + [2] * 4 + [3] * 4 + [4] * 4 + [5] * 4 + [0]
    out, last = [], 0
    while not last:
        last, btype = bits(1), bits(2)
        if btype == 0:
            pos = (pos + 7) // 8 * 8
            n = bits(16)
            pos += 16 + 8 * n
            out.append((0, n))
            continue
        if btype == 1:
            lt = code([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8)
            dt = code([5] * 30)
        else:
            hlit, hdist, hclen = bits(5) + 257, bits(5) + 1, bits(4) + 4
            order = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2,
                     14, 1, 15)
            cl = [0] * 19
            for i in range(hclen):
                cl[order[i]] = bits(3)
            ct, lens = code(cl), []
            while len(lens) < hlit + hdist:
                s = decode(ct)
                lens += ([s] if s < 16 else [lens[-1]] * (3 + bits(2))
                         if s == 16 else [0] * (3 + bits(3)) if s == 17
                         else [0] * (11 + bits(7)))
            lt, dt = code(lens[:hlit]), code(lens[hlit:])
        n = 0
        while (s := decode(lt)) != 256:
            n += 1
            if s > 256:
                bits(lext[s - 257])
                bits(zlib_plain.EXTRA_DBITS[decode(dt)])
        out.append((btype, n))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_corpus_streams_equal_tensorstore(kind):
    for n in range(1, 301):
        for clevel in (1, 4, 9):
            zlib_stream(kind_bytes(kind, n), clevel)
    for n in EDGES:
        for clevel in range(1, 10):
            if n <= torch_blosc_frames.BLOCK['zlib', clevel]:
                zlib_stream(kind_bytes(kind, n), clevel, plain=n <= PLAIN_MAX)


@pytest.mark.parametrize("typesize", [1, 2, 4, 8])
def test_shuffled_texture_streams_equal_tensorstore(typesize):
    """Blocks of the bench's compressible content as c-blosc hands them
    to zlib: byte-shuffled, each of the typesize streams, at clevel 1, 3,
    5 and 9."""
    tex = chip_smoke.compressible(np.random.default_rng(typesize), 512)
    arr = {1: (tex >> 8).astype(np.uint8), 2: tex,
           4: tex.astype(np.uint32) * 3, 8: tex.astype(np.uint64) * 5}[
               typesize]
    raw = arr.tobytes()
    for bs in (32768, 65536, 131072, 262144):
        block = blosc.shuffle_plain(raw[:bs], typesize)
        n = bs // typesize
        for clevel in (1, 3, 5, 9):
            for s in range(typesize):
                if n <= torch_blosc_frames.BLOCK['zlib', clevel]:
                    zlib_stream(block[s * n:(s + 1) * n], clevel,
                                plain=n <= 8192 and s == 0)


def test_block_kinds_seen_in_tensorstore_streams():
    """Blocks that end at 16383 symbols (then a stored block) and the
    window's slide (streams over 64 KiB - 262) at clevel 3-9, and the
    fixed code at every clevel: tensorstore's streams hold them, and the
    port's are the same (plain version too, where it runs here)."""
    kept = dict(torch_blosc_frames.inputs())
    mixed = kept['text_then_random_90000']
    for clevel in range(3, 10):
        stream = zlib_stream(mixed, clevel, plain=clevel in (3, 9))
        kinds = block_types(stream)
        assert kinds[0] == (2, zlib_plain.LIT_BUFSIZE - 1), clevel
        assert kinds[-1][0] == 0, clevel
        zlib_stream(kind_bytes('text', 131072), clevel, plain=clevel == 4)
    for clevel in range(1, 10):
        for label in ('fixed_text_100', 'fixed_repeat_40'):
            assert block_types(zlib_stream(kept[label], clevel)) == \
                [(1, {'fixed_text_100': 58 + (clevel <= 3),
                      'fixed_repeat_40': 8}[label])], (label, clevel)


def test_frames_at_the_room_edge_equal_tensorstore():
    """Single-block u8 chunks of zeros then incompressible bytes, the
    zeros' run set so the stream lies within 3 bytes of c-blosc's room
    (the chunk's size less 8): whole frames are tensorstore's, stored
    and compressed on either side of the edge."""
    rng = np.random.default_rng(8)
    n = 6000
    tail = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    stored = kept = 0
    for clevel in range(1, 10):
        for k in range(0, 200):
            data = np.frombuffer(bytes(k) + tail[k:], np.uint8)
            size = len(blosc.stream_compress('zlib', data, clevel))
            if abs(size - (n - 8)) > 3:
                continue
            frame = bytes(blosc.compress(data, 1, clevel, 0, 'zlib'))
            assert frame == tensorstore_frame(data, 1, clevel, 0, 'zlib'), \
                (clevel, k)
            assert blosc.compress_plain(data, 1, clevel, 0, 'zlib') == frame
            stored += bool(frame[2] & 0x02)
            kept += not frame[2] & 0x02
    assert stored and kept


@settings(max_examples=60, deadline=None, derandomize=True)
@given(st.binary(min_size=1, max_size=500), st.integers(1, 8),
       st.integers(1, 9))
def test_random_short_inputs_equal_tensorstore(data, period, clevel):
    zlib_stream(data + data[::period] + data, clevel)


def test_headers_stored_level_and_trailer():
    """zlib's FLEVEL header byte at each level, level 0's stored blocks of
    65535 bytes, and the adler32 trailer, all read back by the stdlib's
    zlib (C and plain)."""
    data = kind_bytes('text', 140000)
    heads = {0: b'\x78\x01', 1: b'\x78\x01', 2: b'\x78\x5e', 5: b'\x78\x5e',
             6: b'\x78\x9c', 7: b'\x78\xda', 9: b'\x78\xda'}
    for clevel, head in heads.items():
        c = blosc.stream_compress('zlib', data[:3000], clevel)
        assert c[:2] == head and zlib.decompress(c) == data[:3000]
        assert c[-4:] == zlib.adler32(data[:3000]).to_bytes(4, 'big')
    stored = blosc.stream_compress('zlib', data, 0)
    assert len(stored) == 2 + 3 * 5 + len(data) + 4
    assert stored[2:5] == b'\x00\xff\xff' and zlib.decompress(stored) == data
    assert zlib_plain.compress(data, 0) == stored
    for n in (0, 1, 65535, 65536):
        assert zlib_plain.compress(data[:n], 0) == \
            blosc.stream_compress('zlib', data[:n], 0)
        assert zlib.decompress(zlib_plain.compress(data[:n], 0)) == data[:n]
    assert zlib_plain.adler32(data) == zlib.adler32(data)


def test_kept_file_is_what_make_writes(tmp_path):
    path = str(tmp_path / "frames.npz")
    torch_blosc_frames.make(path)
    assert torch_blosc_frames.load(path) == torch_blosc_frames.load()


def test_kept_digests_match():
    """The kept file's zlib columns: the C frames and streams, and the
    plain streams of the inputs up to 4097 bytes."""
    kept = torch_blosc_frames.load()
    cases = torch_blosc_frames.inputs()
    assert sorted(label for label, _ in cases) == sorted(kept)
    sha = torch_blosc_frames.sha
    checked = 0
    for label, data in cases:
        digest, frames = kept[label]
        assert sha(data) == digest, label
        for (cname, clevel), (flen, fsha, slen, ssha) in frames.items():
            if cname != 'zlib':
                continue
            frame = bytes(blosc.compress(framed(data, cname, clevel), 1,
                                         clevel, 0, cname))
            assert (len(frame), sha(frame)) == (flen, fsha), (label, clevel)
            checked += 1
            if slen is None:
                continue
            stream = blosc.stream_compress(cname, data, clevel)
            assert (len(stream), sha(stream)) == (slen, ssha), (label, clevel)
            if len(data) <= PLAIN_MAX:
                assert zlib_plain.compress(data, clevel) == stream, label
    assert checked > 500
