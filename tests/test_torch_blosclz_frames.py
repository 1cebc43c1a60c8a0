"""The port's blosclz encoder (``csrc/codec_blosclz.h``, plain version
``io/blosclz_plain.py``: c-blosc 1.x's entropy-probed encoder) against
tensorstore's c-blosc.

- the kept digests ``chip_smoke.py`` phase 12a holds the C encoder to on
  the card (``tests/torch_blosc_frames.npz``, blosclz at clevel 1-9):
  matched by the C frames and streams, and by the plain streams;
- whole blosc frames of ``chip_smoke.compressible`` 1024^2 as u8, u16,
  f32 and i32 at shuffle 0, 1 and 2 and every clevel 0-9, byte-equal to
  tensorstore's, the memcpyed flag included; 256^2 cuts of them through
  the plain version too;
- one case per rule of the encoder, each frame held to tensorstore's:
  the entropy probe's floor at every clevel (a ratio exactly on it
  compresses, one just under it is stored), the shift at a ratio of
  exactly 4 and just under, and in a frame whose blocks are not split;
  clevel 9's second hash; a far match of 5 refused beside a 6 taken and
  a near 5 taken; a run and a match that end at the bound; streams of
  15 and 16 bytes; a stream's room of 65 and 66 bytes; a stream whose
  whole length equals its room, refused at its last literal.
"""

import functools

import numpy as np
import pytest

from torch_blosc_frames import (framed, inputs, load, probe_arrays, sha,
                                tensorstore_frame)
from image_stitcher_tpu_torch.io import blosc, blosclz_plain

#: the kept inputs the plain version runs on
PLAIN_MAX = 65537
PROBES = [(name, shuffle) for name in ('u8', 'u16', 'f32', 'i32')
          for shuffle in (0, 1, 2)]
#: (window bytes, random bytes at its start, zeros after them) whose
#: entropy probe gives exactly each ratio (one zero fewer: just under)
EXACT = {4.0: (4096, 100, 3115), 2.0: (4096, 100, 2121),
         1.5: (4095, 100, 1457), 1.2: (4092, 100, 795),
         1.15: (4083, 100, 649), 1.1: (4093, 101, 493),
         1.0: (4096, 100, 133)}


@functools.lru_cache(maxsize=1)
def _probes():
    return probe_arrays()


def _random(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8) \
        .tobytes()


def _window(w: int, r: int, z: int) -> bytes:
    """w bytes: r random ones, z zeros, then random ones again."""
    rand = _random(w)
    return rand[:r] + bytes(z) + rand[r + z:w]


def _probed(ratio: float, under: bool = False) -> bytes:
    """A stream of 4 w bytes: 3 w zeros, then a window whose probe ratio
    is exactly ``ratio`` (just under it with ``under``)."""
    w, r, z = EXACT[ratio]
    return bytes(3 * w) + _window(w, r, z - under)


def _frames_equal(data, typesize: int = 1, clevel: int = 5,
                  shuffle: int = 0) -> bytes:
    """The C and plain frames of ``data`` are tensorstore's; returns it."""
    arr = np.frombuffer(bytes(data), np.uint8) if isinstance(
        data, (bytes, bytearray)) else data
    want = tensorstore_frame(arr, typesize, clevel, shuffle, 'blosclz')
    assert bytes(blosc.compress(arr, typesize, clevel, shuffle,
                                'blosclz')) == want
    assert blosc.compress_plain(arr, typesize, clevel, shuffle,
                                'blosclz') == want
    return want


def _tokens(stream: bytes):
    """[('lit', start, n) or ('match', start, length, distance)] of a
    blosclz stream, in order."""
    out, ip, pos = [], 1, 0
    ctrl = stream[0] & 31
    while True:
        if ctrl >= 32:
            length, ofs = (ctrl >> 5) - 1, (ctrl & 31) << 8
            if length == 6:
                while True:
                    code = stream[ip]
                    ip += 1
                    length += code
                    if code != 255:
                        break
            code = stream[ip]
            ip += 1
            length += 3
            dist = ofs + code + 1
            if code == 255 and ofs == 31 << 8:
                dist = (stream[ip] << 8) + stream[ip + 1] + 8192
                ip += 2
            out.append(('match', pos, length, dist))
            pos += length
        else:
            out.append(('lit', pos, ctrl + 1))
            ip += ctrl + 1
            pos += ctrl + 1
        if ip >= len(stream):
            return out
        ctrl = stream[ip]
        ip += 1


@pytest.mark.parametrize("clevel", range(1, 10))
def test_kept_digests(clevel):
    """The C frames of every kept input at the clevel (two blocks of
    zeros, then the input) and the C streams of the input are the kept
    tensorstore ones; so are the plain streams of the shorter inputs, in
    the room the frame gives them (the input's length)."""
    kept = load()
    checked = 0
    for label, data in inputs():
        digest, settings = kept[label]
        assert sha(data) == digest, label
        if ('blosclz', clevel) not in settings:
            continue        # longer than the clevel's block
        flen, fsha, slen, ssha = settings['blosclz', clevel]
        frame = bytes(blosc.compress(framed(data, 'blosclz', clevel), 1,
                                     clevel, 0, 'blosclz'))
        assert (len(frame), sha(frame)) == (flen, fsha), label
        c = blosc.stream_compress('blosclz', data, clevel)
        plain = (blosclz_plain.compress(data, clevel, len(data))
                 if len(data) <= PLAIN_MAX else None)
        if slen is None:
            # stored: c-blosc declined, or its stream was no shorter
            assert not c or len(c) >= len(data), label
            assert plain is None or len(plain) in (0, len(data)), label
        else:
            assert (len(c), sha(c)) == (slen, ssha), label
            assert plain is None or plain == c, label
        checked += 1
    assert checked >= 60


@pytest.mark.parametrize("name,shuffle", PROBES)
def test_probe_frames_equal_tensorstore(name, shuffle):
    arr = _probes()[name]
    for clevel in range(10):
        want = tensorstore_frame(arr, arr.itemsize, clevel, shuffle,
                                 'blosclz')
        assert bytes(blosc.compress(arr, arr.itemsize, clevel, shuffle,
                                    'blosclz')) == want, clevel


@pytest.mark.parametrize("name", ('u8', 'u16', 'f32', 'i32'))
def test_probe_cuts_plain_equal_tensorstore(name):
    cut = np.ascontiguousarray(_probes()[name][:256, :256])
    for shuffle in (0, 1, 2):
        for clevel in range(10):
            _frames_equal(cut, cut.itemsize, clevel, shuffle)


@pytest.mark.parametrize("clevel", range(1, 10))
def test_probe_floor(clevel):
    """A probe ratio exactly on the clevel's floor compresses; one just
    under it is stored (a one-block frame: memcpyed)."""
    floor = blosclz_plain.RATIO_FLOOR[clevel - 1]
    at, under = _probed(floor), _probed(floor, under=True)
    assert blosclz_plain.entropy_probe(at) == floor
    assert blosclz_plain.entropy_probe(under) < floor
    assert not _frames_equal(at, clevel=clevel)[2] & 0x02
    assert _frames_equal(under, clevel=clevel)[2] & 0x02
    assert blosc.stream_compress('blosclz', under, clevel) == b''


def test_shift_at_ratio_4():
    """A probe ratio of exactly 4 takes shift and minimum length 4, one
    just under takes 3 (the streams differ from the other shift's);
    a frame whose blocks are not split takes 3 at any ratio."""
    at, under = _probed(4.0), _probed(4.0, under=True)
    assert blosclz_plain.entropy_probe(at) == 4.0
    assert 3.9 < blosclz_plain.entropy_probe(under) < 4.0
    for data in (at, under):
        _frames_equal(data)
    assert blosclz_plain.compress(at, 5, split=False) != \
        blosclz_plain.compress(at, 5)
    # 125 u64 elements: under c-blosc's 128 a split, one stream
    rng = np.random.default_rng(3)
    walk = (np.cumsum(rng.integers(-1, 2, 125)) + 1000).astype(np.uint64)
    walk[63:] = walk[63]
    raw = walk.tobytes()
    assert blosclz_plain.entropy_probe(raw) >= 4.0
    assert blosclz_plain.compress(raw, 5, split=False) != \
        blosclz_plain.compress(raw, 5)
    assert _frames_equal(walk, 8)[2] & 0x10


def test_clevel_9_second_hash():
    """clevel 9 also enters hash(u32 >> 8) after a match: its stream
    differs from clevel 8's (same table, shift and blocks), and both
    frames are tensorstore's."""
    data = dict(inputs())['alphabet4_4096']
    assert blosc.stream_compress('blosclz', data, 8) != \
        blosc.stream_compress('blosclz', data, 9)
    for clevel in (8, 9):
        assert not _frames_equal(data, clevel=clevel)[2] & 0x02


def _repeat_at(m: int, back: int) -> bytes:
    """12288 random bytes with bytes 1000..1000+m copied ``back`` bytes
    later, then 4096 zeros (the probe's window: shift 4)."""
    a = bytearray(_random(12288)) + bytearray(4096)
    a[1000 + back:1000 + back + m] = a[1000:1000 + m]
    return bytes(a)


def test_far_match_of_5_refused():
    """A far match (distance >= 8192) of length code 5 or less is left
    as literals; one of 6 is taken, and so is a near one of 5."""
    def matches(data):
        return [t for t in _tokens(blosc.stream_compress('blosclz', data))
                if t[0] == 'match' and t[1] < 12288]

    assert matches(_repeat_at(9, 10000)) == [('match', 11000, 8, 10000)]
    assert matches(_repeat_at(8, 10000)) == []
    assert matches(_repeat_at(8, 5000)) == [('match', 6000, 7, 5000)]
    for m, back in ((9, 10000), (8, 10000), (8, 5000)):
        _frames_equal(_repeat_at(m, back))


def test_run_and_match_end_at_bound():
    """A run (distance 1) and a match (distance 100) reaching the
    stream's end stop at n - 1 less the shift of 4: 3 literals follow."""
    period = _random(100, 5)
    n = 16384
    run = _random(12000) + bytes(n - 12000)
    match = _random(8000) + (period * 90)[:n - 8000]
    for data, dist in ((run, 1), (match, 100)):
        toks = _tokens(blosc.stream_compress('blosclz', data))
        last = toks[-2]
        assert last[0] == 'match' and last[3] == dist
        assert last[1] + last[2] == n - 3 and toks[-1] == ('lit', n - 3, 3)
        _frames_equal(data)


def test_streams_of_15_and_16_bytes():
    """Under 16 bytes c-blosc declines before its probe, whose window of
    16 / 4 bytes declines the rest (no frame gives such a stream room
    for a stream: its room is at most its length, under 66)."""
    for n in (15, 16):
        assert blosc.stream_compress('blosclz', bytes(n), 9) == b''
        assert blosclz_plain.compress(bytes(n), 9) == b''


def test_room_of_65_and_66():
    """A frame's last stream of zeros after a stored block of random
    bytes: with 65 bytes of room c-blosc declines (the frame is stored),
    with 66 it compresses."""
    for tail, room, stored in ((81, 65, True), (82, 66, False)):
        chunk = _random(65536) + bytes(tail)
        frame = _frames_equal(chunk, clevel=3)
        assert bool(frame[2] & 0x02) == stored
        assert bool(blosclz_plain.compress(bytes(tail), 3, room)) != stored


def test_overflow_at_last_literal():
    """A stream whose whole length equals its room is declined at its
    last literal (a literal asks for 2 bytes of room): the frame is
    stored; one byte shorter, it compresses."""
    w = 4093
    head = _random(3 * w, 7)
    for z, stored in ((517, True), (518, False)):
        stream = head + _window(w, 100, z)
        room = len(stream) - 16      # after one stored block
        assert len(blosclz_plain.compress(stream, 9)) == room - (not stored)
        assert bool(blosclz_plain.compress(stream, 9, room)) != stored
        frame = _frames_equal(_random(262144, 1) + stream, clevel=9)
        assert bool(frame[2] & 0x02) == stored
