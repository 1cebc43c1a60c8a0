"""The port's blosc codec (``csrc/blosc.c`` through ``io/blosc.py``) at
its default, blosc-lz4, against its plain version and against
tensorstore's c-blosc (the other codecs: ``test_torch_blosc_codecs.py``
and ``test_torch_blosc_ts_*.py``).

- The C encoder and the plain encoder write byte-equal frames, and both
  decoders restore the input, on seeded inputs that take every branch
  of the format: uint8 and uint16 and wider types, a tail that is not a
  whole element, a short last block, a stream stored as it is, a
  memcpyed frame (full entropy, or under 128 bytes, or clevel 0), all
  zeros, several clevels, the LZ4 end-of-block rules.
- tensorstore decodes chunks the port wrote, and the port decodes chunks
  tensorstore wrote (split and unsplit streams, shuffled or not, several
  clevels and chunk shapes).
- A bit-shuffled frame decodes; a frame the codec cannot decode, and a
  codec that cannot be built, raise.
"""

import json
import os
import struct

import numpy as np
import pytest

from image_stitcher_tpu.io.zarr_store import create_zarr_array, open_zarr_array
from image_stitcher_tpu_torch.io import blosc
from image_stitcher_tpu_torch.io.zarr_store import (BloscZarrArray,
                                                    EncodePool, read_array)


def _fluorescence(rng, shape, dtype=np.uint16):
    """Dark Poisson background with sparse bright blobs."""
    img = rng.poisson(100, shape).astype(np.float64)
    img += (rng.random(shape) > 0.995) * rng.uniform(500, 3000, shape)
    return np.clip(img, 0, np.iinfo(dtype).max).astype(dtype)


def _inputs():
    rng = np.random.default_rng(2024)
    u16_noise = rng.integers(0, 65536, (128, 128), dtype=np.uint16)
    # the high bytes compress, the low bytes (full entropy) do not: one
    # stream stored as it is in a frame that still shrinks
    stored = (rng.integers(0, 256, (128, 128)) | 0x0300).astype(np.uint16)
    return {
        'u16_fluorescence': (_fluorescence(rng, (256, 384)), 2),
        'u16_full_entropy': (u16_noise, 2),          # memcpyed frame
        'u16_stored_stream': (stored, 2),
        'u16_zero': (np.zeros((128, 128), np.uint16), 2),
        'u8_fluorescence': (_fluorescence(rng, (200, 300)).astype(np.uint8)
                            >> 3, 1),
        'u8_full_entropy': (rng.integers(0, 256, 5000, dtype=np.uint8), 1),
        # 3 blocks of 256 KiB and a short last one
        'u16_short_last_block': (_fluorescence(rng, (700, 600)), 2),
        # type size 2 over an odd byte count: a tail byte left unshuffled
        'tail_byte': (rng.integers(0, 4, 1001, dtype=np.uint8), 2),
        'u32': (rng.integers(0, 300, (100, 100), dtype=np.uint32), 4),
        'f64_ramp': (np.linspace(0, 1, 5000), 8),
        'under_128_bytes': (np.arange(50, dtype=np.uint16), 2),
        # a run ending exactly at the block end: the last 5 bytes must
        # stay literals and no match may start in the last 12
        'u8_run_to_end': (np.concatenate([rng.integers(0, 256, 40),
                                          np.full(300, 7)]).astype(np.uint8),
                          1),
        'u8_13_bytes': (np.full(13, 9, np.uint8), 1),
    }


INPUTS = _inputs()


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("clevel", [1, 5, 9])
def test_c_and_plain_frames_byte_equal(name, clevel):
    data, typesize = INPUTS[name]
    frame = bytes(blosc.compress(data, typesize, clevel))
    assert frame == blosc.compress_plain(data, typesize, clevel), name
    raw = data.tobytes()
    assert blosc.decompress(frame).tobytes() == raw
    assert blosc.decompress_plain(frame) == raw
    flags = frame[2]
    assert frame[:2] == b'\x02\x01' and flags >> 5 == 1 and frame[3] == typesize
    nbytes, blocksize, cbytes = struct.unpack_from('<iii', frame, 4)
    assert (nbytes, cbytes) == (len(raw), len(frame))
    assert blocksize == blosc.blosc_blocksize(clevel, typesize, len(raw))
    memcpyed = bool(flags & 0x02)
    assert memcpyed == (len(frame) == len(raw) + 16)
    if name in ('u16_full_entropy', 'under_128_bytes'):
        assert memcpyed
    if name in ('u16_zero', 'u16_fluorescence', 'u16_stored_stream'):
        assert not memcpyed and len(frame) < len(raw)


def test_frame_features():
    """The inputs above reach the branches they are named for."""
    def streams(frame):
        """(block index, stream size, stream length) of every stream."""
        nbytes, bs = struct.unpack_from('<ii', frame, 4)
        nblocks = -(-nbytes // bs)
        out = []
        for j in range(nblocks):
            pos = struct.unpack_from('<i', frame, 16 + 4 * j)[0]
            last = j == nblocks - 1 and nbytes % bs
            bsize = nbytes % bs if last else bs
            n = 1 if last or frame[2] & 0x10 else frame[3]
            for _ in range(n):
                size = struct.unpack_from('<i', frame, pos)[0]
                out.append((j, size, bsize // n))
                pos += 4 + size
        return out

    stored = bytes(blosc.compress(*INPUTS['u16_stored_stream']))
    s = streams(stored)
    # the low bytes (full entropy) stored as they are, the high bytes
    # compressed
    assert len(s) == 2 and s[0][1] == s[0][2] and s[1][1] < s[1][2]
    short = bytes(blosc.compress(*INPUTS['u16_short_last_block']))
    s = streams(short)
    nbytes, bs = struct.unpack_from('<ii', short, 4)
    assert bs == 1 << 18 and nbytes % bs and s[-1][0] == nbytes // bs
    assert sum(1 for j, *_ in s if j == s[-1][0]) == 1   # not split
    assert not short[2] & 0x10 and short[2] & 0x01       # split, shuffled
    tail = bytes(blosc.compress(*INPUTS['tail_byte']))
    assert struct.unpack_from('<i', tail, 4)[0] % 2 == 1
    assert bytes(blosc.compress(np.zeros(4096, np.uint8), 1, 0))[2] & 0x02


@pytest.mark.parametrize("n", [0, 1, 5, 12, 13, 17, 64, 1000])
def test_lz4_block_end_rules(n):
    """Blocks of every small length: the C and plain matchers agree, both
    decoders restore the input, the last 5 bytes are literals."""
    rng = np.random.default_rng(n)
    for data in (bytes(n), rng.integers(0, 3, n, dtype=np.uint8).tobytes()):
        block = blosc.lz4_compress_block(data)
        assert block == blosc.lz4_compress_block_plain(data)
        assert blosc.lz4_decompress_block(block, n) == data
        assert blosc.lz4_decompress_block_plain(block, n) == data
        # the last sequence is literals only, and at least 5 of them
        # (or the whole block)
        assert block[-min(n, 5):] == data[-min(n, 5):] if n else True


def test_decoders_read_overlapping_and_long_lengths():
    """Blocks another encoder may write: a match overlapping its own
    output (offset 2, length 300) and 255-continued lengths; truncated
    blocks and an offset of 0 raise."""
    # 'ab' + match(offset 2, length 300) + 5 literals
    m = 300 - 4
    block = bytes([0x2F]) + b'ab' + struct.pack('<H', 2) \
        + bytes([255, m - 15 - 255]) + bytes([0x50]) + b'12345'
    want = b'ab' * 151 + b'12345'
    assert blosc.lz4_decompress_block(block, len(want)) == want
    assert blosc.lz4_decompress_block_plain(block, len(want)) == want
    for bad in (block[:-1], block[:5], bytes([0x1F]) + b'a' + b'\x00\x00'):
        with pytest.raises(blosc.CodecError):
            blosc.lz4_decompress_block(bad, len(want))
        with pytest.raises(blosc.CodecError):
            blosc.lz4_decompress_block_plain(bad, len(want))


# -------------------------------------------------- against tensorstore

def _chunk_files(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names
                  if not n.startswith('.'))


@pytest.mark.parametrize("dtype, shape, chunks", [
    (np.uint16, (1, 1, 1, 300, 200), (1, 1, 1, 128, 128)),
    (np.uint8, (1, 2, 1, 301, 250), (1, 1, 1, 128, 67)),
    # one chunk of 768 x 512 u16 (3 blocks), the second of 2 rows
    (np.uint16, (1, 1, 1, 770, 512), (1, 1, 1, 768, 512)),
    # chunks under 128 bytes: memcpyed frames
    (np.uint16, (1, 1, 1, 20, 20), (1, 1, 1, 7, 9)),
])
def test_tensorstore_reads_port_chunks(tmp_path, dtype, shape, chunks):
    """Arrays the port's writer wrote (compressible and full-entropy
    planes, an all-zero plane) open with tensorstore and decode equal;
    the chunks equal to the fill value are not stored."""
    rng = np.random.default_rng(11)
    data = _fluorescence(rng, shape).astype(dtype)
    data[..., :5, :] = rng.integers(0, np.iinfo(dtype).max, data[..., :5, :]
                                    .shape, dtype=dtype)
    data[..., -3:, :] = 0
    pool = EncodePool(workers=3)
    arr = BloscZarrArray(str(tmp_path / "a"), shape, chunks, dtype, pool)
    for c in range(shape[1]):
        # in two slabs that split a chunk row
        arr.write_plane_rows(0, c, 0, 0, data[0, c, 0, :61])
        arr.write_plane_rows(0, c, 0, 61, data[0, c, 0, 61:])
    arr.flush()
    pool.close()
    got = np.asarray(open_zarr_array(str(tmp_path / "a")).read().result())
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(read_array(str(tmp_path / "a")), data)
    # tensorstore writes the same set of chunk files
    ref = create_zarr_array(str(tmp_path / "b"), shape, chunks, dtype,
                            cname='lz4', clevel=5, shuffle=1)
    ref.write(data).result()
    assert _chunk_files(str(tmp_path / "a")) == _chunk_files(str(tmp_path
                                                                 / "b"))
    with open(tmp_path / "a" / ".zarray") as f, \
            open(tmp_path / "b" / ".zarray") as g:
        assert json.load(f) == json.load(g)


def test_tensorstore_reads_a_tail_byte_frame(tmp_path):
    """A frame whose type size does not divide its byte count (the tail
    byte left unshuffled) decodes in tensorstore to the same bytes."""
    data = np.random.default_rng(3).integers(0, 4, (7, 143), dtype=np.uint8)
    shape = (1, 1, 1) + data.shape
    create_zarr_array(str(tmp_path / "a"), shape, shape, np.uint8,
                      cname='lz4', clevel=5, shuffle=1)
    frame = bytes(blosc.compress(data, 2))
    assert data.nbytes % 2 == 1 and not frame[2] & 0x02
    os.makedirs(tmp_path / "a" / "0" / "0" / "0" / "0")
    with open(tmp_path / "a" / "0" / "0" / "0" / "0" / "0", "wb") as f:
        f.write(frame)
    got = np.asarray(open_zarr_array(str(tmp_path / "a")).read().result())
    np.testing.assert_array_equal(got[0, 0, 0], data)


@pytest.mark.parametrize("clevel, shuffle", [(1, 1), (5, 1), (9, 1), (5, 0)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_port_reads_tensorstore_chunks(tmp_path, clevel, shuffle, dtype):
    """Chunks tensorstore wrote (its c-blosc's block sizes and LZ4 match
    finder) decode equal with the C decoder and the plain one."""
    rng = np.random.default_rng(clevel * 10 + shuffle)
    shape = (1, 1, 1, 600, 700)
    data = _fluorescence(rng, shape).astype(dtype)
    data[..., :8, :] = rng.integers(0, np.iinfo(dtype).max, (8, 700),
                                    dtype=dtype)
    path = str(tmp_path / "ts")
    a = create_zarr_array(path, shape, (1, 1, 1, 512, 512), dtype,
                          cname='lz4', clevel=clevel, shuffle=shuffle)
    a.write(data).result()
    np.testing.assert_array_equal(read_array(path), data)
    for rel in _chunk_files(path):
        with open(os.path.join(path, rel), 'rb') as f:
            frame = f.read()
        assert blosc.decompress_plain(frame) == \
            blosc.decompress(frame).tobytes()


def test_unsupported_and_corrupt_frames_raise(tmp_path):
    """A bit-shuffled store tensorstore wrote decodes (C and plain); a
    frame whose compressor code (5-7) names no codec raises, naming it;
    corrupt and truncated frames raise."""
    rng = np.random.default_rng(5)
    data = _fluorescence(rng, (1, 1, 1, 64, 64))
    path = str(tmp_path / "bit")
    a = create_zarr_array(path, data.shape, data.shape, np.uint16,
                          cname='lz4', clevel=5, shuffle=2)   # bit shuffle
    a.write(data).result()
    np.testing.assert_array_equal(read_array(path), data)
    with open(os.path.join(path, *'00000'), 'rb') as f:
        bit = f.read()
    assert bit[2] & 0x04 and not bit[2] & 0x03
    assert blosc.decompress_plain(bit) == data.tobytes()
    frame = bytearray(blosc.compress(data, 2))
    for code in (5, 6, 7):
        other = bytearray(frame)
        other[2] = (other[2] & 0x1F) | code << 5
        for decode in (blosc.decompress, blosc.decompress_plain):
            with pytest.raises(blosc.CodecError,
                               match=f"compressor code {code}"):
                decode(bytes(other))
    frame[-40:] = bytes(40)
    for decode in (blosc.decompress, blosc.decompress_plain):
        with pytest.raises(blosc.CodecError):
            decode(bytes(frame))
        with pytest.raises(blosc.CodecError):
            decode(bytes(frame[:10]))


def test_missing_compiler_raises(tmp_path, monkeypatch):
    """No C compiler: asking for blosc chunks raises; nothing writes raw
    chunks or runs the plain codec instead."""
    from image_stitcher_tpu_torch import native
    monkeypatch.setattr(native, 'BUILD_ROOT', str(tmp_path / "build"))
    monkeypatch.setattr(native, '_LIBS', {})
    monkeypatch.setattr(blosc, '_LIB', None)
    monkeypatch.delenv('CC', raising=False)
    monkeypatch.setenv('PATH', str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="no C compiler"):
        BloscZarrArray(str(tmp_path / "a"), (1, 1, 1, 8, 8), (1, 1, 1, 8, 8),
                       np.uint16, pool=None)
    assert not (tmp_path / "a").exists()
    with pytest.raises(RuntimeError, match="no C compiler"):
        blosc.compress(np.zeros(256, np.uint8), 1)
