"""The port's blosc codecs other than its default (``csrc/blosc.c`` and
``csrc/codec_*.h`` through ``io/blosc.py``; the plain versions in
``io/blosc.py``, ``io/blosclz_plain.py``, ``io/snappy_plain.py`` and
``io/zstd_plain.py``), beyond the tensorstore matrix of
``test_torch_blosc_ts_*.py``:

- C frames byte-equal to the plain version's, and both decoders exact,
  on inputs that take the frame layer's branches (tails, wide types,
  memcpyed frames, short last blocks) with byte and bit shuffle;
- each codec's streams: C byte-equal to plain at every small length,
  both decoders exact, corrupt streams raising;
- the zstd decoders on libzstd's frames (``zstandard``, present only on
  the CPU test host): levels 1, 3, 9, 19 and 22, with and without the
  content size and the checksum, several blocks, which between them
  take treeless literals, 4 streams, FSE-coded weights and every
  sequence mode; skippable and concatenated frames;
- tensorstore decoding the port's blosclz far matches and long lengths
  and snappy's every tag;
- bit shuffle's layout, and c-blosc's whole-block copy when the element
  count is not a multiple of 8;
- the size bar: on ``chip_smoke.compressible``, each codec's frame at
  most 1.15x tensorstore's bytes for the same settings;
- no fallback: a codec that cannot be built raises, for every cname;
- every clevel 0-9 and shuffle of every cname validates and writes what
  tensorstore reads.
"""

import os
import struct

import numpy as np
import pytest
import zstandard

import chip_smoke
from image_stitcher_tpu.io.zarr_store import create_zarr_array, open_zarr_array
from image_stitcher_tpu_torch.io import (blosc, blosclz_plain, snappy_plain,
                                         zstd_plain)
from image_stitcher_tpu_torch.io.zarr_store import BloscZarrArray

CNAMES = blosc.CNAMES
PLAIN_STREAM = {'lz4': blosc.lz4_compress_block_plain,
                'lz4hc': blosc.lz4hc_compress_block_plain,
                'blosclz': blosclz_plain.compress,
                'snappy': snappy_plain.compress,
                'zstd': zstd_plain.compress}
PLAIN_DECODE = {'lz4': blosc.lz4_decompress_block_plain,
                'lz4hc': blosc.lz4_decompress_block_plain,
                'blosclz': blosclz_plain.decompress,
                'snappy': snappy_plain.decompress,
                'zstd': zstd_plain.decompress}


def _inputs():
    rng = np.random.default_rng(99)
    fl = rng.poisson(100, (120, 160)) + (rng.random((120, 160)) > 0.99) * 900
    return {
        'u16': (fl.astype(np.uint16), 2),
        'u8': ((fl >> 2).astype(np.uint8), 1),
        # 2 blocks of 32 KiB for the high-compression codecs at clevel 1
        # (one for the others) and a short last one
        'u16_blocks': (np.tile(fl.astype(np.uint16), (3, 1))[:300], 2),
        'tail_byte': (rng.integers(0, 4, 1001, dtype=np.uint8), 2),
        # 1003 elements: bit shuffle copies every block as it is
        'not_8_elements': (rng.integers(0, 9, 1003, dtype=np.uint16), 2),
        'u32': (rng.integers(0, 300, (40, 50), dtype=np.uint32), 4),
        'f64_ramp': (np.linspace(0, 1, 3000), 8),
        'full_entropy': (rng.integers(0, 256, 4000, dtype=np.uint8), 1),
        'zeros': (np.zeros(5000, np.uint8), 1),
        'under_128_bytes': (np.arange(50, dtype=np.uint16), 2),
    }


INPUTS = _inputs()


@pytest.mark.parametrize("shuffle", [1, 2])
@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("cname", CNAMES)
def test_c_and_plain_frames_byte_equal(cname, name, shuffle):
    data, typesize = INPUTS[name]
    clevel = 1 if cname in ('zstd', 'lz4hc') else 5
    frame = bytes(blosc.compress(data, typesize, clevel, shuffle, cname))
    assert frame == blosc.compress_plain(data, typesize, clevel, shuffle,
                                         cname)
    raw = data.tobytes()
    assert blosc.decompress(frame).tobytes() == raw
    assert blosc.decompress_plain(frame) == raw
    flags = frame[2]
    assert flags >> 5 == blosc._CODE[cname] and frame[3] == typesize
    nbytes, bs, cbytes = struct.unpack_from('<iii', frame, 4)
    assert (nbytes, cbytes) == (len(raw), len(frame))
    assert bs == blosc.blosc_blocksize(clevel, typesize, nbytes, cname)
    assert bool(flags & 0x10) == (not blosc._split(typesize, bs, cname))
    assert bool(flags & (0x01 if shuffle == 1 else 0x04))
    if name in ('full_entropy', 'under_128_bytes'):
        assert flags & 0x02
    if name in ('zeros', 'u16', 'u16_blocks'):
        assert not flags & 0x02 and len(frame) < len(raw)


@pytest.mark.parametrize("cname", CNAMES)
def test_clevel_0_and_auto_shuffle(cname):
    """clevel 0 stores the input (memcpyed); shuffle -1 bit-shuffles
    1-byte types and byte-shuffles wider ones."""
    data, _ = INPUTS['u16']
    frame = bytes(blosc.compress(data, 2, 0, 1, cname))
    assert frame[2] & 0x02 and frame[16:] == data.tobytes()
    for typesize, flag in ((1, 0x04), (2, 0x01)):
        frame = bytes(blosc.compress(data, typesize, 5, -1, cname))
        assert frame[2] & 0x05 == flag
        assert frame == blosc.compress_plain(data, typesize, 5, -1, cname)
        assert blosc.decompress(frame).tobytes() == data.tobytes()


@pytest.mark.parametrize("cname", [c for c in CNAMES if c != 'zlib'])
def test_streams_at_every_small_length(cname):
    """Streams of 0..80 bytes and a few longer ones: C equals plain, both
    decoders give the input back."""
    rng = np.random.default_rng(len(cname))
    lengths = list(range(0, 81)) + [255, 256, 1000, 4097]
    for n in lengths:
        for data in (bytes(n), rng.integers(0, 3, n, dtype=np.uint8)
                     .tobytes(), rng.integers(0, 256, n, dtype=np.uint8)
                     .tobytes()):
            for clevel in (1, 9):
                if n == 0 and cname not in ('zstd', 'snappy', 'lz4',
                                            'lz4hc'):
                    continue
                stream = blosc.stream_compress(cname, data, clevel)
                assert stream == PLAIN_STREAM[cname](data, clevel), n
                assert blosc.stream_decompress(cname, stream, n) == data
                assert PLAIN_DECODE[cname](stream, n) == data


@pytest.mark.parametrize("cname", [c for c in CNAMES if c != 'zlib'])
def test_corrupt_streams_raise(cname):
    rng = np.random.default_rng(3)
    data = rng.integers(0, 4, 3000, dtype=np.uint8).tobytes() * 2
    stream = blosc.stream_compress(cname, data, 5)
    bad = [stream[:len(stream) // 2], stream[:-1] if cname != 'zstd'
           else stream[:-3]]
    for s in bad:
        with pytest.raises(blosc.CodecError):
            blosc.stream_decompress(cname, s, len(data))
        with pytest.raises(blosc.CodecError):
            PLAIN_DECODE[cname](s, len(data))
    # the right stream, the wrong size
    with pytest.raises(blosc.CodecError):
        blosc.stream_decompress(cname, stream, len(data) + 1)
    with pytest.raises(blosc.CodecError):
        PLAIN_DECODE[cname](stream, len(data) + 1)


# ------------------------------------------------------- zstd and libzstd

def _zstd_blocks(frame):
    """(block type, literals type, literal streams, sequence modes) of
    every block of a single zstd frame, read from its headers."""
    fhd = frame[4]
    fcs_flag, single, dflag = fhd >> 6, (fhd >> 5) & 1, fhd & 3
    pos = 5 + (0 if single else 1) + (4 if dflag == 3 else dflag) + \
        (single if fcs_flag == 0 else 1 << fcs_flag)
    out = []
    while True:
        bh = int.from_bytes(frame[pos:pos + 3], 'little')
        pos += 3
        last, btype, size = bh & 1, (bh >> 1) & 3, bh >> 3
        lit = seq = streams = None
        if btype == 2:
            b0 = frame[pos]
            lit, sf = b0 & 3, (b0 >> 2) & 3
            if lit < 2:
                hs = (1, 2, 1, 3)[sf]
                regen = b0 >> 3 if sf in (0, 2) else \
                    int.from_bytes(frame[pos:pos + hs], 'little') >> 4
                lsize = hs + (1 if lit == 1 else regen)
            else:
                hs = (3, 3, 4, 5)[sf]
                bits = (10, 10, 14, 18)[sf]
                h = int.from_bytes(frame[pos:pos + hs], 'little')
                lsize = hs + ((h >> (4 + bits)) & ((1 << bits) - 1))
                streams = 1 if sf == 0 else 4
            p = pos + lsize
            nseq = frame[p]
            p += 1 if nseq < 128 else 2 if nseq < 255 else 3
            if nseq:
                m = frame[p]
                seq = (m >> 6, (m >> 4) & 3, (m >> 2) & 3)
        out.append((btype, lit, streams, seq))
        pos += 1 if btype == 1 else size
        if last:
            return out


def _zstd_sample(n):
    rng = np.random.default_rng(n)
    fl = (rng.poisson(100, n // 2) + (rng.random(n // 2) > 0.995) * 2000)
    words = fl.astype(np.uint16)
    # repeats of earlier stretches: repeat offsets and long matches
    words[n // 8:n // 8 + 4000] = words[:4000]
    return np.ascontiguousarray(words.view(np.uint8).reshape(-1, 2).T) \
        .tobytes()


def test_zstd_decoders_read_libzstd_frames():
    """Every level the blosc clevels reach (1..9 and 22), with and without
    content size and checksum, over 5 blocks: the C decoder exact; the
    plain one on each setting over 3 blocks. Between them the frames use
    raw, RLE, Huffman and treeless literals, 1 and 4 streams, and every
    sequence mode."""
    big, small = _zstd_sample(600_000), _zstd_sample(300_000)
    seen_lit, seen_modes, seen_streams = set(), set(), set()
    for level in (1, 3, 9, 19, 22):
        for kw in ({}, dict(write_content_size=False),
                   dict(write_checksum=True)):
            cctx = zstandard.ZstdCompressor(level=level, **kw)
            frame = cctx.compress(big)
            assert blosc.stream_decompress('zstd', frame, len(big)) == big
            for btype, lit, streams, seq in _zstd_blocks(frame):
                seen_lit.add(lit)
                seen_streams.add(streams)
                seen_modes.update(seq or ())
            if kw or level in (1, 19):
                frame = cctx.compress(small)
                assert zstd_plain.decompress(frame, len(small)) == small
                assert zstd_plain.decompress(frame) == small
    assert {0, 2, 3} <= seen_lit and {1, 4} <= seen_streams
    assert {0, 2, 3} <= seen_modes
    # RLE literals and RLE sequence codes: a stretch of one byte with
    # the same short match over and over
    rle = b'x' * 40 + b'ab' * 5000 + b'y' * 3000
    frame = zstandard.ZstdCompressor(level=3).compress(rle)
    assert blosc.stream_decompress('zstd', frame, len(rle)) == rle
    assert zstd_plain.decompress(frame) == rle


def test_zstd_skippable_and_concatenated_frames():
    a, b = b'first frame ' * 100, bytes(range(256)) * 40
    skip = struct.pack('<II', 0x184D2A53, 5) + b'12345'
    stream = (skip + zstandard.ZstdCompressor(level=5).compress(a) + skip
              + blosc.stream_compress('zstd', b, 9))
    assert blosc.stream_decompress('zstd', stream, len(a + b)) == a + b
    assert zstd_plain.decompress(stream, len(a + b)) == a + b
    # a dictionary frame is refused
    dict_frame = bytearray(zstandard.ZstdCompressor(level=1).compress(a))
    with pytest.raises(blosc.CodecError):
        blosc.stream_decompress('zstd', bytes(dict_frame[:5]) + b'\x01'
                                + bytes(dict_frame[5:]), len(a))


def test_port_zstd_frames_decode_in_libzstd():
    """The port's zstd frames (its own encoder) decode in libzstd at
    every clevel, over several blocks, and name their content size."""
    data = _zstd_sample(400_000)
    for clevel in range(10):
        frame = blosc.stream_compress('zstd', data, clevel)
        params = zstandard.get_frame_parameters(frame)
        assert params.content_size == len(data) and not params.has_checksum
        assert zstandard.ZstdDecompressor().decompress(frame) == data


# ------------------------------------------- tensorstore on chosen inputs

def _ts_decodes(tmp_path, frame, data):
    """tensorstore decodes ``frame`` as the only chunk of a u8 array."""
    shape = (1, 1, 1, 1, len(data))
    path = str(tmp_path / f"a{len(data)}")
    create_zarr_array(path, shape, shape, np.uint8, cname='lz4')
    os.makedirs(os.path.join(path, *'0000'), exist_ok=True)
    with open(os.path.join(path, *'00000'), 'wb') as f:
        f.write(frame)
    got = np.asarray(open_zarr_array(path).read().result()).tobytes()
    assert got == data


def test_tensorstore_reads_blosclz_far_matches_and_long_lengths(tmp_path):
    """Matches 70000 and 18000 bytes back (the far form) and a 300-byte
    run (the continued length), which c-blosc's own encoder may never
    write, decode in tensorstore."""
    rng = np.random.default_rng(8)
    head = rng.integers(0, 256, 70000, dtype=np.uint8).tobytes()
    data = head + head[:9000] + head[61000:] + bytes(300) + head[:20]
    frame = bytes(blosc.compress(np.frombuffer(data, np.uint8), 1, 9, 0,
                                 'blosclz'))
    # the 18300 repeated bytes went as matches (the rest is random,
    # its literal runs cost 1 byte in 33): both far matches were taken
    assert not frame[2] & 0x02 and len(frame) < len(data) - 15000
    assert blosc.decompress_plain(frame) == data
    _ts_decodes(tmp_path, frame, data)


def test_snappy_decoders_read_every_tag(tmp_path):
    """A hand-built snappy stream with literal lengths in 1-4 extra bytes,
    copies with 1-, 2- and 4-byte offsets, overlapping, decodes in both
    decoders (tensorstore's snappy writes no 4-byte offsets)."""
    lit = bytes(range(256)) * 300           # 76800 literals: 3 extra bytes
    out = bytearray()
    n = len(lit) + 10 + 64 + 12 + 61
    v = n
    while True:
        out.append((v & 127) | (128 if v >= 128 else 0))
        v >>= 7
        if not v:
            break
    m = len(lit) - 1
    out += bytes([62 << 2]) + m.to_bytes(3, 'little') + lit
    out += bytes([1 | (6 << 2), 2])                          # 10 at 2
    out += bytes([3 | (63 << 2)]) + (70000).to_bytes(4, 'little')  # 64
    out += bytes([2 | (11 << 2)]) + (300).to_bytes(2, 'little')   # 12
    out += bytes([60 << 2, 60]) + b'z' * 61
    want = bytearray(lit)
    for off, ln in ((2, 10), (70000, 64), (300, 12)):
        for _ in range(ln):
            want.append(want[-off])
    want += b'z' * 61
    assert blosc.stream_decompress('snappy', bytes(out), n) == want
    assert snappy_plain.decompress(bytes(out), n) == want


# ------------------------------------------------------------ bit shuffle

def test_bitshuffle_layout():
    """Bit b of byte j of element i lands at bit i % 8 of byte
    (8 j + b) n / 8 + i / 8; a tail that is not a whole element stays;
    a block of a count of elements that is not a multiple of 8 is copied
    as it is; C (through a frame) and plain agree."""
    rng = np.random.default_rng(4)
    elems = rng.integers(0, 65536, 16, dtype=np.uint16)
    block = elems.tobytes() + b'\x07'
    out = blosc.bitshuffle_plain(block, 2)
    bits = np.unpackbits(np.frombuffer(out[:-1], np.uint8), bitorder='little')
    for i in range(16):
        for j in range(2):
            for b in range(8):
                want = (int(elems[i]) >> (8 * j + b)) & 1
                assert bits[((8 * j + b) * 16 // 8 + i // 8) * 8 + i % 8] \
                    == want
    assert out[-1:] == b'\x07'
    assert blosc.bitunshuffle_plain(out, 2) == block
    odd = rng.integers(0, 256, 2 * 13, dtype=np.uint8).tobytes()
    assert blosc.bitshuffle_plain(odd, 2) == odd
    for n in (8, 13, 64, 1000, 1003):
        data = rng.integers(0, 5, n, dtype=np.uint16)
        for cname in ('lz4', 'zstd'):
            frame = bytes(blosc.compress(data, 2, 5, 2, cname))
            assert frame == blosc.compress_plain(data, 2, 5, 2, cname)
            assert blosc.decompress(frame).tobytes() == data.tobytes()


# --------------------------------------------------------------- size bar

@pytest.mark.parametrize("clevel", [1, 5, 9])
def test_sizes_within_115_percent_of_tensorstore(tmp_path, clevel):
    """On the bench's compressible content (2048^2 u16, byte shuffle, and
    bit shuffle for zstd) each codec's frame is at most 1.15x
    tensorstore's."""
    tex = chip_smoke.compressible(np.random.default_rng(0), 2048)
    shape = (1, 1, 1) + tex.shape
    for cname, shuffle in [(c, 1) for c in CNAMES] + [('zstd', 2)]:
        if cname == 'zlib' and clevel == 9:
            continue     # stdlib zlib at 9: as tensorstore's, too slow here
        path = str(tmp_path / f"{cname}{shuffle}")
        create_zarr_array(path, shape, shape, np.uint16, cname=cname,
                          clevel=clevel, shuffle=shuffle).write(
                              tex.reshape(shape)).result()
        want = os.path.getsize(os.path.join(path, *'00000'))
        got = len(blosc.compress(tex, 2, clevel, shuffle, cname))
        assert got <= 1.15 * want, (cname, shuffle, got / want)


# ------------------------------------------------------------- no fallback

@pytest.mark.parametrize("cname", CNAMES)
def test_codec_that_cannot_be_built_raises(tmp_path, monkeypatch, cname):
    """No C compiler: every cname raises where it is asked for; nothing
    writes raw chunks, another codec's, or runs the plain version."""
    from image_stitcher_tpu_torch import native
    monkeypatch.setattr(native, 'BUILD_ROOT', str(tmp_path / "build"))
    monkeypatch.setattr(native, '_LIBS', {})
    monkeypatch.setattr(blosc, '_LIB', None)
    monkeypatch.delenv('CC', raising=False)
    monkeypatch.setenv('PATH', str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="no C compiler"):
        BloscZarrArray(str(tmp_path / "a"), (1, 1, 1, 8, 8), (1, 1, 1, 8, 8),
                       np.uint16, pool=None, cname=cname)
    assert not (tmp_path / "a").exists()
    with pytest.raises(RuntimeError, match="no C compiler"):
        blosc.compress(np.ones(256, np.uint8), 1, 5, 1, cname)


def test_build_hash_covers_included_sources(tmp_path, monkeypatch):
    """An edited codec header (``#include``d by ``blosc.c``) changes the
    build's hash, so the library is rebuilt."""
    import shutil
    from image_stitcher_tpu_torch import native
    src = tmp_path / "csrc"
    shutil.copytree(native.CSRC, src)
    before = native._source_text(str(src / "blosc.c"))
    assert b'zstd_compress' in before and b'blosclz_compress' in before
    with open(src / "codec_zstd.h", 'a') as f:
        f.write("\n/* edited */\n")
    assert native._source_text(str(src / "blosc.c")) != before


def test_invalid_settings_raise():
    for bad in (dict(cname='lz5'), dict(clevel=10), dict(shuffle=3)):
        kw = dict(dict(cname='zstd', clevel=1, shuffle=1), **bad)
        with pytest.raises(ValueError):
            blosc.compress(np.ones(256, np.uint8), 1, kw['clevel'],
                           kw['shuffle'], kw['cname'])


@pytest.mark.parametrize("cname", CNAMES)
def test_every_clevel_and_shuffle_writes_what_tensorstore_reads(tmp_path,
                                                                cname):
    """Every clevel 0-9 and shuffle -1, 0, 1, 2 of a cname: the options
    validate, the port's writer takes them and writes the ``.zarray``
    tensorstore writes, and tensorstore reads its chunks back equal (u8
    and u16, a full chunk and an edge chunk)."""
    import json
    from image_stitcher_tpu_torch import EngineOptions
    from image_stitcher_tpu_torch.io.zarr_store import EncodePool
    rng = np.random.default_rng(17)
    for dtype in (np.uint8, np.uint16):
        data = (rng.poisson(30, (1, 1, 1, 40, 150)) * (np.arange(150) % 7)
                ).astype(dtype)
        for clevel in range(10):
            for shuffle in (-1, 0, 1, 2):
                EngineOptions(compressor_cname=cname,
                              compressor_clevel=clevel,
                              compressor_shuffle=shuffle).validate()
                name = f"{np.dtype(dtype).name}_{clevel}_{shuffle}"
                port_path = str(tmp_path / f"port_{name}")
                ts_path = str(tmp_path / f"ts_{name}")
                pool = EncodePool(workers=2)
                arr = BloscZarrArray(port_path, data.shape, (1, 1, 1, 40, 96),
                                     dtype, pool, clevel, shuffle, cname)
                arr.write_plane_rows(0, 0, 0, 0, data[0, 0, 0])
                arr.flush()
                pool.close()
                create_zarr_array(ts_path, data.shape, (1, 1, 1, 40, 96),
                                  dtype, cname=cname, clevel=clevel,
                                  shuffle=shuffle)
                with open(os.path.join(port_path, '.zarray')) as f, \
                        open(os.path.join(ts_path, '.zarray')) as g:
                    assert json.load(f) == json.load(g), name
                got = np.asarray(open_zarr_array(port_path).read().result())
                np.testing.assert_array_equal(got, data, name)
