"""The C tile decoders (``csrc/tile_decode.c``) against their plain
versions (``io/tile_decode.py``) and the data they were made from, on
seeded inputs: TIFF LZW, PackBits, the horizontal predictor at 8, 16, 32
and 64 bits with 1-4 samples a pixel, the floating-point predictor at 32
and 64 bits, every PNG filter at 1-8 bytes a pixel, old-style LZW, the
FillOrder 2 bit reversal, packed samples of 1-16 bits, CCITT in every
mode (Modified Huffman, T.4 1-D and 2-D with and without fill bits,
T.6) and BMP RLE8 / RLE4. Exact equality throughout, corrupt inputs
included (both raise, or both return the same bytes)."""

import numpy as np
import pytest

from torch_tile_files import (apply_fp_predictor, apply_predictor,
                              ccitt_encode, lzw_encode, lzw_encode_old,
                              pack_samples, packbits_encode, png_filter,
                              reverse_bits, rle_encode)
from image_stitcher_tpu_torch.io import tile_decode as td


def _sources(seed):
    """Byte strings of several kinds: full entropy, a small alphabet (long
    LZW strings, the table filling and clearing several times), long runs
    and a smooth 16-bit ramp, and the empty and one-byte inputs."""
    rng = np.random.default_rng(seed)
    runs = np.repeat(rng.integers(0, 256, 600, dtype=np.uint8),
                     rng.integers(1, 300, 600))
    ramp = (np.arange(30000) * 7 + rng.integers(0, 4, 30000)).astype('<u2')
    return {
        'entropy': rng.integers(0, 256, 40000, dtype=np.uint8).tobytes(),
        'alphabet': rng.integers(0, 3, 90000, dtype=np.uint8).tobytes(),
        'runs': runs.tobytes(),
        'ramp16': ramp.tobytes(),
        'one': b'\x07',
        'empty': b'',
    }


KINDS = list(_sources(0))


@pytest.mark.parametrize("kind", KINDS)
def test_lzw_matches_plain_and_source(kind):
    data = _sources(1)[kind]
    enc = lzw_encode(data)
    got = td.lzw_decode(enc, len(data))
    assert got.tobytes() == data
    assert td.lzw_decode_plain(enc, len(data)).tobytes() == data
    # a destination shorter than the strip cuts the last string
    cut = max(0, len(data) - 77)
    assert td.lzw_decode(enc, cut).tobytes() == data[:cut]
    assert td.lzw_decode_plain(enc, cut).tobytes() == data[:cut]


def test_lzw_truncated_and_corrupt_inputs_agree():
    data = _sources(2)['alphabet']
    enc = lzw_encode(data)
    for n in (1, 2, 3, 100, len(enc) // 2, len(enc) - 1):
        a = td.lzw_decode(enc[:n], len(data))
        b = td.lzw_decode_plain(enc[:n], len(data))
        assert a.tobytes() == b.tobytes() == data[:len(a)]
    rng = np.random.default_rng(3)
    for trial in range(40):
        bad = bytearray(enc[:400])
        bad[rng.integers(2, len(bad))] ^= 1 << int(rng.integers(0, 8))
        outs = []
        for fn in (td.lzw_decode, td.lzw_decode_plain):
            try:
                outs.append(fn(bytes(bad), len(data)).tobytes())
            except td.DecodeError:
                outs.append('corrupt')
        assert outs[0] == outs[1], trial


def test_lzw_old_style_is_not_ported():
    """Old-style (LSB-first) LZW, which raised naming item 6 until its
    remainder was ported, decodes (libtiff's LZWDecodeCompat): a short
    stream alike in C and in Python, and a real one to its source."""
    outs = [fn(b'\x00\x01\x02\x03', 10).tobytes()
            for fn in (td.lzw_decode, td.lzw_decode_plain)]
    assert outs[0] == outs[1]
    data = _sources(5)['alphabet'][:5000]
    enc = lzw_encode_old(data)
    assert enc[0] == 0 and enc[1] & 1
    for fn in (td.lzw_decode, td.lzw_decode_plain):
        assert fn(enc, len(data)).tobytes() == data


@pytest.mark.parametrize("kind", KINDS)
def test_packbits_matches_plain_and_source(kind):
    data = _sources(4)[kind]
    enc = packbits_encode(data)
    assert td.packbits_decode(enc, len(data)).tobytes() == data
    assert td.packbits_decode_plain(enc, len(data)).tobytes() == data
    # a no-op header (-128), a cut destination and a cut source agree
    odd = b'\x80' + enc + b'\x80'
    for size, src in ((len(data), odd), (len(data) // 3, enc),
                      (len(data), enc[:len(enc) // 2])):
        assert (td.packbits_decode(src, size).tobytes()
                == td.packbits_decode_plain(src, size).tobytes())


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32,
                                   np.uint64])
@pytest.mark.parametrize("spp", [1, 2, 3, 4])
def test_predictor_matches_plain_and_source(dtype, spp):
    rng = np.random.default_rng(5 + spp)
    src = rng.integers(0, np.iinfo(dtype).max, (23, 41 * spp),
                       dtype=np.uint64).astype(dtype)
    diff = apply_predictor(src, spp)
    got = td.undo_predictor(diff.copy(), spp)
    assert np.array_equal(got, src)
    assert np.array_equal(td.undo_predictor_plain(diff.copy(), spp), src)


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64])
@pytest.mark.parametrize("spp", [1, 2, 3, 4])
def test_fp_predictor_matches_plain_and_source(dtype, spp):
    """Predictor 3: C and plain give the source's native samples back;
    on any bytes (not a predicted row) the two agree byte for byte."""
    rng = np.random.default_rng(11 + spp)
    src = (rng.standard_normal((17, 29 * spp)) * 1e3).astype(dtype)
    src[3, :5] = [0.0, -0.0, np.inf, np.nan,
                  1e-40 if dtype != np.float16 else 1e-6]
    diff = apply_fp_predictor(src, spp)
    size = np.dtype(dtype).itemsize
    got = td.undo_fp_predictor(diff.copy(), spp, size)
    assert got.view(dtype).tobytes() == src.tobytes()
    plain = td.undo_fp_predictor_plain(diff.copy(), spp, size)
    assert plain.tobytes() == got.tobytes()
    noise = rng.integers(0, 256, (9, 24 * size), dtype=np.uint8)
    assert (td.undo_fp_predictor(noise.copy(), spp, size).tobytes()
            == td.undo_fp_predictor_plain(noise.copy(), spp, size).tobytes())


def test_fp_predictor_refuses_what_it_cannot_take():
    with pytest.raises(ValueError):       # 3-byte samples
        td.undo_fp_predictor(np.zeros((4, 9), np.uint8), 1, 3)
    with pytest.raises(ValueError):       # rows not whole samples
        td.undo_fp_predictor(np.zeros((4, 10), np.uint8), 1, 4)
    with pytest.raises(ValueError):       # not bytes
        td.undo_fp_predictor(np.zeros((4, 8), np.float32), 1, 4)


def test_predictor_refuses_what_it_cannot_take():
    with pytest.raises(ValueError):
        td.undo_predictor(np.zeros((4, 6), np.int16), 1)
    with pytest.raises(ValueError):
        td.undo_predictor(np.zeros((4, 6), '>u2'), 1)
    with pytest.raises(ValueError):
        td.undo_predictor(np.zeros((4, 12), np.uint8)[:, ::2], 1)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, 'cycle'],
                         ids=['none', 'sub', 'up', 'average', 'paeth',
                              'cycle'])
def test_png_unfilter_matches_plain_and_source(bpp, kind):
    rng = np.random.default_rng(bpp)
    rows = rng.integers(0, 256, (19, 13 * bpp), dtype=np.uint8)
    rows[5:9] = rows[4]          # repeated rows: Up and Paeth predict them
    kinds = [kind] * len(rows) if kind != 'cycle' else [
        r % 5 for r in range(len(rows))]
    data = png_filter(rows, bpp, kinds)
    got = td.png_unfilter(data, *rows.shape, bpp)
    assert np.array_equal(got, rows)
    assert np.array_equal(td.png_unfilter_plain(data, *rows.shape, bpp), rows)


def test_png_unfilter_refuses_a_bad_filter_type():
    data = bytearray(png_filter(np.zeros((3, 6), np.uint8), 2, [0, 1, 2]))
    data[7] = 5
    for fn in (td.png_unfilter, td.png_unfilter_plain):
        with pytest.raises(td.DecodeError):
            fn(bytes(data), 3, 6, 2)
        with pytest.raises(td.DecodeError):
            fn(bytes(data[:-1]), 3, 6, 2)


# --------------------------------------------- the rest of tile input


def _outcome(fn, *args):
    """A decoder's bytes, or 'corrupt' where it raises DecodeError."""
    try:
        return fn(*args).tobytes()
    except td.DecodeError:
        return 'corrupt'


@pytest.mark.parametrize("kind", KINDS)
def test_lzw_old_style_matches_plain_and_source(kind):
    data = _sources(6)[kind][:20000]
    enc = lzw_encode_old(data)
    for fn in (td.lzw_decode, td.lzw_decode_plain):
        assert fn(enc, len(data)).tobytes() == data
        cut = max(0, len(data) - 77)
        assert fn(enc, cut).tobytes() == data[:cut]


def test_lzw_old_style_truncated_and_corrupt_inputs_agree():
    data = _sources(7)['alphabet'][:8000]
    enc = lzw_encode_old(data)
    for n in (2, 3, 100, len(enc) // 2, len(enc) - 1):
        a = td.lzw_decode(enc[:n], len(data))
        assert a.tobytes() == td.lzw_decode_plain(enc[:n], len(data)
                                                  ).tobytes() == data[:len(a)]
    rng = np.random.default_rng(8)
    for trial in range(60):
        bad = bytearray(enc[:300])
        bad[rng.integers(2, len(bad))] ^= 1 << int(rng.integers(0, 8))
        assert _outcome(td.lzw_decode, bytes(bad), len(data)) == \
            _outcome(td.lzw_decode_plain, bytes(bad), len(data)), trial


def test_reverse_bits_matches_plain():
    data = np.random.default_rng(9).integers(0, 256, 5000, dtype=np.uint8)
    want = np.frombuffer(reverse_bits(data.tobytes()), np.uint8)
    assert np.array_equal(td.reverse_bits(data), want)
    assert np.array_equal(td.reverse_bits_plain(data), want)
    assert np.array_equal(td.reverse_bits(want), data)


@pytest.mark.parametrize("bits", range(1, 17))
def test_unpack_samples_matches_plain_and_source(bits):
    rng = np.random.default_rng(bits)
    for count in (1, 5, 13, 64, 2049):
        values = rng.integers(0, 1 << bits, (6, count))
        packed = pack_samples(values, bits)
        for fn in (td.unpack_samples, td.unpack_samples_plain):
            got = fn(packed, 6, packed.shape[1], count, bits)
            assert got.dtype == (np.uint8 if bits <= 8 else np.uint16)
            np.testing.assert_array_equal(got, values)


def _bilevel(seed, h, w):
    """0/1 rows with a few of everything: noise of several densities,
    long runs (past 64, 1728 and 2560 pixels), solid and empty rows."""
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w)) < rng.choice([0.02, 0.3, 0.7], (h, 1))
           ).astype(np.uint8)
    img[h // 3] = 1
    img[h // 2] = 0
    img[2 * h // 3:, w // 5:w // 2] = 1
    return img


CCITT_MODES = [(2, 0), (3, 0), (3, 1), (3, 4), (3, 5), (4, 0)]


@pytest.mark.parametrize("compression,options", CCITT_MODES,
                         ids=['mh', 't4', 't4-2d', 't4-fill', 't4-2d-fill',
                              't6'])
@pytest.mark.parametrize("w", [1, 7, 61, 3000])
def test_ccitt_matches_plain_and_source(compression, options, w):
    img = _bilevel(w + compression + options, 23, w)
    data = ccitt_encode(img, compression, options)
    want = np.packbits(img, axis=1)
    for fn in (td.ccitt_decode, td.ccitt_decode_plain):
        np.testing.assert_array_equal(
            fn(data, 23, w, compression, options), want)


@pytest.mark.parametrize("compression,options", CCITT_MODES[:3] + [(4, 0)])
def test_ccitt_truncated_and_corrupt_inputs_agree(compression, options):
    rng = np.random.default_rng(compression + options)
    img = _bilevel(3, 9, 40)
    data = ccitt_encode(img, compression, options)
    for n in (0, 1, len(data) // 2, len(data) - 1):
        assert _outcome(td.ccitt_decode, data[:n], 9, 40, compression,
                        options) == _outcome(td.ccitt_decode_plain, data[:n],
                                             9, 40, compression, options)
    for trial in range(80):
        bad = bytearray(data)
        bad[rng.integers(0, len(bad))] ^= 1 << int(rng.integers(0, 8))
        junk = rng.integers(0, 256, rng.integers(1, 40), dtype=np.uint8)
        for case in (bytes(bad), junk.tobytes()):
            assert _outcome(td.ccitt_decode, case, 9, 40, compression,
                            options) == _outcome(td.ccitt_decode_plain, case,
                                                 9, 40, compression,
                                                 options), trial


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("w", [1, 2, 3, 17, 300])
def test_bmp_rle_matches_plain_and_source(bits, w):
    rng = np.random.default_rng(w * bits)
    idx = rng.integers(0, 1 << bits, (9, w)).astype(np.uint8)
    idx[2] = 5
    idx[4, :w // 2] = 3
    idx[6] = np.repeat(rng.integers(0, 1 << bits, w // 4 + 1), 4)[:w]
    data = rle_encode(idx, bits)
    for fn in (td.bmp_rle_decode, td.bmp_rle_decode_plain):
        np.testing.assert_array_equal(fn(data, w, 9, bits)[::-1], idx)


@pytest.mark.parametrize("bits", [8, 4])
def test_bmp_rle_escapes_and_corrupt_inputs_agree(bits):
    """Deltas, EOF, EOL after a full row, absolute runs of odd length, and
    damaged or random streams: C and plain agree."""
    w, h = 8, 5
    streams = [bytes([3, 7, 0, 2, 2, 1, 2, 9, 0, 0, 0, 1]),
               bytes([8, 5, 0, 0, 8, 6, 0, 0, 0, 1]),
               bytes([0, 8, 1, 2, 3, 4, 5, 6, 7, 8, 0, 0, 4, 9, 0, 1]),
               bytes([0, 3, 1, 2, 3, 0, 5, 4, 0, 0, 0, 1]),
               bytes([2, 4, 0, 2, 7, 0, 3, 5, 0, 1]),
               bytes([8, 1, 0, 0] * 5)]
    rng = np.random.default_rng(bits)
    for trial in range(150):
        base = bytearray(streams[trial % len(streams)])
        base[rng.integers(0, len(base))] = int(rng.integers(0, 256))
        streams.append(bytes(base))
        streams.append(rng.integers(0, 12, rng.integers(2, 30),
                                    dtype=np.uint8).tobytes())
    for k, data in enumerate(streams):
        assert _outcome(td.bmp_rle_decode, data, w, h, bits) == \
            _outcome(td.bmp_rle_decode_plain, data, w, h, bits), k
