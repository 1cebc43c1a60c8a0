"""The C tile decoders (``csrc/tile_decode.c``) against their plain
versions (``io/tile_decode.py``) and the data they were made from, on
seeded inputs: TIFF LZW, PackBits, the horizontal predictor at 8, 16, 32
and 64 bits with 1-4 samples a pixel, the floating-point predictor at 32
and 64 bits, and every PNG filter at 1-8 bytes a pixel. Exact equality
throughout, corrupt inputs included (both raise, or both return the same
bytes)."""

import numpy as np
import pytest

from torch_tile_files import (apply_fp_predictor, apply_predictor,
                              lzw_encode, packbits_encode, png_filter)
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
    for fn in (td.lzw_decode, td.lzw_decode_plain):
        with pytest.raises(NotImplementedError, match="item 6"):
            fn(b'\x00\x01\x02\x03', 10)


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
