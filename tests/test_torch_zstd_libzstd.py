"""The port's zstd encoder at blosc clevel 1 to 9 (``csrc/codec_zstd.h``,
plain version ``io/zstd_plain.py``) against libzstd 1.5.7, whose level
2 * clevel - 1 (22 at clevel 9) c-blosc calls: ``zstandard`` (present
only on the CPU test host) at levels 1 (fast), 3 (dfast), 5 (lazy up to
16 KiB, greedy above), 7 (lazy2, lazy over 128 KiB), 9 (btlazy2 up to 16
KiB, lazy2 above), 11 (btopt up to 16 KiB, btlazy2 to 256 KiB, lazy2
above), 13 and 15 (btultra up to 16 KiB, btopt to 256 KiB, btlazy2
above) and 22 (btultra2), and tensorstore's c-blosc.

- the parameters (window, chain, hash and search logs, minimum match,
  target length, strategy) for every source size up to 1 MiB, as
  libzstd adjusts them;
- a fixed corpus: lengths 1-300 and the block edges up to 1 MiB of
  incompressible bytes, one repeated byte, zeros, text and a 4-symbol
  alphabet (the table's rows change at 16384/16385, 131072/131073 and
  262144/262145; 131073 and over take two blocks, 512 KiB four, 1 MiB
  eight), and blocks of ``chip_smoke.compressible`` byte-shuffled at
  type sizes 1, 2, 4 and 8 (blosc's 32, 64, 128, 256 and 512 KiB and
  1 MiB blocks, a short tail), and 256 and 512 KiB whose later blocks
  libzstd's pre-splitter cuts, and 128 KiB + 1 whose block its post-block
  splitter divides from btopt up: the C frames byte-equal to libzstd's,
  the plain version's to C's on the inputs of at most 16 KiB + 1 (hash
  chain, binary tree, the optimal parser) and on one row-matcher input,
  one of two blocks and the post-splitter's;
- a ``hypothesis`` property on random short inputs (C), seeded inputs
  of mixed runs up to 256 KiB at clevel 3-5 (lazy skipping over long
  literal runs, raw and compressed blocks in one frame), and literals
  whose symbols tie at count 164, the last count ``HUF_sort`` buckets
  exactly (C and plain);
- frames into a bounded buffer: single-block blosc chunks whose libzstd
  frame lies within 24 bytes of c-blosc's budget, where libzstd's own
  room checks decide between a frame and a stored block, and chunks with
  a short last block or one of up to 16 KiB or of two zstd blocks: whole
  blosc frames byte-equal to tensorstore's, the memcpyed flag included;
- the kept digests of libzstd's frames that ``chip_smoke.py`` phase 12
  holds the C encoder to on the card (``tests/torch_zstd_frames.npz``):
  what ``torch_zstd_frames.make`` writes here, and matched by the C
  frames (and the plain ones on the inputs of at most 16 KiB + 1).
"""

import os

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import chip_smoke
import torch_zstd_frames
from image_stitcher_tpu.io.zarr_store import create_zarr_array
from image_stitcher_tpu_torch.io import blosc, zstd_plain

zstandard = pytest.importorskip("zstandard")

#: blosc clevel -> libzstd level (c-blosc's 2 * clevel - 1)
LEVELS = torch_zstd_frames.LEVELS
#: the longest input each clevel follows libzstd on (a blosc block)
MAXSRC = torch_zstd_frames.MAXSRC
EDGES = (511, 512, 513, 1023, 1024, 1025, 4095, 4096, 4097, 16383, 16384,
         16385, 32767, 32768, 32769, 65535, 65536, 65537, 65791, 65792,
         131071, 131072, 131073, 196608, 262144, 262145, 524288, 1048576)
LENGTHS = tuple(range(1, 301)) + EDGES
PLAIN_MAX = 16385


def libzstd(data: bytes, level: int) -> bytes:
    return zstandard.ZstdCompressor(
        level=level, write_content_size=True).compress(data)


def _kind(kind: str, n: int) -> bytes:
    rng = np.random.default_rng(n)
    if kind == 'random':
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == 'repeated':
        return b'\x5a' * n
    if kind == 'zeros':
        return bytes(n)
    if kind == 'alphabet4':
        return rng.integers(0, 4, n, dtype=np.uint8).tobytes()
    words = (b"stitched tiles of a well plate, fused into one canvas and "
             b"written as blosc chunks; ")
    text = (words * (n // len(words) + 1)).decode()
    # a few random words break the period, so matches vary in offset
    pos = rng.integers(0, max(len(text) - 8, 1), n // 40 + 1)
    out = bytearray(text.encode())
    for p in pos:
        out[p:p + 6] = rng.integers(97, 123, 6, dtype=np.uint8).tobytes()
    return bytes(out[:n])


def _check(data: bytes, plain: bool, plain_opt: bool = True) -> None:
    """C frames equal libzstd's at every clevel; the plain version's
    equal C's where ``plain`` says (from clevel 6, whose optimal parser
    runs slowly in Python, where ``plain_opt`` says too and on inputs of
    at most PLAIN_MAX bytes)."""
    for clevel, level in LEVELS.items():
        if len(data) > MAXSRC[clevel]:
            continue
        frame = blosc.stream_compress('zstd', data, clevel)
        assert frame == libzstd(data, level), (len(data), clevel)
        if plain and (clevel <= 5 or plain_opt and len(data) <= PLAIN_MAX):
            assert zstd_plain.compress(data, clevel) == frame, \
                (len(data), clevel)


def test_parameters_equal_libzstd():
    """libzstd's table row and ZSTD_adjustCParams for every size up to
    1 MiB (each power of two and its neighbours, and the table edges)."""
    sizes = sorted({max(1, (1 << k) + d) for k in range(21)
                    for d in (-1, 0, 1)} | {63, 64, 65, 196608})
    for level in LEVELS.values():
        for n in sizes:
            if n > 1048576:
                continue
            p = zstandard.ZstdCompressionParameters.from_level(
                level, source_size=n)
            assert zstd_plain.lib_params(level, n) == (
                p.window_log, p.chain_log, p.hash_log, p.search_log,
                p.min_match, p.target_length, p.strategy), (level, n)


@pytest.mark.parametrize("kind", ['random', 'repeated', 'zeros', 'text',
                                  'alphabet4'])
def test_corpus_frames_equal_libzstd(kind):
    """The corpus at every clevel; the plain version at clevel 1 to 5 here,
    at 6 to 9 in ``test_torch_zstd_plain_opt.py`` (in parallel)."""
    for n in LENGTHS:
        _check(_kind(kind, n), n <= PLAIN_MAX, plain_opt=False)


@pytest.mark.parametrize("typesize", [1, 2, 4, 8])
def test_shuffled_texture_frames_equal_libzstd(typesize):
    """Blocks of the bench's compressible texture as c-blosc hands them to
    zstd: byte-shuffled at the type size, 32 KiB (clevel 1), 64 KiB
    (clevel 2), 128 KiB (clevel 3), 256 KiB (clevel 4 and 5), 512 KiB
    (clevel 6 to 8) and 1 MiB (clevel 9) blocks, and a short last one."""
    tex = chip_smoke.compressible(np.random.default_rng(typesize), 512)
    dtype = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[typesize]
    raw = (tex >> 8).astype(dtype).tobytes() if typesize == 1 else \
        (tex.astype(dtype) * dtype(3)).tobytes()
    for bs in (32768, 65536, 131072, 262144, 524288, 1048576):
        for off in (0, bs, 5 * bs):
            block = raw[off:off + bs]
            if not block or (bs > 262144 and len(block) < bs):
                continue
            shuffled = blosc.shuffle_plain(block, typesize) \
                if typesize > 1 else block
            for clevel, level in LEVELS.items():
                if len(block) > MAXSRC[clevel]:
                    continue
                frame = blosc.stream_compress('zstd', shuffled, clevel)
                assert frame == libzstd(shuffled, level), (bs, off, clevel)
    tail = blosc.shuffle_plain(raw[:3000], typesize) if typesize > 1 \
        else raw[:3000]
    _check(tail, True)
    _check(blosc.shuffle_plain(raw[:32768], typesize) if typesize > 1
           else raw[:32768], typesize == 2)


@settings(max_examples=300, deadline=None, database=None)
@given(data=st.one_of(
    st.binary(max_size=4000),
    st.lists(st.sampled_from([b'\x00' * 8, b'ab', b'abcabcab', b'xyz12',
                              b'\xff\x00', b'q']), max_size=600)
    .map(b''.join)))
def test_random_short_inputs_equal_libzstd(data):
    for clevel, level in LEVELS.items():
        assert blosc.stream_compress('zstd', data, clevel) == \
            libzstd(data, level)


def _pieces(seed: int, n: int) -> bytes:
    """n bytes of runs: incompressible stretches (long enough for
    libzstd's lazy skipping), one repeated byte, a few-symbol alphabet and
    copies of earlier bytes with a few changed."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < n:
        kind = int(rng.integers(0, 4))
        size = int(rng.integers(1, (6000, 300, 3000, 8000)[kind]))
        if kind == 0:
            out += rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        elif kind == 1:
            out += bytes([int(rng.integers(0, 256))]) * size
        elif kind == 2:
            out += rng.integers(0, int(rng.integers(2, 16)), size,
                                dtype=np.uint8).tobytes()
        elif out:
            start = int(rng.integers(0, len(out)))
            copy = bytearray(out[start:start + size])
            for k in rng.integers(0, max(len(copy), 1), 3):
                if copy:
                    copy[k] = int(rng.integers(0, 256))
            out += copy
    return bytes(out[:n])


@pytest.mark.parametrize("seed", range(4))
def test_pieced_inputs_equal_libzstd(seed):
    """Inputs of mixed runs up to 256 KiB at clevel 3-5: the lazy parsers'
    skipping over long literal runs, repeat offsets across two blocks,
    raw and compressed blocks in one frame."""
    rng = np.random.default_rng(100 + seed)
    for k in range(40):
        n = int(rng.integers(1, (16385, 131073, 262145)[k % 3]))
        _check(_pieces(1000 * seed + k, n), False)


@pytest.mark.parametrize("clevel,n", [(3, 40000), (5, 100000), (4, 262144),
                                      (5, 196608)],
                         ids=['greedy-row', 'lazy2-row', 'lazy-2-blocks',
                              'lazy2-2-blocks'])
def test_plain_row_matcher_equals_c(clevel, n):
    """The plain version's row matcher and two-block frames (texture and
    mixed runs) byte-equal to C, and C to libzstd."""
    tex = chip_smoke.compressible(np.random.default_rng(n), 512)
    for data in (blosc.shuffle_plain(tex.tobytes()[:n], 2),
                 _pieces(n, n)):
        frame = blosc.stream_compress('zstd', data, clevel)
        assert frame == libzstd(data, LEVELS[clevel])
        assert zstd_plain.compress(data, clevel) == frame


@pytest.mark.parametrize("seed", [145, 280])
def test_huffman_count_ties_equal_libzstd(seed):
    """Incompressible literals where 10 symbols share the count 164, the
    last count HUF_sort buckets exactly, across the boundary of two code
    lengths: libzstd quicksorts that bucket, which orders them, and so
    their code lengths (every clevel; C and plain). The seeds are ones
    where the order matters."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(130, 200, 256)
    counts[rng.choice(256, 13, replace=False)] = rng.integers(800, 3000, 13)
    counts[rng.choice(np.flatnonzero(counts < 800), 10, replace=False)] = 164
    _check(rng.permutation(np.repeat(np.arange(256, dtype=np.uint8),
                                     counts)).tobytes(), True)


def test_split_second_block_equals_libzstd():
    """256 KiB whose second half changes its byte statistics: libzstd's
    pre-splitter cuts the second block (three blocks); C and plain."""
    words = torch_zstd_frames._text(3, 196608)
    data = words + np.random.default_rng(4).integers(
        0, 4, 65536, dtype=np.uint8).tobytes()
    for clevel in (3, 4, 5):
        frame = blosc.stream_compress('zstd', data, clevel)
        assert frame == libzstd(data, LEVELS[clevel])
        assert zstd_plain.compress(data, clevel) == frame
    assert _block_count(frame) == 3


def test_optimal_levels_split_blocks_equal_libzstd():
    """From btopt up libzstd's post-block splitter divides a block of at
    least 300 sequences where its estimates gain (128 KiB + 1 of text,
    then a 4-symbol alphabet: a frame of two blocks written as more); at
    clevel 6 to 8 over 512 KiB (lazy2, btlazy2) its pre-splitter cuts a
    later block where its statistics change. C frames equal libzstd's,
    the plain version's equal C's at clevel 7 (btopt, 128 KiB + 1)."""
    inputs = dict(torch_zstd_frames.inputs())
    data = inputs['split_131073']
    for clevel in (6, 7, 8, 9):
        frame = blosc.stream_compress('zstd', data, clevel)
        assert frame == libzstd(data, LEVELS[clevel]), clevel
        assert _block_count(frame) == (2 if clevel == 6 else
                                       (7, 8, 10)[clevel - 7]), clevel
        if clevel == 7:
            assert zstd_plain.compress(data, clevel) == frame
    data = inputs['mixed_524288']
    for clevel in (6, 7, 8, 9):
        frame = blosc.stream_compress('zstd', data, clevel)
        assert frame == libzstd(data, LEVELS[clevel]), clevel
        if clevel < 9:
            assert _block_count(frame) == 5, clevel


def _block_count(frame: bytes) -> int:
    """The blocks of a single-segment frame with a 4-byte content size."""
    pos, count = 4 + 1 + 4, 0
    while True:
        head = int.from_bytes(frame[pos:pos + 3], 'little')
        count += 1
        pos += 3 + (1 if (head >> 1) & 3 == 1 else head >> 3)
        if head & 1:
            return count


def _edge_cases(count: int, lo: int, hi: int):
    """Seeded single-block chunks (under 32 KiB, so one block whose zstd
    budget is its size less 8) whose unbounded libzstd frame of the
    shuffled block is lo to hi bytes longer than that budget: (data,
    clevel, shuffle)."""
    rng = np.random.default_rng(2024 + lo)
    out = []
    while len(out) < count:
        dtype = (np.uint8, np.uint16)[len(out) % 2]
        clevel = 1 + (len(out) // 2) % 9
        shuffle = (0, 1, 2, -1)[(len(out) // 10) % 4]
        n = int(rng.integers(128, 3000)) & ~1
        raw = rng.integers(0, 256, n, dtype=np.uint8)
        raw[rng.random(n) > rng.uniform(0.6, 1.0)] = 0
        data = raw.view(dtype)
        ts = data.itemsize
        flags, _, _ = blosc._frame_params('zstd', clevel, shuffle, ts, n)
        block = blosc._prepare_plain(flags, ts, raw.tobytes())
        if lo <= len(libzstd(block, LEVELS[clevel])) - (n - 8) <= hi:
            out.append((data, clevel, shuffle))
    return out


@pytest.mark.parametrize("band", [(-24, 24), (-9, -7)],
                         ids=['near', 'slack'])
def test_bounded_frames_equal_tensorstore(tmp_path, band):
    """libzstd's room checks in c-blosc's bounded buffer (frames near the
    budget; and frames ending 7 to 9 bytes before it, where the bit
    writers' 8 bytes of slack decide): the port's whole frames are
    tensorstore's, the memcpyed flag included."""
    stored = 0
    cases = _edge_cases(48, *band)
    for k, (data, clevel, shuffle) in enumerate(cases):
        shape = (1, 1, 1, 1, data.size)
        path = str(tmp_path / f"a{k}")
        create_zarr_array(path, shape, shape, data.dtype, cname='zstd',
                          clevel=clevel, shuffle=shuffle).write(
                              data.reshape(shape)).result()
        with open(os.path.join(path, *'00000'), 'rb') as f:
            want = f.read()
        frame = bytes(blosc.compress(data, data.itemsize, clevel, shuffle,
                                     'zstd'))
        assert frame == want, (k, clevel, shuffle, len(frame), len(want))
        assert blosc.compress_plain(data, data.itemsize, clevel, shuffle,
                                    'zstd') == frame, k
        stored += bool(want[2] & 0x02)
    assert 0 < stored < len(cases)      # both sides of the edge


@pytest.mark.parametrize("clevel", range(1, 10))
def test_short_last_blocks_equal_tensorstore(tmp_path, clevel):
    """A chunk of whole blocks and a last block of 2-40 bytes: under the
    18 bytes libzstd wants for its frame header the last block is stored,
    above them a frame of zeros fits; from clevel 3 also last blocks of
    texture of up to 16 KiB (hash chain, binary tree, the optimal parser)
    and, in blocks of 256 KiB and more, of 150000 bytes (two zstd blocks);
    from clevel 6 (512 KiB and 1 MiB blocks, libzstd's slower levels) the
    edges alone: 2, 18 and 19 bytes, 16 KiB + 1 and 150000; whole frames
    are tensorstore's."""
    bs = {1: 32768, 2: 65536, 3: 131072, 4: 262144, 5: 262144, 6: 524288,
          7: 524288, 8: 524288, 9: 1048576}[clevel]
    tex = (chip_smoke.compressible(np.random.default_rng(5),
                                   512 if bs <= 262144 else 1024) >> 8) \
        .astype(np.uint8).ravel()
    body = tex[:bs]
    # (from clevel 6, whose libzstd levels run slowly, the edges alone)
    tails = [np.zeros(n, np.uint8) for n in ((2, 12, 17, 18, 19, 25, 40)
                                             if clevel <= 5 else (2, 18, 19))]
    if clevel >= 3:
        tails += [tex[-n:] for n in ((5000, 16384, 16385) if clevel <= 5
                                     else (16385,))]
    if clevel >= 4:
        tails.append(tex[-150000:])
    for k, tail in enumerate(tails):
        data = np.concatenate([body, tail])
        shape = (1, 1, 1, 1, data.size)
        path = str(tmp_path / f"t{k}")
        create_zarr_array(path, shape, shape, np.uint8, cname='zstd',
                          clevel=clevel, shuffle=0).write(
                              data.reshape(shape)).result()
        with open(os.path.join(path, *'00000'), 'rb') as f:
            want = f.read()
        assert bytes(blosc.compress(data, 1, clevel, 0, 'zstd')) == want, \
            tail.size


def test_kept_frames_are_what_make_writes(tmp_path):
    path = str(tmp_path / "frames.npz")
    torch_zstd_frames.make(path)
    assert torch_zstd_frames.load(path) == torch_zstd_frames.load()
    with np.load(torch_zstd_frames.PATH) as f:
        assert tuple(f['version'].tolist()) == zstandard.ZSTD_VERSION


def test_c_frames_match_kept_frames():
    """The C frames of the kept inputs (on a pool of threads: the C
    encoder releases the interpreter lock) match the kept digests, and
    the plain version's the C frames on the inputs of at most
    PLAIN_MAX bytes."""
    from concurrent.futures import ThreadPoolExecutor
    kept = torch_zstd_frames.load()
    cases = torch_zstd_frames.inputs()
    assert sorted(label for label, _ in cases) == sorted(kept)
    tasks = []
    for label, data in cases:
        digest, frames = kept[label]
        assert torch_zstd_frames.sha(data) == digest, label
        tasks += [(label, data, clevel, want)
                  for clevel, want in frames.items()]

    def c_frame(task):
        return blosc.stream_compress('zstd', task[1], task[2])

    with ThreadPoolExecutor(4) as pool:
        for (label, data, clevel, want), frame in zip(
                tasks, pool.map(c_frame, tasks)):
            assert (len(frame), torch_zstd_frames.sha(frame)) == want, \
                (label, clevel)
            if len(data) <= PLAIN_MAX:
                assert zstd_plain.compress(data, clevel) == frame, label
