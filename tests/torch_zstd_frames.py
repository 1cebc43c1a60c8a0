"""Seeded inputs and the digests of libzstd 1.5.7's frames of them at
levels 1, 3, 5, 7, 9, 11, 13, 15 and 22 (the levels c-blosc calls at
blosc clevel 1 to 9), kept in the repo.

The card's host has no ``zstandard``. So ``chip_smoke.py`` (phase 12)
makes the inputs with :func:`inputs` (NumPy integer arithmetic on
PCG64's raw words, the same on every NumPy) and holds the port's C
encoder to the SHA-256 of libzstd's frames kept in
``torch_zstd_frames.npz``, written by :func:`make` on the CPU test host
(``zstandard`` 0.25.0, which bundles libzstd 1.5.7). The inputs are
blosc blocks as c-blosc hands them to zstd (byte-shuffled textures at
type sizes 1, 2, 4 and 8 in 32, 64, 128, 256 and 512 KiB and 1 MiB
blocks, one of 16 KiB, unshuffled ones), text, incompressible bytes,
zeros, one repeated byte, text then a 4-symbol alphabet (256 and 512 KiB,
where libzstd's pre-splitter cuts later blocks, and 128 KiB + 1, whose
block its post-block splitter divides from btopt up), and the frame
header's and the parameter table's size edges. A frame is kept only at
the levels whose rules the C encoder follows for its size (a blosc block
of the clevel: 128 KiB at clevel 1 and 2, 256 KiB at 3 to 5, 512 KiB at
6 to 8, 1 MiB at 9). Regenerate with::

    python tests/torch_zstd_frames.py

``tests/test_torch_zstd_libzstd.py`` checks that the file is what
:func:`make` writes and that the port's frames match it.
"""

import hashlib
import os
import sys

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    'torch_zstd_frames.npz')
#: blosc clevel -> libzstd level
LEVELS = {1: 1, 2: 3, 3: 5, 4: 7, 5: 9, 6: 11, 7: 13, 8: 15, 9: 22}
#: the longest input each clevel follows libzstd on
MAXSRC = {1: 131072, 2: 131072, 3: 262144, 4: 262144, 5: 262144,
          6: 524288, 7: 524288, 8: 524288, 9: 1048576}


def _words(seed: int, n: int) -> np.ndarray:
    return np.random.PCG64(seed).random_raw(n).astype(np.uint64)


def texture(seed: int, side: int) -> np.ndarray:
    """A (side, side) uint16 texture in integers only: row and column
    random walks on a dark level, sparse bright spikes, the 6 low bits
    zeroed (as ``chip_smoke.compressible``)."""
    r = _words(seed, side * side).reshape(side, side)
    walk = np.cumsum((r % np.uint64(7)).astype(np.int64) - 3, axis=1)
    walk += np.cumsum(((r >> np.uint64(8)) % np.uint64(3)).astype(np.int64)
                      - 1, axis=0)
    img = 6000 + 48 * walk
    spike = (r >> np.uint64(16)) % np.uint64(400) == 0
    img = img + np.where(spike, ((r >> np.uint64(32)) % np.uint64(30000))
                         .astype(np.int64), 0)
    return (np.clip(img, 0, 65535) & ~63).astype(np.uint16)


def _shuffle(block: bytes, ts: int) -> bytes:
    """c-blosc's byte shuffle of a block (whole elements; the tail as
    it is)."""
    n = len(block) // ts * ts
    a = np.frombuffer(block[:n], np.uint8).reshape(-1, ts)
    return a.T.tobytes() + block[n:]


def _text(seed: int, n: int) -> bytes:
    words = [b'tile', b'well', b'plate', b'stitch', b'canvas', b'chunk',
             b'blosc', b'zstd', b'level', b'fused', b'A1', b'B12', b'0.65']
    r = _words(seed, n // 3 + 1)
    out = b' '.join(words[int(v % np.uint64(len(words)))] for v in r)
    return out[:n]


def inputs():
    """[(label, bytes)]: the kept inputs."""
    tex = texture(19, 512).astype(np.uint64)
    cases = []
    for ts, dtype, scale in ((1, np.uint8, 0), (2, np.uint16, 1),
                             (4, np.uint32, 3), (8, np.uint64, 5)):
        arr = (tex >> np.uint64(8)) if ts == 1 else tex * np.uint64(scale)
        raw = arr.astype(dtype).tobytes()
        for bs, ks in ((32768, (0, 3)), (65536, (0, 3)), (131072, (0, 1)),
                       (262144, (0,))):
            for k in ks:
                block = raw[k * bs:(k + 1) * bs]
                cases.append((f'tex{ts}_shuffled_{bs}_{k}',
                              _shuffle(block, ts) if ts > 1 else block))
        cases.append((f'tex{ts}_tail_3000', _shuffle(raw[:3000], ts)))
    cases.append(('tex2_raw_32768', tex.astype(np.uint16).tobytes()[:32768]))
    cases.append(('tex2_raw_131072',
                  tex.astype(np.uint16).tobytes()[-131072:]))
    cases.append(('tex2_shuffled_16384_2', _shuffle(
        tex.astype(np.uint16).tobytes()[2 * 16384:3 * 16384], 2)))
    rnd = _words(7, 8192).tobytes()
    for n in (1, 6, 7, 100, 255, 256, 1000, 50000):
        cases.append((f'random_{n}', rnd[:n]))
    for n in (70, 4096, 16385, 65791, 65792, 131072, 200000):
        cases.append((f'text_{n}', _text(n, n)))
    cases.append(('random_262144', _words(8, 32768).tobytes()))
    cases.append(('mixed_262144', _text(3, 196608) + (
        _words(5, 65536) % np.uint64(4)).astype(np.uint8).tobytes()))
    cases += [('zeros_5000', bytes(5000)), ('repeated_300', b'\x5a' * 300),
              ('alphabet4_20000', (_words(11, 20000) % np.uint64(4))
               .astype(np.uint8).tobytes())]
    # the blosc blocks of clevel 6 to 9 (512 KiB, 1 MiB) and the edges of
    # libzstd's table rows for levels 11, 13, 15 and 22
    for ts, dtype, scale, sizes in ((2, np.uint16, 1, (524288,)),
                                    (4, np.uint32, 3, (524288, 1048576)),
                                    (8, np.uint64, 5, (524288, 1048576))):
        raw = (tex * np.uint64(scale)).astype(dtype).tobytes()
        for bs in sizes:
            cases.append((f'tex{ts}_shuffled_{bs}_0', _shuffle(raw[:bs], ts)))
    for n in (16384, 65536, 65537, 131073, 262145):
        cases.append((f'text_edge_{n}', _text(n + 1, n)))
    cases += [('random_524288', _words(9, 65536).tobytes()),
              ('text_1048576', _text(12, 1048576)),
              ('mixed_524288', _text(4, 327680) + (
                  _words(6, 196608) % np.uint64(4)).astype(np.uint8)
               .tobytes()),
              ('split_131073', _text(13, 65536) + (
                  _words(14, 65537) % np.uint64(4)).astype(np.uint8)
               .tobytes())]
    return cases


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def make(path: str = PATH) -> None:
    """Write the kept file: each input's label and digest, and the
    length and digest of libzstd's frame at each level (none, '-', where
    the input is longer than the clevel's MAXSRC)."""
    import zstandard
    from concurrent.futures import ThreadPoolExecutor

    def frame(task):
        data, level = task
        return zstandard.ZstdCompressor(
            level=level, write_content_size=True).compress(data)

    cases = inputs()
    tasks = [(data, level) for _, data in cases
             for clevel, level in LEVELS.items()
             if len(data) <= MAXSRC[clevel]]
    with ThreadPoolExecutor(4) as pool:     # zstandard releases the GIL
        frames = iter(pool.map(frame, tasks))
    rows = []
    for label, data in cases:
        row = [label, sha(data)]
        for clevel in LEVELS:
            if len(data) > MAXSRC[clevel]:
                row += ['-', '-']
                continue
            f = next(frames)
            row += [str(len(f)), sha(f)]
        rows.append(row)
    np.savez_compressed(path, rows=np.array(rows),
                        version=np.array(zstandard.ZSTD_VERSION))


def load(path: str = PATH):
    """{label: (input digest, {clevel: (frame length, frame digest)})}."""
    with np.load(path) as f:
        rows = f['rows'].tolist()
    return {r[0]: (r[1], {clevel: (int(r[2 + 2 * k]), r[3 + 2 * k])
                          for k, clevel in enumerate(LEVELS)
                          if r[2 + 2 * k] != '-'})
            for r in rows}


if __name__ == '__main__':
    sys.exit(make())
