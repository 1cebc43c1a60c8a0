"""Seeded inputs and the digests of tensorstore's blosc snappy, zlib and
blosclz frames of them (and of the codec stream each frame holds), kept
in the repo.

The card's host has no tensorstore. So ``chip_smoke.py`` (phase 12)
makes the inputs with :func:`inputs` (NumPy integer arithmetic on
PCG64's raw words, as ``torch_zstd_frames``) and holds the port's C
encoders to the SHA-256 kept in ``torch_blosc_frames.npz``, written by
:func:`make` on the CPU test host from the JAX package's
``create_zarr_array`` (tensorstore's c-blosc: Google snappy 1.2,
Chromium's zlib 1.3.1 and c-blosc's own blosclz).

Each input goes into one u8 chunk, shuffle 0, as the last of three
blosc blocks: two blocks of zeros, then the input (``framed``). The
blocks of zeros compress to a few bytes, so every stream has the room
c-blosc gives when the frame has room to spare (snappy is refused a
buffer under its worst case, and c-blosc clips the room of a frame's
first stream to the frame's), and the input is the whole last block, so
the frame's last stream is the codec's stream of exactly the input.
Snappy is kept at clevel 9 (256 KiB blocks), zlib at each clevel 1-9
(64 KiB blocks at clevel 1-2, 128 KiB at 3, 256 KiB at 4-9), blosclz at
each clevel 1-9 (64 KiB blocks at clevel 1-3, 128 KiB at 4-5, 256 KiB at
6-9; where blosclz declines, the frame stores the input and the stream
is '-'); an input longer than the clevel's block is not kept there
('-'). The inputs are
the edges 14-17, 255-257, 4095-4097, 16383-16385,
32767-32769, 65535-65537, 131072 and 262144 of text, incompressible
bytes and a 4-symbol alphabet, zeros and one repeated byte, blosc blocks
of a byte-shuffled texture at type sizes 1, 2, 4 and 8, text ending in
20000 incompressible bytes (deflate's last block stored), and short
inputs deflate sends with the fixed code. Regenerate with::

    python tests/torch_blosc_frames.py

``tests/test_torch_zlib_frames.py`` checks that the file is what
:func:`make` writes; it, ``tests/test_torch_snappy_frames.py`` and
``tests/test_torch_blosclz_frames.py`` check that the port's frames and
streams match it.
"""

import hashlib
import os
import struct
import sys
import tempfile

import numpy as np

if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from torch_zstd_frames import _shuffle, _text, _words, texture  # noqa: E402
from image_stitcher_tpu_torch.io.blosc import blosc_blocksize  # noqa: E402

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    'torch_blosc_frames.npz')
#: the (cname, clevel) settings kept, in the file's column order
SETTINGS = ((('snappy', 9),) + tuple(('zlib', c) for c in range(1, 10))
            + tuple(('blosclz', c) for c in range(1, 10)))
#: u8 blosc block size of each setting (c-blosc's rule for inputs of at
#: least one block)
BLOCK = {s: blosc_blocksize(s[1], 1, 1 << 20, s[0]) for s in SETTINGS}
EDGES = (14, 15, 16, 17, 255, 256, 257, 4095, 4096, 4097, 16383, 16384,
         16385, 32767, 32768, 32769, 65535, 65536, 65537, 131072, 262144)
#: the kinds of input of the CPU tests' corpus (``kind_bytes``)
KINDS = ('zeros', 'repeated', 'text', 'random', 'alphabet4')


def inputs():
    """[(label, bytes)]: the kept inputs."""
    cases = []
    for n in EDGES:
        cases.append((f'text_{n}', _text(n, n)))
        cases.append((f'random_{n}', _words(n, n // 8 + 1).tobytes()[:n]))
        cases.append((f'alphabet4_{n}', (_words(n + 1, n) % np.uint64(4))
                      .astype(np.uint8).tobytes()))
    cases += [('zeros_70000', bytes(70000)), ('repeated_5000', b'\x5a' * 5000),
              ('fixed_text_100', _text(3, 100)),
              ('fixed_repeat_40', b'abcabcabd' * 4 + b'abca'),
              ('text_then_random_90000', _text(9, 70000)
               + _words(10, 2500).tobytes()[:20000])]
    tex = texture(21, 512).astype(np.uint64)
    for ts, dtype, scale in ((1, np.uint8, 0), (2, np.uint16, 1),
                             (4, np.uint32, 3), (8, np.uint64, 5)):
        arr = (tex >> np.uint64(8)) if ts == 1 else tex * np.uint64(scale)
        raw = arr.astype(dtype).tobytes()
        for bs in (32768, 65536, 131072, 262144):
            cases.append((f'tex{ts}_shuffled_{bs}', _shuffle(raw[:bs], ts)))
    return cases


def kind_bytes(kind: str, n: int) -> bytes:
    """n bytes of one of ``KINDS``, seeded by n (the CPU tests'
    corpus)."""
    rng = np.random.default_rng(n)
    if kind == 'zeros':
        return bytes(n)
    if kind == 'repeated':
        return b'\x5a' * n
    if kind == 'random':
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == 'alphabet4':
        return rng.integers(0, 4, n, dtype=np.uint8).tobytes()
    words = [b'tile', b'well', b'plate', b'stitch', b'canvas', b'A1', b'0.65',
             b'blosc', b'chunk']
    idx = rng.integers(0, len(words), n // 3 + 1)
    return b' '.join(words[i] for i in idx)[:n]


def probe_arrays():
    """The twelve probe cases' arrays: ``chip_smoke.compressible``
    1024^2 u16, and that array as u8 (>> 8), f32 (x 0.37) and i32
    (- 3000)."""
    import chip_smoke
    tex = chip_smoke.compressible(np.random.default_rng(0), 1024)
    return {'u8': (tex >> 8).astype(np.uint8), 'u16': tex,
            'f32': (tex * np.float32(0.37)).astype(np.float32),
            'i32': tex.astype(np.int32) - 3000}


def framed(data: bytes, cname: str, clevel: int) -> np.ndarray:
    """The u8 chunk a kept frame holds: two blocks of zeros, then
    ``data`` (at most one block)."""
    return np.frombuffer(bytes(2 * BLOCK[cname, clevel]) + data, np.uint8)


def last_stream(frame: bytes) -> bytes:
    """The last codec stream of a frame (not memcpyed) as it is stored:
    the codec's stream, or the input's bytes where the codec did not
    make it shorter."""
    nbytes, bs = struct.unpack_from('<ii', frame, 4)
    nblocks = -(-nbytes // bs)
    pos = struct.unpack_from('<i', frame, 16 + 4 * (nblocks - 1))[0]
    size = struct.unpack_from('<i', frame, pos)[0]
    return frame[pos + 4:pos + 4 + size]


def tensorstore_frame(data, typesize: int, clevel: int, shuffle: int,
                      cname: str) -> bytes:
    """tensorstore's blosc frame of ``data`` (one chunk of its bytes as
    ``typesize``-byte unsigned integers), through the JAX package's
    ``create_zarr_array`` (no fill value, so a chunk of zeros is
    written too)."""
    from image_stitcher_tpu.io.zarr_store import create_zarr_array
    dtype = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[typesize]
    arr = np.frombuffer(bytes(np.ascontiguousarray(data).reshape(-1)
                              .view(np.uint8)), dtype)
    shape = (1, 1, 1, 1, arr.size)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'a')
        create_zarr_array(path, shape, shape, dtype, cname=cname,
                          clevel=clevel, shuffle=shuffle,
                          fill_value=None).write(arr.reshape(shape)).result()
        with open(os.path.join(path, *'00000'), 'rb') as f:
            return f.read()


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def make(path: str = PATH) -> None:
    """Write the kept file: each input's label and digest, and for each
    setting the length and digest of tensorstore's frame of
    :func:`framed` and of the input's stream in it ('-' where the input
    is longer than the setting's block; the stream's '-' where c-blosc
    stored the input as it is, or the whole frame)."""
    rows = []
    for label, data in inputs():
        row = [label, sha(data)]
        for cname, clevel in SETTINGS:
            if len(data) > BLOCK[cname, clevel]:
                row += ['-'] * 4
                continue
            frame = tensorstore_frame(framed(data, cname, clevel), 1, clevel,
                                      0, cname)
            stream = data if frame[2] & 0x02 else last_stream(frame)
            row += [str(len(frame)), sha(frame)]
            row += (['-', '-'] if len(stream) == len(data)
                    else [str(len(stream)), sha(stream)])
        rows.append(row)
    np.savez_compressed(path, rows=np.array(rows))


def load(path: str = PATH):
    """{label: (input digest, {(cname, clevel): (frame length, frame
    digest, stream length or None, stream digest or None)})}."""
    with np.load(path) as f:
        rows = f['rows'].tolist()
    out = {}
    for r in rows:
        kept = {}
        for k, setting in enumerate(SETTINGS):
            flen, fsha, slen, ssha = r[2 + 4 * k:6 + 4 * k]
            if flen == '-':
                continue
            kept[setting] = (int(flen), fsha,
                             None if slen == '-' else int(slen),
                             None if ssha == '-' else ssha)
        out[r[0]] = (r[1], kept)
    return out


if __name__ == '__main__':
    sys.exit(make())
