"""Read OME-Zarr v2 level arrays whose chunks are blosc 1.x frames.

The benchmark's own reader of the program's output: it parses each
``.zarray`` and decodes every chunk file with ``csrc/unblosc.c`` (a frozen
copy of the port's LZ4 and Zstandard decoders under a frame walker of its
own), built with ``cc`` at first use into ``build/stitchbench/<hash>/``
under the checkout, a fixed path, so only a checkout's first run builds.
Absent chunk files read as the array's fill value, as zarr reads them.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, 'csrc', 'unblosc.c')
#: blosc's compressor codes by the names zarr gives them
CODES = {'blosclz': 0, 'lz4': 1, 'lz4hc': 1, 'snappy': 2, 'zlib': 3,
         'zstd': 4}


def build_dir(root: str) -> str:
    """``build/stitchbench/<hash of the source>`` under ``root``."""
    with open(SOURCE, 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(root, 'build', 'stitchbench', digest)


class Decoder:
    """The built decoder library of one checkout."""

    def __init__(self, root: str):
        out = build_dir(root)
        lib = os.path.join(out, 'libunblosc.so')
        if not os.path.exists(lib):
            os.makedirs(out, exist_ok=True)
            tmp = f"{lib}.{os.getpid()}.tmp"
            subprocess.run(['cc', '-O2', '-shared', '-fPIC', SOURCE, '-o',
                            tmp], check=True)
            os.replace(tmp, lib)
        self._lib = ctypes.CDLL(lib)
        fn = self._lib.unblosc
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_int64]
        fn.restype = ctypes.c_int64

    def decode(self, frame: bytes, nbytes: int) -> np.ndarray:
        """One frame's bytes as a uint8 array of ``nbytes``."""
        src = np.frombuffer(frame, np.uint8)
        out = np.empty(nbytes, np.uint8)
        rc = self._lib.unblosc(src.ctypes.data, src.size, out.ctypes.data,
                               nbytes)
        if rc != nbytes:
            raise ValueError(f"blosc frame not decoded (code {rc})")
        return out


def frame_header(frame: bytes) -> Dict:
    """The fields of a blosc 1.x frame header that the array's
    ``compressor`` fixes: shuffle, compressor code, type size."""
    flags = frame[2]
    return {'shuffle': flags & 1, 'bitshuffle': (flags >> 2) & 1,
            'code': flags >> 5, 'typesize': frame[3],
            'nbytes': int.from_bytes(frame[4:8], 'little')}


def read_level(decoder: Decoder, path: str, threads: int = 8
               ) -> Tuple[np.ndarray, Dict, List[str]]:
    """(array, .zarray, faults) of one zarr v2 level at ``path``: the
    decoded array, its metadata, and a list of frame headers that do not
    match the metadata's compressor."""
    with open(os.path.join(path, '.zarray')) as f:
        meta = json.load(f)
    shape = tuple(meta['shape'])
    chunks = tuple(meta['chunks'])
    dtype = np.dtype(meta['dtype'])
    sep = meta.get('dimension_separator', '.')
    comp: Optional[Dict] = meta.get('compressor')
    out = np.full(shape, meta.get('fill_value') or 0, dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    faults: List[str] = []
    nbytes = int(np.prod(chunks)) * dtype.itemsize

    def one(index):
        name = sep.join(str(i) for i in index)
        fpath = os.path.join(path, name)
        try:
            with open(fpath, 'rb') as f:
                data = f.read()
        except FileNotFoundError:
            return
        if comp is None:
            raw = np.frombuffer(data, np.uint8)
        else:
            head = frame_header(data)
            want = {'shuffle': int(comp['shuffle'] == 1),
                    'bitshuffle': int(comp['shuffle'] == 2),
                    'code': CODES[comp['cname']],
                    'typesize': dtype.itemsize, 'nbytes': nbytes}
            if head != want:
                faults.append(f"{fpath}: header {head}, want {want}")
            raw = decoder.decode(data, nbytes)
        block = raw.view(dtype).reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(index, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]

    indices = list(np.ndindex(*grid))
    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(one, indices))
    return out, meta, faults
