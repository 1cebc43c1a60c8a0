"""The port's zstd encoder against libzstd (``zstandard``) on the same
blocks: one ``chip_smoke.compressible`` 2048^2 uint16 chunk, byte-shuffled
into c-blosc's blocks (32 KiB at clevel 1, 64 KiB at clevel 2, 128 KiB at
clevel 3, 256 KiB at clevel 4 and 5, 512 KiB at clevel 6 to 8, 1 MiB at
clevel 9), each block one frame at blosc clevel 1 to 9 (libzstd levels
1, 3, 5, ..., 15 and 22); at clevel 9 the chunk's first 2 MiB, and at
6 to 9 the best of two passes, libzstd's search being slow there.
Prints encode MB/s on one thread (best of five passes) and the bytes of
both, which are equal where the port follows libzstd 1.5.7 (every
clevel). Needs ``zstandard`` (the CPU test host), not a card:

    python tools/torch_zstd_rates.py [seed] [clevel ...]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _best(fn, blocks, passes: int = 5) -> float:
    best = float('inf')
    for _ in range(passes):
        t0 = time.perf_counter()
        for b in blocks:
            fn(b)
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    seed = int(sys.argv[1]) if len(sys.argv) > 1 else 0
    clevels = [int(c) for c in sys.argv[2:]] or list(range(1, 10))
    import zstandard
    import chip_smoke
    from image_stitcher_tpu_torch.io import blosc
    raw = chip_smoke.compressible(np.random.default_rng(seed), 2048).tobytes()
    for clevel in clevels:
        level = 22 if clevel == 9 else 2 * clevel - 1
        bs = {1: 32768, 2: 65536, 3: 131072, 4: 262144, 5: 262144,
              9: 1048576}.get(clevel, 524288)
        src = raw[:2 << 20] if clevel == 9 else raw
        blocks = [blosc.shuffle_plain(src[i:i + bs], 2)
                  for i in range(0, len(src), bs)]
        lib = zstandard.ZstdCompressor(level=level, write_content_size=True)
        passes = 5 if clevel <= 5 else 2
        port_s = _best(lambda b: blosc.stream_compress('zstd', b, clevel),
                       blocks, passes)
        lib_s = _best(lib.compress, blocks, passes)
        port_bytes = sum(len(blosc.stream_compress('zstd', b, clevel))
                         for b in blocks)
        lib_bytes = sum(len(lib.compress(b)) for b in blocks)
        print(f"clevel {clevel} (libzstd level {level}, {bs // 1024} KiB "
              f"blocks, {len(src) >> 20} MiB): port "
              f"{len(src) / port_s / 1e6:.2f} MB/s, libzstd "
              f"{zstandard.ZSTD_VERSION} {len(src) / lib_s / 1e6:.2f} MB/s "
              f"on one thread; bytes {port_bytes} vs {lib_bytes}",
              flush=True)


if __name__ == '__main__':
    main()
