"""The port's zstd encoder against libzstd (``zstandard``) on the same
blocks: one ``chip_smoke.compressible`` 2048^2 uint16 chunk, byte-shuffled
into c-blosc's blocks (32 KiB at clevel 1, 64 KiB at clevel 2, 128 KiB at
clevel 3, 256 KiB at clevel 4 and 5), each block one frame at blosc
clevel 1 to 5 (libzstd levels 1, 3, 5, 7 and 9). Prints encode MB/s on
one thread (best of five passes) and the bytes of both, which are equal
where the port follows libzstd 1.5.7. Needs ``zstandard`` (the CPU test
host), not a card:

    python tools/torch_zstd_rates.py [seed] [clevel ...]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _best(fn, blocks) -> float:
    best = float('inf')
    for _ in range(5):
        t0 = time.perf_counter()
        for b in blocks:
            fn(b)
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    seed = int(sys.argv[1]) if len(sys.argv) > 1 else 0
    clevels = [int(c) for c in sys.argv[2:]] or [1, 2, 3, 4, 5]
    import zstandard
    import chip_smoke
    from image_stitcher_tpu_torch.io import blosc
    raw = chip_smoke.compressible(np.random.default_rng(seed), 2048).tobytes()
    for clevel in clevels:
        level = 2 * clevel - 1
        bs = {1: 32768, 2: 65536, 3: 131072}.get(clevel, 262144)
        blocks = [blosc.shuffle_plain(raw[i:i + bs], 2)
                  for i in range(0, len(raw), bs)]
        lib = zstandard.ZstdCompressor(level=level, write_content_size=True)
        port_s = _best(lambda b: blosc.stream_compress('zstd', b, clevel),
                       blocks)
        lib_s = _best(lib.compress, blocks)
        port_bytes = sum(len(blosc.stream_compress('zstd', b, clevel))
                         for b in blocks)
        lib_bytes = sum(len(lib.compress(b)) for b in blocks)
        print(f"clevel {clevel} (libzstd level {level}, {bs // 1024} KiB "
              f"blocks): port {len(raw) / port_s / 1e6:.1f} MB/s, libzstd "
              f"{zstandard.ZSTD_VERSION} {len(raw) / lib_s / 1e6:.1f} MB/s "
              f"on one thread; bytes {port_bytes} vs {lib_bytes}",
              flush=True)


if __name__ == '__main__':
    main()
