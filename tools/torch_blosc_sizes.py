"""The port's blosc frame sizes against tensorstore's (c-blosc 1.x), on
``chip_smoke.compressible`` (the JAX package's compressible bench
content, one 2048^2 uint16 chunk), for every cname at clevel 1, 5 and 9
with byte shuffle, and zstd with bit shuffle. Prints port bytes /
tensorstore bytes and both ratios. Needs tensorstore (the CPU test host),
not a card:

    python tools/torch_blosc_sizes.py [seed]
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    seed = int(sys.argv[1]) if len(sys.argv) > 1 else 0
    import chip_smoke
    from image_stitcher_tpu.io.zarr_store import create_zarr_array
    from image_stitcher_tpu_torch.io import blosc
    tex = chip_smoke.compressible(np.random.default_rng(seed), 2048)
    shape = (1, 1, 1) + tex.shape
    with tempfile.TemporaryDirectory() as tmp:
        for cname, shuffle in [(c, 1) for c in blosc.CNAMES] + [('zstd', 2)]:
            row = []
            for clevel in (1, 5, 9):
                path = os.path.join(tmp, f"{cname}{shuffle}{clevel}")
                create_zarr_array(path, shape, shape, np.uint16, cname=cname,
                                  clevel=clevel, shuffle=shuffle).write(
                                      tex.reshape(shape)).result()
                ts_bytes = os.path.getsize(os.path.join(path, *'00000'))
                port = len(blosc.compress(tex, 2, clevel, shuffle, cname))
                row.append(f"clevel {clevel}: {port / ts_bytes:.3f} "
                           f"({port / tex.nbytes:.4f} vs "
                           f"{ts_bytes / tex.nbytes:.4f})")
            print(f"{cname:8s} shuffle {shuffle}  " + "; ".join(row),
                  flush=True)


if __name__ == '__main__':
    main()
