"""``band_write.share``: seconds of the band writer thread (``models/streaming.py``, ``io/zarr_store.py``, ``csrc/blosc.c``: pyramid folds, chunk hand-off, encodes; the program's ``fuse_stats[...]['write']``), as a share of the traced window
(the sum of its passes' seconds)."""


def read(record):
    stats = [s for p in record['passes'] for s in p['fuse_stats'].values()
             if 'write' in s and 'readback_wait' in s]
    if not stats:
        return None
    return 100.0 * sum(s['write'] for s in stats) / record['window_s']
