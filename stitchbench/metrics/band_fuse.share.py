"""``band_fuse.share``: seconds of the band fuser's main thread (``models/streaming.py``: tile loads and warps, uploads, launches; the program's ``fuse_stats[...]['fuse']``), as a share of the traced window
(the sum of its passes' seconds)."""


def read(record):
    stats = [s for p in record['passes'] for s in p['fuse_stats'].values()
             if 'fuse' in s and 'readback_wait' in s]
    if not stats:
        return None
    return 100.0 * sum(s['fuse'] for s in stats) / record['window_s']
