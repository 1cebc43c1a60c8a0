"""``ram_fuse.share``: seconds of the in-RAM fuse (``models/pipeline.py::stitch_region``: loads, uploads, launches; the program's ``timers['fuse']``), as a share of the traced window
(the sum of its passes' seconds)."""


def read(record):
    total = sum(p['timers'].get('fuse', 0.0) for p in record['passes'])
    if not any('fuse' in p['timers'] for p in record['passes']):
        return None
    return 100.0 * total / record['window_s']
