"""``fit.share``: seconds of the flatfield fit (``ops/flatfield.py``, on the host; the program's ``timers['flatfield_fit']``), as a share of the traced window
(the sum of its passes' seconds)."""


def read(record):
    total = sum(p['timers'].get('flatfield_fit', 0.0) for p in record['passes'])
    if not any('flatfield_fit' in p['timers'] for p in record['passes']):
        return None
    return 100.0 * total / record['window_s']
