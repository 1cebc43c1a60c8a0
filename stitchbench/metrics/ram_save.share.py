"""``ram_save.share``: seconds of the in-RAM save on the saver thread (``save_region``: pyramid, copies, chunk encodes and writes; the program's ``timers['save']``), as a share of the traced window
(the sum of its passes' seconds)."""


def read(record):
    total = sum(p['timers'].get('save', 0.0) for p in record['passes'])
    if not any('save' in p['timers'] for p in record['passes']):
        return None
    return 100.0 * total / record['window_s']
