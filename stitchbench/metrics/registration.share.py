"""``registration.share``: seconds of registration (``ops/phasecorr.py``, ``ops/globalopt.py``; the program's ``timers['registration']``), as a share of the traced window
(the sum of its passes' seconds)."""


def read(record):
    total = sum(p['timers'].get('registration', 0.0) for p in record['passes'])
    if not any('registration' in p['timers'] for p in record['passes']):
        return None
    return 100.0 * total / record['window_s']
