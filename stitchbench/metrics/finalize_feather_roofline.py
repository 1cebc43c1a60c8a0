"""``finalize_feather_roofline``: the finalize_feather kernel's share of its roofline: the
bytes its calls' work needs (``roofline.py``) at the card's peak
bandwidth, over the device seconds of its kernels in the profiler's
trace."""


def read(record):
    k = record['kernels'].get('finalize_feather')
    peak = record['peak_bytes_per_s']
    if not k or not k.get('seconds') or not k.get('bytes') or not peak:
        return None
    return 100.0 * k['bytes'] / peak / k['seconds']
