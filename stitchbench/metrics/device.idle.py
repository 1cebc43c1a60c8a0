"""``device.idle``: the share of the traced window (the passes' seconds)
in which no kernel, copy or fill ran on the card (``torch.profiler``)."""


def read(record):
    dev = record.get('device') or {}
    if not dev.get('busy_s') or not dev.get('window_s'):
        return None
    return 100.0 * (1.0 - dev['busy_s'] / dev['window_s'])
