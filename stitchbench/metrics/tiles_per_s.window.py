"""``tiles_per_s.window``: all tiles of all passes of the traced window over
all the seconds of those passes, scan to last chunk, on the host's clock
(the runs' rate; it moves with the host's CPU speed, which shifts from run
to run)."""


def read(record):
    if not record.get('tiles') or not record['window_s']:
        return None
    return record['tiles'] / record['window_s']
