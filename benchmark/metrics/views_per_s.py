"""End to end: views of every step of the window over the window's
seconds, which end when the last queued step has finished (host clock)."""


def read(record):
    w = record.window
    if w is None or w.seconds <= 0:
        return None
    return w.steps * record.views_per_step / w.seconds
