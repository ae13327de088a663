"""Device: the share of the profiled stretch (whole chunks, at least a
second, ending in a synchronize) in which no kernel, copy or fill ran on
the card: one minus the union of their intervals over the stretch's wall
span, in percent."""


def read(record):
    tl = record.stretches["profiled"].timeline
    if tl.window_s <= 0 or tl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
