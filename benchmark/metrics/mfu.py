"""Train step: the operations the unprofiled stretch's steps and chunks
need (``work.py``: VGG-19 forward and input gradients at every live level,
the masked Grams, each chunk's content encode) over its wall time, as a
share of the card's dense bf16 peak (``peaks.json``), in percent."""


def read(record):
    if record.peaks is None:
        return None
    s = record.stretches["plain"]
    flops = 0.0
    for key, steps, prepared in s.segments:
        w = record.session.chunk_work(key)
        flops += steps * w.step_flops() + prepared * w.trunk_chunk()
    if s.seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / s.seconds / record.peaks["bf16_flop_per_s"]
