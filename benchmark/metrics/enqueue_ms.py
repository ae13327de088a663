"""Train step, on the host (``TexturePipeline.train_step``): the median
over the unprofiled recorded stretch's steps of the program's
``train_step`` span, the host's time to queue a step's loss, gradient and
update, in milliseconds (``progtrace.py``)."""

import statistics

from benchmark import progtrace


def read(record):
    times = progtrace.enqueue_s(record) or []
    return statistics.median(times) * 1e3 if times else None
