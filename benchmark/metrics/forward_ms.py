"""Loss forward (``TexturePipeline.loss_fn``: render, gradient weighting,
trunk, Grams, losses): the device time of the operations launched inside
the program's ``forward`` span, a step of the profiled recorded stretch, in
milliseconds (``progtrace.py``)."""

from benchmark import progtrace


def read(record):
    join = progtrace.read(record)
    if join is None or join.steps <= 0:
        return None
    seconds = join.device_s("forward")
    return seconds / join.steps * 1e3 if seconds > 0 else None
