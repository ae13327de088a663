"""Backward (``torch.autograd.grad``: K2, the trunk's input gradients, K4,
the relu masks): the device time of the operations launched inside the
program's ``backward`` span, a step of the profiled recorded stretch, in
milliseconds (``progtrace.py``)."""

from benchmark import progtrace


def read(record):
    join = progtrace.read(record)
    if join is None or join.steps <= 0:
        return None
    seconds = join.device_s("backward")
    return seconds / join.steps * 1e3 if seconds > 0 else None
