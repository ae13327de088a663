"""Data layer, the copy to the card (``data/schema.py::to_device``): the
program's ``h2d_bytes`` counter over the device time of the host-to-device
copies launched inside its ``to_device`` span, over the profiled recorded
stretch's chunks, in GB/s (1e9 bytes; ``progtrace.py``)."""

from benchmark import progtrace


def read(record):
    join = progtrace.read(record)
    if join is None:
        return None
    nbytes = join.counters.get("h2d_bytes", 0)
    seconds = join.device_s("to_device", progtrace.H2D)
    return nbytes / seconds / 1e9 if nbytes > 0 and seconds > 0 else None
