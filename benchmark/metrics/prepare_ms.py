"""Batch constants (``TexturePipeline.prepare_batch``): the median over
the synced stretch's chunks of its span, between two synchronizes, in
milliseconds."""

import statistics


def read(record):
    times = (record.stretches["synced"].spans or {}).get("prepare_batch", [])
    return statistics.median(times) * 1e3 if times else None
