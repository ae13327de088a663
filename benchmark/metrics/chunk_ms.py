"""Data layer (``SceneCache.get_batch`` + ``convert.batch_from_numpy``):
the median over the synced stretch's chunks of the two spans' sum, each
span between two synchronizes, in milliseconds."""

import statistics


def read(record):
    times = record.stretches["synced"].spans or {}
    per_chunk = [a + b for a, b in zip(times.get("get_batch", []),
                                       times.get("to_device", []))]
    return statistics.median(per_chunk) * 1e3 if per_chunk else None
