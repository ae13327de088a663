"""Loss Grams (``models/losses.py`` -> ``ops/gram_kernels.py``, K3/K4):
the least time of the profiled stretch's Gram calls, each the larger of
its bytes and its operations bound (features of live pixels, masks, Grams,
``S`` and the feature gradient; ``2 C^2`` a live pixel and mask each way;
``work.py``), over the device time of the kernels named below, in
percent."""

from benchmark.work import bound_s

KERNELS = ("gram_fwd_kernel", "gram_reduce_kernel", "gram_bwd_kernel")


def read(record):
    if record.peaks is None:
        return None
    s = record.stretches["profiled"]
    bound = sum(steps * sum(bound_s(ops, b, record.peaks) for ops, b in
                            record.session.chunk_work(key).gram_calls())
                for key, steps, _ in s.segments)
    device = s.timeline.device_s(KERNELS)
    if device <= 0 or bound <= 0:
        return None
    return 100.0 * bound / device
