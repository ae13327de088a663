"""Device: ``torch.cuda.max_memory_allocated`` over the window, in GB
(1e9 bytes)."""


def read(record):
    if not record.window_peak_bytes:
        return None
    return record.window_peak_bytes / 1e9
