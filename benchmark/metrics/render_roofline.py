"""Render (``models/texture.py::sample_texture`` -> ``ops/grid_sample.py``,
K1 + K2): the least time of their bytes in the profiled stretch (grids,
rendered pixels, cotangents, touched texels; ``work.py``) over the device
time of the kernels named below, in percent."""

KERNELS = ("gather_kernel", "splat_kernel")


def read(record):
    if record.peaks is None:
        return None
    s = record.stretches["profiled"]
    nbytes = sum(steps * record.session.chunk_work(key).render_bytes()
                 for key, steps, _ in s.segments)
    device = s.timeline.device_s(KERNELS)
    if device <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / record.peaks["hbm_bytes_per_s"] / device
