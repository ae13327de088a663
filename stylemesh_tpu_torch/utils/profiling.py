"""Profiling and tracing (counterpart of ``stylemesh_tpu/utils/profiling.py``).

- :func:`trace`: a ``torch.profiler`` trace of the enclosed region, written
  to ``log_dir`` as a Chrome trace (viewable in Perfetto).
- :class:`StepProfiler`: host wall-clock by phase for the run loop. On a
  CUDA device every phase ends with ``torch.cuda.synchronize()``, so a
  phase's time includes the device work it launched.
"""

import contextlib
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(log_dir):
    """Capture a ``torch.profiler`` trace (CPU and, when present, CUDA
    activity) of the enclosed region into ``<log_dir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepProfiler:
    """Host-side phase timing: ``with prof.phase('data'): ...``. With a
    CUDA ``device`` each phase synchronizes that device before it ends."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self):
        return {k: {"total_s": round(v, 3),
                    "mean_ms": round(1000 * v / max(self.counts[k], 1), 2)}
                for k, v in self.totals.items()}
