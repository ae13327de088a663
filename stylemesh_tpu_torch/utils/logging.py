"""Run metrics: JSONL scalars, image dumps and step timing (counterpart of
``stylemesh_tpu/utils/logging.py``).

Scalars follow the reference's taxonomy (``Batch/Loss/<state>/<type>``,
per-epoch means ``Loss/<state>/<type>``) in ``metrics.jsonl``; image grids
are saved as pngs. With ``tb=True`` the scalars and images also go to a
TensorBoard event file (``utils/tb_events.py``).
"""

import json
import os
import time
from collections import defaultdict
from os.path import join

import numpy as np

from stylemesh_tpu_torch.utils.tb_events import TBEventWriter


class MetricsLogger:
    """Writes under ``log_dir``; with ``log_dir`` None (the ranks other than
    0 of a multi-device run) it keeps the epoch means and writes nothing."""

    def __init__(self, log_dir, tb=False):
        self.log_dir = log_dir
        self._f = None
        self._tb = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self._f = open(join(log_dir, "metrics.jsonl"), "a")
            if tb:
                self._tb = TBEventWriter(log_dir)
        self._epoch_hist = defaultdict(list)
        self._t0 = time.perf_counter()

    def scalar(self, tag, value, step):
        if self._f is None:
            return
        rec = {"tag": tag, "value": float(value), "step": int(step),
               "t": round(time.perf_counter() - self._t0, 3)}
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def batch_losses(self, state, losses, step):
        for k, v in losses.items():
            self.scalar(f"Batch/Loss/{state}/{k}", v, step)
            self._epoch_hist[(state, k)].append(float(v))

    def epoch_means(self, state, epoch):
        means = {}
        for (s, k), vals in list(self._epoch_hist.items()):
            if s == state and vals:
                means[k] = float(np.mean(vals))
                self.scalar(f"Loss/{state}/{k}", means[k], epoch)
        for key in [k for k in self._epoch_hist if k[0] == state]:
            self._epoch_hist[key].clear()
        return means

    def image(self, tag, img_hwc, step):
        from PIL import Image

        arr = np.clip(np.asarray(img_hwc), 0.0, 1.0)
        path = join(self.log_dir, f"{tag.replace('/', '_')}_{step}.png")
        Image.fromarray((arr * 255 + 0.5).astype(np.uint8)).save(path)
        if self._tb is not None:
            self._tb.add_image(tag, arr, step)
        return path

    def close(self):
        if self._f is not None:
            self._f.close()
        if self._tb is not None:
            self._tb.close()


class StepTimer:
    """Rolling step timing: steps/s and views/s."""

    def __init__(self, window=50):
        self.window = window
        self.times = []
        self.last = None

    def tick(self):
        now = time.perf_counter()
        if self.last is not None:
            self.times.append(now - self.last)
            if len(self.times) > self.window:
                self.times.pop(0)
        self.last = now

    @property
    def steps_per_sec(self):
        if not self.times:
            return 0.0
        return 1.0 / (sum(self.times) / len(self.times))
