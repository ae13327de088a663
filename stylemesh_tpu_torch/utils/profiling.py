"""Profiling (counterpart of ``stylemesh_tpu/utils/profiling.py``).

- :func:`span`, :func:`count`, :func:`recording`: the program's in-memory
  spans and counters. The program opens spans at its layer boundaries
  (``get_batch``, ``to_device``, ``prepare_batch``, ``train_step`` with
  ``forward``, ``backward`` and ``update``) and counts at them
  (``h2d_bytes``; in the train step on a card ``step_graph_captures``,
  ``step_graph_replays`` and ``eager_steps``, ``models/step_graph.py``);
  only the caller of :func:`recording` turns them on. Off,
  a span is one shared null context and a count returns at once: nothing
  is stored and nothing synchronizes.
- :class:`StepProfiler`: host wall-clock by phase for the run loop. On a
  CUDA device every phase ends with ``torch.cuda.synchronize()``, so a
  phase's time includes the device work it launched.

Spans are taken on ``time.time_ns``, the clock of ``torch.profiler``'s
device timestamps, and are opened on one thread (the one that drives the
step); a span's ``parent`` is the index of the span open around it.
"""

import contextlib
import time
from collections import defaultdict
from typing import NamedTuple, Optional

import torch


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]  # index in ``Recording.spans``, None at the top
    step: Optional[int]  # the train step's count, inherited from the parent


class Recording:
    """What one :func:`recording` region recorded: ``spans`` in the order
    they opened, ``counters`` by name."""

    def __init__(self):
        self.spans = []
        self.counters = defaultdict(int)
        self._open = []  # indices of the spans open now, innermost last

    def _enter(self, name, step):
        parent = self._open[-1] if self._open else None
        if step is None and parent is not None:
            step = self.spans[parent][4]
        self._open.append(len(self.spans))
        self.spans.append([name, time.time_ns(), None, parent, step])

    def _exit(self):
        self.spans[self._open.pop()][2] = time.time_ns()

    def _close(self):
        self.spans = [Span(*s) for s in self.spans]
        self.counters = dict(self.counters)


class _OpenSpan:
    __slots__ = ("rec", "name", "step")

    def __init__(self, rec, name, step):
        self.rec, self.name, self.step = rec, name, step

    def __enter__(self):
        self.rec._enter(self.name, self.step)

    def __exit__(self, *exc):
        self.rec._exit()


_OFF = contextlib.nullcontext()
_active = None  # the Recording of the open recording() region, or None


def span(name, step=None):
    """A context that records ``name``'s host interval while a
    :func:`recording` region is open; ``step`` defaults to the parent's."""
    if _active is None:
        return _OFF
    return _OpenSpan(_active, name, step)


def count(name, n):
    """Add ``n`` to the counter ``name`` while a :func:`recording` region
    is open."""
    if _active is None:
        return
    _active.counters[name] += n


@contextlib.contextmanager
def recording():
    """Record the program's spans and counters in the enclosed region;
    yields the :class:`Recording`, complete when the region ends."""
    global _active
    if _active is not None:
        raise RuntimeError("a recording() region is already open")
    rec = _active = Recording()
    try:
        yield rec
    finally:
        _active = None
        rec._close()


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
