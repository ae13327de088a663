"""Faults planted under the timed path, for the check that a broken
program comes out not correct (``tests/``, ``calibrate.py``):

- ``unchanged_state``: a train step that leaves the texture, the Adam
  moments and the step count as they were;
- ``half_batch``: the step sees only the first half of its chunk's views
  and takes the mean over them.
"""

import contextlib

from stylemesh_tpu_torch.models.pipeline import TexturePipeline


@contextlib.contextmanager
def unchanged_state():
    saved = TexturePipeline.apply_update
    TexturePipeline.apply_update = lambda self, state, grads, gram_cache=None: None
    try:
        yield
    finally:
        TexturePipeline.apply_update = saved


@contextlib.contextmanager
def half_batch():
    from benchmark import harness

    saved = harness.batch_from_numpy

    def first_half(host, device):
        n = host.rgb.shape[0] // 2
        return saved(type(host)(*[
            None if f is None else tuple(x[:n] for x in f)
            if isinstance(f, tuple) else f[:n] for f in host]), device)

    harness.batch_from_numpy = first_half
    try:
        yield
    finally:
        harness.batch_from_numpy = saved


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch}


def applicable(cell):
    """The faults ``cell`` can have: half a batch needs two views."""
    return [f for f in FAULTS if f != "half_batch"
            or cell.traffic["views_per_step"] >= 2]
