"""The train step replayed as CUDA graphs (:meth:`TexturePipeline.train_step`
on a card).

A step launches about 1,800 kernels, most of them small. Queued one by one
from Python, they took the host longer to queue than the card took to run
them. Here each step signature is captured once into three graphs, which
every later step replays inside the program's ``forward``, ``backward``
and ``update`` spans:

- forward: :meth:`TexturePipeline.step_loss` (the regularizer's value
  detached), and the loss terms stacked into one static vector;
- backward: ``torch.autograd.grad`` of the forward's static total
  (``pipeline.texture_grads``), captured as
  ``torch.cuda.make_graphed_callables`` captures a backward: on the same
  stream and in the same memory pool as the forward;
- update: :meth:`TexturePipeline.apply_update` (Adam with the
  regularizer's gradient folded in, the clamp, the walked Gram cache
  copied into the state's own tensors).

The signature is the structure, shapes and dtypes of every tensor of the
batch and of its constants (and which of them are one tensor), the
pipeline's skipped and stop-grad levels, the environment variables that
choose the trunk's route (``vgg.ROUTE_ENV``) and the addresses of the
state's tensors. The first step of a signature runs eagerly on the capture
stream, so that what PyTorch creates lazily for a stream (cuBLAS
workspaces, on the backward's thread too) exists before the capture; the
second captures and replays. A state whose tensors were replaced (a
restored checkpoint) is a new signature.

- The graphs read the batch and its constants from static buffers, copied
  in whenever a step gets other objects than the last ones its graphs
  replayed with (a new chunk): one copy a tensor, and no capture.
- Adam's rate and bias corrections are read from a device tensor, which
  :meth:`TexturePipeline.prepare_update` fills before each update replay
  (and where the update folds in the regularizer's gradient, counts
  ``tex_reg_folded``).
- Each replay returns the step's own loss terms, copied out of the
  forward's static vector, and adds to the kernel wrappers' launch
  counters the launches its capture made.
- Every graph of the process shares one memory pool: graphs replay a whole
  step at a time on one stream, and what a forward saves for its backward
  lives only from the one replay to the other, within the step.

Counters (``utils/profiling.py``): ``step_graph_captures``,
``step_graph_replays`` and, in :meth:`TexturePipeline.eager_step`,
``eager_steps``; ``tex_reg_folded`` once an executed update, eager or
replayed, that adds the regularizer's gradient.
"""

import dataclasses
import os

import torch

from stylemesh_tpu_torch.models.texture import texture_grads
from stylemesh_tpu_torch.models.vgg import ROUTE_ENV
from stylemesh_tpu_torch.utils.profiling import count, span

_pool = None  # the memory pool of every graph of the process
_streams = {}  # device index -> the capture stream


def _shared_pool():
    global _pool
    if _pool is None:
        _pool = torch.cuda.graph_pool_handle()
    return _pool


def _capture_stream(device):
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    if index not in _streams:
        _streams[index] = torch.cuda.Stream(index)
    return _streams[index]


def _tensors(tree):
    """The tensors of a nest of tuples, lists and dicts, in order."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def _rebuilt(tree, tensors):
    """``tree`` with its tensors taken, in order, from the iterator
    ``tensors``."""
    if torch.is_tensor(tree):
        return next(tensors)
    if isinstance(tree, dict):
        return {k: _rebuilt(v, tensors) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_rebuilt(v, tensors) for v in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuilt(v, tensors) for v in tree)
    return tree


def _structure(tree):
    """A hashable description of ``tree``: its containers and keys, each
    tensor's shape, dtype and device, and its other leaves as they are."""
    if torch.is_tensor(tree):
        return (tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, _structure(v)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__,) + tuple(_structure(v) for v in tree)
    return tree


def _firsts(tensors):
    """For each tensor, the position of the first that is the same tensor."""
    seen = {}
    return tuple(seen.setdefault(id(t), i) for i, t in enumerate(tensors))


def _state_tensors(state):
    cache = state.gram_cache
    return (list(state.texture.layers) + list(state.mu) + list(state.nu)
            + ([] if cache is None
               else list(cache.grams.values()) + [cache.count]))


def _launch_counters():
    """(wrapper, attribute) of every launch counter of the kernel
    wrappers (the ``*launches`` integers of ``ops/``' functions)."""
    from stylemesh_tpu_torch.ops import (
        adam_kernels,
        conv_im2col,
        conv_kernels,
        gram_kernels,
        grid_sample,
        head_kernels,
    )

    out = {}
    for module in (adam_kernels, conv_im2col, conv_kernels, gram_kernels,
                   grid_sample, head_kernels):
        for fn in vars(module).values():
            for attr, v in getattr(fn, "__dict__", {}).items():
                if (callable(fn) and attr.endswith("launches")
                        and isinstance(v, int)):
                    out[(id(fn), attr)] = (fn, attr)
    return list(out.values())


class StepGraphs:
    """A pipeline's graph sets, one for each step signature it has
    captured; :meth:`step` is its ``train_step`` on a card."""

    def __init__(self):
        self._sets = {}
        self._warm = set()  # the signatures whose eager step has run
        self._last = None  # (batch, aux, input signature, tensors)

    def step(self, pipe, state, batch, aux=None):
        """One train step of ``pipe``: eager on the capture stream at a
        signature's first step, else the replay of its graphs (captured
        at its second)."""
        if aux is None:
            aux = pipe.prepare_batch(batch)
        last = self._last
        if last is None or last[0] is not batch or last[1] is not aux:
            tensors = list(_tensors((batch, aux)))
            inputs = (_structure((batch, aux)), _firsts(tensors))
            last = self._last = (batch, aux, inputs, tensors)
        key = (last[2], pipe.config.skip_levels, pipe.config.stop_grad_levels,
               tuple(os.environ.get(k) for k in ROUTE_ENV),
               tuple(t.data_ptr() for t in _state_tensors(state)))
        graphs = self._sets.get(key)
        if graphs is None and key not in self._warm:
            self._warm.add(key)
            return _warm_up(pipe, state, batch, aux)
        with span("train_step", step=state.step):
            if graphs is None:
                graphs = self._sets[key] = _Graphs(pipe, state, batch, aux,
                                                   last[3])
                count("step_graph_captures", 1)
            count("step_graph_replays", 1)
            return graphs.replay(pipe, state, batch, aux, last[3])


def _warm_up(pipe, state, batch, aux):
    """The eager step, on the capture stream."""
    main = torch.cuda.current_stream(pipe.device)
    stream = _capture_stream(pipe.device)
    stream.wait_stream(main)
    with torch.cuda.stream(stream):
        losses = pipe.eager_step(state, batch, aux)
    main.wait_stream(stream)
    return losses


class _Graphs:
    """The forward, backward and update graphs of one step signature, the
    static buffers they read the batch and its constants from, and the
    forward's static vector of loss terms."""

    def __init__(self, pipe, state, batch, aux, tensors):
        firsts = _firsts(tensors)
        # outside the capture, so in the default pool: they outlive replays
        buffers = {i: tensors[i].clone() for i in set(firsts)}
        self.copies = sorted(buffers.items())  # (position, buffer)
        static_batch, static_aux = _rebuilt(
            (batch, aux), iter([buffers[i] for i in firsts]))
        self.inputs = (batch, aux)  # what the buffers hold
        stream, pool = _capture_stream(pipe.device), _shared_pool()
        counters = _launch_counters()
        before = [getattr(fn, attr) for fn, attr in counters]
        self.forward, self.backward, self.update = (
            torch.cuda.CUDAGraph() for _ in range(3))
        with torch.cuda.graph(self.forward, pool=pool, stream=stream):
            total, losses, cache = pipe.step_loss(
                state.texture, static_batch, static_aux, state.gram_cache)
            self.keys = tuple(losses)
            self.losses = torch.stack([v.detach() for v in losses.values()])
        with torch.cuda.graph(self.backward, pool=pool, stream=stream):
            grads = texture_grads(total, list(state.texture.layers))
        # the capture runs apply_update's host half too: on a copy
        captured = dataclasses.replace(state)
        with torch.cuda.graph(self.update, pool=pool, stream=stream):
            pipe.apply_update(captured, grads, cache)
        self.steps = captured.step - state.step  # what apply_update counts
        # the capture launched nothing: each replay counts its launches
        self.launches = []
        for (fn, attr), n in zip(counters, before):
            if getattr(fn, attr) != n:
                self.launches.append((fn, attr, getattr(fn, attr) - n))
                setattr(fn, attr, n)

    def replay(self, pipe, state, batch, aux, tensors):
        if self.inputs[0] is not batch or self.inputs[1] is not aux:
            for i, buffer in self.copies:
                buffer.copy_(tensors[i])
            self.inputs = (batch, aux)
        with span("forward"):
            self.forward.replay()
            losses = self.losses.clone()
        with span("backward"):
            self.backward.replay()
        with span("update"):
            pipe.prepare_update(state.step)
            self.update.replay()
        state.step += self.steps
        for fn, attr, n in self.launches:
            setattr(fn, attr, getattr(fn, attr) + n)
        return dict(zip(self.keys, losses.unbind()))
