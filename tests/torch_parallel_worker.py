"""One rank of the multi-process tests of ``stylemesh_tpu_torch.parallel``
(``tests/test_torch_parallel.py``, ``tests/test_torch_gram_average.py``).

The test process writes the inputs (numpy arrays) to ``<dir>/inputs.pt`` and
starts the ranks with :func:`spawn`; each rank joins a gloo process group
through a ``file://`` store, runs the cases its test file names, and writes
what it computed to ``<dir>/rank<r>.pt``. This module imports no JAX, so a
rank starts in a few seconds.

Every rank computes on one thread, and so does the test process's
single-device reference (:func:`one_thread`). On the CPU, ``torch.sqrt``
of a float32 tensor is MKL's vector math, split over the intra-op threads
when it holds more than 2048 elements (a band of 3072: two chunks of
1536). The first such call of a process, split over two or more threads,
has returned the calling thread's chunk at about 2^-12 relative error in
some runs; the same inputs came within one ulp in the others. Adam's first
step divides by that square root, so the texels of that chunk moved up to
1.5e-4 away from the reference (the atlas step on 4 ranks: up to 124 of a
rank's 3072 layer-0 entries beyond 1e-4, all among its first 1536, with
the gradients equal bit for bit). On one thread no call is split.
"""

import contextlib
import dataclasses
import multiprocessing
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from stylemesh_tpu_torch.convert import batch_from_numpy, train_state_from_numpy
from stylemesh_tpu_torch.models.pipeline import PipelineConfig
from stylemesh_tpu_torch.parallel.atlas import AtlasShardedPipeline
from stylemesh_tpu_torch.parallel.mesh import make_mesh, shutdown
from stylemesh_tpu_torch.parallel.multistyle import MultiStylePipeline
from stylemesh_tpu_torch.parallel.train import ShardedTexturePipeline

TIMEOUT_S = 240


def spawn(world, directory, cases):
    """Run ``cases`` (a name of this module's ``CASES``) on ``world`` gloo
    ranks; returns every rank's results. Raises when a rank fails or does
    not finish within TIMEOUT_S."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, str(directory),
                                                  cases))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    if alive:
        raise RuntimeError(f"{len(alive)} ranks did not finish in {TIMEOUT_S} s")
    results = []
    for r, p in enumerate(procs):
        path = os.path.join(directory, f"rank{r}.pt")
        out = torch.load(path, weights_only=False) if os.path.exists(path) else None
        if p.exitcode != 0 or out is None or "error" in out:
            raise RuntimeError(f"rank {r} failed (exit {p.exitcode}):\n"
                               + (out or {}).get("error", ""))
        results.append(out)
    return results


@contextlib.contextmanager
def one_thread():
    """Run the block with one intra-op thread (see the module docstring)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _rank_main(rank, world, directory, cases):
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    out = {}
    try:
        mesh = make_mesh(world, rank, "cpu", init_method="file://"
                         + os.path.join(directory, "store"),
                         timeout_s=TIMEOUT_S)
        inputs = torch.load(os.path.join(directory, "inputs.pt"),
                            weights_only=False)
        try:
            CASES[cases](mesh, inputs, out, directory)
        finally:
            shutdown(mesh)
    except BaseException:  # reported to the test process, which raises
        out["error"] = traceback.format_exc()
    torch.save(out, os.path.join(directory, f"rank{rank}.pt"))


def _setup(inputs, **overrides):
    cfg = PipelineConfig(**{**inputs["cfg"], **overrides})
    vgg = inputs["port_vgg"]
    batch = batch_from_numpy(inputs["batch"], "cpu")
    return cfg, vgg, torch.from_numpy(inputs["style"]), batch


def _state(layers, device="cpu"):
    zeros = [np.zeros_like(l) for l in layers]
    return train_state_from_numpy(layers, zeros, zeros, 0, device)


def _grads(pipe, state, batch, aux):
    layers = list(state.texture.layers)
    total, losses, _ = pipe.loss_fn(state.texture, batch, aux,
                                    state.gram_cache)
    return [g.numpy() for g in torch.autograd.grad(total, layers)], losses


def _atlas(mesh, inputs, tag, out):
    """Band gradients, one train step's losses and the bands after it."""
    cfg, vgg, style, batch = _setup(inputs)
    pipe = AtlasShardedPipeline(cfg, vgg, style, mesh)
    state = pipe.shard_state(_state(inputs["layers"]))
    aux = pipe.prepare_batch(batch)
    grads, _ = _grads(pipe, state, batch, aux)
    losses = pipe.train_step(state, batch, aux)
    full = pipe.gather_state(state)
    out[tag] = dict(
        grads=grads, losses={k: float(v) for k, v in losses.items()},
        bands=[l.detach().numpy() for l in state.texture.layers],
        full=None if full is None else [l.detach().numpy()
                                        for l in full.texture.layers])


def _data_parallel(mesh, inputs, tag, out, steps=1, **overrides):
    """The averaged gradients, and the losses, textures and Gram caches of
    ``steps`` train steps."""
    cfg, vgg, style, batch = _setup(inputs, **overrides)
    pipe = ShardedTexturePipeline(cfg, vgg, style, mesh)
    state = _state(inputs["layers"])
    if cfg.gram_mode == "average":
        state.gram_cache = pipe.init().gram_cache
    aux = pipe.prepare_batch(batch)
    local = pipe.local_batch(batch)
    layers = list(state.texture.layers)
    total, _, _ = pipe.loss_fn(state.texture, local, aux, state.gram_cache)
    grads = pipe._pmean(list(torch.autograd.grad(total, layers)))
    history, caches = [], []
    for _ in range(steps):
        history.append({k: float(v) for k, v in
                        pipe.train_step(state, batch, aux).items()})
        if state.gram_cache is not None:
            assert state.gram_cache.push_log is None
            caches.append(dict(
                count=int(state.gram_cache.count),
                grams={k: g.numpy().copy()
                       for k, g in state.gram_cache.grams.items()}))
    out[tag] = dict(grads=[g.numpy() for g in grads], history=history,
                    caches=caches,
                    layers=[l.detach().numpy() for l in state.texture.layers])


def _multistyle(mesh, inputs, tag, out, steps=2):
    cfg, vgg, _, batch = _setup(inputs)
    pipe = MultiStylePipeline(cfg, vgg, inputs["styles"], mesh)
    state = pipe.init()
    for st in state.states:
        fresh = _state(inputs["layers"])
        st.texture, st.mu, st.nu = fresh.texture, fresh.mu, fresh.nu
    aux = pipe.prepare_batch(batch)
    history = [{k: v.numpy().copy() for k, v in
                pipe.train_step(state, batch, aux).items()}
               for _ in range(steps)]
    textures = pipe.textures(state)
    out[tag] = dict(local_styles=pipe.local_styles, history=history,
                    textures=[[l.detach().numpy() for l in t.layers]
                              for t in textures])


def _run_training(mesh, inputs, tag, out, directory):
    """The run loop, then a second run resumed from the first's last
    checkpoint."""
    from stylemesh_tpu_torch.optimize import RunConfig, run_training

    cfg = PipelineConfig(**inputs["run_cfg"])
    run = RunConfig(log_dir=os.path.join(directory, tag), **inputs["run"])
    _, log_dir, _, _ = run_training(run, cfg, mesh=mesh)
    resumed = dataclasses.replace(
        run, log_dir=os.path.join(directory, tag + "_resumed"),
        resume_from=os.path.join(log_dir, "ckpt"))
    state, _, _, _ = run_training(resumed, cfg, mesh=mesh)
    out[tag] = dict(log_dir=log_dir, resumed_step=state.step)


def _subgroup(mesh, ranks):
    """The mesh over ``ranks`` (every rank must call it); None on a rank
    outside them."""
    group = dist.new_group(ranks)
    if mesh.rank not in ranks:
        return None
    return dataclasses.replace(mesh, rank=ranks.index(mesh.rank),
                               size=len(ranks), group=group)


def _parallel_cases(mesh, inputs, out, directory):
    """4 ranks: the atlas step over all four; then ranks 0-1 run the atlas
    step over two and the run loop with ``shard_atlas``, while ranks 2-3
    run the view-parallel step and the multi-style sweep."""
    _atlas(mesh, inputs, "atlas4", out)
    first, second = _subgroup(mesh, [0, 1]), _subgroup(mesh, [2, 3])
    if first is not None:
        _atlas(first, inputs, "atlas2", out)
        _run_training(first, inputs, "run_atlas", out, directory)
    if second is not None:
        _data_parallel(second, inputs, "dp2", out)
        _multistyle(second, inputs, "multistyle2", out)


def _gram_average_cases(mesh, inputs, out, directory):
    """2 ranks: the view-parallel step under gram_mode='average'."""
    _data_parallel(mesh, inputs, "dp_average", out, steps=2,
                   gram_mode="average")


CASES = {"parallel": _parallel_cases, "gram_average": _gram_average_cases}
