"""View-parallel training (counterpart of ``stylemesh_tpu/parallel/train.py``).

Rank r of D takes the contiguous views ``[r * V / D, (r + 1) * V / D)`` of
every batch, runs the whole single-device step on them, and the texture
gradients and the losses are averaged over the ranks (the loss is a mean
over views, so this is the single-device step's arithmetic). The texture
and the Adam moments are replicated; every rank applies the same update,
which adds the regularizer's gradient ``c * p`` to the averaged one: with
``p`` replicated, ``pmean(g) + c * p`` is ``pmean(g + c * p)``.

Under ``gram_mode='average'`` each rank walks its own views from the
pre-step cache, and :meth:`ShardedTexturePipeline._merge_gram_pushes`
folds every rank's pushes into that cache in (rank, view, level) order,
which with contiguous view slices is the single-device walk's order: the
cache after the step is the sequential one. A view mixes against the
pushes of its own rank's earlier views only; other ranks' pushes of the
same step land one step late (the JAX package's documented staleness).
"""

import dataclasses
from typing import Optional

import torch

from stylemesh_tpu_torch.models.losses import GRAM_CACHE_DEPTH, GramCache, _push
from stylemesh_tpu_torch.models.pipeline import (
    BatchAux,
    PipelineConfig,
    TexturePipeline,
    TrainState,
)
from stylemesh_tpu_torch.models.texture import texture_grads
from stylemesh_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_rows,
    shard_view_batch,
)


class ShardedTexturePipeline(TexturePipeline):
    """TexturePipeline whose step runs view-parallel over the ranks of
    ``mesh``. Its methods take the whole batch (``num_views`` divisible by
    the world size) and use the rank's views of it."""

    def __init__(self, config: PipelineConfig, vgg_params, style_image,
                 mesh: Mesh, style_targets=None):
        super().__init__(config, vgg_params, style_image,
                         style_targets=style_targets, device=mesh.device)
        self.mesh = mesh
        if config.gram_mode == "average":
            self.loss = dataclasses.replace(self.loss, collect_push_log=True)

    def local_batch(self, batch):
        return shard_view_batch(batch, self.mesh)

    def prepare_batch(self, batch) -> BatchAux:
        """The batch constants of the rank's views."""
        return super().prepare_batch(self.local_batch(batch))

    def _pmean(self, tensors):
        """The mean over the ranks of each tensor, in place."""
        if self.mesh.size > 1:
            for t in tensors:
                torch.distributed.all_reduce(t, group=self.mesh.group)
                t.div_(self.mesh.size)
        return tensors

    def _merge_gram_pushes(self, pre_cache: GramCache,
                           local_cache: GramCache) -> GramCache:
        """The pre-step cache with every rank's pushes folded in, in
        (rank, view, level) order: the sequential walk's cache."""
        pushes, flags = local_cache.push_log
        flags_all = all_gather_rows(flags.to(torch.int32), self.mesh).bool()
        grams = {}
        for k, cache_k in pre_cache.grams.items():
            pushed = all_gather_rows(pushes[k], self.mesh)
            for j in range(pushed.shape[0]):
                cache_k = torch.where(flags_all[j], _push(cache_k, pushed[j]),
                                      cache_k)
            grams[k] = cache_k
        count = torch.clamp(pre_cache.count + flags_all.sum(),
                            max=GRAM_CACHE_DEPTH)
        return GramCache(grams=grams, count=count)

    def train_step(self, state: TrainState, batch,
                   aux: Optional[BatchAux] = None):
        if aux is None:
            aux = self.prepare_batch(batch)
        layers = list(state.texture.layers)
        total, losses, cache = self.step_loss(state.texture,
                                              self.local_batch(batch), aux,
                                              state.gram_cache)
        grads = self._pmean(texture_grads(total, layers))
        if cache is not None and cache.push_log is not None:
            cache = self._merge_gram_pushes(state.gram_cache, cache)
        self.apply_update(state, grads, cache)
        return dict(zip(losses, self._pmean(
            [v.detach().clone() for v in losses.values()])))

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch,
                  aux: Optional[BatchAux] = None):
        if aux is None:
            aux = self.prepare_batch(batch)
        _, losses, _ = self.loss_fn(state.texture, self.local_batch(batch),
                                    aux, state.gram_cache)
        return dict(zip(losses, self._pmean(
            [v.detach().clone() for v in losses.values()])))
