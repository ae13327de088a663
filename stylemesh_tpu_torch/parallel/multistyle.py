"""Multi-style sweeps: one texture per style image, the styles split over
the ranks (counterpart of ``stylemesh_tpu/parallel/multistyle.py``).

With S styles the sweep uses the largest d <= world size that divides S.
Rank r < d holds the S / d textures of styles ``[r * S / d, (r + 1) * S / d)``
with their Adam moments and style targets, and trains them one after the
other on the same (replicated) batch; ranks >= d hold none and only join
the gathers. The styles never exchange gradients: the only collective is
the gather of the per-style losses (and of the textures for export).

``gram_mode='current'`` only, as in the JAX package.
"""

from typing import List, NamedTuple, Optional

import torch

from stylemesh_tpu_torch.models.losses import StyleTargets
from stylemesh_tpu_torch.models.pipeline import (
    BatchAux,
    PipelineConfig,
    TexturePipeline,
    TrainState,
)
from stylemesh_tpu_torch.models.texture import Texture, texture_grads
from stylemesh_tpu_torch.parallel.mesh import Mesh, all_gather_rows


class MultiStyleState(NamedTuple):
    """The train states of this rank's styles (one ``TrainState`` each, in
    style order; empty on a rank that holds no style)."""

    states: List[TrainState]

    @property
    def step(self):
        return self.states[0].step if self.states else 0


def style_ranks(num_styles, world_size):
    """The number of ranks that hold styles: the largest d <= world_size
    that divides ``num_styles``."""
    d = world_size
    while d > 1 and num_styles % d:
        d -= 1
    return d


class MultiStylePipeline:
    """S styles, S textures, one shared scene; the styles over the ranks."""

    def __init__(self, config: PipelineConfig, vgg_params, style_images,
                 mesh: Mesh):
        if config.gram_mode != "current":
            raise ValueError("multi-style sweeps require gram_mode='current'")
        self.config = config
        self.mesh = mesh
        self.num_styles = len(style_images)
        d = style_ranks(self.num_styles, mesh.size)
        self.per_rank = self.num_styles // d
        first = mesh.rank * self.per_rank
        self.local_styles = (list(range(first, first + self.per_rank))
                             if mesh.rank < d else [])
        # the base pipeline brings the loss, the batch constants and the
        # update; every texture is scored with its own style's targets
        self.base = TexturePipeline(config, vgg_params, None,
                                    style_targets=StyleTargets(grams={}),
                                    device=mesh.device)
        self.style_targets = [
            self.base.loss.set_style_image(
                self.base.vgg_params,
                torch.as_tensor(style_images[s]).to(mesh.device))
            for s in self.local_styles]

    def init(self, generator: Optional[torch.Generator] = None):
        return MultiStyleState(states=[self.base.init(generator)
                                       for _ in self.local_styles])

    def prepare_batch(self, batch) -> Optional[BatchAux]:
        """The style-independent batch constants (shared by every style;
        None on a rank that holds no style)."""
        if not self.local_styles:
            return None
        return self.base.prepare_batch(batch)

    def _gather_losses(self, per_style):
        """``{key: [S]}`` from every rank's list of loss dicts."""
        keys = ("content", "style", "tex_reg", "total")
        rows = torch.zeros((self.per_rank, len(keys)), device=self.mesh.device)
        for i, losses in enumerate(per_style):
            rows[i] = torch.stack([losses[k].detach().float() for k in keys])
        every = all_gather_rows(rows, self.mesh)[:self.num_styles]
        return {k: every[:, j] for j, k in enumerate(keys)}

    def train_step(self, state: MultiStyleState, batch,
                   aux: Optional[BatchAux] = None):
        """One step of every style; ``{key: [S] losses}`` on every rank."""
        if aux is None and self.local_styles:
            aux = self.prepare_batch(batch)
        per_style = []
        for st, targets in zip(state.states, self.style_targets):
            total, losses, _ = self.base.step_loss(
                st.texture, batch, aux, style_targets=targets)
            grads = texture_grads(total, list(st.texture.layers))
            self.base.apply_update(st, grads)
            per_style.append(losses)
        return self._gather_losses(per_style)

    @torch.no_grad()
    def eval_step(self, state: MultiStyleState, batch,
                  aux: Optional[BatchAux] = None):
        if aux is None and self.local_styles:
            aux = self.prepare_batch(batch)
        return self._gather_losses([
            self.base.loss_with_targets(st.texture, targets, batch, aux)[1]
            for st, targets in zip(state.states, self.style_targets)])

    def textures(self, state: MultiStyleState):
        """Every style's texture, in style order, on rank 0 (every rank must
        call it); an empty list on the other ranks."""
        cfg = self.config
        layers = []
        for l in range(cfg.hierarchical_layers):
            shape = (cfg.texture_height // 2 ** l, cfg.texture_width // 2 ** l, 3)
            local = torch.zeros((self.per_rank,) + shape, device=self.mesh.device)
            for i, st in enumerate(state.states):
                local[i] = st.texture.layers[l].detach()
            layers.append(all_gather_rows(local, self.mesh)[:self.num_styles])
        if not self.mesh.is_root:
            return []
        return [Texture([x[s] for x in layers]) for s in range(self.num_styles)]
