"""Atlas-sharded training: every texture layer split into row bands, one
per rank (counterpart of ``stylemesh_tpu/parallel/atlas.py``).

Rank r holds rows ``[r * h_l / D, (r + 1) * h_l / D)`` of every layer ``l``
and the Adam moments of those rows; the view batch, the loss and its
constants are replicated on every rank.

- forward: each rank renders its bands' partial of every live pyramid
  level with one launch of the banded K1
  (``ops/grid_sample.py::gather_levels`` with a band), and each level's
  partials are summed over the ranks (:func:`mesh.all_reduce_sum`);
- backward: the summed renders' cotangents are the same on every rank, and
  one launch of the banded K2 scatters them into the rank's bands only:
  texture gradients never cross ranks;
- the regularizer sums each band's squares, all-reduces the sums and
  divides by the full layer sizes; the train step takes that value under
  ``no_grad``;
- Adam and the clamp run on the bands, the regularizer's gradient folded
  in with the full layers' coefficients;
- the step is :meth:`TexturePipeline.eager_step` on a card too: the
  forward's all-reduces are collectives, which the single-device step's
  CUDA graphs do not capture.

The port has no splat plans, so every layer is banded (the JAX package
all-gathers the layers its planner cannot band). A layer height that D
does not divide raises. ``gram_mode='current'`` only, as in the JAX
package.
"""

import dataclasses

import torch

from stylemesh_tpu_torch.models.pipeline import (
    PipelineConfig,
    TexturePipeline,
    TrainState,
    _scatter_levels,
)
from stylemesh_tpu_torch.models.texture import Texture
from stylemesh_tpu_torch.ops.grid_sample import sample_levels
from stylemesh_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum,
    gather_to_rank0,
)


class AtlasShardedPipeline(TexturePipeline):
    """TexturePipeline whose texture and Adam moments are row-banded over
    the ranks of ``mesh``; the loss is the single-device step's."""

    def __init__(self, config: PipelineConfig, vgg_params, style_image,
                 mesh: Mesh, style_targets=None):
        if config.gram_mode != "current":
            raise ValueError("atlas-sharded training supports "
                             "gram_mode='current' only")
        d = mesh.size
        self.heights = tuple(config.texture_height // 2 ** l
                             for l in range(config.hierarchical_layers))
        if any(h % d for h in self.heights):
            raise ValueError(f"layer heights {self.heights} do not split "
                             f"into {d} row bands")
        super().__init__(config, vgg_params, style_image,
                         style_targets=style_targets, device=mesh.device)
        self.mesh = mesh
        self.row0s = tuple(mesh.rank * h // d for h in self.heights)
        self.band_rows = tuple(h // d for h in self.heights)

    # ------------------------------------------------------------ state

    def init_full(self, generator=None) -> TrainState:
        """The single-device initial state (every rank draws the same)."""
        return super().init(generator)

    def init(self, generator=None) -> TrainState:
        return self.shard_state(self.init_full(generator))

    def shard_state(self, full: TrainState) -> TrainState:
        """This rank's bands of a full state (copies, on the rank's
        device)."""
        def band(ts):
            return [t[r0:r0 + n].to(self.device).clone()
                    for t, r0, n in zip(ts, self.row0s, self.band_rows)]

        return dataclasses.replace(
            full, texture=Texture(band([l.detach() for l in full.texture.layers])),
            mu=band(full.mu), nu=band(full.nu))

    def gather_state(self, state: TrainState):
        """The full state on rank 0 (every rank must call it), None on the
        other ranks."""
        def gather(ts):
            return [gather_to_rank0(t.detach(), self.mesh) for t in ts]

        layers, mu, nu = (gather(ts) for ts in (state.texture.layers,
                                                 state.mu, state.nu))
        if not self.mesh.is_root:
            return None
        return dataclasses.replace(state, texture=Texture(layers), mu=mu,
                                   nu=nu)

    def train_step(self, state: TrainState, batch, aux=None):
        return self.eager_step(state, batch, aux)

    # ----------------------------------------------- per-band loss pieces

    def _render_pyramid(self, texture: Texture, batch):
        """The summed renders of the live levels: one banded K1 launch for
        this rank's partials (one banded K2 in the backward), each level's
        partial all-reduced."""
        live = self._live_levels(batch)
        partials = sample_levels(
            list(texture.layers), [batch.uv[i] for i in live],
            self.config.kernel_compute, band=(self.row0s, self.heights))
        return _scatter_levels(len(batch.uv), live,
                               [all_reduce_sum(p, self.mesh) for p in partials])

    def _tex_reg(self, texture: Texture):
        """The mean square of every full layer: the bands' sums of squares,
        all-reduced, over the full layer sizes."""
        reg = 0.0
        for w, band in zip(self.config.resolved_tex_reg_weights(),
                           texture.layers):
            total = all_reduce_sum(torch.sum(torch.square(band.float())),
                                   self.mesh)
            reg = reg + total / (band.numel() * self.mesh.size) * w
        return reg

    @torch.no_grad()
    def _tex_reg_value(self, texture: Texture):
        return self._tex_reg(texture)
