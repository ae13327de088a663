"""The texture-optimization pipeline: one train step over a batch of views
(counterpart of ``stylemesh_tpu/models/pipeline.py``).

- The reference's backward gradient hooks (angle weighting, depth-level
  interpolation) multiply pixel gradients by constants; here they are the
  forward reweighting ``x.detach() + w * (x - x.detach())``, whose value is
  exactly ``x`` and whose gradient is ``w``.
- Adam (0.9, 0.999, eps 1e-8) with a staircase StepLR, written out as optax
  computes it, followed by the clamp of the texture to the Gatys range
  (``ops/adam_kernels.py``: one kernel launch on a card). The texture, the
  Adam moments and the Gram cache are updated in place. The step's rate and
  bias corrections are written to a device tensor before each update, which
  reads them there.
- On a card, :meth:`TexturePipeline.train_step` replays the step as three
  CUDA graphs (``models/step_graph.py``) from the second step of each step
  signature on; :meth:`TexturePipeline.eager_step` is the step launched op
  by op, on the CPU always.
- ``skip_levels`` are neither rendered nor encoded and add no loss term;
  ``stop_grad_levels`` are rendered and scored but their prediction is
  detached (the run loop picks both from the scene, ``optimize.py``).
- ``gram_mode="average"`` carries the loss's ``GramCache`` in the train
  state (``TrainState.gram_cache``).
- The render (:meth:`TexturePipeline._render_pyramid`), the regularizer
  (:meth:`TexturePipeline._tex_reg`) and the update
  (:meth:`TexturePipeline.apply_update`) are the pieces the multi-device
  pipelines of ``parallel/`` override or reuse.
"""

import dataclasses
import warnings
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from stylemesh_tpu_torch import resolve_device
from stylemesh_tpu_torch.data.schema import ViewBatch
from stylemesh_tpu_torch.models.losses import (
    ContentAndStyleLoss,
    GramCache,
    StyleTargets,
)
from stylemesh_tpu_torch.models.texture import (
    Texture,
    clamp_texture,
    sample_texture,
    texture_regularizer,
)
from stylemesh_tpu_torch.models.step_graph import StepGraphs
from stylemesh_tpu_torch.models.vgg import VGG_LAYER_CHANNELS
from stylemesh_tpu_torch.ops.adam_kernels import (
    ADAM_B1,
    ADAM_B2,
    ADAM_EPS,
    adam_clamp_,
)
from stylemesh_tpu_torch.ops.erosion import erode
from stylemesh_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from stylemesh_tpu_torch.utils.profiling import count, span


def _grad_scale(x, w):
    """Value ``x``, gradient ``w * dx``."""
    sg = x.detach()
    return sg + w * (x - sg)


def _scatter_levels(n, live, renders):
    """``n`` pyramid levels: ``renders`` at the ``live`` indices, None at
    the skipped ones."""
    levels = [None] * n
    for i, r in zip(live, renders):
        levels[i] = r
    return levels


def depth_pyramid_masks(batch: ViewBatch, level_shapes):
    """Per-level loss masks from the per-pixel depth levels: pixels whose
    nearest or 2nd-nearest level is i, inside the UV mask, eroded 3x3,
    nearest-resized to the level resolution, binarized."""
    masks = []
    for i, hw in enumerate(level_shapes):
        m1 = (batch.rounded_depth_level == i).float()
        m2 = (batch.other_depth_level == i).float()
        m = erode((m1 + m2) * batch.mask.float())
        m = resize_nearest(m, hw)
        masks.append((m > 0).float())
    return masks


def depth_interpolation_weights(batch: ViewBatch, level_shapes):
    """Per-level gradient interpolation weights."""
    weights = []
    mask = batch.mask.float()
    w = batch.depth_level_weight.float()
    for i, hw in enumerate(level_shapes):
        m1 = erode((batch.rounded_depth_level == i).float() * mask)
        m2 = erode((batch.other_depth_level == i).float() * mask)
        weights.append(resize_nearest(m1 * w + m2 * (1.0 - w), hw))
    return weights


def last_level_only_masks(batch: ViewBatch, level_shapes):
    """No-depth-scaling masks: all levels empty except the last, which gets
    the full UV mask."""
    masks = []
    v = batch.mask.shape[0]
    for i, hw in enumerate(level_shapes):
        if i == len(level_shapes) - 1:
            m = resize_nearest(batch.mask.float(), hw)
            masks.append((m > 0).float())
        else:
            masks.append(torch.zeros((v,) + tuple(hw) + (1,),
                                     device=batch.mask.device))
    return masks


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static configuration: the fields of the JAX ``PipelineConfig`` that
    this port runs."""

    # texture
    texture_width: int = 4096
    texture_height: int = 4096
    hierarchical_layers: int = 4
    random_texture_init: bool = False

    # loss
    style_layers: Tuple[str, ...] = ("r11", "r21", "r31", "r41", "r51")
    content_layers: Tuple[str, ...] = ("r42",)
    style_weights: Tuple[float, ...] = tuple(1e3 / n ** 2 for n in (64, 128, 256, 512, 512))
    content_weights: Tuple[float, ...] = (1.0,)
    use_angle_weight: bool = True
    use_depth_scaling: bool = True
    angle_threshold: float = 60.0
    style_pyramid_mode: str = "single"
    gram_mode: str = "current"  # "current" | "average"
    num_style_levels: int = 5
    style_min_size: int = 256

    # loss weights (reference --loss_weight flags)
    content_weight: float = 0.0
    style_weight: float = 0.0
    tex_reg_weight: float = 0.0
    tex_reg_weights: Optional[Tuple[float, ...]] = None

    # optimization
    learning_rate: float = 1.0
    decay_gamma: float = 0.1
    decay_step_size: int = 30  # in epochs
    # converts the epoch-based StepLR to steps; 0 = unset, taken as 1 with a
    # warning (as in the JAX package)
    steps_per_epoch: int = 0

    # numerics / kernels
    compute_dtype: Optional[torch.dtype] = None  # torch.bfloat16 on the card
    precision: str = "highest"  # 'highest': float32 convolutions without TF32
    kernel_compute: str = "f32"  # K1/K2 numerics: "f32" | "bf16"
    remat_vgg: bool = True  # recompute VGG activations in the backward
    remat_min_px: int = 0  # remat only levels with >= this many pixels
    # pyramid levels empty for every view: not rendered, encoded or scored
    skip_levels: Tuple[int, ...] = ()
    # pyramid levels whose gradient weight is zero at every pixel: value
    # kept, prediction detached
    stop_grad_levels: Tuple[int, ...] = ()

    def resolved_tex_reg_weights(self):
        if self.tex_reg_weights is not None:
            if len(self.tex_reg_weights) != self.hierarchical_layers:
                raise ValueError("tex_reg_weights needs one weight per layer")
            return tuple(self.tex_reg_weights)
        # reference default: [2^(L-1-i)], last layer 0
        w = [2.0 ** (self.hierarchical_layers - i - 1)
             for i in range(self.hierarchical_layers)]
        if self.hierarchical_layers > 0:
            w[-1] = 0.0
        return tuple(w)

    def loss_config(self) -> ContentAndStyleLoss:
        return ContentAndStyleLoss(
            style_layers=self.style_layers,
            content_layers=self.content_layers,
            style_weights=self.style_weights,
            content_weights=self.content_weights,
            angle_threshold=self.angle_threshold,
            style_pyramid_mode=self.style_pyramid_mode,
            gram_mode=self.gram_mode,
            num_style_levels=self.num_style_levels,
            style_min_size=self.style_min_size,
            remat=self.remat_vgg,
            remat_min_px=self.remat_min_px,
            compute_dtype=self.compute_dtype,
            precision=self.precision,
            skip_levels=self.skip_levels,
        )


@dataclasses.dataclass
class TrainState:
    """The texture, the Adam moments (one per layer), the step count and,
    under ``gram_mode='average'``, the Gram cache.
    :meth:`TexturePipeline.train_step` updates it in place: its tensors stay
    the same objects from step to step."""

    texture: Texture
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    step: int = 0
    gram_cache: Optional[GramCache] = None


class BatchAux(NamedTuple):
    """Texture-independent per-batch constants (see
    :meth:`TexturePipeline.prepare_batch`)."""

    grad_weights: Optional[Tuple]  # per level [V, H_i, W_i, 1] or None
    pyramid_masks: Tuple  # per level [V, H_i, W_i, 1]
    loss_aux: Any  # ContentAndStyleLoss.precompute_aux result


class TexturePipeline:
    """Owns the train and eval steps.

    Usage::

        pipe = TexturePipeline(config, vgg_params, style_image)  # on CUDA
        state = pipe.init()
        aux = pipe.prepare_batch(batch)
        losses = pipe.train_step(state, batch, aux)  # updates state in place
    """

    def __init__(self, config: PipelineConfig, vgg_params, style_image,
                 style_targets: Optional[StyleTargets] = None, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.vgg_params = {
            name: {k: t.to(self.device) for k, t in p.items()}
            for name, p in vgg_params.items()}
        self.loss = config.loss_config()
        self.style_targets = (
            style_targets if style_targets is not None
            else self.loss.set_style_image(
                self.vgg_params, torch.as_tensor(style_image).to(self.device)))
        steps_per_epoch = config.steps_per_epoch
        if steps_per_epoch == 0:
            warnings.warn(
                "PipelineConfig.steps_per_epoch is unset; assuming 1, so "
                "StepLR decays every decay_step_size STEPS (the reference "
                "schedules in EPOCHS).", stacklevel=2)
            steps_per_epoch = 1
        self._decay_every = config.decay_step_size * steps_per_epoch
        # the rate and the two bias corrections the update reads
        self._adam_scalars = torch.zeros(3, device=self.device)
        self._graphs = StepGraphs() if self.device.type == "cuda" else None

    # ------------------------------------------------------------- state

    def init(self, generator: Optional[torch.Generator] = None) -> TrainState:
        cfg = self.config
        texture = Texture.create(cfg.texture_width, cfg.texture_height, 3,
                                 num_layers=cfg.hierarchical_layers,
                                 random_init=cfg.random_texture_init,
                                 generator=generator, device=self.device)
        clamp_texture(texture)
        gram_cache = None
        if cfg.gram_mode == "average":
            gram_cache = GramCache.create(cfg.style_layers, VGG_LAYER_CHANNELS,
                                          device=self.device)
        return TrainState(
            texture=texture,
            mu=[torch.zeros_like(l) for l in texture.layers],
            nu=[torch.zeros_like(l) for l in texture.layers],
            gram_cache=gram_cache)

    def learning_rate(self, step: int) -> float:
        """optax.exponential_decay(staircase=True) at optimizer count ``step``."""
        cfg = self.config
        return cfg.learning_rate * cfg.decay_gamma ** (step // self._decay_every)

    # ------------------------------------------------------------- loss

    @torch.no_grad()
    def prepare_batch(self, batch: ViewBatch) -> BatchAux:
        """Every texture-independent part of the step for this batch:
        per-level gradient weights, loss masks, content-target encodings,
        level factors. Reuse it across the batch's repeat steps."""
        with span("prepare_batch"):
            cfg = self.config
            level_shapes = [tuple(u.shape[1:3]) for u in batch.uv]
            weights = None
            if cfg.use_angle_weight or cfg.use_depth_scaling:
                interp = (depth_interpolation_weights(batch, level_shapes)
                          if cfg.use_depth_scaling else None)
                per_level = []
                for i, hw in enumerate(level_shapes):
                    w = None
                    if cfg.use_angle_weight:
                        w = resize_bilinear(batch.angle_guidance.float(), hw)
                    if interp is not None:
                        w = interp[i] if w is None else w * interp[i]
                    per_level.append(w)
                weights = tuple(per_level)
            if cfg.use_depth_scaling:
                pyramid_masks = tuple(depth_pyramid_masks(batch,
                                                          level_shapes))
            else:
                pyramid_masks = tuple(last_level_only_masks(batch,
                                                            level_shapes))
            loss_aux = self.loss.precompute_aux(
                self.vgg_params, level_shapes, batch.rgb, pyramid_masks,
                batch.angle_degrees)
            return BatchAux(grad_weights=weights, pyramid_masks=pyramid_masks,
                            loss_aux=loss_aux)

    def loss_fn(self, texture: Texture, batch: ViewBatch,
                aux: Optional[BatchAux] = None,
                gram_cache: Optional[GramCache] = None):
        """(total loss, dict of the weighted loss terms, new Gram cache)."""
        return self.loss_with_targets(texture, self.style_targets, batch, aux,
                                      gram_cache)

    def loss_with_targets(self, texture: Texture, style_targets: StyleTargets,
                          batch: ViewBatch, aux: Optional[BatchAux] = None,
                          gram_cache: Optional[GramCache] = None):
        """:meth:`loss_fn` with explicit style targets (the multi-style
        sweep's per-style loss, ``parallel/multistyle.py``)."""
        cfg = self.config
        if aux is None:
            aux = self.prepare_batch(batch)
        # 1. render: sample the atlas at every live UV pyramid level (K1 / K2)
        pred_pyramid = self._render_pyramid(texture, batch)
        # gradient-dead levels: value kept, backward dropped
        sgl = set(cfg.stop_grad_levels)
        pred_pyramid = [p.detach() if p is not None and i in sgl else p
                        for i, p in enumerate(pred_pyramid)]
        # 2. gradient weighting (forward-mode equivalent of the hooks)
        if aux.grad_weights is not None:
            pred_pyramid = [p if p is None else _grad_scale(p, w)
                            for p, w in zip(pred_pyramid, aux.grad_weights)]
        # 3. content + style
        style_loss, content_loss, new_cache = self.loss(
            self.vgg_params, style_targets, pred_pyramid, batch.rgb,
            aux.pyramid_masks, batch.angle_degrees, aux=aux.loss_aux,
            gram_cache=gram_cache)
        # 4. texture regularizer
        if cfg.tex_reg_weight > 0:
            tex_reg = self._tex_reg(texture)
        else:
            tex_reg = torch.zeros((), device=self.device)
        losses = {
            "content": cfg.content_weight * content_loss,
            "style": cfg.style_weight * style_loss,
            "tex_reg": cfg.tex_reg_weight * tex_reg,
        }
        total = losses["content"] + losses["style"] + losses["tex_reg"]
        losses["total"] = total
        return total, losses, new_cache

    def _render_pyramid(self, texture: Texture, batch: ViewBatch):
        """The atlas sampled at every UV pyramid level, None for a skipped
        level: one K1 launch for the live levels, one K2 in the backward."""
        live = self._live_levels(batch)
        renders = sample_texture(texture, [batch.uv[i] for i in live],
                                 compute=self.config.kernel_compute)
        return _scatter_levels(len(batch.uv), live, renders)

    def _live_levels(self, batch: ViewBatch):
        """The indices of the UV pyramid levels not in ``skip_levels``."""
        skip = set(self.config.skip_levels)
        return [i for i in range(len(batch.uv)) if i not in skip]

    def _tex_reg(self, texture: Texture):
        return texture_regularizer(texture,
                                   self.config.resolved_tex_reg_weights())

    # ------------------------------------------------------------- steps

    def train_step(self, state: TrainState, batch: ViewBatch,
                   aux: Optional[BatchAux] = None) -> Dict[str, torch.Tensor]:
        """One optimization step; updates ``state`` in place and returns the
        loss terms (detached 0-d tensors, not synchronized). On a card the
        step's CUDA graphs (``models/step_graph.py``), else
        :meth:`eager_step`."""
        if self._graphs is None:
            return self.eager_step(state, batch, aux)
        return self._graphs.step(self, state, batch, aux)

    def eager_step(self, state: TrainState, batch: ViewBatch,
                   aux: Optional[BatchAux] = None) -> Dict[str, torch.Tensor]:
        """:meth:`train_step` launched op by op; counted under
        ``eager_steps`` on a card."""
        if self.device.type == "cuda":
            count("eager_steps", 1)
        layers = list(state.texture.layers)
        with span("train_step", step=state.step):
            with span("forward"):
                total, losses, cache = self.loss_fn(state.texture, batch, aux,
                                                    state.gram_cache)
            with span("backward"):
                grads = torch.autograd.grad(total, layers)
            with span("update"):
                self.apply_update(state, grads, cache)
        return {k: v.detach() for k, v in losses.items()}

    def apply_update(self, state: TrainState, grads, gram_cache=None):
        """Adam on the texture with ``grads`` and the clamp (on a card one
        launch, ``ops/adam_kernels.py``), the walked Gram cache copied into
        the state's own (its push log dropped), all in place, and the step
        count. Adam's rate and bias corrections are written here
        (:meth:`write_adam_scalars`); under a CUDA graph capture, which
        would freeze them, before each replay instead."""
        if not (self.device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            self.write_adam_scalars(state.step)
        adam_clamp_(list(state.texture.layers), grads, state.mu, state.nu,
                    self._adam_scalars)
        if gram_cache is not None:
            own = state.gram_cache
            with torch.no_grad():
                for k, g in gram_cache.grams.items():
                    own.grams[k].copy_(g)
                own.count.copy_(gram_cache.count)
        state.step += 1

    def write_adam_scalars(self, step: int):
        """The scheduled rate and Adam's bias corrections at optimizer count
        ``step + 1``, filled into the device tensor the update reads: fills
        ordered on the stream before the update."""
        lr, bc1, bc2 = self._adam_scalars
        lr.fill_(self.learning_rate(step))
        bc1.fill_(1.0 - ADAM_B1 ** (step + 1))
        bc2.fill_(1.0 - ADAM_B2 ** (step + 1))

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: ViewBatch,
                  aux: Optional[BatchAux] = None) -> Dict[str, torch.Tensor]:
        """The loss terms without an update."""
        _, losses, _ = self.loss_fn(state.texture, batch, aux,
                                    state.gram_cache)
        return losses

