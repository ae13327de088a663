"""Content + style losses over a multi-resolution prediction pyramid
(counterpart of ``stylemesh_tpu/models/losses.py``).

- Variable-length masked feature sets are mask-weighted Grams / MSEs.
- An empty pyramid level gets factor 0 and zero masked losses.
- A batch of V views computes per-view masks, factors and losses and returns
  the mean over views.
- Style layers of at least ``gram_kernels.MIN_PX`` pixels (every non-empty
  layer) go, in bf16, to the fused masked-Gram kernels K3/K4 (one feature
  read for both mask variants); the JAX package keeps layers below 50 000
  pixels on its einsum (see ``ops/gram_kernels.py``). The float32 loss stays
  on the plain masked Gram.
- ``skip_levels`` (levels empty for every view) are neither encoded nor
  scored, and the level factors are normalized over the other levels.
- ``remat`` recomputes the VGG encode of every level with at least
  ``remat_min_px`` pixels in the backward
  (``torch.utils.checkpoint.checkpoint``); the numbers are the same.
- ``gram_mode="average"`` (the reference's rolling mean of the current and
  up to 9 detached earlier Grams) carries a :class:`GramCache` from step to
  step. Views are walked in order, view-outer and level-inner, so that a
  view mixes against the pushes of the earlier views of its batch: V
  consecutive reference steps. A level empty for a view does not push.
"""

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from stylemesh_tpu_torch.models.vgg import vgg_features
from stylemesh_tpu_torch.ops import gram_kernels
from stylemesh_tpu_torch.ops.gram import gram_matrix, masked_gram, masked_mse
from stylemesh_tpu_torch.ops.pyramid import image_pyramid
from stylemesh_tpu_torch.ops.resize import resize_bilinear, resize_nearest

DEFAULT_STYLE_LAYERS = ("r11", "r21", "r31", "r41", "r51")
DEFAULT_CONTENT_LAYERS = ("r42",)
DEFAULT_STYLE_WEIGHTS = tuple(1e3 / n ** 2 for n in (64, 128, 256, 512, 512))
DEFAULT_CONTENT_WEIGHTS = (1.0,)

GRAM_CACHE_DEPTH = 10  # the current Gram + 9 detached ones


class StyleTargets(NamedTuple):
    """Precomputed style Gram targets: layer name -> ``[num_levels, C, C]``."""

    grams: Dict[str, torch.Tensor]


class GramCache(NamedTuple):
    """State of ``gram_mode='average'``.

    ``grams[layer]``: ``[GRAM_CACHE_DEPTH, C, C]`` float32 ring (slot 0 the
    most recent push); ``count``: 0-d int64 tensor, the valid entries.
    ``push_log`` is set only under ``ContentAndStyleLoss.collect_push_log``
    (the view-parallel cache merge, ``parallel/train.py``): the walk's
    pushes ``({layer: [P, C, C]}, [P] bool flags)`` in (view, level) order.
    It is never kept in the train state.
    """

    grams: Dict[str, torch.Tensor]
    count: torch.Tensor
    push_log: Optional[Tuple[Dict[str, torch.Tensor], torch.Tensor]] = None

    @staticmethod
    def create(style_layers, layer_channels, device=None):
        return GramCache(
            grams={k: torch.zeros((GRAM_CACHE_DEPTH, layer_channels[k],
                                   layer_channels[k]), device=device)
                   for k in style_layers},
            count=torch.zeros((), dtype=torch.int64, device=device))


def _push(cache_k, gram):
    """``cache_k`` with ``gram`` pushed into slot 0 (the oldest drops)."""
    return torch.cat([gram[None], cache_k[:-1]], dim=0)


def _mse_gram(y, y_hat):
    """Per-view MSE between a target Gram ``[C, C]`` and ``[V, C, C]``."""
    d = (y_hat.float() - y.float()) ** 2
    return d.mean(dim=(-2, -1))


@dataclasses.dataclass(frozen=True)
class ContentAndStyleLoss:
    """Static configuration of the loss."""

    style_layers: Tuple[str, ...] = DEFAULT_STYLE_LAYERS
    content_layers: Tuple[str, ...] = DEFAULT_CONTENT_LAYERS
    style_weights: Tuple[float, ...] = DEFAULT_STYLE_WEIGHTS
    content_weights: Tuple[float, ...] = DEFAULT_CONTENT_WEIGHTS
    angle_threshold: float = 60.0
    style_pyramid_mode: str = "single"  # 'single' | 'multi'
    gram_mode: str = "current"
    pool: str = "max"
    num_style_levels: int = 5
    style_min_size: int = 256
    remat: bool = True
    remat_min_px: int = 0
    compute_dtype: Optional[torch.dtype] = None
    precision: str = "highest"
    skip_levels: Tuple[int, ...] = ()
    # record the gram-average walk's pushes in GramCache.push_log
    collect_push_log: bool = False

    def __post_init__(self):
        if self.style_pyramid_mode not in ("single", "multi"):
            raise ValueError(f"style_pyramid_mode {self.style_pyramid_mode!r}")
        if self.gram_mode not in ("current", "average"):
            raise ValueError(f"gram_mode {self.gram_mode!r}")

    @property
    def layers(self):
        return tuple(self.style_layers) + tuple(self.content_layers)

    def _encode(self, vgg_params, x, keys):
        return vgg_features(vgg_params, x, keys, pool=self.pool,
                            compute_dtype=self.compute_dtype,
                            precision=self.precision)

    @torch.no_grad()
    def set_style_image(self, vgg_params, style_image):
        """Per-level style Gram targets of a ``[1, H, W, 3]`` Gatys image."""
        levels = list(range(self.num_style_levels))
        pyramid = image_pyramid(style_image, levels, reverse=True,
                                minimum_size=self.style_min_size)
        per_level = []
        for p in pyramid:
            encs = self._encode(vgg_params, p, self.style_layers)
            per_level.append({k: gram_matrix(encs[k])[0]
                              for k in self.style_layers})
        return StyleTargets(grams={
            k: torch.stack([g[k] for g in per_level], dim=0)
            for k in self.style_layers})

    @staticmethod
    def _layer_hw(name, hw):
        """Feature resolution of a named activation for an ``hw`` input."""
        pools = int(name[1]) - (0 if name.startswith("p") else 1)
        return (hw[0] // 2 ** pools, hw[1] // 2 ** pools)

    @torch.no_grad()
    def precompute_aux(self, vgg_params, level_shapes, target_content,
                       pyramid_masks, angle_degrees):
        """All texture-independent constants of the loss for one batch: the
        content-target encodings and their resizes, the mask resizes, the
        level factors, and the stacked masks of the fused-Gram layers."""
        num_levels = len(level_shapes)
        v = target_content.shape[0]
        content_encs = self._encode(vgg_params, target_content,
                                    self.content_layers)
        # masks are 0/1 (exact in bf16); content targets follow the compute
        # dtype (they came out of compute-dtype activations anyway)
        store = self.compute_dtype or torch.float32

        masks = [dict() for _ in range(num_levels)]
        masks_passed = [dict() for _ in range(num_levels)]
        masks_failed = [dict() for _ in range(num_levels)]
        content_targets = [dict() for _ in range(num_levels)]
        factors = [dict() for _ in range(num_levels)]
        gram_masks = [dict() for _ in range(num_levels)]
        gram_counts = [dict() for _ in range(num_levels)]
        use_fused = self.compute_dtype == torch.bfloat16
        live = [i for i in range(num_levels) if i not in self.skip_levels]

        for i in live:
            mask = pyramid_masks[i].float()
            hw = tuple(mask.shape[1:3])
            passed = (resize_bilinear(angle_degrees.float(), hw)
                      < self.angle_threshold).float()
            by_hw = {}
            gm_by_hw = {}
            for k in self.layers:
                fhw = self._layer_hw(k, hw)
                if fhw not in by_hw:  # r41/r42 share a resolution
                    m = resize_nearest(mask, fhw)
                    by_hw[fhw] = (
                        m.to(store),
                        resize_nearest(mask * passed, fhw).to(store),
                        resize_nearest(mask * (1.0 - passed), fhw).to(store),
                        m.reshape(v, -1).mean(dim=1),
                    )
                m, mp, mf, f = by_hw[fhw]
                masks[i][k] = m
                masks_passed[i][k] = mp
                masks_failed[i][k] = mf
                factors[i][k] = f  # [V]
                if k in self.content_layers:
                    content_targets[i][k] = resize_bilinear(
                        content_encs[k].float(), fhw).to(store)
                if (use_fused and k in self.style_layers
                        and fhw[0] * fhw[1] >= gram_kernels.MIN_PX):
                    if fhw not in gm_by_hw:
                        if self.style_pyramid_mode == "multi":
                            stack = torch.stack([mp[..., 0], mf[..., 0]])
                        else:
                            stack = torch.stack([m[..., 0]])
                        gm_by_hw[fhw] = (
                            gram_kernels.stack_masks(stack),
                            stack.float().reshape(stack.shape[0], v, -1).sum(dim=2),
                        )
                    gram_masks[i][k], gram_counts[i][k] = gm_by_hw[fhw]

        # normalize factors across levels per layer, guarded against
        # all-empty layers
        for k in self.layers:
            total = sum(factors[i][k] for i in live)
            safe = torch.where(total > 0, total, torch.ones_like(total))
            for i in live:
                factors[i][k] = torch.where(total > 0, factors[i][k] / safe,
                                            torch.zeros_like(total))

        return dict(masks=masks, masks_passed=masks_passed,
                    masks_failed=masks_failed,
                    content_targets=content_targets, factors=factors,
                    gram_masks=gram_masks, gram_counts=gram_counts)

    def __call__(self, vgg_params, style_targets: StyleTargets,
                 pred_pyramid: Sequence[torch.Tensor],
                 target_content: torch.Tensor,
                 pyramid_masks: Sequence[torch.Tensor],
                 angle_degrees: torch.Tensor, aux=None,
                 gram_cache: Optional[GramCache] = None):
        """Compute (style_loss, content_loss, new_gram_cache): the losses
        are scalar means over the views; the cache is ``gram_cache`` walked
        through this batch under ``gram_mode='average'`` and ``gram_cache``
        itself otherwise.

        Args:
            pred_pyramid: per level ``[V, H_i, W_i, 3]`` sampled textures,
                None for a level of ``skip_levels``.
            target_content: ``[V, H, W, 3]`` Gatys-preprocessed photo.
            pyramid_masks: per level ``[V, H_i, W_i, 1]`` 0/1 float.
            angle_degrees: ``[V, H, W, 1]`` viewing angle in degrees.
            aux: optional :meth:`precompute_aux` result.
            gram_cache: required under ``gram_mode='average'``.
        """
        num_levels = len(pred_pyramid)
        v = target_content.shape[0]
        live = [i for i in range(num_levels)
                if i not in self.skip_levels and pred_pyramid[i] is not None]
        if aux is None:
            aux = self.precompute_aux(
                vgg_params, [tuple(m.shape[1:3]) for m in pyramid_masks],
                target_content, pyramid_masks, angle_degrees)
        masks = aux["masks"]
        masks_failed = aux["masks_failed"]
        factors = aux["factors"]
        device = target_content.device
        style_loss = torch.zeros((), dtype=torch.float32, device=device)
        content_loss = torch.zeros((), dtype=torch.float32, device=device)

        def encode(p):
            return self._encode(vgg_params, p, self.layers)

        # per live level: the prediction's Grams (the bad-angle ones under
        # the multi mode) and the content loss
        grams, failed_grams = {}, {}
        for i in live:
            p = pred_pyramid[i]
            if self.remat and p.shape[1] * p.shape[2] >= self.remat_min_px:
                # the encode draws no random numbers: no generator state to
                # stash (reading it is refused inside a CUDA graph capture)
                encs = checkpoint(encode, p, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                encs = encode(p)
            grams[i], failed_grams[i] = {}, {}
            for k in self.style_layers:
                if k in aux["gram_masks"][i]:
                    sums = gram_kernels.fused_masked_grams(
                        encs[k], aux["gram_masks"][i][k])  # [V, K, C, C]
                    counts = aux["gram_counts"][i][k]  # [K, V]
                    denom = torch.where(counts > 0, counts,
                                        torch.ones_like(counts))
                    grams[i][k] = sums[:, 0] / denom[0][:, None, None]
                    if self.style_pyramid_mode == "multi":
                        failed_grams[i][k] = sums[:, 1] / denom[1][:, None, None]
                else:
                    m = (aux["masks_passed"][i][k]
                         if self.style_pyramid_mode == "multi"
                         else masks[i][k])
                    grams[i][k] = masked_gram(encs[k], m)
                    if self.style_pyramid_mode == "multi":
                        failed_grams[i][k] = masked_gram(encs[k],
                                                         masks_failed[i][k])
            for li, k in enumerate(self.content_layers):
                l = masked_mse(aux["content_targets"][i][k], encs[k],
                               masks[i][k])
                content_loss = content_loss + (
                    self.content_weights[li] * factors[i][k] * l).mean()

        new_cache = gram_cache
        if self.gram_mode == "average":
            if gram_cache is None:
                raise ValueError("gram_mode='average' needs a GramCache")
            grams, new_cache = self._average_walk(grams, gram_cache, live,
                                                  pyramid_masks, v)

        for i in live:
            for li, k in enumerate(self.style_layers):
                w = self.style_weights[li]
                f = factors[i][k]  # [V]
                y_hat = grams[i][k]
                y = (style_targets.grams[k][2]
                     if self.style_pyramid_mode == "multi"
                     else style_targets.grams[k][0])
                l = w * f * _mse_gram(y, y_hat)  # [V]
                if self.style_pyramid_mode == "multi":
                    # bad-angle areas are stylized only with the larger style
                    # image, active only when non-empty
                    has_failed = (masks_failed[i][k].reshape(v, -1).sum(dim=1)
                                  > 0).float()
                    l = l + w * f * has_failed * _mse_gram(
                        y, failed_grams[i][k])
                    if li > 2:
                        l = l + w * f * _mse_gram(style_targets.grams[k][0],
                                                  y_hat)
                style_loss = style_loss + l.mean()

        return style_loss, content_loss, new_cache

    def _average_walk(self, grams, cache: GramCache, live, pyramid_masks, v):
        """The view-outer cache walk of ``gram_mode='average'``: view ``vi``
        at (level, layer) mixes its current Gram with the detached history,
        which holds the pushes of earlier views and of view ``vi``'s earlier
        levels. Returns the mixed Grams and the walked cache."""
        nonempty = {i: pyramid_masks[i].float().reshape(v, -1).sum(dim=1) > 0
                    for i in live}
        slot = torch.arange(GRAM_CACHE_DEPTH,
                            device=cache.count.device)[:, None, None]
        cache_grams = dict(cache.grams)
        count = cache.count
        mixed = {i: {k: [] for k in self.style_layers} for i in live}
        push_flags, push_grams = [], {k: [] for k in self.style_layers}
        for vi in range(v):
            for i in live:
                ne = nonempty[i][vi]
                push_flags.append(ne)
                n_detached = torch.clamp(count, max=GRAM_CACHE_DEPTH - 1)
                denom = (n_detached + 1).float()
                for k in self.style_layers:
                    cache_k = cache_grams[k]
                    detached_sum = torch.where(
                        slot < n_detached, cache_k,
                        torch.zeros((), device=cache_k.device)).sum(dim=0)
                    cur = grams[i][k][vi]
                    mixed[i][k].append((cur + detached_sum) / denom)
                    cur_det = cur.detach().float()
                    push_grams[k].append(cur_det)
                    cache_grams[k] = torch.where(ne, _push(cache_k, cur_det),
                                                 cache_k)
                count = torch.where(
                    ne, torch.clamp(count + 1, max=GRAM_CACHE_DEPTH), count)
        mixed = {i: {k: torch.stack(g, dim=0) for k, g in per.items()}
                 for i, per in mixed.items()}
        push_log = None
        if self.collect_push_log and push_flags:
            push_log = ({k: torch.stack(g) for k, g in push_grams.items()},
                        torch.stack(push_flags))
        return mixed, GramCache(grams=cache_grams, count=count,
                                push_log=push_log)
