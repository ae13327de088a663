"""The work a step needs, counted from its shapes and masks: the yardstick
of ``mfu`` and of the rooflines. It counts what the algorithm needs,
whatever implements it:

- the VGG-19 trunk: ``2 * 9 * Cin * Cout`` operations a pixel of every
  convolution up to the deepest requested activation, forward, and the same
  again for its input gradient at every level whose gradient is kept; the
  content encode of a chunk's photos, forward only;
- the masked Grams: ``2 * C^2`` operations a live pixel and mask, forward
  (``f f^T``) and backward (``S f``); their bytes are the features of the
  live pixels, the masks and the Gram outputs (forward) and the features of
  the live pixels, the masks, ``S`` and the dense feature gradient
  (backward);
- the render: the bytes of the grids, the rendered pixels, the cotangents
  and the texels the grids touch (read by the gather, added to by the
  splat), in float32. The gradient's zero fill is not counted.

Operations and bytes are per call, so a share of a roofline sums
``max(operations / peak, bytes / bandwidth)`` over the calls.
"""

import numpy as np
import torch

from benchmark.reference.step import (
    TRUNK,
    VGG_CONVS,
    bilinear,
    layer_hw,
    level_masks,
    nearest,
)

CHANNELS = {name: cout for name, _, cout in VGG_CONVS}
LAYER_CHANNELS = {act: CHANNELS[conv] for act, conv in TRUNK if conv}
F32 = 4
BF16 = 2


def trunk_flops(hw, keys):
    """Forward operations of one image of ``hw`` through the trunk up to
    the deepest of ``keys``."""
    last = max(i for i, (n, _) in enumerate(TRUNK) if n in set(keys))
    cin = dict((n, ci) for n, ci, _ in VGG_CONVS)
    h, w = hw
    total = 0
    for name, conv in TRUNK[:last + 1]:
        if conv is None:
            h, w = h // 2, w // 2
        else:
            total += 2 * 9 * cin[conv] * CHANNELS[conv] * h * w
    return total


def host_views(vb):
    """The port's host ``ViewBatch`` (numpy, channel-last) as the
    reference's ``[V, C, H, W]`` CPU tensors."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32)).permute(0, 3, 1, 2)

    return {"mask": t(vb.mask), "rounded": t(vb.rounded_depth_level),
            "other": t(vb.other_depth_level),
            "angle_degrees": t(vb.angle_degrees),
            "uv": [np.asarray(u, np.float32) for u in vb.uv],
            "content_hw": tuple(vb.rgb.shape[1:3])}


class ChunkWork:
    """The work of one chunk's steps (``cfg``: the resolved pipeline
    configuration, a dict)."""

    def __init__(self, views, cfg, texture_shapes):
        self.views = views
        self.cfg = cfg
        self.texture_shapes = texture_shapes
        self.v = views["mask"].shape[0]
        self.shapes = [tuple(u.shape[1:3]) for u in views["uv"]]
        self.live = [i for i in range(len(self.shapes))
                     if i not in cfg["skip_levels"]]
        self.grad = [i for i in self.live if i not in cfg["stop_grad_levels"]]
        self.layers = list(cfg["style_layers"]) + list(cfg["content_layers"])
        self._grams = None
        self._texels = None

    def trunk_step(self):
        """Trunk operations of one train step: forward at every live level,
        input gradients at every level whose gradient is kept."""
        return sum(self.v * trunk_flops(self.shapes[i], self.layers)
                   * (2 if i in self.grad else 1) for i in self.live)

    def trunk_chunk(self):
        """Trunk operations of the chunk's content encode."""
        return self.v * trunk_flops(self.views["content_hw"],
                                    self.cfg["content_layers"])

    def gram_calls(self):
        """``[(operations, bytes)]`` of one step's Gram calls, forward and
        backward, one per (live level, style layer)."""
        if self._grams is None:
            self._grams = self._count_grams()
        return self._grams

    def _count_grams(self):
        cfg = self.cfg
        multi = cfg["style_pyramid_mode"] == "multi"
        masks = level_masks(self.views, self.shapes, cfg["use_depth_scaling"])
        calls = []
        for i in self.live:
            passed = (bilinear(self.views["angle_degrees"], self.shapes[i])
                      < cfg["angle_threshold"]).float()
            for k in cfg["style_layers"]:
                fhw = layer_hw(k, self.shapes[i])
                c = LAYER_CHANNELS[k]
                p = fhw[0] * fhw[1]
                if multi:
                    stack = [nearest(masks[i] * passed, fhw),
                             nearest(masks[i] * (1.0 - passed), fhw)]
                else:
                    stack = [nearest(masks[i], fhw)]
                m = torch.stack([s.reshape(self.v, -1) > 0 for s in stack])
                live = float(m.sum())
                union = float(m.any(dim=0).sum())
                kk = len(stack)
                ops = 2.0 * c * c * live
                masks_b = kk * self.v * p * BF16
                fwd_b = union * c * BF16 + masks_b + kk * self.v * c * c * F32
                calls.append((ops, fwd_b))
                if i in self.grad:
                    bwd_b = (union * c * BF16 + masks_b
                             + kk * self.v * c * c * BF16
                             + self.v * p * c * BF16)
                    calls.append((ops, bwd_b))
        return calls

    def gram_step(self):
        return sum(ops for ops, _ in self.gram_calls())

    def step_flops(self):
        return self.trunk_step() + self.gram_step()

    def touched_texels(self):
        """Distinct texels the bilinear corners of the live levels' grids
        read, summed over the layers."""
        if self._texels is None:
            total = 0
            for h, w in self.texture_shapes:
                seen = np.zeros(h * w, bool)
                for i in self.live:
                    g = self.views["uv"][i].reshape(-1, 2).astype(np.float64)
                    px = np.clip(np.nan_to_num((g[:, 0] + 1) * 0.5 * (w - 1)),
                                 0, w - 1)
                    py = np.clip(np.nan_to_num((g[:, 1] + 1) * 0.5 * (h - 1)),
                                 0, h - 1)
                    x0 = np.floor(px).astype(np.int64)
                    y0 = np.floor(py).astype(np.int64)
                    x1 = np.minimum(x0 + 1, w - 1)
                    y1 = np.minimum(y0 + 1, h - 1)
                    for yy, xx in ((y0, x0), (y0, x1), (y1, x0), (y1, x1)):
                        seen[yy * w + xx] = True
                total += int(seen.sum())
            self._texels = total
        return self._texels

    def render_bytes(self):
        """Bytes of one step's gather (grids, rendered pixels, texels read)
        and splat (grids, cotangents, texels added to)."""
        texel = 3 * F32
        px = sum(self.v * self.shapes[i][0] * self.shapes[i][1]
                 for i in self.live)
        px_grad = sum(self.v * self.shapes[i][0] * self.shapes[i][1]
                      for i in self.grad)
        gather = px * (2 + 3) * F32 + self.touched_texels() * texel
        splat = px_grad * (2 + 3) * F32 + (self.touched_texels() * texel
                                           if self.grad else 0)
        return gather + splat


def bound_s(ops, nbytes, peaks):
    """The least time of a call on the device of ``peaks``."""
    return max(ops / peaks["bf16_flop_per_s"], nbytes / peaks["hbm_bytes_per_s"])
