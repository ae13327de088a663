"""Learnable texture atlases (counterpart of ``stylemesh_tpu/models/texture.py``).

A Laplacian pyramid of channel-last ``[H / 2**i, W / 2**i, 3]`` float32
layers, sampled at the same UV grid per layer and summed. The atlas lives in
Gatys-preprocessed space and is clamped to ``[GATYS_MIN, GATYS_MAX]`` after
every optimizer update (the reference clamps in place before every forward,
so the forward always sees clamped values either way).
"""

import torch
from torch import nn

from stylemesh_tpu_torch import resolve_device
from stylemesh_tpu_torch.ops.color import GATYS_MAX, GATYS_MIN
from stylemesh_tpu_torch.ops.grid_sample import sample_levels


class Texture(nn.Module):
    """A (possibly hierarchical) texture atlas: ``layers[i]`` is a parameter
    of shape ``[H // 2**i, W // 2**i, C]``."""

    def __init__(self, layers):
        super().__init__()
        h, w, c = layers[0].shape
        for i, layer in enumerate(layers):
            if tuple(layer.shape) != (h // 2 ** i, w // 2 ** i, c):
                raise ValueError(f"layer {i} has shape {tuple(layer.shape)}")
        self.layers = nn.ParameterList([nn.Parameter(l) for l in layers])

    @property
    def shape(self):
        return tuple(self.layers[0].shape)

    @staticmethod
    def create(width, height, channels=3, num_layers=1, random_init=False,
               generator=None, dtype=torch.float32, device=None):
        """Zero layers, or uniform [0, 1) ones drawn from ``generator``."""
        device = resolve_device(device)
        layers = []
        for i in range(num_layers):
            shape = (height // 2 ** i, width // 2 ** i, channels)
            if random_init:
                layers.append(torch.rand(shape, generator=generator,
                                         dtype=dtype).to(device))
            else:
                layers.append(torch.zeros(shape, dtype=dtype, device=device))
        return Texture(layers)

    @staticmethod
    def from_arrays(arrays, device=None):
        """Layers copied from ``arrays`` (the optimizer updates them in
        place, so they never share memory with the caller's arrays)."""
        device = resolve_device(device)
        return Texture([torch.tensor(a, dtype=torch.float32, device=device)
                        for a in arrays])


@torch.no_grad()
def clamp_texture(texture: Texture) -> Texture:
    """Clamp every layer to the valid Gatys pixel range, in place."""
    for layer in texture.layers:
        layer.clamp_(GATYS_MIN, GATYS_MAX)
    return texture


def sample_texture(texture: Texture, grids, compute="f32"):
    """For each grid ``[..., 2]`` of the list ``grids`` (a step's UV pyramid
    levels), all layers sampled at it and summed: one render per grid. On
    the card one K1 launch renders all grids and one K2 launch splats all
    their gradients in the backward. ``compute``: ``"f32"`` (exact) or
    ``"bf16"``, the kernels' bf16 mode (``ops/grid_sample.py``)."""
    return sample_levels(list(texture.layers), list(grids), compute)


def texture_regularizer(texture: Texture, weights):
    """Weighted L2 on the pyramid layers: ``sum_i w_i * mean(layer_i**2)``."""
    reg = 0.0
    for w, layer in zip(weights, texture.layers):
        reg = reg + torch.mean(torch.square(layer.float())) * w
    return reg


def texture_grads(total, layers):
    """The gradient of the step's loss ``total`` for each texture layer;
    zeros for a layer the loss does not reach (every live level detached,
    and the regularizer's gradient folded into the update)."""
    if not total.requires_grad:
        return [torch.zeros_like(l) for l in layers]
    grads = torch.autograd.grad(total, layers, allow_unused=True)
    return [torch.zeros_like(l) if g is None else g
            for g, l in zip(grads, layers)]


def texture_image(texture: Texture):
    """Compose the pyramid into a full-resolution ``[H, W, C]`` image: every
    layer sampled at the identity grid over [-1, 1]² and summed."""
    h, w, _ = texture.shape
    device = texture.layers[0].device
    xs = torch.linspace(-1.0, 1.0, w, device=device)
    ys = torch.linspace(-1.0, 1.0, h, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return sample_texture(texture, [torch.stack([gx, gy], dim=-1)])[0]
