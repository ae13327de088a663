"""Checkpoints and texture exports (counterpart of
``stylemesh_tpu/utils/checkpoint.py``).

- The train state (texture layers, Adam moments, step and, under
  ``gram_mode='average'``, the Gram cache) is written with ``torch.save``
  and read with ``torch.load(weights_only=True)``, where the JAX package
  uses orbax. Restoring copies into an existing state, on its device.
- Texture exports use the JAX package's file names and formats: raw layers
  as ``.npz`` (``layer_<i>``), the composited full-resolution image as
  ``<prefix>texture.jpg`` and per-layer images as
  ``<prefix>_layer<i>_texture.jpg``, RGB after the Gatys post transform.
"""

import os
from os.path import join

import numpy as np
import torch

from stylemesh_tpu_torch.models.texture import Texture, texture_image
from stylemesh_tpu_torch.ops.color import gatys_post

STATE_FILE = "train_state.pt"


def save_train_state(state, path):
    """Write ``state`` (``models.pipeline.TrainState``) to
    ``<path>/train_state.pt``."""
    os.makedirs(path, exist_ok=True)
    blob = {"layers": [l.detach().cpu() for l in state.texture.layers],
            "mu": [m.cpu() for m in state.mu],
            "nu": [n.cpu() for n in state.nu],
            "step": int(state.step)}
    if state.gram_cache is not None:
        blob["gram_cache"] = {
            "grams": {k: g.cpu() for k, g in state.gram_cache.grams.items()},
            "count": int(state.gram_cache.count)}
    tmp = join(path, STATE_FILE + ".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, join(path, STATE_FILE))


@torch.no_grad()
def restore_train_state(template_state, path):
    """Copy the state saved under ``path`` into ``template_state`` (same
    layer shapes), in place on its device; returns it."""
    blob = torch.load(join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)
    targets = (list(template_state.texture.layers), template_state.mu,
               template_state.nu)
    for dst, src in zip(targets, (blob["layers"], blob["mu"], blob["nu"])):
        if [tuple(t.shape) for t in dst] != [tuple(t.shape) for t in src]:
            raise ValueError(f"{path}: saved shapes {[tuple(t.shape) for t in src]} "
                             f"vs {[tuple(t.shape) for t in dst]}")
        for d, s in zip(dst, src):
            d.copy_(s)
    template_state.step = int(blob["step"])
    cache = template_state.gram_cache
    if (cache is None) != ("gram_cache" not in blob):
        raise ValueError(f"{path}: the saved state and the template differ "
                         "in having a Gram cache (gram_mode)")
    if cache is not None:
        saved = blob["gram_cache"]
        for k, g in cache.grams.items():
            g.copy_(saved["grams"][k])
        cache.count.fill_(saved["count"])
    return template_state


def save_texture_npz(texture: Texture, path):
    """Raw texture layers (the reference's .pt equivalent)."""
    np.savez(path, **{f"layer_{i}": l.detach().cpu().numpy()
                      for i, l in enumerate(texture.layers)})


def load_texture_npz(path, device=None) -> Texture:
    data = np.load(path)
    layers = [data[f"layer_{i}"] for i in range(len(data.files))]
    return Texture.from_arrays(layers, device=device)


def _to_pil(img_hwc3):
    from PIL import Image

    arr = np.clip(img_hwc3.detach().cpu().numpy(), 0.0, 1.0)
    return Image.fromarray((arr * 255.0 + 0.5).astype(np.uint8))


@torch.no_grad()
def save_texture_image(texture: Texture, directory, prefix=""):
    """Composite full-res texture -> ``<prefix>texture.jpg`` in RGB."""
    img = gatys_post(texture_image(texture))
    path = join(directory, f"{prefix}texture.jpg")
    _to_pil(img).save(path)
    return path


@torch.no_grad()
def save_texture_layers(texture: Texture, directory, prefix=""):
    """Per-layer images (the reference's save_layers naming)."""
    paths = []
    for i, layer in enumerate(texture.layers):
        img = gatys_post(layer)
        path = join(directory, f"{prefix}_layer{i}_texture.jpg")
        _to_pil(img).save(path)
        paths.append(path)
    return paths
