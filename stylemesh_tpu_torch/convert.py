"""Builds the port's parameters and batches from the JAX package's, given as
numpy arrays (the port imports nothing of JAX).

- ``vgg_params_from_jax``: ``{conv: {"kernel": HWIO, "bias": [C]}}`` ->
  the port's ``{conv: {"weight": OIHW, "bias": [C]}}``.
- ``texture_from_jax``: ``[H_l, W_l, 3]`` layers -> :class:`Texture`.
- ``batch_from_numpy``: a ``ViewBatch``-shaped tuple of numpy arrays (the JAX
  ``ViewBatch`` fields in order; ``splat_plans`` is dropped) -> the port's
  :class:`ViewBatch` on a device.
- ``train_state_from_numpy``: texture layers, Adam moments and step (a JAX
  ``TrainState``'s ``texture.layers``, ``opt_state[0].mu`` / ``.nu`` and
  ``step``, as numpy) -> the port's :class:`TrainState` on a device.
"""

import numpy as np
import torch

from stylemesh_tpu_torch import resolve_device
from stylemesh_tpu_torch.data.schema import ViewBatch, to_device
from stylemesh_tpu_torch.models.pipeline import TrainState
from stylemesh_tpu_torch.models.texture import Texture
from stylemesh_tpu_torch.models.vgg import _params_from_hwio


def vgg_params_from_jax(params_np, dtype=torch.float32, device=None):
    return _params_from_hwio(
        {name: (np.asarray(p["kernel"]), np.asarray(p["bias"]))
         for name, p in params_np.items()}, dtype, device)


def texture_from_jax(layers_np, device=None):
    return Texture.from_arrays([np.asarray(l, np.float32) for l in layers_np],
                               device=device)


def batch_from_numpy(batch, device=None):
    return to_device(ViewBatch(*[getattr(batch, name)
                                 for name in ViewBatch._fields]),
                     resolve_device(device))



def train_state_from_numpy(layers, mu, nu, step, device=None):
    device = resolve_device(device)

    def tensors(arrays):
        return [torch.as_tensor(np.array(a, np.float32)).to(device)
                for a in arrays]

    return TrainState(texture=Texture.from_arrays(layers, device=device),
                      mu=tensors(mu), nu=tensors(nu), step=int(step))
