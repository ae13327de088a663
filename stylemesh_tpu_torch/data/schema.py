"""The per-view training batch (counterpart of ``stylemesh_tpu/data/schema.py``).

Same fields and layouts as the JAX ``ViewBatch``, as torch tensors (or numpy
arrays before :func:`to_device`). ``splat_plans`` is not carried: the Hopper
gather/splat kernels sample straight from the atlas and take no plans.
"""

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from stylemesh_tpu_torch.utils.profiling import count, span


class ViewBatch(NamedTuple):
    """A batch of V posed views of one scene.

    - ``rgb``: ``[V, H, W, 3]`` Gatys-preprocessed photo (content target).
    - ``uv``: per level ``[V, H_i, W_i, 2]`` sampling grid, (x, y) in [-1, 1].
    - ``mask``: ``[V, H, W, 1]`` float 0/1 — valid UV and valid depth.
    - ``depth``: ``[V, H, W, 1]`` metric depth.
    - ``rounded_depth_level`` / ``other_depth_level``: ``[V, H, W, 1]``
      nearest / second-nearest pyramid level index per pixel (float-valued).
    - ``depth_level_weight``: ``[V, H, W, 1]`` weight toward the nearest level.
    - ``angle_guidance``: ``[V, H, W, 1]`` cos(viewing angle) in [0, 1].
    - ``angle_degrees``: ``[V, H, W, 1]`` viewing angle in degrees.
    - ``extrinsics`` / ``intrinsics``: ``[V, 4, 4]``.
    - ``idx``: ``[V]`` int32 dataset indices.
    - ``depth_level``: optional ``[V, H, W, 1]`` continuous level (logging).
    """

    rgb: torch.Tensor
    uv: Tuple[torch.Tensor, ...]
    mask: torch.Tensor
    depth: torch.Tensor
    rounded_depth_level: torch.Tensor
    other_depth_level: torch.Tensor
    depth_level_weight: torch.Tensor
    angle_guidance: torch.Tensor
    angle_degrees: torch.Tensor
    extrinsics: torch.Tensor
    intrinsics: torch.Tensor
    idx: torch.Tensor
    depth_level: Optional[torch.Tensor] = None

    @property
    def num_views(self):
        return self.rgb.shape[0]


def to_device(batch: ViewBatch, device) -> ViewBatch:
    """Every field as a contiguous tensor on ``device`` (tensors or any
    array-like, such as numpy arrays, in). Counts the bytes it copies from
    host memory to another device under ``h2d_bytes``."""
    to_host = torch.device(device).type == "cpu"

    def move(x):
        if x is None:
            return None
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.array(x))
        if x.device.type == "cpu" and not to_host:
            count("h2d_bytes", x.nbytes)
        return x.to(device).contiguous()

    with span("to_device"):
        return ViewBatch(*[
            tuple(move(x) for x in f) if isinstance(f, tuple) else move(f)
            for f in batch
        ])
