"""Binary erosion via a box filter (counterpart of ``stylemesh_tpu/ops/erosion.py``).

A ``k x k`` all-ones convolution with zero padding, divided by ``k^2``,
clamped to [0, 1]; a pixel survives only where the response is exactly 1,
so the zero-padded border always erodes.
"""

import torch
import torch.nn.functional as F


def erode(x, kernel_size: int = 3):
    """Erode a ``[..., H, W, 1]`` 0/1 mask with a ``kernel_size``² box:
    returns ``x * (box_mean(x) == 1)``."""
    k = kernel_size
    lead = x.shape[:-3]
    h, w = x.shape[-3], x.shape[-2]
    flat = x.reshape((-1, 1, h, w)).float()
    ones = torch.ones((1, 1, k, k), dtype=flat.dtype, device=flat.device)
    summed = F.conv2d(flat, ones, padding=(k - 1) // 2)
    response = torch.clamp(summed / (k * k), 0.0, 1.0)
    keep = (response == 1.0).to(x.dtype)
    return x * keep.reshape(lead + (h, w, 1))
