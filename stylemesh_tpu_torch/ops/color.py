"""Gatys-style RGB pre/post color transforms (counterpart of
``stylemesh_tpu/ops/color.py``).

The VGG was trained on BGR images with the ImageNet mean subtracted and
values scaled to 0..255. Images are channel-last ``[..., H, W, 3]``.
"""

import torch

# ImageNet mean in BGR order (applied after the RGB->BGR flip), 0..1 range.
_IMAGENET_MEAN_BGR = (0.40760392, 0.45795686, 0.48501961)

# Valid range of a Gatys-preprocessed pixel: pre(0) and pre(1). The texture
# atlas is clamped to it after every optimizer update.
GATYS_MIN = -123.6800
GATYS_MAX = 151.0610


def gatys_pre(rgb):
    """RGB [0,1] -> Gatys VGG input: BGR, mean-subtracted, scaled by 255."""
    bgr = rgb.flip(-1)
    mean = torch.tensor(_IMAGENET_MEAN_BGR, dtype=bgr.dtype, device=bgr.device)
    return (bgr - mean) * 255.0


def gatys_post(x):
    """Inverse of :func:`gatys_pre`: Gatys VGG input -> RGB in [0,1] (clamped)."""
    mean = torch.tensor(_IMAGENET_MEAN_BGR, dtype=x.dtype, device=x.device)
    bgr = x / 255.0 + mean
    return torch.clamp(bgr.flip(-1), 0.0, 1.0)
