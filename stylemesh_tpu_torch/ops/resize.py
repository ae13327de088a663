"""Image resizes with torch ``F.interpolate`` semantics (counterpart of
``stylemesh_tpu/ops/resize.py``, which reimplements exactly these).

- bilinear: ``align_corners=False``, no antialias (half-pixel source
  coordinates clamped at 0, upper index clamped to ``in - 1``);
- nearest: source index ``floor(i * in / out)``.

Images are channel-last ``[..., H, W, C]`` with any number of leading dims.
"""

import torch.nn.functional as F


def _channel_last_interpolate(img, size, mode, **kw):
    lead = img.shape[:-3]
    h, w, c = img.shape[-3:]
    x = img.reshape((-1, h, w, c)).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=tuple(size), mode=mode, **kw)
    return y.permute(0, 2, 3, 1).reshape(lead + tuple(size) + (c,))


def resize_bilinear(img, size):
    """Bilinear resize to ``size = (H_out, W_out)``; identity when equal."""
    if tuple(img.shape[-3:-1]) == tuple(size):
        return img
    return _channel_last_interpolate(img, size, "bilinear",
                                     align_corners=False)


def resize_nearest(img, size):
    """Nearest resize (torch floor rule) to ``size``; identity when equal."""
    if tuple(img.shape[-3:-1]) == tuple(size):
        return img
    return _channel_last_interpolate(img, size, "nearest")
