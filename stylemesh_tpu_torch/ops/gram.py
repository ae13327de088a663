"""Gram matrices over VGG feature maps, with masked variants (counterpart of
``stylemesh_tpu/ops/gram.py``).

The masked Gram is the mask-weighted form ``G = (F*m)^T (F*m) / sum(m)``,
identical to gathering the masked pixels for a 0/1 mask. Features are
channel-last ``[B, H, W, C]``; Grams are ``[B, C, C]`` float32.

bf16 features are multiplied as float32: a bf16 x bf16 product is exact in
float32, so this is the same function as a bf16 matmul with a float32
accumulator (the JAX package's ``preferred_element_type=float32``). On the
card, float32 matmuls run in full float32 (TF32 is off for matmuls by
default in PyTorch).
"""

import torch


def _gram_sums(f):
    """``[B, P, C]`` -> ``[B, C, C]`` float32 raw sums ``f^T f``."""
    f = f.float()
    return torch.bmm(f.transpose(1, 2), f)


def gram_matrix(features):
    """``[B, H, W, C] -> [B, C, C]`` float32, divided by the pixel count."""
    b, h, w, c = features.shape
    return _gram_sums(features.reshape(b, h * w, c)) / (h * w)


def masked_gram(features, mask):
    """Gram over the masked pixels only, divided by the per-item mask count.

    ``features``: ``[B, H, W, C]``; ``mask``: ``[B, H, W, 1]`` 0/1. Returns
    ``[B, C, C]`` float32, all zeros for an empty mask.
    """
    b, h, w, c = features.shape
    m = mask.to(features.dtype)
    g = _gram_sums((features * m).reshape(b, h * w, c))
    count = m.float().reshape(b, -1).sum(dim=1)
    denom = torch.where(count > 0, count, torch.ones_like(count))
    return g / denom[:, None, None]


def masked_mse(a, b, mask):
    """MSE over the masked pixels of two ``[B, H, W, C]`` maps, per item
    (the mean over ``C * N_selected`` elements; 0 for an empty mask)."""
    bsz, h, w, c = a.shape
    m = mask.float()
    d = (a.float() - b.float()) ** 2 * m
    num = d.reshape(bsz, -1).sum(dim=1)
    count = m.reshape(bsz, -1).sum(dim=1) * c
    return torch.where(count > 0, num / torch.clamp(count, min=1.0),
                       torch.zeros_like(num))


def mse(a, b):
    """Plain MSE over all elements, per batch item. Returns ``[B]``."""
    d = (a.float() - b.float()) ** 2
    return d.reshape(d.shape[0], -1).mean(dim=1)
