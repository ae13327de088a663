"""Fused multi-mask Gram sums and their gradient (counterpart of
``stylemesh_tpu/ops/gram_pallas.py``).

The style loss needs, per (pyramid level, VGG layer), up to two masked Grams
over the same feature map: the angle-passed and the angle-failed pixels.
:func:`fused_masked_grams` computes all of them from one read of the
features with kernel K3 (:func:`masked_gram_sums`), and its gradient with
K4 (:func:`masked_gram_sums_grad`):

    G[v, k]  = sum_p m[v, k, p] * f[v, p]^T f[v, p]              (raw sums)
    dF[v, p] = sum_k m[v, k, p] * (S[v, k] f[v, p]),  S = bf16(dG + dG^T)

bf16 features and 0/1 masks, float32 accumulation, float32 Grams and a bf16
gradient, as the TPU kernels. The JAX module pads P and C for the TPU; the
port takes the unpadded ``[V, P, C]`` features and ``[V, K, P]`` masks.
The caller divides by the mask counts.
"""

import torch

from stylemesh_tpu_torch import kernels

# Style layers below this pixel count stay on the plain einsum (their Gram
# is cheap), as in the JAX package. Read at call time, so tests may lower it.
MIN_PX = 50000

_TILE = 64    # kTile in kernels/csrc/gram.cu: C must be a multiple
_FWD_PX = 32  # kFwdPx: pixels per K3 step; a block's range is a multiple
_FWD_BLOCKS_PER_SM = 8  # K3 splits the pixels into about this many blocks per SM


def stack_masks(masks):
    """``[K, V, H, W]`` (or ``[K, V, P]``) 0/1 masks -> ``[V, K, P]`` bf16."""
    k, v = masks.shape[:2]
    return masks.reshape(k, v, -1).to(torch.bfloat16).transpose(0, 1).contiguous()


def masked_gram_sums_plain(f, masks):
    """Plain version of K3: ``[V, P, C]``, ``[V, K, P]`` -> ``[V, K, C, C]``
    float32 (bf16 products are exact in float32)."""
    fm = (f[:, None] * masks[..., None].to(f.dtype)).float()  # [V, K, P, C]
    return torch.einsum("vkpc,vpd->vkcd", fm, f.float())


def masked_gram_sums_grad_plain(f, masks, s):
    """Plain version of K4: ``dF = sum_k m_k * (S_k f)``, bf16 ``[V, P, C]``."""
    fs = torch.einsum("vkcd,vpd->vkpc", s.to(torch.bfloat16).float(), f.float())
    return (fs * masks[..., None].float()).sum(dim=1).to(torch.bfloat16)


def _check_gram(f, masks):
    v, p, c = f.shape
    if c % _TILE:
        raise ValueError(f"C must be a multiple of {_TILE}, got {c}")
    if masks.shape[0] != v or masks.shape[2] != p or masks.shape[1] not in (1, 2):
        raise ValueError(f"masks {tuple(masks.shape)} vs features {tuple(f.shape)}")
    kernels.require_cuda(f, masks, dtype=torch.bfloat16)


def masked_gram_sums(f, masks):
    """K3: raw masked Gram sums ``[V, K, C, C]`` float32 of bf16 ``f [V, P, C]``
    under 0/1 bf16 ``masks [V, K, P]``. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise. Equal to the plain version up to
    the order of the float32 sums."""
    if f.device.type == "cpu":
        return masked_gram_sums_plain(f, masks)
    _check_gram(f, masks)
    v, p, c = f.shape
    k = masks.shape[1]
    out = torch.zeros((v, k, c, c), dtype=torch.float32, device=f.device)
    sms = torch.cuda.get_device_properties(f.device).multi_processor_count
    splits = max(1, _FWD_BLOCKS_PER_SM * sms // (v * (c // _TILE) ** 2))
    px_per_block = -(-p // splits)
    px_per_block = -(-px_per_block // _FWD_PX) * _FWD_PX
    kernels.launch("stylemesh_gram_fwd", f.device, f.data_ptr(),
                   masks.data_ptr(), out.data_ptr(), v, k, p, c, px_per_block)
    masked_gram_sums.launches += 1
    return out


masked_gram_sums.launches = 0


def masked_gram_sums_grad(f, masks, s):
    """K4: ``dF [V, P, C]`` bf16 for symmetric ``s = dG + dG^T [V, K, C, C]``
    (cast to bf16 first, as the TPU kernel does). CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if f.device.type == "cpu":
        return masked_gram_sums_grad_plain(f, masks, s)
    s = s.to(torch.bfloat16).contiguous()
    _check_gram(f, masks)
    kernels.require_cuda(s, dtype=torch.bfloat16)
    v, p, c = f.shape
    k = masks.shape[1]
    if s.shape != (v, k, c, c):
        raise ValueError(f"s {tuple(s.shape)} vs ({v}, {k}, {c}, {c})")
    df = torch.empty_like(f)
    kernels.launch("stylemesh_gram_bwd", f.device, f.data_ptr(),
                   masks.data_ptr(), s.data_ptr(), df.data_ptr(), v, k, p, c)
    masked_gram_sums_grad.launches += 1
    return df


masked_gram_sums_grad.launches = 0


class _MaskedGramSums(torch.autograd.Function):
    """K3 forward, K4 backward; the masks are batch constants (no gradient)."""

    @staticmethod
    def forward(ctx, f, masks):
        ctx.save_for_backward(f, masks)
        return masked_gram_sums(f, masks)

    @staticmethod
    def backward(ctx, dg):
        f, masks = ctx.saved_tensors
        s = dg + dg.transpose(-1, -2)
        return masked_gram_sums_grad(f, masks, s), None


def fused_masked_grams(features, masks):
    """``[V, H, W, C]`` features + :func:`stack_masks` masks -> raw Gram sums
    ``[V, K, C, C]`` float32. The features are taken as bf16."""
    v, h, w, c = features.shape
    f = features.reshape(v, h * w, c).to(torch.bfloat16).contiguous()
    return _MaskedGramSums.apply(f, masks.contiguous())
