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

Routing: the bf16 loss sends every style layer here (``MIN_PX = 1``). The
JAX package keeps layers below 50 000 pixels on its einsum because its
kernel pads the pixels to chunks of 4096 and that padding would dominate a
small layer. These kernels pad nothing (TMA's zero fill covers the ragged
edge), and the alternative here, the plain masked Gram, would multiply
bf16 features in float32 on the CUDA cores.
"""

import torch

from stylemesh_tpu_torch import kernels

# Style layers of at least this many pixels go to K3/K4 in the bf16 loss:
# every non-empty one. Read at call time, so tests may change it.
MIN_PX = 1

_TILE = 64     # C must be a multiple (kernels/csrc/gram.cu)
_FWD_PX = 64   # kGramPx: pixels per K3 stage
_FWD_MIN_TILES = 8        # K3: pixel tiles per split at least
_FWD_BLOCKS_PER_SM = 2    # K3 splits the pixels into about this many blocks per SM


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


def fwd_splits(v, p, c, sms):
    """K3's number of pixel ranges: about ``_FWD_BLOCKS_PER_SM`` blocks per
    SM over the ``v`` views and the Gram's upper tile pairs, each range at
    least ``_FWD_MIN_TILES`` pixel tiles."""
    nb = 1 if c % (2 * _TILE) else 2     # 64 x 64 nb output tiles
    groups = c // _TILE // nb
    pairs = nb * groups * (groups + 1) // 2
    tiles = -(-p // _FWD_PX)
    want = -(-_FWD_BLOCKS_PER_SM * sms // (v * pairs))
    return max(1, min(want, tiles // _FWD_MIN_TILES))


def masked_gram_sums(f, masks):
    """K3: raw masked Gram sums ``[V, K, C, C]`` float32 of bf16 ``f [V, P, C]``
    under 0/1 bf16 ``masks [V, K, P]``. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise. Equal to the plain version up to
    the order of the float32 sums; on the card exactly symmetric and the same
    from run to run (partial sums over pixel ranges, reduced in a fixed
    order)."""
    if f.device.type == "cpu":
        return masked_gram_sums_plain(f, masks)
    _check_gram(f, masks)
    v, p, c = f.shape
    k = masks.shape[1]
    out = torch.empty((v, k, c, c), dtype=torch.float32, device=f.device)
    splits = fwd_splits(v, p, c, torch.cuda.get_device_properties(
        f.device).multi_processor_count)
    part = torch.empty((splits * (2 if k == 1 else 1), v, k, c, c),
                       dtype=torch.float32, device=f.device)
    kernels.launch("stylemesh_gram_fwd", f.device, f.data_ptr(),
                   masks.data_ptr(), part.data_ptr(), out.data_ptr(), v, k, p,
                   c, splits)
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
