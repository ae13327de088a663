"""conv1_1 (3 input channels), the VGG trunk's stem (counterpart of
``stylemesh_tpu/ops/conv_im2col.py``).

    y = bf16(act(conv3x3(x, w9) + bias)),   act = relu or identity

``x`` is bf16 ``[V, H, W, 3]``, ``w9`` the bf16 ``[27, 64]`` kernel matrix
in (dy, dx, ci) row order, ``bias`` float32 ``[64]`` or None: bf16 values,
float32 products and sums, the float32 bias, relu, one rounding to bf16.
The backward masks the cotangent by ``y > 0`` (with relu) and sums its
products with the kernel over the nine taps and 64 channels in float32,
rounded once. The VGG is frozen: the weight and bias get no gradient.

A 3-channel input is too narrow for K5's 64-channel K steps. CUDA tensors
launch two hand-written kernels (``kernels/csrc/conv_stem.cu``), one each
way: :func:`stem_forward` and :func:`stem_backward`. CPU tensors take the
plain versions, the JAX package's explicit im2col
(:func:`stem_forward_plain`: the nine shifted copies stacked into
``[V, H, W, 27]`` and contracted with the kernel matrix in one
``torch.matmul``; :func:`stem_backward_plain`: the masked cotangent times
the kernel matrix, its 27 columns folded back with nine shifted adds).
"""

import torch
import torch.nn.functional as F

from stylemesh_tpu_torch import kernels

CIN, COUT = 3, 64  # the only channel counts the kernels take


def _im2col(x):
    """``[V, H, W, C]`` -> ``[V, H, W, 9C]`` SAME-padded taps in (dy, dx, ci)
    order, matching the rows of ``ops/conv_kernels.py::w9_from_oihw``."""
    h, w = x.shape[1:3]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.cat([xp[:, dy:dy + h, dx:dx + w]
                      for dy in range(3) for dx in range(3)], dim=-1)


def stem_forward_plain(x, w9, bias=None, relu=True):
    """Plain version of :func:`stem_forward`, the explicit im2col product:
    ``bf16(act(im2col(x) @ w9 + bias))`` in float32 (any C)."""
    y = torch.matmul(_im2col(x.float()), w9.float())
    if bias is not None:
        y = y + bias.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def stem_backward_plain(g, y, w9, relu=True):
    """Plain version of :func:`stem_backward`: the cotangent masked by
    ``y > 0`` (with relu) times the kernel matrix in float32, its 9C
    columns folded back by nine shifted float32 adds, rounded once."""
    if relu:
        g = torch.where(y > 0, g, torch.zeros((), dtype=g.dtype,
                                              device=g.device))
    v, h, w, _ = y.shape
    c = w9.shape[0] // 9
    dxc = torch.matmul(g.float(), w9.float().t())  # [V, H, W, 9C]
    dxp = torch.zeros((v, h + 2, w + 2, c), dtype=torch.float32,
                      device=g.device)
    for t in range(9):
        dy, dx = divmod(t, 3)
        dxp[:, dy:dy + h, dx:dx + w] += dxc[..., t * c:(t + 1) * c]
    return dxp[:, 1:1 + h, 1:1 + w].to(y.dtype)


class _Im2colConv(torch.autograd.Function):
    """The plain version's autograd, for CPU tensors: only ``y`` is
    saved."""

    @staticmethod
    def forward(ctx, x, w9, bias, relu):
        y = stem_forward_plain(x, w9, bias, relu)
        ctx.save_for_backward(y, w9)
        ctx.relu = relu
        return y

    @staticmethod
    def backward(ctx, g):
        y, w9 = ctx.saved_tensors
        return stem_backward_plain(g, y, w9, ctx.relu), None, None, None


def _check_map(name, t, channels):
    if t.dim() != 4 or t.shape[-1] != channels:
        raise ValueError(f"{name} {tuple(t.shape)}: expected [V, H, W, "
                         f"{channels}]")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: expected torch.bfloat16, got {t.dtype}")


def _check_w9(w9):
    if tuple(w9.shape) != (9 * CIN, COUT):
        raise ValueError(f"w9 {tuple(w9.shape)}: expected ({9 * CIN}, {COUT})")
    if w9.dtype != torch.bfloat16:
        raise TypeError(f"w9: expected torch.bfloat16, got {w9.dtype}")


def check_stem(x, w9, bias):
    """Raise unless ``x``, ``w9`` and ``bias`` are inputs the forward kernel
    takes: ``x`` bf16 ``[V, H, W, 3]``, ``w9`` bf16 ``[27, 64]``, ``bias``
    float32 ``[64]`` or None (``ValueError`` for a shape or channel count,
    ``TypeError`` for a dtype), all contiguous CUDA tensors on one device
    (``kernels.require_cuda``)."""
    _check_map("x", x, CIN)
    _check_w9(w9)
    if bias is not None:
        if tuple(bias.shape) != (COUT,):
            raise ValueError(f"bias {tuple(bias.shape)}: expected ({COUT},)")
        if bias.dtype != torch.float32:
            raise TypeError(f"bias: expected torch.float32, got {bias.dtype}")
    kernels.require_cuda(x, w9, *([] if bias is None else [bias]))


def check_stem_grad(g, y, w9):
    """Raise unless ``g``, ``y`` and ``w9`` are inputs the input-gradient
    kernel takes: ``g`` and ``y`` bf16 ``[V, H, W, 64]`` of one shape,
    ``w9`` as :func:`check_stem`'s, all contiguous CUDA tensors on one
    device."""
    _check_map("g", g, COUT)
    _check_map("y", y, COUT)
    if g.shape != y.shape:
        raise ValueError(f"g {tuple(g.shape)} vs y {tuple(y.shape)}")
    _check_w9(w9)
    kernels.require_cuda(g, y, w9)


def stem_forward(x, w9, bias=None, relu=True):
    """The forward kernel: ``bf16(act(conv3x3(x, w9) + bias))``
    ``[V, H, W, 64]``, one launch."""
    check_stem(x, w9, bias)
    v, h, w, _ = x.shape
    y = torch.empty((v, h, w, COUT), dtype=torch.bfloat16, device=x.device)
    kernels.launch("stylemesh_stem_fwd", x.device, x.data_ptr(), w9.data_ptr(),
                   None if bias is None else bias.data_ptr(), y.data_ptr(),
                   v, h, w, int(relu))
    stem_forward.launches += 1
    return y


stem_forward.launches = 0


def stem_backward(g, y, w9, relu=True):
    """The input-gradient kernel: ``dx = bf16(sum over taps and channels of
    [y > 0] g w9)`` ``[V, H, W, 3]`` (no mask without relu), one launch."""
    check_stem_grad(g, y, w9)
    v, h, w, _ = g.shape
    dx = torch.empty((v, h, w, CIN), dtype=torch.bfloat16, device=g.device)
    kernels.launch("stylemesh_stem_bwd", g.device, g.data_ptr(), y.data_ptr(),
                   w9.data_ptr(), dx.data_ptr(), v, h, w, int(relu))
    stem_backward.launches += 1
    return dx


stem_backward.launches = 0


class _StemConv(torch.autograd.Function):
    """The kernels' autograd: only ``y`` is saved (the relu mask is
    ``y > 0``)."""

    @staticmethod
    def forward(ctx, x, w9, bias, relu):
        y = stem_forward(x, w9, bias, relu)
        ctx.save_for_backward(y, w9)
        ctx.relu = relu
        return y

    @staticmethod
    def backward(ctx, g):
        y, w9 = ctx.saved_tensors
        return stem_backward(g.contiguous(), y, w9, ctx.relu), None, None, None


def conv3x3_im2col(x, w9, bias, relu=True):
    """3x3 SAME conv of ``x [V, H, W, C]`` with ``w9 [9C, Cout]`` (+ bias,
    optional relu). CPU tensors take the plain im2col version (any C);
    CUDA tensors launch the stem kernels (C = 3, Cout = 64) or raise."""
    if x.device.type == "cpu":
        return _Im2colConv.apply(x, w9, bias, relu)
    return _StemConv.apply(x, w9, bias, relu)
