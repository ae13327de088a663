"""conv1_1 (3 input channels) as an explicit im2col matrix product
(counterpart of ``stylemesh_tpu/ops/conv_im2col.py``).

A 3-channel input is too narrow for the implicit-GEMM conv kernel's
32-channel steps, so the nine shifted copies are stacked into
``[V, H, W, 27]`` and contracted with the ``[27, Cout]`` kernel matrix in one
``torch.matmul``: bf16 values, float32 products and sums, the float32 bias,
relu, one rounding to bf16. The backward masks the cotangent by ``y > 0``,
multiplies by the kernel matrix and folds the 27 columns back with nine
shifted adds. The VGG is frozen: the weight and bias get no gradient.
"""

import torch
import torch.nn.functional as F


def _im2col(x):
    """``[V, H, W, C]`` -> ``[V, H, W, 9C]`` SAME-padded taps in (dy, dx, ci)
    order, matching the rows of ``ops/conv_kernels.py::w9_from_oihw``."""
    h, w = x.shape[1:3]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.cat([xp[:, dy:dy + h, dx:dx + w]
                      for dy in range(3) for dx in range(3)], dim=-1)


class _Im2colConv(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w9, bias, relu):
        y = torch.matmul(_im2col(x.float()), w9.float())
        if bias is not None:
            y = y + bias.float()
        if relu:
            y = torch.relu(y)
        y = y.to(x.dtype)
        ctx.save_for_backward(y, w9)
        ctx.relu = relu
        return y

    @staticmethod
    def backward(ctx, g):
        y, w9 = ctx.saved_tensors
        if ctx.relu:
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
        return dxp[:, 1:1 + h, 1:1 + w].to(y.dtype), None, None, None


def conv3x3_im2col(x, w9, bias, relu=True):
    """3x3 SAME conv of ``x [V, H, W, C]`` with ``w9 [9C, Cout]`` (+ bias,
    optional relu) through an explicit im2col; for C below 32."""
    return _Im2colConv.apply(x, w9, bias, relu)
