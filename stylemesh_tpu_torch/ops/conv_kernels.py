"""3x3 stride-1 SAME convolution with the bias and relu fused: kernel K5
(counterpart of ``stylemesh_tpu/ops/conv_pallas.py::conv3x3_v2``, which
reaches ``_conv3x3_v2_raw``), and the plain convolution K9 (counterpart of
``conv_pallas.py::conv3x3_mxu`` and its ``conv3x3_frozen`` VJP).

    y = bf16(act(conv3x3(x, w) + b)),   act = relu or identity

``x`` is bf16 ``[V, H, W, Cin]`` channel-last, the kernel the bf16 matrix
``w9 [9 * Cin, Cout]`` whose rows run in (dy, dx, ci) order (an HWIO kernel
reshaped, :func:`w9_from_oihw`), ``b`` float32 ``[Cout]`` or None. The sum
is taken in float32 and rounded to bf16 once, after the bias and the relu,
as the TPU kernel does. The trunk's input gradients are the same function
with the flipped, io-swapped kernel (:func:`flipped_w9_from_oihw`), no bias
and relu off.

K9 computes ``bf16(conv3x3(x, w9))``: bf16 inputs, float32 sums, no bias,
no relu. That is K5 with ``bias=None, relu=False``, so K9 is that entry of
``conv_gemm.cu`` under its own wrapper (:func:`conv3x3_mxu`) and launch
count, bit for bit K5's; :class:`_ConvFrozen` gives it the frozen-VGG VJP
(input gradient = K9 with the flipped kernel, no weight gradient).

:func:`conv3x3_masked` is the input gradient that also finishes the
cotangent of its own input, a relu output ``m`` of the trunk, in the
kernel's epilogue: ``where(m > 0, bf16(conv) + t, 0)`` with ``t`` the loss
tap's cotangent of ``m`` (optional), rounded as the separate passes it
replaces (K5's rounding, the bf16 add, the mask), so equal to them bit for
bit.

The kernel (``kernels/csrc/conv_gemm.cu``) is an implicit GEMM bound by the
H100's tensor cores: two warpgroups issue ``wgmma`` on 128-byte-swizzled
tiles that one producer thread keeps coming by TMA through a ring of
stages. A tile is :func:`tile_pixels` output pixels, a box of
:func:`pixel_box` rows and columns chosen per layer to pad the map least,
times :func:`block_n` output channels; K advances one tap times 64 input
channels at a time, and TMA's zero fill outside the map is the SAME
padding. ``w9`` is read as it is stored; the output is stored by TMA,
clipped at the map's edge. The TPU kernels' width packing of narrow
channel counts, lane padding of Cin to 128, 8-column alignment pads and
VMEM tile heuristics are not carried over.
"""

import contextlib

import torch
import torch.nn.functional as F

from stylemesh_tpu_torch import kernels

CIN_STEP = 64  # channels per K step (kBK in conv_gemm.cu): Cin a multiple
COUT_STEP = 64  # the narrowest output-channel tile: Cout a multiple
BOX_WIDTHS = (256, 128, 64, 32, 16, 8)  # columns of a tile's pixel box
POOL_BOX_WIDTHS = (32, 16, 8)  # those that split an m64 block in row pairs


def block_n(cout):
    """Output channels per tile: 256 where Cout allows, else 128, else 64."""
    return next(n for n in (256, 128, 64) if cout % n == 0)


def tile_pixels(cout):
    """Output pixels per tile: 128 beside 256 channels, else 256 (two m64
    blocks per consumer warpgroup): the taller tile feeds more products
    with each stage's bytes from L2."""
    return 128 if block_n(cout) == 256 else 256


def pixel_box(h, w, pixels, widths=BOX_WIDTHS):
    """``(rows, cols)`` of the box of ``pixels`` output pixels a tile covers
    on an ``h x w`` map: the box of one of ``widths`` columns that pads the
    map least when the map is cut into such boxes, the widest among
    equals."""
    def padded(bw):
        bh = pixels // bw
        return -(-h // bh) * bh * (-(-w // bw) * bw)

    widths = [bw for bw in widths if bw <= pixels]
    bw = min(widths, key=padded)  # min keeps the first (widest) of ties
    return pixels // bw, bw


def pool_box(h, w, pixels):
    """The pixel box of a block-tail tile (K6, K7): :func:`pixel_box` among
    the widths of :data:`POOL_BOX_WIDTHS`. A consumer warpgroup's m64 block
    is then ``64 // cols`` whole rows of the box, an even count, and the
    box's origin is even, so every 2x2 pool window lies inside one block."""
    return pixel_box(h, w, pixels, POOL_BOX_WIDTHS)


def w9_from_oihw(weight):
    """OIHW ``[Cout, Cin, 3, 3]`` -> bf16 ``[9 * Cin, Cout]`` in (dy, dx, ci)
    row order: the JAX package's ``kernel.reshape(9 * Cin, Cout)``."""
    cout, cin = weight.shape[:2]
    return (weight.permute(2, 3, 1, 0).reshape(9 * cin, cout)
            .to(torch.bfloat16).contiguous())


def flipped_w9_from_oihw(weight):
    """The input-gradient kernel ``flip(kernel, (dy, dx))`` with Cin and
    Cout swapped, as ``[9 * Cout, Cin]`` bf16 (:func:`w9_from_oihw` of
    ``weight.flip(2, 3).transpose(0, 1)``)."""
    return w9_from_oihw(weight.flip(2, 3).transpose(0, 1))


@contextlib.contextmanager
def _full_float32():
    """float32 convolutions of the plain version in full float32 on a card
    (cuDNN would run them in TF32)."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


def conv3x3_plain(x, w9, bias=None, relu=False):
    """Plain version of K5: the float32 convolution of the bf16 values, plus
    the float32 bias, relu, one rounding to bf16."""
    cin, cout = x.shape[-1], w9.shape[1]
    k = w9.float().reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
    with _full_float32():
        y = F.conv2d(x.float().permute(0, 3, 1, 2), k, padding=1)
    if bias is not None:
        y = y + bias.float().view(1, -1, 1, 1)
    if relu:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()


def check_conv(x, w9, bias):
    """Raise unless ``x``, ``w9`` and ``bias`` are inputs the conv kernels
    take."""
    kernels.require_cuda(x, w9, dtype=torch.bfloat16)
    if bias is not None:
        kernels.require_cuda(x, bias)
        kernels.require_cuda(bias, dtype=torch.float32)
    cin = x.shape[-1]
    cout = w9.shape[1]
    if x.dim() != 4 or cin % CIN_STEP or cout % COUT_STEP:
        raise ValueError(f"x {tuple(x.shape)}: Cin must be a multiple of "
                         f"{CIN_STEP} and Cout of {COUT_STEP}, got {cout}")
    if tuple(w9.shape) != (9 * cin, cout):
        raise ValueError(f"w9 {tuple(w9.shape)} vs Cin {cin}")
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"bias {tuple(bias.shape)} vs Cout {cout}")


def _launch_conv3x3(x, w9, bias, relu):
    check_conv(x, w9, bias)
    v, h, w, cin = x.shape
    cout = w9.shape[1]
    y = torch.empty((v, h, w, cout), dtype=torch.bfloat16, device=x.device)
    box_h, box_w = pixel_box(h, w, tile_pixels(cout))
    kernels.launch("stylemesh_conv3x3", x.device, x.data_ptr(), w9.data_ptr(),
                   None if bias is None else bias.data_ptr(), y.data_ptr(),
                   v, h, w, cin, cout, int(relu), box_h, box_w, block_n(cout))
    return y


def conv3x3(x, w9, bias=None, relu=False):
    """K5: ``bf16(act(conv3x3(x, w9) + bias))`` ``[V, H, W, Cout]``. CPU
    tensors take the plain version; CUDA tensors launch the kernel or raise.
    Equal to the plain version up to the order of the float32 sums."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w9, bias, relu)
    y = _launch_conv3x3(x, w9, bias, relu)
    conv3x3.launches += 1
    return y


conv3x3.launches = 0


def conv3x3_masked_plain(x, w9, mask, tap=None):
    """Plain version of :func:`conv3x3_masked`, the passes it replaces:
    K5's plain version, the bf16 sum with ``tap``, the relu mask."""
    y = conv3x3_plain(x, w9)
    if tap is not None:
        y = y + tap
    return relu_mask(y, mask)


def relu_mask(g, y):
    """A relu's backward from its output: ``g`` where ``y > 0``, else +0."""
    return torch.where(y > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))


def conv3x3_masked(x, w9, mask, tap=None):
    """K5's input gradient that finishes the cotangent of its input, the
    relu output ``mask [V, H, W, Cout]``: ``where(mask > 0, bf16(conv3x3(x,
    w9)) + tap, 0)`` in bf16, ``tap`` (the loss tap's cotangent of ``mask``,
    the same shape) optional; no bias, no relu. CPU tensors take
    :func:`conv3x3_masked_plain`; CUDA tensors launch the kernel or raise.
    Counted in ``conv3x3.launches``."""
    if x.device.type == "cpu":
        return conv3x3_masked_plain(x, w9, mask, tap)
    check_conv(x, w9, None)
    v, h, w, cin = x.shape
    cout = w9.shape[1]
    for t in (mask,) if tap is None else (mask, tap):
        kernels.require_cuda(x, t, dtype=torch.bfloat16)
        if tuple(t.shape) != (v, h, w, cout):
            raise ValueError(f"{tuple(t.shape)} vs the output {(v, h, w, cout)}")
    y = torch.empty((v, h, w, cout), dtype=torch.bfloat16, device=x.device)
    box_h, box_w = pixel_box(h, w, tile_pixels(cout))
    kernels.launch("stylemesh_conv3x3_masked", x.device, x.data_ptr(),
                   w9.data_ptr(), mask.data_ptr(),
                   None if tap is None else tap.data_ptr(), y.data_ptr(),
                   v, h, w, cin, cout, box_h, box_w, block_n(cout))
    conv3x3.launches += 1
    return y


def conv3x3_mxu_plain(x, w9):
    """Plain version of K9: the float32 convolution of the bf16 values, one
    rounding to bf16."""
    return conv3x3_plain(x, w9)


def conv3x3_mxu(x, w9):
    """K9: ``bf16(conv3x3(x, w9))`` ``[V, H, W, Cout]``, no bias, no relu.
    CPU tensors take :func:`conv3x3_mxu_plain`; CUDA tensors launch the
    kernel or raise."""
    if x.device.type == "cpu":
        return conv3x3_mxu_plain(x, w9)
    y = _launch_conv3x3(x, w9, None, False)
    conv3x3_mxu.launches += 1
    return y


conv3x3_mxu.launches = 0


class _ConvFrozen(torch.autograd.Function):
    """K9 with the JAX package's ``conv3x3_frozen`` VJP: the input gradient
    is K9 with the flipped, io-swapped kernel applied to the bf16
    cotangent; the weights get no gradient (the VGG is frozen)."""

    @staticmethod
    def forward(ctx, x, w9, w9_flipped):
        ctx.save_for_backward(w9_flipped)
        return conv3x3_mxu(x, w9)

    @staticmethod
    def backward(ctx, g):
        (w9_flipped,) = ctx.saved_tensors
        dx = conv3x3_mxu(g.to(torch.bfloat16).contiguous(), w9_flipped)
        return dx, None, None
