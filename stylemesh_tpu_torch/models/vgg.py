"""VGG-16 feature extractor, Gatys variant (counterpart of
``stylemesh_tpu/models/vgg.py``).

The 16-conv / 5-pool trunk of the style and content losses; any subset of
the 21 named activations ``r11..r54, p1..p5`` can be requested. Weights are
frozen: the parameters are plain tensors that never require a gradient.

Two routes, as in the JAX package:

- bf16 compute at ``precision='default'`` (the bench step): the JAX
  package's accelerator branch on the hand-written kernels. conv1_1 is an
  im2col product (``ops/conv_im2col.py``); the other convs are K5
  (``ops/conv_kernels.py``), whose input gradient is K5 again with the
  flipped kernel; the block tails conv1_2 + p1 and conv2_2 + p2 are fused
  into K6 / K7 when the conv's own activation is not requested, with K8 as
  the 64-channel backward (``ops/head_kernels.py``). p3..p5 stay
  ``F.max_pool2d``. Activations are channel-last ``[V, H, W, C]``
  throughout. On the CPU the kernels' plain versions run the same structure.
- float32, or ``precision='highest'``: PyTorch's ``F.conv2d`` on NCHW
  tensors in ``channels_last`` memory, as the JAX package keeps its float32
  path on XLA.

Two environment variables of the JAX package choose the route, read at
every call of :func:`vgg_features` as the JAX package reads them, with the
same defaults:

- ``STYLEMESH_CONV_FLIPVJP`` (default ``1``): ``0`` turns off every fused
  route above. Every conv is then ``relu(conv3x3(h) + b)`` with autograd's
  relu and every pool the plain ``F.max_pool2d`` / ``F.avg_pool2d``
  (:func:`_unfused_trunk`).
- ``STYLEMESH_FAST_CONV`` (default ``0``): on that unfused route, ``1``
  sends each bf16 / ``precision='default'`` conv with Cin >= 64 to K9
  (``conv_kernels._ConvFrozen``) followed by a bf16 bias add, as the JAX
  package's ``_conv3x3`` does; conv1_1 and every other conv stay on
  ``F.conv2d`` (cuDNN on the card) with autograd.

Parameters are stored OIHW (PyTorch's layout; the JAX package's are HWIO).
The kernel route lays each conv's weights out once, at its first use, as
``w9`` / ``w9_flipped`` bf16 matrices and a float32 bias kept in the conv's
parameter dict (:func:`kernel_layout`).
"""

import os

import numpy as np
import torch
import torch.nn.functional as F

from stylemesh_tpu_torch import resolve_device
from stylemesh_tpu_torch.ops import conv_kernels, head_kernels
from stylemesh_tpu_torch.ops.conv_im2col import conv3x3_im2col

# (name, in_channels, out_channels) of the 16 convs in trunk order.
VGG_CONVS = [
    ("conv1_1", 3, 64), ("conv1_2", 64, 64),
    ("conv2_1", 64, 128), ("conv2_2", 128, 128),
    ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256), ("conv3_4", 256, 256),
    ("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512), ("conv4_4", 512, 512),
    ("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512), ("conv5_4", 512, 512),
]

# Channel count of every named activation (relu outputs + pooled maps).
VGG_LAYER_CHANNELS = {
    "r11": 64, "r12": 64, "p1": 64,
    "r21": 128, "r22": 128, "p2": 128,
    "r31": 256, "r32": 256, "r33": 256, "r34": 256, "p3": 256,
    "r41": 512, "r42": 512, "r43": 512, "r44": 512, "p4": 512,
    "r51": 512, "r52": 512, "r53": 512, "r54": 512, "p5": 512,
}

# trunk order: (activation name, conv name or None for a pool)
_TRUNK = [
    ("r11", "conv1_1"), ("r12", "conv1_2"), ("p1", None),
    ("r21", "conv2_1"), ("r22", "conv2_2"), ("p2", None),
    ("r31", "conv3_1"), ("r32", "conv3_2"), ("r33", "conv3_3"), ("r34", "conv3_4"), ("p3", None),
    ("r41", "conv4_1"), ("r42", "conv4_2"), ("r43", "conv4_3"), ("r44", "conv4_4"), ("p4", None),
    ("r51", "conv5_1"), ("r52", "conv5_2"), ("r53", "conv5_3"), ("r54", "conv5_4"), ("p5", None),
]


def _params_from_hwio(arrays, dtype, device):
    """{name: (HWIO kernel, bias) numpy} -> {name: {"weight": OIHW, "bias"}}."""
    device = resolve_device(device)
    params = {}
    for name, (kernel, bias) in arrays.items():
        w = torch.from_numpy(np.array(
            np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1))))
        b = torch.from_numpy(np.array(bias, np.float32))
        params[name] = {"weight": w.to(device=device, dtype=dtype),
                        "bias": b.to(device=device, dtype=dtype)}
    return params


def init_vgg_params(rng=None, dtype=torch.float32, scale=0.05, he=False,
                    device=None):
    """Random VGG params with the JAX package's numpy draws, so the same
    ``rng`` seed gives the same weights (``he=True``: per-layer
    sqrt(2/fan_in) scales)."""
    rng = np.random.default_rng(0 if rng is None else rng)
    arrays = {}
    for name, cin, cout in VGG_CONVS:
        s = float(np.sqrt(2.0 / (9 * cin))) if he else scale
        kernel = rng.normal(0.0, s, size=(3, 3, cin, cout))
        bias = rng.normal(0.0, 0.05 if he else scale, size=(cout,))
        arrays[name] = (kernel.astype(np.float32), bias.astype(np.float32))
    return _params_from_hwio(arrays, dtype, device)


def convert_torch_state_dict(state_dict, dtype=torch.float32, device=None):
    """Reference ``vgg_conv.pth`` state dict (OIHW) -> params."""
    device = resolve_device(device)
    params = {}
    for name, cin, cout in VGG_CONVS:
        w = torch.as_tensor(np.asarray(state_dict[f"{name}.weight"], np.float32))
        b = torch.as_tensor(np.asarray(state_dict[f"{name}.bias"], np.float32))
        if tuple(w.shape) != (cout, cin, 3, 3):
            raise ValueError(f"{name}: weight shape {tuple(w.shape)}")
        params[name] = {"weight": w.to(device=device, dtype=dtype),
                        "bias": b.to(device=device, dtype=dtype)}
    return params


def save_vgg_params(params, path):
    """Write ``params`` as the JAX package's ``save_vgg_params`` does: an
    ``.npz`` of ``<conv>.kernel`` (HWIO float32) and ``<conv>.bias``, in
    the order of ``params``; both packages' :func:`load_vgg_params` read
    it."""
    flat = {}
    for name, p in params.items():
        w = p["weight"].detach().to(device="cpu", dtype=torch.float32)
        flat[f"{name}.kernel"] = np.ascontiguousarray(
            w.permute(2, 3, 1, 0).numpy())  # OIHW -> HWIO
        flat[f"{name}.bias"] = p["bias"].detach().to(
            device="cpu", dtype=torch.float32).numpy()
    np.savez(path, **flat)


def load_vgg_params(path, dtype=torch.float32, device=None):
    """Params from the ``.npz`` of the JAX package's ``save_vgg_params``
    (``<conv>.kernel`` HWIO, ``<conv>.bias``)."""
    data = np.load(path)
    return _params_from_hwio(
        {name: (data[f"{name}.kernel"], data[f"{name}.bias"])
         for name, _, _ in VGG_CONVS}, dtype, device)


def _conv_flags(x, precision):
    """float32 convolutions in full float32 for ``precision='highest'``
    (cuDNN's default would run them in TF32)."""
    allow_tf32 = not (precision == "highest" and x.dtype == torch.float32)
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic,
                       allow_tf32=allow_tf32)


class _ConvReLU(torch.autograd.Function):
    """``relu(conv3x3(x) + b)`` with the frozen-VGG backward of the JAX
    package's ``_conv3x3_relu_flipvjp``: only the output is saved (the relu
    mask is ``y > 0``) and the input gradient is the convolution of the
    masked cotangent with the flipped, io-swapped kernel. The bias is added
    after the convolution in the working dtype, as the JAX package does."""

    @staticmethod
    def forward(ctx, x, weight, bias, precision):
        with _conv_flags(x, precision):
            y = F.conv2d(x, weight, padding=1)
        y = torch.relu_(y.add_(bias.to(y.dtype).view(1, -1, 1, 1)))
        ctx.save_for_backward(y, weight)
        ctx.precision = precision
        return y

    @staticmethod
    def backward(ctx, g):
        y, weight = ctx.saved_tensors
        g = torch.where(y > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))
        kt = weight.flip(2, 3).transpose(0, 1).to(g.dtype).contiguous(
            memory_format=torch.channels_last)
        with _conv_flags(g, ctx.precision):
            dx = F.conv2d(g, kt, padding=1)
        return dx, None, None, None


def kernel_layout(p):
    """``(w9, w9_flipped, bias)`` of one conv's params for the kernel route:
    bf16 ``[9 * Cin, Cout]`` and ``[9 * Cout, Cin]`` matrices and the float32
    bias. Built at the first call and kept in ``p`` (the VGG is frozen)."""
    if "w9" not in p:
        p["w9"] = conv_kernels.w9_from_oihw(p["weight"])
        p["w9_flipped"] = conv_kernels.flipped_w9_from_oihw(p["weight"])
        p["bias_f32"] = p["bias"].float().contiguous()
    return p["w9"], p["w9_flipped"], p["bias_f32"]


class _ConvReLUV2(torch.autograd.Function):
    """K5 ``relu(conv3x3(x) + b)`` with the JAX package's
    ``_conv3x3_relu_v2`` backward: only ``y`` is saved, the cotangent is
    masked by ``y > 0`` and cast to bf16, and the input gradient is K5 with
    the flipped kernel, no bias and relu off."""

    @staticmethod
    def forward(ctx, x, w9, w9_flipped, bias):
        y = conv_kernels.conv3x3(x, w9, bias, relu=True)
        ctx.save_for_backward(y, w9_flipped)
        return y

    @staticmethod
    def backward(ctx, g):
        y, w9_flipped = ctx.saved_tensors
        g = torch.where(y > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))
        g = g.to(torch.bfloat16).contiguous()
        return conv_kernels.conv3x3(g, w9_flipped), None, None, None


class _ConvReLUPool(torch.autograd.Function):
    """The fused block tail ``maxpool2(relu(conv3x3(x) + b))``, the JAX
    package's ``_conv_relu_pool_frozen``. 64 channels: K6 forward, ``x``
    saved, K8 backward. 128 channels: K7 forward, the pre-pool activation
    saved; backward = first-maximum pool routing with the relu mask, then
    K5 with the flipped kernel."""

    @staticmethod
    def forward(ctx, x, w9, w9_flipped, bias):
        ctx.fused_backward = x.shape[-1] == 64
        if ctx.fused_backward:
            ctx.save_for_backward(x, w9, w9_flipped, bias)
            return head_kernels.conv_relu_pool(x, w9, bias)
        pooled, pre = head_kernels.conv_relu_pool(x, w9, bias, with_pre=True)
        ctx.save_for_backward(pre, w9_flipped)
        return pooled

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.bfloat16).contiguous()
        if ctx.fused_backward:
            x, w9, w9_flipped, bias = ctx.saved_tensors
            dx = head_kernels.conv_relu_pool_bwd(x, w9, w9_flipped, bias, g)
        else:
            pre, w9_flipped = ctx.saved_tensors
            dx = conv_kernels.conv3x3(head_kernels.pool_route(pre, g),
                                      w9_flipped)
        return dx, None, None, None


def _fused_pool_wanted(h, cout, pool, name_wanted):
    """The JAX package's ``_fused_pool_wanted`` on the kernel route: max
    pool, Cin == Cout in {64, 128}, the conv's own activation not
    requested, at least one pool window."""
    cin = h.shape[-1]
    return (pool == "max" and not name_wanted and cin == cout
            and cin in (64, 128) and h.shape[1] >= 2 and h.shape[2] >= 2)


def _pool_nhwc(h, pool):
    h = h.permute(0, 3, 1, 2)
    h = F.max_pool2d(h, 2) if pool == "max" else F.avg_pool2d(h, 2)
    return h.permute(0, 2, 3, 1).contiguous()


def _kernel_trunk(params, x, wanted, last_needed, pool):
    """The bf16 trunk on the hand-written kernels; channel-last throughout."""
    outs = {}
    h = x.contiguous()
    skip_pool = False
    for i, (name, conv) in enumerate(_TRUNK):
        if conv is not None:
            w9, w9_flipped, bias = kernel_layout(params[conv])
            next_is_pool = (i + 1 < len(_TRUNK) and _TRUNK[i + 1][1] is None
                            and i + 1 <= last_needed)
            if next_is_pool and _fused_pool_wanted(h, w9.shape[1], pool,
                                                   name in wanted):
                # the fused output is the pool's, recorded under its name
                h = _ConvReLUPool.apply(h, w9, w9_flipped, bias)
                skip_pool = True
                continue
            if h.shape[-1] < conv_kernels.CIN_STEP:
                h = conv3x3_im2col(h, w9, bias, relu=True)
            else:
                h = _ConvReLUV2.apply(h, w9, w9_flipped, bias)
        elif skip_pool:
            skip_pool = False
        else:
            h = _pool_nhwc(h, pool)
        if name in wanted:
            outs[name] = h
        if i == last_needed:
            break
    return outs


def _conv3x3(h, p, precision):
    """The unfused route's ``conv3x3(h) + b`` (the JAX package's
    ``_conv3x3`` with the flip VJP off), channel-last. K9 under
    ``STYLEMESH_FAST_CONV=1`` for bf16 at default precision and Cin >= 64,
    with the bias added in bf16 after K9's rounding; ``F.conv2d`` with
    autograd otherwise."""
    if (h.dtype == torch.bfloat16 and precision == "default"
            and h.shape[-1] >= 64
            and os.environ.get("STYLEMESH_FAST_CONV", "0") == "1"):
        w9, w9_flipped, _ = kernel_layout(p)
        out = conv_kernels._ConvFrozen.apply(h.contiguous(), w9, w9_flipped)
        return out + p["bias"].to(out.dtype)
    w = p["weight"].to(h.dtype).contiguous(memory_format=torch.channels_last)
    with _conv_flags(h, precision):
        out = F.conv2d(h.permute(0, 3, 1, 2), w, padding=1)
    return (out + p["bias"].to(out.dtype).view(1, -1, 1, 1)).permute(0, 2, 3, 1)


def _unfused_trunk(params, x, wanted, last_needed, pool, precision):
    """``STYLEMESH_CONV_FLIPVJP=0``: every conv is ``relu(_conv3x3(h))``
    with autograd's relu, every pool the plain one; channel-last."""
    outs = {}
    h = x
    for i, (name, conv) in enumerate(_TRUNK):
        if conv is not None:
            h = torch.relu(_conv3x3(h, params[conv], precision))
        else:
            h = _pool_nhwc(h, pool)
        if name in wanted:
            outs[name] = h
        if i == last_needed:
            break
    return outs


def vgg_features(params, x, out_keys, pool="max", compute_dtype=None,
                 precision="highest"):
    """Run the VGG-16 trunk and return the requested activations.

    Args:
        params: from :func:`init_vgg_params` / :func:`load_vgg_params`.
        x: ``[B, H, W, 3]`` Gatys-preprocessed image.
        out_keys: activation names (see :data:`VGG_LAYER_CHANNELS`).
        pool: ``'max'`` (the gradient goes to the first maximum of each
            window, torch's and the JAX package's tie rule) or ``'avg'``.
        compute_dtype: cast input and weights to this dtype (``torch.bfloat16``
            on the card); ``None`` keeps the input dtype.
        precision: ``'highest'`` keeps float32 convolutions out of TF32;
            ``'default'`` with bf16 compute takes the kernel route.
    Returns:
        dict name -> ``[B, h, w, c]`` activation in the compute dtype.
    """
    out_keys = list(out_keys)
    wanted = set(out_keys)
    last_needed = max(i for i, (name, _) in enumerate(_TRUNK) if name in wanted)
    dtype = compute_dtype or x.dtype
    if os.environ.get("STYLEMESH_CONV_FLIPVJP", "1") == "0":
        outs = _unfused_trunk(params, x.to(dtype), wanted, last_needed, pool,
                              precision)
        return {k: outs[k] for k in out_keys}
    if dtype == torch.bfloat16 and precision == "default":
        outs = _kernel_trunk(params, x.to(dtype), wanted, last_needed, pool)
        return {k: outs[k] for k in out_keys}
    h = x.to(dtype).permute(0, 3, 1, 2)
    h = h.contiguous(memory_format=torch.channels_last)
    outs = {}
    for i, (name, conv) in enumerate(_TRUNK):
        if conv is not None:
            w = params[conv]["weight"].to(dtype).contiguous(
                memory_format=torch.channels_last)
            h = _ConvReLU.apply(h, w, params[conv]["bias"].to(dtype), precision)
        elif pool == "max":
            h = F.max_pool2d(h, 2)
        else:
            h = F.avg_pool2d(h, 2)
        if name in wanted:
            outs[name] = h.permute(0, 2, 3, 1)
        if i == last_needed:
            break
    return {k: outs[k] for k in out_keys}
