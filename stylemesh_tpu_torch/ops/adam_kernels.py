"""The texture's update in one pass: Adam, then the clamp to the Gatys range
(counterpart of ``optax.adam`` and ``clamp_texture`` in
``stylemesh_tpu/models/pipeline.py``, an XLA fusion there), with the texture
regularizer's gradient folded in; and the regularizer's value in one read.

:func:`adam_clamp_` updates every layer of the atlas and its two Adam
moments in place from the layer's gradient, reading the scheduled rate and
the bias corrections from a device tensor ``scalars = [lr, bc1, bc2]``
(``TexturePipeline.write_adam_scalars`` fills it before each update, so
that a CUDA graph replay reads the step's values). Each layer's gradient
is first joined by the regularizer's, ``coefs[l] * p`` (the regularizer
``sum_l w_l * mean(p_l**2)`` times its loss weight has the gradient
``c_l * p`` with ``c_l = weight * w_l * 2 / N_l``; ``PipelineConfig.
tex_reg_coefficients``), so the train step's autograd never sees it. On a
card that is one launch of ``kernels/csrc/adam.cu`` over all the layers,
which reads p, g, m and v once and writes p, m and v once;
:func:`adam_clamp_plain_` is the chain of PyTorch elementwise operations it
replaces, and the CPU's update.

:func:`tex_reg_value` is the regularizer's value, detached: on a card two
launches of ``adam.cu`` (per-block partials, then one finishing block) that
read every layer once; on the CPU :func:`tex_reg_value_plain`.
"""

import ctypes

import torch

from stylemesh_tpu_torch import kernels
from stylemesh_tpu_torch.ops.color import GATYS_MAX, GATYS_MIN

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
MAX_LAYERS = 8  # kMaxLayers of kernels/csrc/adam.cu
MAX_PARTIALS = 4096  # the value's scratch: one double a block, at most


def _coefs(layers, coefs):
    return [0.0] * len(layers) if coefs is None else [float(c) for c in coefs]


@torch.no_grad()
def adam_clamp_plain_(layers, grads, mus, nus, scalars, coefs=None):
    """optax.adam(b1=0.9, b2=0.999, eps=1e-8) and the clamp, in place, the
    rate and bias corrections read from ``scalars``, each layer's gradient
    joined first by ``coefs[l] * p`` (the product rounded, then the sum, as
    autograd joined the regularizer's gradient; none where a coefficient is
    0, or ``coefs`` None). On the CPU, the same roundings as
    ``addcdiv_(mu / bc1, denom, value=-lr)`` with Python scalars (whose CPU
    kernel multiplies before it divides)."""
    lr, bc1, bc2 = scalars
    for p, g, mu, nu, c in zip(layers, grads, mus, nus, _coefs(layers, coefs)):
        if c != 0.0:
            g = g + p * c
        mu.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
        nu.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
        denom = (nu / bc2).sqrt_().add_(ADAM_EPS)
        p.addcdiv_((mu / bc1).mul_(lr), denom, value=-1.0)
    for p in layers:
        p.clamp_(GATYS_MIN, GATYS_MAX)


def _check_layers(layers):
    for t in layers:
        if t.dtype != torch.float32:
            raise TypeError(f"expected torch.float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("expected a contiguous tensor")


def _check(layers, grads, mus, nus, scalars, coefs):
    if not len(layers) == len(grads) == len(mus) == len(nus) >= 1:
        raise ValueError(f"{len(layers)} layers, {len(grads)} gradients, "
                         f"{len(mus)} and {len(nus)} moments")
    if coefs is not None and len(coefs) != len(layers):
        raise ValueError(f"{len(coefs)} coefficients for {len(layers)} "
                         f"layers")
    for group in zip(layers, grads, mus, nus):
        _check_layers(group)
        for t in group:
            if t.shape != group[0].shape:
                raise ValueError(f"shape {tuple(t.shape)} vs the layer's "
                                 f"{tuple(group[0].shape)}")
    if scalars.shape != (3,) or scalars.dtype != torch.float32:
        raise ValueError(f"scalars: expected float32 [3], got "
                         f"{scalars.dtype} {list(scalars.shape)}")


def adam_clamp_(layers, grads, mus, nus, scalars, coefs=None):
    """Adam and the clamp on ``layers`` and their moments ``mus`` / ``nus``,
    in place, from ``grads`` plus ``coefs[l] * p`` (the regularizer's
    gradient; None: no term); ``scalars`` the float32 ``[lr, bc1, bc2]``.
    Every tensor contiguous float32, each layer's four of one shape. CPU
    tensors take the plain version; CUDA tensors launch the kernel (one
    launch for up to 8 layers) or raise."""
    _check(layers, grads, mus, nus, scalars, coefs)
    if layers[0].device.type == "cpu":
        return adam_clamp_plain_(layers, grads, mus, nus, scalars, coefs)
    n = len(layers)
    if n > MAX_LAYERS:
        raise ValueError(f"at most {MAX_LAYERS} layers, got {n}")
    kernels.require_cuda(*layers, *grads, *mus, *nus, scalars,
                         dtype=torch.float32)

    def table(ts):
        return (ctypes.c_void_p * n)(*[t.data_ptr() for t in ts])

    kernels.launch("stylemesh_adam_clamp", layers[0].device, table(layers),
                   table(grads), table(mus), table(nus),
                   (ctypes.c_longlong * n)(*[t.numel() for t in layers]),
                   (ctypes.c_float * n)(*_coefs(layers, coefs)), n,
                   scalars.data_ptr(), ADAM_B1, 1.0 - ADAM_B1, ADAM_B2,
                   1.0 - ADAM_B2, ADAM_EPS, GATYS_MIN, GATYS_MAX)
    adam_clamp_.launches += 1


adam_clamp_.launches = 0


@torch.no_grad()
def tex_reg_value_plain(layers, weights):
    """``sum_l w_l * mean(p_l**2)``: the value of
    ``models/texture.py::texture_regularizer``, bit for bit, detached."""
    reg = 0.0
    for w, p in zip(weights, layers):
        reg = reg + torch.mean(torch.square(p)) * w
    return reg


def tex_reg_value(layers, weights):
    """The texture regularizer's value ``sum_l w_l * mean(p_l**2)`` as a
    0-d float32 tensor, detached. CPU tensors take the plain version; CUDA
    tensors (contiguous float32, 16-byte aligned) launch the kernels: one
    read of every layer, summed in double in a fixed order, so two calls
    give the same bits. Up to 8 layers."""
    if len(weights) != len(layers) or not layers:
        raise ValueError(f"{len(weights)} weights for {len(layers)} layers")
    _check_layers(layers)
    if layers[0].device.type == "cpu":
        return tex_reg_value_plain(layers, weights)
    n = len(layers)
    if n > MAX_LAYERS:
        raise ValueError(f"at most {MAX_LAYERS} layers, got {n}")
    kernels.require_cuda(*layers, dtype=torch.float32)
    device = layers[0].device
    partials = torch.empty(MAX_PARTIALS, dtype=torch.float64, device=device)
    out = torch.empty((), dtype=torch.float32, device=device)
    kernels.launch("stylemesh_tex_reg_value", device,
                   (ctypes.c_void_p * n)(*[t.data_ptr() for t in layers]),
                   (ctypes.c_longlong * n)(*[t.numel() for t in layers]),
                   (ctypes.c_double * n)(*[float(w) / t.numel() for w, t in
                                           zip(weights, layers)]),
                   n, partials.data_ptr(), MAX_PARTIALS, out.data_ptr())
    tex_reg_value.launches += 1
    return out


tex_reg_value.launches = 0
