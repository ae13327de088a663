"""The texture's update in one pass: Adam, then the clamp to the Gatys range
(counterpart of ``optax.adam`` and ``clamp_texture`` in
``stylemesh_tpu/models/pipeline.py``, an XLA fusion there).

:func:`adam_clamp_` updates every layer of the atlas and its two Adam
moments in place from the layer's gradient, reading the scheduled rate and
the bias corrections from a device tensor ``scalars = [lr, bc1, bc2]``
(``TexturePipeline.write_adam_scalars`` fills it before each update, so
that a CUDA graph replay reads the step's values). On a card that is one
launch of ``kernels/csrc/adam.cu`` over all the layers, which reads p, g,
m and v once and writes p, m and v once; :func:`adam_clamp_plain_` is the
chain of PyTorch elementwise operations it replaces, and the CPU's update.
"""

import ctypes

import torch

from stylemesh_tpu_torch import kernels
from stylemesh_tpu_torch.ops.color import GATYS_MAX, GATYS_MIN

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
MAX_LAYERS = 8  # kMaxLayers of kernels/csrc/adam.cu


@torch.no_grad()
def adam_clamp_plain_(layers, grads, mus, nus, scalars):
    """optax.adam(b1=0.9, b2=0.999, eps=1e-8) and the clamp, in place, the
    rate and bias corrections read from ``scalars``. On the CPU, the same
    roundings as ``addcdiv_(mu / bc1, denom, value=-lr)`` with Python
    scalars (whose CPU kernel multiplies before it divides)."""
    lr, bc1, bc2 = scalars
    for p, g, mu, nu in zip(layers, grads, mus, nus):
        mu.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
        nu.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
        denom = (nu / bc2).sqrt_().add_(ADAM_EPS)
        p.addcdiv_((mu / bc1).mul_(lr), denom, value=-1.0)
    for p in layers:
        p.clamp_(GATYS_MIN, GATYS_MAX)


def _check(layers, grads, mus, nus, scalars):
    if not len(layers) == len(grads) == len(mus) == len(nus) >= 1:
        raise ValueError(f"{len(layers)} layers, {len(grads)} gradients, "
                         f"{len(mus)} and {len(nus)} moments")
    for group in zip(layers, grads, mus, nus):
        for t in group:
            if t.dtype != torch.float32:
                raise TypeError(f"expected torch.float32, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError("expected a contiguous tensor")
            if t.shape != group[0].shape:
                raise ValueError(f"shape {tuple(t.shape)} vs the layer's "
                                 f"{tuple(group[0].shape)}")
    if scalars.shape != (3,) or scalars.dtype != torch.float32:
        raise ValueError(f"scalars: expected float32 [3], got "
                         f"{scalars.dtype} {list(scalars.shape)}")


def adam_clamp_(layers, grads, mus, nus, scalars):
    """Adam and the clamp on ``layers`` and their moments ``mus`` / ``nus``,
    in place, from ``grads``; ``scalars`` the float32 ``[lr, bc1, bc2]``.
    Every tensor contiguous float32, each layer's four of one shape. CPU
    tensors take the plain version; CUDA tensors launch the kernel (one
    launch for up to 8 layers) or raise."""
    _check(layers, grads, mus, nus, scalars)
    if layers[0].device.type == "cpu":
        return adam_clamp_plain_(layers, grads, mus, nus, scalars)
    n = len(layers)
    if n > MAX_LAYERS:
        raise ValueError(f"at most {MAX_LAYERS} layers, got {n}")
    kernels.require_cuda(*layers, *grads, *mus, *nus, scalars,
                         dtype=torch.float32)

    def table(ts):
        return (ctypes.c_void_p * n)(*[t.data_ptr() for t in ts])

    kernels.launch("stylemesh_adam_clamp", layers[0].device, table(layers),
                   table(grads), table(mus), table(nus),
                   (ctypes.c_longlong * n)(*[t.numel() for t in layers]), n,
                   scalars.data_ptr(), ADAM_B1, 1.0 - ADAM_B1, ADAM_B2,
                   1.0 - ADAM_B2, ADAM_EPS, GATYS_MIN, GATYS_MAX)
    adam_clamp_.launches += 1


adam_clamp_.launches = 0
