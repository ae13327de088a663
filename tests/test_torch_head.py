"""Port parity: the fused VGG block tails K6 / K7 / K8
(``ops/head_kernels.py``) and the trunk's ``_ConvReLUPool`` gradient,
against the JAX package's Pallas kernels (``ops/head_pallas.py``) in
interpret mode and ``jax.vjp`` of ``_conv_relu_pool_frozen``, on the CPU
(where the port runs the kernels' plain versions).

Tolerances (both sides: bf16 operands, float32 sums in different orders,
float32 bias, relu, one bf16 rounding, the pool over the bf16 values):
- forward: max |diff| <= 2e-2 of the largest reference value, and mean
  |diff| < 5e-3 (the JAX package's own bounds);
- gradients: at most 2e-3 of the elements outside ``0.05 + 0.05 * |ref|``:
  a near-tie in a pool window, rounded differently, routes the gradient to
  another pixel.
The routing helper against the JAX package's elementwise pool backward is
exact.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylemesh_tpu.models.vgg import (_conv_relu_pool_frozen, _maxpool2_bwd,
                                      _maxpool2_raw)
from stylemesh_tpu.ops.head_pallas import (conv_relu_pool,
                                           conv_relu_pool_bwd,
                                           conv_relu_pool_dual)
from stylemesh_tpu_torch.models import vgg as tvgg
from stylemesh_tpu_torch import kernels
from stylemesh_tpu_torch.ops import head_kernels
from test_torch_conv import (_assert_forward, _assert_grad, _bf16, _inputs,
                             _port_layout)

SHAPES = [  # tests/test_head_pallas.py's parity shapes
    ((2, 48, 67), 64),  # odd width: the trailing column is a conv halo only
    ((2, 48, 64), 64),
    ((1, 33, 41), 64),  # odd height and width
    ((2, 48, 66), 128),
    ((1, 30, 42), 128),
]


def _jax(a):
    return jnp.asarray(a, jnp.bfloat16)


@pytest.mark.parametrize("shape,c", SHAPES)
def test_conv_relu_pool_matches_pallas(shape, c):
    _, x, k, b = _inputs(0, *shape, c, c)
    want = conv_relu_pool(_jax(x), _jax(k), jnp.asarray(b), interpret=True)
    w9, _ = _port_layout(k)
    got = head_kernels.conv_relu_pool(_bf16(x), w9, torch.from_numpy(b))
    assert tuple(got.shape) == (shape[0], shape[1] // 2, shape[2] // 2, c)
    _assert_forward(got, want)


def test_conv_relu_pool_dual_matches_pallas():
    _, x, k, b = _inputs(9, 2, 26, 31, 128, 128)
    want_pooled, want_pre = conv_relu_pool_dual(_jax(x), _jax(k),
                                                jnp.asarray(b), interpret=True)
    w9, _ = _port_layout(k)
    pooled, pre = head_kernels.conv_relu_pool(_bf16(x), w9,
                                              torch.from_numpy(b),
                                              with_pre=True)
    _assert_forward(pooled, want_pooled)
    _assert_forward(pre, want_pre)
    assert torch.equal(pooled, head_kernels.maxpool2(pre))


@pytest.mark.parametrize("shape", [(1, 24, 26), (2, 30, 33), (1, 17, 20)])
def test_conv_relu_pool_bwd_matches_pallas(shape):
    rng, x, k, b = _inputs(7, *shape, 64, 64)
    v, h, w = shape
    g = rng.normal(0, 1, (v, h // 2, w // 2, 64)).astype(np.float32)
    want = conv_relu_pool_bwd(_jax(x), _jax(k), jnp.asarray(b), _jax(g),
                              interpret=True)
    w9, w9t = _port_layout(k)
    got = head_kernels.conv_relu_pool_bwd(_bf16(x), w9, w9t,
                                          torch.from_numpy(b), _bf16(g))
    assert got.dtype == torch.bfloat16
    _assert_grad(got, want)


@pytest.mark.parametrize("c", [64, 128])
def test_conv_relu_pool_gradient_matches_jax(c):
    """``_ConvReLUPool`` (K6 + K8 at 64 channels, K7 + routing + K5 at 128)
    against ``jax.vjp`` of ``_conv_relu_pool_frozen`` in interpret mode."""
    rng, x, k, b = _inputs(4 + c, 1, 24, 27, c, c)
    ct = rng.normal(0, 1, (1, 12, 13, c)).astype(np.float32)
    y, vjp = jax.vjp(lambda t: _conv_relu_pool_frozen(
        t, _jax(k), jnp.asarray(b), True), _jax(x))
    (want,) = vjp(_jax(ct))
    w9, w9t = _port_layout(k)
    xt = _bf16(x).requires_grad_()
    out = tvgg._ConvReLUPool.apply(xt, w9, w9t, torch.from_numpy(b))
    (got,) = torch.autograd.grad(out, [xt], _bf16(ct))
    _assert_forward(out.detach(), y)
    _assert_grad(got, want)


def test_pool_route_matches_jax_pool_backward():
    """First maximum in raster order, relu mask folded in, odd tails zero:
    the JAX package's elementwise pool backward, then the ``> 0`` mask."""
    rng = np.random.default_rng(5)
    r = np.maximum(rng.integers(-2, 3, (2, 9, 11, 8)), 0).astype(np.float32)
    g = rng.normal(0, 1, (2, 4, 5, 8)).astype(np.float32)
    jr, jg = _jax(r), _jax(g)
    (want,) = _maxpool2_bwd((jr, _maxpool2_raw(jr)), jg)
    want = np.where(r > 0, np.asarray(want.astype(jnp.float32)), 0.0)
    got = head_kernels.pool_route(_bf16(r), _bf16(g))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_bwd_tile_geometry():
    """K8's dx tile (24 x 32, even, so it holds whole pool windows) and its
    r region (the tile plus one ring of windows, 28 x 36): the recompute
    overhead the source note claims, 28 * 36 / (24 * 32) = 1.3125, under
    1.4 (the WMMA kernel's 8 x 28 tile had 12 * 32 / (8 * 28) = 1.71); the
    region splits into 4 phase-1 boxes of 7 x 36 = 252 <= 256 pixels; the
    tile into m64 blocks of two rows of 32."""
    th, tw = head_kernels.BWD_TILE
    rh, rw = th + 4, tw + 4
    assert th % 2 == 0 and tw % 2 == 0
    assert rh * rw / (th * tw) == 1.3125 <= 1.4
    assert rh % 4 == 0 and (rh // 4) * rw <= 256
    assert tw * 2 == 64 and th % 8 == 0
    note = (Path(kernels.CSRC) / "conv_pool_bwd.cu").read_text()
    assert "28 * 36 / (24 * 32) = 1.3125" in note
    assert f"kTH = {th}, kTW = {tw}" in note
