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


def _route_by_loops(r, g):
    """The pool's backward with the relu mask, window by window and channel
    by channel: the cotangent to the first maximum in raster order where it
    is > 0, nothing from a window that holds a NaN, 0 elsewhere."""
    v, h, w, c = r.shape
    dr = np.zeros(r.shape, np.float32)
    for n in range(v):
        for i in range(h // 2):
            for j in range(w // 2):
                for k in range(c):
                    px = [(2 * i, 2 * j), (2 * i, 2 * j + 1),
                          (2 * i + 1, 2 * j), (2 * i + 1, 2 * j + 1)]
                    vals = [r[n, y, x, k] for y, x in px]
                    if any(np.isnan(vals)):
                        continue
                    top = max(vals)
                    for (y, x), val in zip(px, vals):
                        if val == top and val > 0:
                            dr[n, y, x, k] = g[n, i, j, k]
                            break
    return dr


def _route_case(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    shape = {"h1": (2, 1, 7, 8), "w1": (2, 7, 1, 8), "odd": (2, 9, 11, 8)}.get(
        case, (2, 8, 10, 8))
    v, h, w, c = shape
    r = np.maximum(rng.normal(0, 1, shape), 0).astype(np.float32)
    g = rng.normal(0, 1, (v, h // 2, w // 2, c)).astype(np.float32)
    if case == "nan":
        r[rng.random(shape) < 0.05] = np.nan
    elif case == "ties":
        r = rng.integers(0, 3, shape).astype(np.float32)
    elif case == "nonpositive":
        r = -r
    elif case == "inf":
        r[rng.random(shape) < 0.05] = np.inf
    elif case == "neg_zero_g":
        g[rng.random(g.shape) < 0.3] = -0.0
    return _bf16(r), _bf16(g)


@pytest.mark.parametrize("case", ["nan", "neg_zero_g", "h1", "w1", "odd",
                                  "ties", "nonpositive", "inf"])
def test_pool_route_plain_edge_semantics(case):
    """The plain route, the card's reference, against a loop over windows,
    bit for bit (signed zeros too): a NaN silences its window's channel, -0.0
    in g is routed with its sign, H or W of 1 routes nothing, the odd last
    row and column get +0, ties go to the first maximum in raster order,
    windows all <= 0 route nothing, +inf is a maximum."""
    r, g = _route_case(case)
    got = head_kernels.pool_route_plain(r, g)
    want = torch.from_numpy(_route_by_loops(r.float().numpy(),
                                            g.float().numpy())).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    if case == "neg_zero_g":
        assert (got.view(torch.int16) == -32768).any()
    if case in ("h1", "w1", "nonpositive"):
        assert torch.equal(got.view(torch.int16), torch.zeros_like(
            got).view(torch.int16))


def test_pool_route_takes_the_plain_version_on_the_cpu():
    """On the CPU the wrapper is the plain version and launches nothing."""
    r, g = _route_case("odd")
    before = head_kernels.pool_route.launches
    assert torch.equal(head_kernels.pool_route(r, g).view(torch.int16),
                       head_kernels.pool_route_plain(r, g).view(torch.int16))
    assert head_kernels.pool_route.launches == before


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
