"""Port parity: the 3x3 convs K5 and K9 (``ops/conv_kernels.py``), conv1_1's
im2col product (``ops/conv_im2col.py``) and the input gradients of the
trunk's conv + relu and of K9's frozen VJP, against the JAX package's Pallas
kernels ``conv3x3_v2`` and ``conv3x3_mxu`` / ``conv3x3_frozen`` in interpret
mode and its ``conv3x3_im2col``, on the CPU (where the port runs the
kernels' plain versions).

Tolerances (both sides: bf16 operands, float32 sums in different orders,
float32 bias, relu, one bf16 rounding):
- forward: max |diff| <= 2e-2 of the largest reference value, and mean
  |diff| < 5e-3 (the JAX package's own bounds for its conv kernels);
- input gradients: at most 2e-3 of the elements outside
  ``0.05 + 0.05 * |ref|``, since a value that rounds to the other side of
  zero flips a relu mask. K9 has no relu: its input gradient is held to the
  forward's bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylemesh_tpu.models.vgg import _conv3x3_relu_v2
from stylemesh_tpu.ops.conv_im2col import conv3x3_im2col as j_im2col
from stylemesh_tpu.ops.conv_pallas import conv3x3_frozen, conv3x3_mxu, conv3x3_v2
from stylemesh_tpu_torch.models import vgg as tvgg
from stylemesh_tpu_torch.ops import conv_kernels
from stylemesh_tpu_torch.ops import conv_im2col
from stylemesh_tpu_torch.ops.conv_im2col import conv3x3_im2col


def _inputs(seed, v, h, w, cin, cout):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (v, h, w, cin)).astype(np.float32)
    k = rng.normal(0, float(np.sqrt(2.0 / (9 * cin))), (3, 3, cin, cout))
    b = rng.normal(0, 0.05, (cout,)).astype(np.float32)
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    k = np.array(jnp.asarray(k, jnp.bfloat16).astype(jnp.float32))
    return rng, x, k, b


def _port_layout(k):
    """HWIO numpy kernel -> the port's ``(w9, w9_flipped)``."""
    weight = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    return (conv_kernels.w9_from_oihw(weight),
            conv_kernels.flipped_w9_from_oihw(weight))


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _assert_forward(got, want):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= 2e-2 * scale
    assert np.abs(got - want).mean() < 5e-3


def _assert_grad(got, want):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    assert np.abs(want).max() > 0
    bad = np.abs(got - want) > 0.05 + 0.05 * np.abs(want)
    assert bad.mean() <= 2e-3, f"{bad.mean():.4f} of the gradients disagree"


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("cin,cout", [(64, 128), (128, 64), (128, 128),
                                      (256, 256)])
def test_conv3x3_matches_pallas(cin, cout, relu):
    _, x, k, b = _inputs(cin + cout, 2, 11, 13, cin, cout)
    want = conv3x3_v2(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                      jnp.asarray(b), relu=relu, interpret=True)
    w9, _ = _port_layout(k)
    got = conv_kernels.conv3x3(_bf16(x), w9, torch.from_numpy(b), relu=relu)
    assert got.dtype == torch.bfloat16
    _assert_forward(got, want)


@pytest.mark.parametrize("cin,cout", [(64, 128), (128, 128), (256, 128)])
def test_conv_relu_input_gradient_matches_jax(cin, cout):
    """``_ConvReLUV2`` (K5 forward, relu mask from y, K5 with the flipped
    kernel) against ``jax.vjp`` of ``_conv3x3_relu_v2`` in interpret mode."""
    rng, x, k, b = _inputs(7 + cin, 2, 12, 15, cin, cout)
    ct = rng.normal(0, 1, (2, 12, 15, cout)).astype(np.float32)
    y, vjp = jax.vjp(lambda t: _conv3x3_relu_v2(
        t, jnp.asarray(k, jnp.bfloat16), jnp.asarray(b), True),
        jnp.asarray(x, jnp.bfloat16))
    (want,) = vjp(jnp.asarray(ct, jnp.bfloat16))
    w9, w9t = _port_layout(k)
    xt = _bf16(x).requires_grad_()
    out = tvgg._ConvReLUV2.apply(xt, w9, w9t, torch.from_numpy(b))
    (got,) = torch.autograd.grad(out, [xt], _bf16(ct))
    _assert_forward(out.detach(), y)
    assert got.dtype == torch.bfloat16
    _assert_grad(got, want)


@pytest.mark.parametrize("relu", [True, False])
def test_im2col_matches_jax(relu):
    rng, x, k, b = _inputs(3, 2, 13, 17, 3, 64)
    x = x * 50.0  # Gatys-preprocessed pixel scale
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    ct = rng.normal(0, 1, (2, 13, 17, 64)).astype(np.float32)
    y, vjp = jax.vjp(lambda t: j_im2col(t, jnp.asarray(k, jnp.bfloat16),
                                        jnp.asarray(b), relu),
                     jnp.asarray(x, jnp.bfloat16))
    (want,) = vjp(jnp.asarray(ct, jnp.bfloat16))
    w9, _ = _port_layout(k)
    xt = _bf16(x).requires_grad_()
    out = conv3x3_im2col(xt, w9, torch.from_numpy(b), relu=relu)
    (got,) = torch.autograd.grad(out, [xt], _bf16(ct))
    _assert_forward(out.detach(), y)
    _assert_grad(got, want)


@pytest.mark.parametrize("cin,cout", [(64, 64), (64, 128), (128, 256),
                                      (256, 512)])
def test_conv3x3_mxu_matches_pallas(cin, cout):
    """K9 (``conv3x3_mxu_plain`` here) against ``conv3x3_mxu`` in interpret
    mode: no bias, no relu, one bf16 rounding."""
    _, x, k, _ = _inputs(100 + cin + cout, 2, 9, 11, cin, cout)
    want = conv3x3_mxu(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                       interpret=True)
    w9, _ = _port_layout(k)
    got = conv_kernels.conv3x3_mxu(_bf16(x), w9)
    assert got.dtype == torch.bfloat16
    _assert_forward(got, want)
    _assert_forward(conv_kernels.conv3x3_mxu_plain(_bf16(x), w9), want)


@pytest.mark.parametrize("cin,cout", [(64, 128), (256, 256)])
def test_conv_frozen_input_gradient_matches_jax(cin, cout):
    """``_ConvFrozen`` (K9 forward, K9 with the flipped kernel on the bf16
    cotangent) against ``jax.vjp`` of ``conv3x3_frozen`` in interpret mode;
    the weights get no gradient in either."""
    rng, x, k, _ = _inputs(50 + cin, 2, 10, 13, cin, cout)
    ct = rng.normal(0, 1, (2, 10, 13, cout)).astype(np.float32)
    y, vjp = jax.vjp(lambda t: conv3x3_frozen(t, jnp.asarray(k, jnp.bfloat16),
                                              True),
                     jnp.asarray(x, jnp.bfloat16))
    (want,) = vjp(jnp.asarray(ct, jnp.bfloat16))
    w9, w9t = _port_layout(k)
    xt = _bf16(x).requires_grad_()
    out = conv_kernels._ConvFrozen.apply(xt, w9, w9t)
    (got,) = torch.autograd.grad(out, [xt], _bf16(ct))
    _assert_forward(out.detach(), y)
    assert got.dtype == torch.bfloat16
    _assert_forward(got, want)


@pytest.mark.parametrize("pixels", [128, 256])
@pytest.mark.parametrize("h,w", [(1, 1), (1, 261), (7, 31), (17, 33),
                                 (98, 130), (196, 261), (256, 341),
                                 (392, 522), (32, 42), (5, 1045)])
def test_pixel_box_pads_least(h, w, pixels):
    """K5's tile is a box of 128 or 256 output pixels: the box the wrapper
    picks covers the map with no more padded pixels than any other box of
    the allowed widths, and is the widest of those that tie."""
    box_h, box_w = conv_kernels.pixel_box(h, w, pixels)
    assert box_h * box_w == pixels
    assert box_w in conv_kernels.BOX_WIDTHS and box_w % 8 == 0

    def padded(bw):
        bh = pixels // bw
        return -(-h // bh) * bh * (-(-w // bw) * bw)

    widths = [bw for bw in conv_kernels.BOX_WIDTHS if bw <= pixels]
    least = min(padded(bw) for bw in widths)
    assert padded(box_w) == least
    assert box_w == max(bw for bw in widths if padded(bw) == least)


def test_pixel_box_of_the_bench_maps():
    """The tiles of the largest bench level (UV height 784): its conv3 and
    conv4 maps take 8 x 16 boxes of 128 pixels (6% and 17% padding, where
    4 x 32 pads 10% and 25%); its conv1 and conv2 maps boxes of 256."""
    assert conv_kernels.pixel_box(196, 261, 128) == (8, 16)
    assert conv_kernels.pixel_box(98, 130, 128) == (8, 16)
    assert conv_kernels.pixel_box(784, 1045, 256) == (8, 32)
    assert conv_kernels.pixel_box(392, 522, 256) == (16, 16)
    assert conv_kernels.pixel_box(1, 261, 128) == (1, 128)


@pytest.mark.parametrize("cout,n,pixels", [(64, 64, 256), (128, 128, 256),
                                           (192, 64, 256), (256, 256, 128),
                                           (384, 128, 256), (512, 256, 128)])
def test_block_n_and_tile_pixels(cout, n, pixels):
    """Output channels per tile: the widest of 256, 128, 64 dividing Cout;
    pixels per tile: 128 beside 256 channels, else 256."""
    assert conv_kernels.block_n(cout) == n
    assert conv_kernels.tile_pixels(cout) == pixels


@pytest.mark.parametrize("pixels", [128, 256])
@pytest.mark.parametrize("h,w", [(1, 1), (2, 3), (7, 31), (17, 33),
                                 (256, 341), (432, 576), (608, 810),
                                 (784, 1045), (128, 170), (392, 522),
                                 (33, 57)])
def test_pool_box_keeps_windows_in_a_warpgroup(h, w, pixels):
    """The block tails' box (K6, K7): each consumer warpgroup's m64 block
    (64 consecutive pixels of the box, row-major) is an even number of
    whole box rows, and the box's height is even, so every 2x2 pool window
    of a tile lies inside one block; among such boxes it pads the map
    least, the widest of those that tie."""
    box_h, box_w = conv_kernels.pool_box(h, w, pixels)
    assert box_h * box_w == pixels and box_w % 8 == 0
    assert 64 % box_w == 0 and (64 // box_w) % 2 == 0 and box_h % 2 == 0

    def padded(bw):
        bh = pixels // bw
        return -(-h // bh) * bh * (-(-w // bw) * bw)

    allowed = [bw for bw in conv_kernels.BOX_WIDTHS
               if 64 % bw == 0 and (64 // bw) % 2 == 0]
    assert sorted(allowed) == sorted(conv_kernels.POOL_BOX_WIDTHS)
    least = min(padded(bw) for bw in allowed)
    assert padded(box_w) == least
    assert box_w == max(bw for bw in allowed if padded(bw) == least)


def test_pool_box_of_the_bench_maps():
    """conv1_2 of the largest level keeps K5's 8 x 32 box and conv2_2's
    392 x 522 map K5's 16 x 16; the smallest level's conv1_2 (256 x 341)
    takes 32 x 8."""
    assert conv_kernels.pool_box(784, 1045, 256) == (8, 32)
    assert conv_kernels.pool_box(392, 522, 256) == (16, 16)
    assert conv_kernels.pool_box(256, 341, 256) == (32, 8)


def _stem_inputs():
    """conv1_1's inputs on the CPU: x [2, 9, 11, 3] at the Gatys pixel
    scale, its w9 [27, 64] and float32 bias."""
    _, x, k, b = _inputs(21, 2, 9, 11, 3, 64)
    w9, _ = _port_layout(k)
    return _bf16(x * 50.0), w9, torch.from_numpy(b)


@pytest.mark.parametrize("relu", [True, False])
def test_stem_cpu_takes_the_plain_im2col(relu):
    """CPU tensors go through ``_Im2colConv``, bit for bit forward and
    backward, and launch no stem kernel."""
    x, w9, b = _stem_inputs()
    launches = (conv_im2col.stem_forward.launches,
                conv_im2col.stem_backward.launches)
    ct = _bf16(np.random.default_rng(5).normal(0, 1, (2, 9, 11, 64))
               .astype(np.float32))
    xa = x.clone().requires_grad_()
    out = conv3x3_im2col(xa, w9, b, relu=relu)
    (got,) = torch.autograd.grad(out, [xa], ct)
    xb = x.clone().requires_grad_()
    ref = conv_im2col._Im2colConv.apply(xb, w9, b, relu)
    (want,) = torch.autograd.grad(ref, [xb], ct)
    assert type(out.grad_fn).__name__ == "_Im2colConvBackward"
    assert torch.equal(out, ref) and torch.equal(got, want)
    assert out.dtype == got.dtype == torch.bfloat16
    assert launches == (conv_im2col.stem_forward.launches,
                        conv_im2col.stem_backward.launches)


def _bad_stem_forward(case):
    """Arguments of ``stem_forward`` with one fault, and the error it
    raises."""
    x, w9, b = _stem_inputs()
    return {
        "x_rank": ((x[0], w9, b), ValueError, "V, H, W, 3"),
        "x_channels": ((torch.zeros((2, 9, 11, 4), dtype=torch.bfloat16),
                        w9, b), ValueError, "V, H, W, 3"),
        "x_dtype": ((x.float(), w9, b), TypeError, "bfloat16"),
        "w9_shape": ((x, torch.zeros((27, 128), dtype=torch.bfloat16), b),
                     ValueError, "27, 64"),
        "w9_dtype": ((x, w9.float(), b), TypeError, "bfloat16"),
        "bias_shape": ((x, w9, b[:32]), ValueError, "64,"),
        "bias_dtype": ((x, w9, b.to(torch.bfloat16)), TypeError, "float32"),
        "cpu": ((x, w9, b), ValueError, "CUDA"),
        "cpu_no_bias": ((x, w9, None), ValueError, "CUDA"),
    }[case]


@pytest.mark.parametrize("case", ["x_rank", "x_channels", "x_dtype",
                                  "w9_shape", "w9_dtype", "bias_shape",
                                  "bias_dtype", "cpu", "cpu_no_bias"])
def test_stem_forward_refuses_bad_inputs(case):
    """``stem_forward`` checks shapes and channel counts (ValueError), then
    dtypes (TypeError), then that every tensor lies on one card
    (``kernels.require_cuda``): valid CPU tensors are refused too."""
    args, exc, match = _bad_stem_forward(case)
    before = conv_im2col.stem_forward.launches
    with pytest.raises(exc, match=match):
        conv_im2col.stem_forward(*args)
    assert conv_im2col.stem_forward.launches == before


def _bad_stem_backward(case):
    """Arguments of ``stem_backward`` with one fault, and the error it
    raises."""
    _, w9, _ = _stem_inputs()
    g = torch.zeros((2, 9, 11, 64), dtype=torch.bfloat16)
    return {
        "g_channels": ((g[..., :32], g, w9), ValueError, "V, H, W, 64"),
        "y_channels": ((g, g[..., :3], w9), ValueError, "V, H, W, 64"),
        "g_dtype": ((g.float(), g, w9), TypeError, "bfloat16"),
        "y_dtype": ((g, g.float(), w9), TypeError, "bfloat16"),
        "shapes_differ": ((g, g[:, :8], w9), ValueError, "vs y"),
        "w9_shape": ((g, g, w9[:9]), ValueError, "27, 64"),
        "cpu": ((g, g, w9), ValueError, "CUDA"),
    }[case]


@pytest.mark.parametrize("case", ["g_channels", "y_channels", "g_dtype",
                                  "y_dtype", "shapes_differ", "w9_shape",
                                  "cpu"])
def test_stem_backward_refuses_bad_inputs(case):
    """``stem_backward`` checks g and y (bf16 [V, H, W, 64] of one shape)
    and w9 as ``stem_forward`` does, then the device."""
    args, exc, match = _bad_stem_backward(case)
    before = conv_im2col.stem_backward.launches
    with pytest.raises(exc, match=match):
        conv_im2col.stem_backward(*args)
    assert conv_im2col.stem_backward.launches == before

