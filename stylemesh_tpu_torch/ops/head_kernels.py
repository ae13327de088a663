"""The VGG block tail ``maxpool2(relu(conv3x3 + b))`` fused: kernels K6, K7
and K8 (counterpart of ``stylemesh_tpu/ops/head_pallas.py``), and the route
kernel of the 128-channel tail's backward.

- :func:`conv_relu_pool` (K6): the pooled map only, the conv output never
  reaches device memory (``head_pallas.py::conv_relu_pool``, 64 and 128
  channels); with ``with_pre=True`` (K7) it also writes the pre-pool
  activation, the 128-channel backward's residual
  (``conv_relu_pool_dual``).
- :func:`conv_relu_pool_bwd` (K8): the input gradient of the 64-channel
  form in one pass: conv + relu recomputed on the tile with the forward's
  arithmetic, the pooled cotangent routed to the first maximum of each 2x2
  window (raster order) where the activation is > 0, then the transposed
  conv (``conv_relu_pool_bwd``); optionally with the loss tap's cotangent
  of the input added in its epilogue, as autograd's bf16 sum would.
- :func:`pool_route`: the 128-channel form's backward before K5, the same
  routing from K7's saved pre-pool map, one pass (the TPU path's pool VJP,
  ``models/vgg.py::_maxpool2_bwd``, has no kernel).

Numerics are K5's (``ops/conv_kernels.py``): float32 sums, float32 bias,
relu, one bf16 rounding, and the pool takes the maximum of the bf16 values.
The pooled map is ``[V, H // 2, W // 2, C]``; an odd tail row or column is a
conv halo only. The TPU kernels' width packing, lane-duplicated cotangent
and tile heuristics are not carried over.

The kernels run on K5's ``wgmma`` + TMA core (``kernels/csrc/conv_core.cuh``)
at K5's output-channel tile (:func:`conv_kernels.block_n`), so K6's and
K7's pre-pool values are K5's relu output bit for bit: K6/K7 are K5's
kernel with a pool epilogue (``conv_gemm.cu``), on a pixel box of
:func:`conv_kernels.pool_box`; K8 (``conv_pool_bwd.cu``) recomputes the
relu output on a dx tile of :data:`BWD_TILE` plus one ring of pool windows
and runs the transposed conv in K5's sum order, so it
equals ``conv3x3(pool_route(relu output, g), w9t)`` bit for bit.
"""

import torch

from stylemesh_tpu_torch import kernels
from stylemesh_tpu_torch.ops import conv_kernels
from stylemesh_tpu_torch.ops.conv_kernels import check_conv, conv3x3_plain

# K8's dx tile (rows, cols), which the C entry checks: it recomputes the
# relu output on the tile plus one ring of pool windows, 28 x 36 pixels,
# 1.3125 per dx pixel
BWD_TILE = (24, 32)


def maxpool2(x):
    """2x2 / 2 max pool of channel-last ``[V, H, W, C]`` (floor sizes)."""
    v, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    return x[:, :2 * h2, :2 * w2].reshape(v, h2, 2, w2, 2, c).amax(dim=(2, 4))


def pool_route_plain(r, g):
    """The backward of ``maxpool2`` and of the relu before it, from the
    relu output ``r [V, H, W, C]``: each window's cotangent ``g`` goes to its
    first maximum in raster order ((0,0), (0,1), (1,0), (1,1)) where that
    value is > 0; every other element, and the odd tail, gets 0. Returns
    ``dr`` in ``r``'s dtype."""
    v, h, w, c = r.shape
    h2, w2 = h // 2, w // 2
    q = r[:, :2 * h2, :2 * w2].reshape(v, h2, 2, w2, 2, c).float()
    quads = [q[:, :, 0, :, 0], q[:, :, 0, :, 1], q[:, :, 1, :, 0],
             q[:, :, 1, :, 1]]
    top = torch.maximum(torch.maximum(quads[0], quads[1]),
                        torch.maximum(quads[2], quads[3]))
    g = g.to(r.dtype)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    taken = torch.zeros_like(top, dtype=torch.bool)
    routed = []
    for t in quads:
        m = (t == top) & (t > 0) & ~taken
        taken = taken | m
        routed.append(torch.where(m, g, zero))
    dq = torch.stack(routed, dim=3).reshape(v, h2, w2, 2, 2, c)
    dr = torch.zeros_like(r)
    dr[:, :2 * h2, :2 * w2] = dq.permute(0, 1, 3, 2, 4, 5).reshape(
        v, 2 * h2, 2 * w2, c)
    return dr


def pool_route(r, g):
    """:func:`pool_route_plain`'s ``dr``: CPU tensors take the plain
    version; CUDA tensors launch the route kernel (one pass, bf16 ``r``, C a
    multiple of 8; ``conv_pool_bwd.cu``), equal to it bit for bit, or raise.
    Launches count in ``pool_route.launches``."""
    if r.device.type == "cpu":
        return pool_route_plain(r, g)
    g = g.to(torch.bfloat16).contiguous()
    kernels.require_cuda(r, g, dtype=torch.bfloat16)
    v, h, w, c = r.shape
    if c % 8:
        raise ValueError(f"the route kernel takes C a multiple of 8, got {c}")
    if tuple(g.shape) != (v, h // 2, w // 2, c):
        raise ValueError(f"g {tuple(g.shape)} vs r {tuple(r.shape)}")
    dr = torch.empty_like(r)
    kernels.launch("stylemesh_pool_route", r.device, r.data_ptr(),
                   g.data_ptr(), dr.data_ptr(), v, h, w, c)
    pool_route.launches += 1
    return dr


pool_route.launches = 0


def conv_relu_pool_plain(x, w9, bias, with_pre=False):
    """Plain version of K6 (and of K7 with ``with_pre``): K5's plain version
    with relu, then :func:`maxpool2` of the bf16 map."""
    pre = conv3x3_plain(x, w9, bias, relu=True)
    pooled = maxpool2(pre)
    return (pooled, pre) if with_pre else pooled


def conv_relu_pool_bwd_plain(x, w9, w9_flipped, bias, g, tap=None):
    """Plain version of K8, the composed backward: recompute, route, conv
    with the flipped kernel, then the bf16 sum with ``tap``."""
    r = conv3x3_plain(x, w9, bias, relu=True)
    dx = conv3x3_plain(pool_route_plain(r, g), w9_flipped)
    return dx if tap is None else dx + tap


def conv_relu_pool(x, w9, bias, with_pre=False):
    """K6 / K7: ``maxpool2(bf16(relu(conv3x3(x, w9) + bias)))`` and, with
    ``with_pre``, the pre-pool map too (returns ``(pooled, pre)``). CPU
    tensors take the plain version; CUDA tensors launch the kernel or raise.
    K6 launches count in ``conv_relu_pool.launches``, K7 launches in
    ``conv_relu_pool.dual_launches``."""
    if x.device.type == "cpu":
        return conv_relu_pool_plain(x, w9, bias, with_pre)
    check_conv(x, w9, bias)
    v, h, w, _ = x.shape
    cout = w9.shape[1]
    if conv_kernels.block_n(cout) not in (64, 128):
        raise ValueError(f"K6/K7 take K5's 64- or 128-wide N tile: Cout a "
                         f"multiple of 64 that 256 does not divide, got {cout}")
    pooled = torch.empty((v, h // 2, w // 2, cout), dtype=torch.bfloat16,
                         device=x.device)
    pre = (torch.empty((v, h, w, cout), dtype=torch.bfloat16, device=x.device)
           if with_pre else None)
    launch_conv_relu_pool(x, w9, bias, pre, pooled)
    if with_pre:
        conv_relu_pool.dual_launches += 1
        return pooled, pre
    conv_relu_pool.launches += 1
    return pooled


conv_relu_pool.launches = 0
conv_relu_pool.dual_launches = 0


def launch_conv_relu_pool(x, w9, bias, pre, pooled):
    """The K6 (``pre`` None) or K7 launch into the given outputs, on K5's
    tile for Cout and a :func:`conv_kernels.pool_box` box. Counts
    nothing."""
    v, h, w, cin = x.shape
    cout = w9.shape[1]
    pixels = conv_kernels.tile_pixels(cout)
    box_h, box_w = conv_kernels.pool_box(h, w, pixels)
    kernels.launch("stylemesh_conv_relu_pool", x.device, x.data_ptr(),
                   w9.data_ptr(), None if bias is None else bias.data_ptr(),
                   None if pre is None else pre.data_ptr(), pooled.data_ptr(),
                   v, h, w, cin, cout, int(pre is not None), box_h, box_w,
                   conv_kernels.block_n(cout))


def conv_relu_pool_bwd(x, w9, w9_flipped, bias, g, tap=None):
    """K8: ``dx [V, H, W, 64]`` bf16 of :func:`conv_relu_pool` at 64
    channels for the pooled cotangent ``g [V, H // 2, W // 2, 64]`` (cast to
    bf16); with ``tap`` (bf16, x's shape), ``dx + tap`` rounded to bf16.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if x.device.type == "cpu":
        return conv_relu_pool_bwd_plain(x, w9, w9_flipped, bias, g, tap)
    g = g.to(torch.bfloat16).contiguous()
    check_conv(x, w9, bias)
    check_conv(g, w9_flipped, None)
    v, h, w, c = x.shape
    if c != 64 or w9.shape[1] != 64 or bias is None:
        raise ValueError(f"K8 takes 64 -> 64 channels with a bias, got x "
                         f"{tuple(x.shape)}, w9 {tuple(w9.shape)}")
    if tuple(g.shape) != (v, h // 2, w // 2, c):
        raise ValueError(f"g {tuple(g.shape)} vs x {tuple(x.shape)}")
    if tap is not None:
        kernels.require_cuda(x, tap, dtype=torch.bfloat16)
        if tap.shape != x.shape:
            raise ValueError(f"tap {tuple(tap.shape)} vs x {tuple(x.shape)}")
    dx = torch.empty_like(x)
    launch_conv_relu_pool_bwd(x, w9, w9_flipped, bias, g, dx, tap=tap)
    conv_relu_pool_bwd.launches += 1
    return dx


conv_relu_pool_bwd.launches = 0


def launch_conv_relu_pool_bwd(x, w9, w9_flipped, bias, g, dx, tile=BWD_TILE,
                              tap=None):
    """The K8 launch into ``dx`` (``tap`` added if given), on dx tiles of
    ``tile``. Counts nothing."""
    v, h, w, _ = x.shape
    kernels.launch("stylemesh_conv_relu_pool_bwd", x.device, x.data_ptr(),
                   w9.data_ptr(), w9_flipped.data_ptr(), bias.data_ptr(),
                   g.data_ptr(), None if tap is None else tap.data_ptr(),
                   dx.data_ptr(), v, h, w, *tile)
