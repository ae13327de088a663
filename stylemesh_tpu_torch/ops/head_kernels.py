"""The VGG block tail ``maxpool2(relu(conv3x3 + b))`` fused: kernels K6, K7
and K8 (counterpart of ``stylemesh_tpu/ops/head_pallas.py``), and the route
kernel of the 128-channel tail's backward.

- :func:`conv_relu_pool` (K6): the pooled map only, the conv output never
  reaches device memory (``head_pallas.py::conv_relu_pool``, 64 and 128
  channels); with ``with_pre=True`` (K7) it also writes the pre-pool
  activation, the 128-channel backward's residual
  (``conv_relu_pool_dual``); with ``with_codes=True`` (64 channels) it also
  writes each pool window's route, the 64-channel backward's residual:
  per window and channel a 4-bit code, the pixel in raster order ((0,0),
  (0,1), (1,0), (1,1)) that takes the pooled cotangent, the first maximum
  that is > 0, or :data:`NO_ROUTE` (:func:`pool_codes_plain`).
- :func:`conv_relu_pool_bwd` (K8): the input gradient of the 64-channel
  form in one pass from those codes: the pooled cotangent routed by them,
  then the transposed conv (``conv_relu_pool_bwd``, which recomputes the
  relu output instead); optionally with the loss tap's cotangent of the
  input added in its epilogue, as autograd's bf16 sum would.
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
:func:`conv_kernels.pool_box`; K8 (``conv_pool_bwd.cu``) builds the routed
cotangent from the codes on a work item of :data:`BWD_TILE` plus one ring
of pixels and runs the transposed conv in K5's sum order, so it equals
``conv3x3(pool_route(relu output, g), w9t)`` bit for bit. The rule is one
device function (``kernels/csrc/pool_route.cuh``) for the codes and the
route kernel.
"""

import torch

from stylemesh_tpu_torch import kernels
from stylemesh_tpu_torch.ops import conv_kernels
from stylemesh_tpu_torch.ops.conv_kernels import check_conv, conv3x3_plain

# K8's work item (dx rows, cols), which the C entry checks: 16 m64 blocks
# of one row of 64 pixels, whose routed cotangent it builds row by row on
# the item plus one ring of pixels, 18 x 66
BWD_TILE = (16, 64)
# the code of a window and channel that routes nothing (every code is 0-3,
# the pixel that takes the cotangent, or this)
NO_ROUTE = 4


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
    quads = _quads(r)
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


def _quads(r):
    """The four pixels of each whole 2x2 window of ``r [V, H, W, C]`` in
    raster order, float32 ``[V, H // 2, W // 2, C]`` each."""
    v, h, w, c = r.shape
    h2, w2 = h // 2, w // 2
    q = r[:, :2 * h2, :2 * w2].reshape(v, h2, 2, w2, 2, c).float()
    return [q[:, :, 0, :, 0], q[:, :, 0, :, 1], q[:, :, 1, :, 0],
            q[:, :, 1, :, 1]]


def pool_codes_plain(r):
    """The route codes of the pre-pool map ``r [V, H, W, C]`` (C a multiple
    of 8): each window's and channel's code is the first pixel in raster
    order whose value is the window's maximum and > 0, or :data:`NO_ROUTE`
    (all four values <= 0, or a NaN among them), 4 bits a channel, eight
    channels a word: int32 ``[V, H // 2, W // 2, C // 8]``, channel
    ``8 j + k`` in bits ``[4 k, 4 k + 4)`` of word ``j``. Routing ``g`` by
    them (:func:`route_codes_plain`) is :func:`pool_route_plain`."""
    quads = _quads(r)
    top = torch.maximum(torch.maximum(quads[0], quads[1]),
                        torch.maximum(quads[2], quads[3]))
    code = torch.full(top.shape, NO_ROUTE, dtype=torch.int32, device=r.device)
    for e in (3, 2, 1, 0):  # the last set is the first maximum
        code = torch.where((quads[e] == top) & (quads[e] > 0), e, code)
    v, h2, w2, c = code.shape
    shifts = 4 * torch.arange(8, dtype=torch.int32, device=r.device)
    return (code.reshape(v, h2, w2, c // 8, 8) << shifts).sum(
        dim=-1, dtype=torch.int32)


def route_codes_plain(codes, g, hw):
    """The routed cotangent ``dr [V, H, W, C]`` in ``g``'s dtype, ``hw = (H,
    W)``: each window's cotangent ``g [V, H // 2, W // 2, C]`` to the pixel
    its code (:func:`pool_codes_plain`) names, 0 in every other element and
    in the odd tail."""
    v, h2, w2, c = g.shape
    h, w = hw
    shifts = 4 * torch.arange(8, dtype=torch.int32, device=codes.device)
    code = ((codes.unsqueeze(-1) >> shifts) & 0xF).reshape(v, h2, w2, c)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    dq = torch.stack([torch.where(code == e, g, zero) for e in range(4)],
                     dim=3).reshape(v, h2, w2, 2, 2, c)
    dr = torch.zeros((v, h, w, c), dtype=g.dtype, device=g.device)
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


def conv_relu_pool_plain(x, w9, bias, with_pre=False, with_codes=False):
    """Plain version of K6 (of K7 with ``with_pre``, of K6 with codes with
    ``with_codes``): K5's plain version with relu, then :func:`maxpool2` of
    the bf16 map (and :func:`pool_codes_plain` of it)."""
    pre = conv3x3_plain(x, w9, bias, relu=True)
    pooled = maxpool2(pre)
    if with_codes:
        return pooled, pool_codes_plain(pre)
    return (pooled, pre) if with_pre else pooled


def conv_relu_pool_bwd_plain(codes, g, w9_flipped, hw, tap=None):
    """Plain version of K8, the composed backward: route by the codes, conv
    with the flipped kernel, then the bf16 sum with ``tap``."""
    dx = conv3x3_plain(route_codes_plain(codes, g.to(torch.bfloat16), hw),
                       w9_flipped)
    return dx if tap is None else dx + tap


def conv_relu_pool(x, w9, bias, with_pre=False, with_codes=False):
    """K6 / K7: ``maxpool2(bf16(relu(conv3x3(x, w9) + bias)))`` and, with
    ``with_pre``, the pre-pool map too (returns ``(pooled, pre)``); with
    ``with_codes`` (K6 at 64 channels), each window's route codes too
    (returns ``(pooled, codes)``, the codes as :func:`pool_codes_plain`'s).
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. K6 launches count in ``conv_relu_pool.launches``, those with
    codes also in ``conv_relu_pool.switch_launches``, K7 launches in
    ``conv_relu_pool.dual_launches``."""
    if with_pre and with_codes:
        raise ValueError("K6 writes the codes, K7 the pre-pool map: not both")
    if x.device.type == "cpu":
        return conv_relu_pool_plain(x, w9, bias, with_pre, with_codes)
    check_conv(x, w9, bias)
    v, h, w, _ = x.shape
    cout = w9.shape[1]
    if conv_kernels.block_n(cout) not in (64, 128):
        raise ValueError(f"K6/K7 take K5's 64- or 128-wide N tile: Cout a "
                         f"multiple of 64 that 256 does not divide, got {cout}")
    if with_codes and cout != 64:
        raise ValueError(f"K6 writes route codes at 64 channels, got {cout}")
    pooled = torch.empty((v, h // 2, w // 2, cout), dtype=torch.bfloat16,
                         device=x.device)
    pre = (torch.empty((v, h, w, cout), dtype=torch.bfloat16, device=x.device)
           if with_pre else None)
    codes = (torch.empty((v, h // 2, w // 2, cout // 8), dtype=torch.int32,
                         device=x.device) if with_codes else None)
    launch_conv_relu_pool(x, w9, bias, pre, pooled, codes)
    if with_pre:
        conv_relu_pool.dual_launches += 1
        return pooled, pre
    conv_relu_pool.launches += 1
    if with_codes:
        conv_relu_pool.switch_launches += 1
        return pooled, codes
    return pooled


conv_relu_pool.launches = 0
conv_relu_pool.dual_launches = 0
conv_relu_pool.switch_launches = 0


def launch_conv_relu_pool(x, w9, bias, pre, pooled, codes=None):
    """The K6 (``pre`` None; with ``codes``, those too) or K7 launch into
    the given outputs, on K5's tile for Cout and a
    :func:`conv_kernels.pool_box` box. Counts nothing."""
    v, h, w, cin = x.shape
    cout = w9.shape[1]
    pixels = conv_kernels.tile_pixels(cout)
    box_h, box_w = conv_kernels.pool_box(h, w, pixels)
    kernels.launch("stylemesh_conv_relu_pool", x.device, x.data_ptr(),
                   w9.data_ptr(), None if bias is None else bias.data_ptr(),
                   None if pre is None else pre.data_ptr(), pooled.data_ptr(),
                   None if codes is None else codes.data_ptr(),
                   v, h, w, cin, cout, int(pre is not None), box_h, box_w,
                   conv_kernels.block_n(cout))


def conv_relu_pool_bwd(codes, g, w9_flipped, hw, tap=None):
    """K8: ``dx [V, H, W, 64]`` bf16 of :func:`conv_relu_pool` at 64
    channels, ``hw = (H, W)``, from its route codes ``codes [V, H // 2,
    W // 2, 8]`` and the pooled cotangent ``g [V, H // 2, W // 2, 64]``
    (cast to bf16); with ``tap`` (bf16, dx's shape), ``dx + tap`` rounded to
    bf16. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    if g.device.type == "cpu":
        return conv_relu_pool_bwd_plain(codes, g, w9_flipped, hw, tap)
    g = g.to(torch.bfloat16).contiguous()
    check_conv(g, w9_flipped, None)
    kernels.require_cuda(g, codes, dtype=None)
    v, h2, w2, c = g.shape
    h, w = hw
    if c != 64 or w9_flipped.shape[1] != 64:
        raise ValueError(f"K8 takes 64 -> 64 channels, got g {tuple(g.shape)}, "
                         f"w9_flipped {tuple(w9_flipped.shape)}")
    if (h // 2, w // 2) != (h2, w2):
        raise ValueError(f"g {tuple(g.shape)} vs dx {(v, h, w, c)}")
    if codes.dtype != torch.int32 or tuple(codes.shape) != (v, h2, w2, c // 8):
        raise ValueError(f"codes {codes.dtype} {tuple(codes.shape)} vs g "
                         f"{tuple(g.shape)}")
    if tap is not None:
        kernels.require_cuda(g, tap, dtype=torch.bfloat16)
        if tuple(tap.shape) != (v, h, w, c):
            raise ValueError(f"tap {tuple(tap.shape)} vs dx {(v, h, w, c)}")
    dx = torch.empty((v, h, w, c), dtype=torch.bfloat16, device=g.device)
    launch_conv_relu_pool_bwd(codes, g, w9_flipped, dx, tap=tap)
    conv_relu_pool_bwd.launches += 1
    return dx


conv_relu_pool_bwd.launches = 0


def launch_conv_relu_pool_bwd(codes, g, w9_flipped, dx, tile=BWD_TILE,
                              tap=None):
    """The K8 launch into ``dx`` (``tap`` added if given), on dx tiles of
    ``tile``. Counts nothing."""
    v, h, w, _ = dx.shape
    kernels.launch("stylemesh_conv_relu_pool_bwd", dx.device,
                   codes.data_ptr(), g.data_ptr(), w9_flipped.data_ptr(),
                   None if tap is None else tap.data_ptr(), dx.data_ptr(),
                   v, h, w, *tile)
