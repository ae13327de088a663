"""The hand-written kernels against their plain versions on a CUDA card, at
edge shapes the main path does not reach (one mask, ragged pixel counts,
one to eight texture layers, all-zero cotangents).

Needs a Hopper card (the kernels are built for sm_90a); skips elsewhere.
On the card, without JAX installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerances, relative to the plain output's largest value: sampling 1e-5
(float32, fused multiply-adds; 1e-6 in the bf16 mode, whose products of
bf16 values are exact and whose other operations are unfused), splat 1e-5
(float32 atomics order), Gram sums 1e-4 (float32 sums in another order;
exactly symmetric and equal from run to run on the card),
Gram gradient two bf16 ulps; the trunk's convs K5-K9 1e-2 (about two bf16
ulps: float32 sums in another order, then one rounding). Between the
kernels themselves, bit for bit (one wgmma core, one mainloop, K5's N
tile): K9 is K5 without bias and relu (one entry); K6 is maxpool2 of K5's
relu output, K7's pre-pool map is K5's relu output and its pooled map
K6's; K8 is K5 with the flipped kernel on ``pool_route`` of K5's relu
output.
"""

import pytest
import torch

from stylemesh_tpu_torch import kernels
from stylemesh_tpu_torch.ops import conv_kernels, gram_kernels, head_kernels
from stylemesh_tpu_torch.ops import grid_sample as gs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels are built for sm_90a")
    return torch.device("cuda")


def _close(got, want, rel):
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if w.numel() == 0:
            continue
        scale = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("n_layers,size", [(1, (5, 7)), (3, (64, 96)),
                                           (8, (512, 512))])
def test_gather_and_splat(cuda, n_layers, size):
    gen = torch.Generator(device=cuda).manual_seed(n_layers)
    grid = torch.rand((2, 13, 17, 2), generator=gen, device=cuda) * 2.4 - 1.2
    grid[:, :3, :3] = -1.0  # background pixels
    layers = [torch.randn((max(size[0] >> l, 1), max(size[1] >> l, 1), 3),
                          generator=gen, device=cuda) * 50
              for l in range(n_layers)]
    _close(gs.gather_layers(layers, grid), gs.gather_layers_plain(layers, grid),
           1e-5)
    g = torch.randn((2, 13, 17, 3), generator=gen, device=cuda)
    g[:, 5:] = 0.0  # skipped pixels
    shapes = [tuple(l.shape[:2]) for l in layers]
    _close(gs.splat_layers(g, grid, shapes),
           gs.splat_layers_plain(g, grid, shapes), 1e-5)
    zero = gs.splat_layers(torch.zeros_like(g), grid, shapes)
    assert all(z.abs().max().item() == 0.0 for z in zero)


@pytest.mark.parametrize("n_layers,size", [(1, (5, 7)), (4, (257, 129)),
                                           (8, (512, 512))])
def test_gather_and_splat_bf16_mode(cuda, n_layers, size):
    """K1/K2's bf16 mode: the same roundings as the plain versions (gather
    within 1e-6, splat 1e-5 for the atomics' order), background pixels at
    (-1, -1) exact float32, and an odd pixel count."""
    gen = torch.Generator(device=cuda).manual_seed(10 + n_layers)
    grid = torch.rand((3, 19, 23, 2), generator=gen, device=cuda) * 2.4 - 1.2
    grid[:, :3, :4] = -1.0  # background pixels
    layers = [torch.randn((max(size[0] >> l, 1), max(size[1] >> l, 1), 3),
                          generator=gen, device=cuda) * 50
              for l in range(n_layers)]
    got = gs.gather_layers(layers, grid, "bf16")
    want = gs.gather_layers_plain_bf16(layers, grid)
    _close(got, want, 1e-6)
    exact = gs.gather_layers_plain(layers, grid)
    assert torch.equal(got[:, :3, :4], exact[:, :3, :4])
    assert (got - exact).abs().max().item() > 0.0  # the mode rounds
    g = torch.randn((3, 19, 23, 3), generator=gen, device=cuda)
    g[:, 7:] = 0.0  # skipped pixels
    shapes = [tuple(l.shape[:2]) for l in layers]
    _close(gs.splat_layers(g, grid, shapes, "bf16"),
           gs.splat_layers_plain_bf16(g, grid, shapes), 1e-5)
    # only background pixels: their gradient lands on texel (0, 0) unrounded
    g_bg = torch.zeros_like(g)
    g_bg[:, :3, :4] = g[:, :3, :4]
    for d in gs.splat_layers(g_bg, grid, shapes, "bf16"):
        torch.testing.assert_close(d[0, 0], g_bg.sum(dim=(0, 1, 2)),
                                   rtol=1e-6, atol=1e-5)
        assert d.abs().sum().item() == pytest.approx(
            d[0, 0].abs().sum().item())


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("size,d,n_layers", [((48, 37), 3, 3),
                                             ((64, 129), 4, 4),
                                             ((16, 5), 16, 1),
                                             ((40, 23), 5, 2)])
def test_banded_gather_and_splat(cuda, compute, size, d, n_layers):
    """The banded K1/K2 at odd widths, D not a power of 2 and bands of one
    row: each band against its plain version (gather 1e-5, splat 1e-5 for
    the atomics' order); the bands' partials summed against the unbanded
    kernel, the bands' gradients stacked against the unbanded splat (1e-5);
    a grid of background pixels only reads and writes texel (0, 0) in
    band 0 alone."""
    gen = torch.Generator(device=cuda).manual_seed(sum(size) + d + n_layers)
    grid = torch.rand((2, 11, 19, 2), generator=gen, device=cuda) * 2.4 - 1.2
    grid[:, :2, :3] = -1.0
    layers = [torch.randn((size[0] >> l, size[1] >> l, 3), generator=gen,
                          device=cuda) * 50 for l in range(n_layers)]
    heights = [l.shape[0] for l in layers]
    g = torch.randn((2, 11, 19, 3), generator=gen, device=cuda)
    g[:, 6:] = 0.0
    bg_grid = torch.full_like(grid, -1.0)
    total, parts = 0, [[] for _ in layers]
    for b in range(d):
        row0s = [b * h // d for h in heights]
        bands = [l[r:r + h // d].clone()  # own, aligned allocations
                 for l, r, h in zip(layers, row0s, heights)]
        shapes = [tuple(x.shape[:2]) for x in bands]
        got = gs.gather_layers_banded(bands, grid, row0s, heights, compute)
        _close(got, gs.gather_layers_banded_plain(bands, grid, row0s, heights,
                                                  compute), 1e-5)
        total = total + got
        grads = gs.splat_layers_banded(g, grid, shapes, row0s, heights, compute)
        _close(grads, gs.splat_layers_banded_plain(g, grid, shapes, row0s,
                                                   heights, compute), 1e-5)
        for acc, x in zip(parts, grads):
            acc.append(x)
        out_bg = gs.gather_layers_banded(bands, bg_grid, row0s, heights,
                                         compute)
        grads_bg = gs.splat_layers_banded(g, bg_grid, shapes, row0s, heights,
                                          compute)
        if b == 0:
            assert torch.equal(out_bg[0, 0, 0], sum(x[0, 0] for x in bands))
            for x in grads_bg:
                assert x.abs().sum().item() == pytest.approx(
                    x[0, 0].abs().sum().item())
        else:
            assert out_bg.abs().max().item() == 0.0
            assert all(x.abs().max().item() == 0.0 for x in grads_bg)
    _close(total, gs.gather_layers(layers, grid, compute), 1e-5)
    full = gs.splat_layers(g, grid, [tuple(l.shape[:2]) for l in layers],
                           compute)
    _close([torch.cat(p) for p in parts], full, 1e-5)


def test_sampling_autograd_matches_cpu(cuda):
    gen = torch.Generator().manual_seed(0)
    layers = [torch.randn((32 >> l, 48 >> l, 3), generator=gen) for l in range(3)]
    grid = torch.rand((2, 9, 11, 2), generator=gen) * 2 - 1
    ct = torch.randn((2, 9, 11, 3), generator=gen)
    results = []
    for device in ("cpu", cuda):
        ls = [l.to(device).requires_grad_() for l in layers]
        out = gs.sample_layers(ls, grid.to(device))
        grads = torch.autograd.grad(out, ls, ct.to(device))
        results.append([out.cpu()] + [x.cpu() for x in grads])
    _close(results[1], results[0], 1e-5)


# C = 192 and 320 take 64-wide column groups, as C = 64 does
@pytest.mark.parametrize("c,k,p", [(64, 1, 1000), (128, 2, 4097),
                                   (256, 2, 33), (64, 2, 100003),
                                   (512, 1, 336), (512, 2, 336),
                                   (512, 1, 3185), (512, 2, 3185),
                                   (512, 1, 12740), (512, 2, 12740),
                                   (192, 1, 3000), (192, 2, 1000),
                                   (320, 2, 777)])
def test_masked_gram_sums_and_grad(cuda, c, k, p):
    gen = torch.Generator(device=cuda).manual_seed(c + k + p)
    f = torch.randn((3, p, c), generator=gen, device=cuda).to(torch.bfloat16)
    m = (torch.rand((3, k, p), generator=gen, device=cuda) < 0.5).to(torch.bfloat16)
    m[1] = 0.0  # empty masks: zero Grams, zero gradient rows
    m[0, :, 64:320] = 0.0  # every mask zero over whole pixel tiles
    m[2, 0, :256] = 0.0    # one mask zero where the other is not
    sums = gram_kernels.masked_gram_sums(f, m)
    _close(sums, gram_kernels.masked_gram_sums_plain(f, m), 1e-4)
    assert not sums[1].any()
    assert torch.equal(sums, sums.transpose(-1, -2))  # exactly symmetric
    assert torch.equal(sums, gram_kernels.masked_gram_sums(f, m))  # deterministic
    dg = torch.randn((3, k, c, c), generator=gen, device=cuda)
    s = dg + dg.transpose(-1, -2)
    df = gram_kernels.masked_gram_sums_grad(f, m, s)
    _close(df, gram_kernels.masked_gram_sums_grad_plain(f, m, s), 2 ** -7)
    assert not df[1].any()
    assert not df[0, 64:320].any()


def test_wrappers_refuse_bad_inputs(cuda):
    grid = torch.zeros((1, 4, 4, 2), device=cuda)
    with pytest.raises(TypeError):
        gs.gather_layers([torch.zeros((8, 8, 3), device=cuda,
                                      dtype=torch.float64)], grid)
    with pytest.raises(ValueError):
        gs.gather_layers([torch.zeros((8, 8, 3), device=cuda)] * 9, grid)
    f = torch.zeros((1, 16, 48), dtype=torch.bfloat16, device=cuda)
    m = torch.zeros((1, 1, 16), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 64"):
        gram_kernels.masked_gram_sums(f, m)


TRUNK_PAIRS = [(64, 64), (64, 128), (128, 64), (128, 128), (128, 256),
               (256, 128), (256, 256), (256, 512), (512, 256), (512, 512)]
EDGE_SHAPES = [(1, 1, 1), (1, 2, 3), (3, 1, 17), (2, 3, 2), (1, 17, 33),
               (2, 20, 37)]


def _conv_inputs(cuda, v, h, w, cin, cout, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed + cin + cout + h + w)
    x = torch.randn((v, h, w, cin), generator=gen, device=cuda).to(torch.bfloat16)
    weight = torch.randn((cout, cin, 3, 3), generator=gen, device=cuda)
    weight = weight * (2.0 / (9 * cin)) ** 0.5
    b = torch.randn((cout,), generator=gen, device=cuda) * 0.05
    return (x, conv_kernels.w9_from_oihw(weight),
            conv_kernels.flipped_w9_from_oihw(weight), b)


@pytest.mark.parametrize("cin,cout", TRUNK_PAIRS)
def test_conv3x3_trunk_pairs(cuda, cin, cout):
    x, w9, _, b = _conv_inputs(cuda, 2, 23, 29, cin, cout)
    for relu in (True, False):
        _close(conv_kernels.conv3x3(x, w9, b, relu),
               conv_kernels.conv3x3_plain(x, w9, b, relu), 1e-2)
    _close(conv_kernels.conv3x3(x, w9), conv_kernels.conv3x3_plain(x, w9), 1e-2)


@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_conv3x3_edge_shapes(cuda, shape):
    x, w9, _, b = _conv_inputs(cuda, *shape, 128, 64)
    _close(conv_kernels.conv3x3(x, w9, b, True),
           conv_kernels.conv3x3_plain(x, w9, b, True), 1e-2)


# the edge shapes, odd H and W at V = 3, and the largest bench level
POOL_SHAPES = EDGE_SHAPES + [(3, 33, 57), (1, 784, 1045)]


def _close_but(got, want, rel, share):
    """As _close, but up to ``share`` of the elements may lie beyond the
    tolerance (a pool tie broken the other way by a sum rounded apart)."""
    scale = want.float().abs().max().item()
    beyond = ((got.float() - want.float()).abs() > rel * scale).float()
    assert beyond.mean().item() <= share


@pytest.mark.parametrize("c", [64, 128])
@pytest.mark.parametrize("shape", POOL_SHAPES)
def test_conv_relu_pool_is_pool_of_k5(cuda, c, shape):
    """K6 equals maxpool2 of K5's relu output, K7's pre-pool map equals
    K5's relu output and its pooled map K6's, bit for bit (one core, K5's
    N tile, only the pixel box differs); both within 1e-2 of the plain
    version."""
    x, w9, _, b = _conv_inputs(cuda, *shape, c, c)
    y = conv_kernels.conv3x3(x, w9, b, True)
    pooled = head_kernels.conv_relu_pool(x, w9, b)
    dual, pre = head_kernels.conv_relu_pool(x, w9, b, with_pre=True)
    assert torch.equal(pooled, head_kernels.maxpool2(y))
    assert torch.equal(pre, y)
    assert torch.equal(dual, pooled)
    _close(pooled, head_kernels.conv_relu_pool_plain(x, w9, b), 1e-2)


@pytest.mark.parametrize("shape", POOL_SHAPES + [(4, 33, 57)])
def test_conv_relu_pool_bwd(cuda, shape):
    """K8 equals the backward composed from K5's relu output (the same
    routing) and K5 with the flipped kernel, bit for bit: it recomputes
    the relu output and runs the transposed conv in K5's sum order. Against
    its plain version within 1e-2, where up to 2e-3 of the elements may
    differ more (a tie in a pool window broken the other way by a sum
    rounded apart)."""
    x, w9, w9t, b = _conv_inputs(cuda, *shape, 64, 64)
    v, h, w = shape
    gen = torch.Generator(device=cuda).manual_seed(h * w)
    g = torch.randn((v, h // 2, w // 2, 64), generator=gen,
                    device=cuda).to(torch.bfloat16)
    got = head_kernels.conv_relu_pool_bwd(x, w9, w9t, b, g)
    y = conv_kernels.conv3x3(x, w9, b, True)
    composed = conv_kernels.conv3x3(head_kernels.pool_route(y, g), w9t)
    assert torch.equal(got, composed)
    if h >= 2 and w >= 2:
        _close_but(got, head_kernels.conv_relu_pool_bwd_plain(x, w9, w9t, b, g),
                   1e-2, 2e-3)


@pytest.mark.parametrize("shape", [(2, 30, 70), (3, 25, 33)])
def test_conv_relu_pool_bwd_ties(cuda, shape):
    """Many pool windows with equal maxima: x in {0, 1}, the weights in
    {0, 1/2}, the bias a multiple of 1/2 and g in {-1, 1, 2}, so every sum
    is exact in float32 in any order. K8 must route each window to its
    first maximum in raster order as the plain version does: equal bit for
    bit, with ties in over a tenth of the live windows."""
    v, h, w = shape
    gen = torch.Generator(device=cuda).manual_seed(h + w)
    x = (torch.rand((v, h, w, 64), generator=gen, device=cuda) < 0.3)
    x = x.to(torch.bfloat16)
    weight = (torch.rand((64, 64, 3, 3), generator=gen, device=cuda) < 0.1)
    weight = weight.float() / 2
    b = torch.randint(-12, 2, (64,), generator=gen, device=cuda).float() / 2
    w9 = conv_kernels.w9_from_oihw(weight)
    w9t = conv_kernels.flipped_w9_from_oihw(weight)
    g = torch.tensor([-1.0, 1.0, 2.0], device=cuda)[torch.randint(
        0, 3, (v, h // 2, w // 2, 64), generator=gen, device=cuda)]
    g = g.to(torch.bfloat16)
    y = conv_kernels.conv3x3(x, w9, b, True)
    assert torch.equal(y, conv_kernels.conv3x3_plain(x, w9, b, True))
    q = y[:, :h // 2 * 2, :w // 2 * 2].float().reshape(
        v, h // 2, 2, w // 2, 2, 64)
    top = q.amax(dim=(2, 4), keepdim=True)
    live = top > 0
    ties = ((q == top) & live).sum(dim=(2, 4)) >= 2
    assert ties.sum().item() > 0.1 * live.sum().item()
    got = head_kernels.conv_relu_pool_bwd(x, w9, w9t, b, g)
    assert torch.equal(got, head_kernels.conv_relu_pool_bwd_plain(
        x, w9, w9t, b, g))


def _canary(cuda, shape, guard=4096):
    """A NaN-filled bf16 buffer with ``guard`` elements before and after a
    view of ``shape``; returns (buffer, view)."""
    n = 1
    for d in shape:
        n *= d
    buf = torch.full((n + 2 * guard,), float("nan"), dtype=torch.bfloat16,
                     device=cuda)
    return buf, buf[guard:guard + n].view(shape)


def _guards_intact(buf, view, guard=4096):
    torch.cuda.synchronize()
    assert torch.isnan(buf[:guard]).all()
    assert torch.isnan(buf[guard + view.numel():]).all()
    assert torch.isfinite(view).all()


@pytest.mark.parametrize("shape", [(1, 3, 31), (2, 9, 65), (1, 17, 261),
                                   (3, 2, 130)])
@pytest.mark.parametrize("c", [64, 128])
def test_conv_relu_pool_writes_only_its_output(cuda, shape, c):
    """A canary around K6's pooled map and K7's two outputs: every element
    written (finite, equal to the wrapper's), nothing outside, so no window
    past the floor of H / 2 or W / 2 and no ragged tile stores out of
    bounds."""
    v, h, w = shape
    x, w9, _, b = _conv_inputs(cuda, v, h, w, c, c, seed=3)
    want_pooled, want_pre = head_kernels.conv_relu_pool(x, w9, b, with_pre=True)
    pbuf, pooled = _canary(cuda, (v, h // 2, w // 2, c))
    head_kernels.launch_conv_relu_pool(x, w9, b, None, pooled)
    _guards_intact(pbuf, pooled)
    assert torch.equal(pooled, want_pooled)
    pbuf, pooled = _canary(cuda, (v, h // 2, w // 2, c))
    ybuf, pre = _canary(cuda, (v, h, w, c))
    head_kernels.launch_conv_relu_pool(x, w9, b, pre, pooled)
    _guards_intact(pbuf, pooled)
    _guards_intact(ybuf, pre)
    assert torch.equal(pooled, want_pooled) and torch.equal(pre, want_pre)


@pytest.mark.parametrize("shape", [(1, 1, 31), (2, 9, 65), (1, 25, 33),
                                   (3, 2, 130), (1, 49, 97)])
def test_conv_relu_pool_bwd_writes_only_its_output(cuda, shape):
    """A canary around K8's dx: every element written, nothing outside (the
    dx tile's stores are clipped at the map's edge)."""
    v, h, w = shape
    x, w9, w9t, b = _conv_inputs(cuda, v, h, w, 64, 64, seed=4)
    g = torch.randn((v, h // 2, w // 2, 64), device=cuda).to(torch.bfloat16)
    buf, dx = _canary(cuda, (v, h, w, 64))
    head_kernels.launch_conv_relu_pool_bwd(x, w9, w9t, b, g, dx)
    _guards_intact(buf, dx)
    assert torch.equal(dx, head_kernels.conv_relu_pool_bwd(x, w9, w9t, b, g))


def test_block_tails_refuse_bad_tiles(cuda):
    """The block-tail entries take K5's tile for Cout with a box 8, 16 or 32
    pixels wide (K6/K7) and K8's own dx tile; they refuse any other."""
    x, w9, w9t, b = _conv_inputs(cuda, 1, 8, 8, 64, 128)
    y = torch.empty((1, 8, 8, 128), dtype=torch.bfloat16, device=cuda)
    p = torch.empty((1, 4, 4, 128), dtype=torch.bfloat16, device=cuda)
    for box_h, box_w, bn in ((4, 64, 128), (8, 16, 128), (16, 16, 96),
                             (8, 32, 256), (64, 4, 128)):
        with pytest.raises(RuntimeError, match="failed"):
            kernels.launch("stylemesh_conv_relu_pool", x.device, x.data_ptr(),
                           w9.data_ptr(), b.data_ptr(), y.data_ptr(),
                           p.data_ptr(), 1, 8, 8, 64, 128, 1, box_h, box_w, bn)
    x, w9, w9t, b = _conv_inputs(cuda, 1, 8, 8, 64, 64)
    g = torch.zeros((1, 4, 4, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(RuntimeError, match="failed"):
        head_kernels.launch_conv_relu_pool_bwd(x, w9, w9t, b, g,
                                               torch.empty_like(x), (16, 32))


def test_conv_wrappers_refuse_bad_inputs(cuda):
    x, w9, w9t, b = _conv_inputs(cuda, 1, 8, 8, 128, 128)
    with pytest.raises(ValueError, match="multiple"):
        conv_kernels.conv3x3(x[..., :48].contiguous(), w9[:9 * 48].contiguous())
    with pytest.raises(ValueError):
        conv_kernels.conv3x3(x, w9[:9 * 64].contiguous())
    with pytest.raises(TypeError):
        conv_kernels.conv3x3(x.float(), w9)
    g = torch.zeros((1, 4, 4, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="64"):
        head_kernels.conv_relu_pool_bwd(x, w9, w9t, b, g)
    x, w9, _, b = _conv_inputs(cuda, 1, 8, 8, 64, 256)
    with pytest.raises(ValueError, match="Cout"):
        head_kernels.conv_relu_pool(x, w9, b)


@pytest.mark.parametrize("cin,cout", [(64, 64), (64, 128), (128, 256),
                                      (256, 512), (512, 512), (128, 64)])
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_conv3x3_mxu(cuda, cin, cout, shape):
    """K9 (K5's entry without bias and relu, its own launch count) at sizes
    1-3 and odd widths: bit for bit K5 with ``bias=None, relu=False``, within
    1e-2 of its plain version; ``_ConvFrozen``'s input gradient is K9 with
    the flipped kernel and the weights get none."""
    x, w9, w9t, _ = _conv_inputs(cuda, *shape, cin, cout)
    k5_before = conv_kernels.conv3x3.launches
    before = conv_kernels.conv3x3_mxu.launches
    y = conv_kernels.conv3x3_mxu(x, w9)
    assert conv_kernels.conv3x3_mxu.launches == before + 1
    assert torch.equal(y, conv_kernels.conv3x3(x, w9))
    assert conv_kernels.conv3x3.launches == k5_before + 1
    _close(y, conv_kernels.conv3x3_mxu_plain(x, w9), 1e-2)
    xt = x.clone().requires_grad_()
    out = conv_kernels._ConvFrozen.apply(xt, w9, w9t)
    g = torch.randn(out.shape, device=cuda).to(torch.bfloat16)
    (dx,) = torch.autograd.grad(out, [xt], g)
    assert torch.equal(out, y)
    assert torch.equal(dx, conv_kernels.conv3x3_mxu(g, w9t))
    _close(dx, conv_kernels.conv3x3_mxu_plain(g, w9t), 1e-2)


# widths on either side of the pixel boxes' edges (8 to 128 columns) and of
# the widest bench map (261); one row; several images
TILING_SHAPES = [(1, 5, 31), (2, 3, 33), (1, 9, 65), (1, 4, 130), (2, 1, 129),
                 (1, 1, 261), (1, 7, 261), (3, 2, 8), (1, 17, 7)]


@pytest.mark.parametrize("shape", TILING_SHAPES)
@pytest.mark.parametrize("cin,cout", [(64, 128), (256, 64), (128, 256),
                                      (512, 512)])
def test_conv3x3_tiling(cuda, shape, cin, cout):
    """K5 across the box and N-tile choices: forward with bias and relu,
    and as an input gradient (no bias, relu off) down to Cout = 64 and up
    to 512, within 1e-2 of the plain version."""
    x, w9, _, b = _conv_inputs(cuda, *shape, cin, cout, seed=1)
    _close(conv_kernels.conv3x3(x, w9, b, True),
           conv_kernels.conv3x3_plain(x, w9, b, True), 1e-2)
    _close(conv_kernels.conv3x3(x, w9), conv_kernels.conv3x3_plain(x, w9), 1e-2)


@pytest.mark.parametrize("shape", [(1, 1, 31), (2, 9, 65), (1, 17, 261),
                                   (3, 2, 130)])
@pytest.mark.parametrize("cout", [64, 512])
def test_conv3x3_writes_only_its_output(cuda, shape, cout):
    """A canary: the output lies inside a NaN-filled buffer with a guard
    before and after it; the kernel writes every output element (all
    finite, equal to K5's) and nothing outside, so a ragged tile stores no
    pixel out of bounds."""
    v, h, w = shape
    x, w9, _, b = _conv_inputs(cuda, v, h, w, 128, cout, seed=2)
    guard = 4096
    n = v * h * w * cout
    buf = torch.full((n + 2 * guard,), float("nan"), dtype=torch.bfloat16,
                     device=cuda)
    y = buf[guard:guard + n].view(v, h, w, cout)
    box_h, box_w = conv_kernels.pixel_box(h, w, conv_kernels.tile_pixels(cout))
    kernels.launch("stylemesh_conv3x3", x.device, x.data_ptr(), w9.data_ptr(),
                   b.data_ptr(), y.data_ptr(), v, h, w, 128, cout, 1, box_h,
                   box_w, conv_kernels.block_n(cout))
    torch.cuda.synchronize()
    assert torch.isnan(buf[:guard]).all() and torch.isnan(buf[guard + n:]).all()
    assert torch.isfinite(y).all()
    assert torch.equal(y, conv_kernels.conv3x3(x, w9, b, True))


def test_conv3x3_refuses_bad_tiles(cuda):
    """The C entry takes tiles of 128 pixels x 256 channels or 256 pixels x
    64 or 128 channels, with a box width a multiple of 8 and an N tile that
    divides Cout; it refuses any other."""
    x, w9, _, b = _conv_inputs(cuda, 1, 8, 8, 64, 128)
    y = torch.empty((1, 8, 8, 128), dtype=torch.bfloat16, device=cuda)
    for box_h, box_w, bn in ((4, 16, 128), (8, 16, 128), (16, 16, 96),
                             (8, 16, 256), (64, 4, 128)):
        with pytest.raises(RuntimeError, match="failed"):
            kernels.launch("stylemesh_conv3x3", x.device, x.data_ptr(),
                           w9.data_ptr(), b.data_ptr(), y.data_ptr(), 1, 8, 8,
                           64, 128, 1, box_h, box_w, bn)
